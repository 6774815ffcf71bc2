"""Memory reporting — counterpart of ``deepspeed_tpu/utils/memory.py``
(``memory_stats``, ``see_memory_usage``, ``memory_breakdown_report``),
the reference's ``see_memory_usage`` analogue.

The device figures come from PyTorch's caching allocator
(``torch.cuda.memory_stats``: bytes allocated now and at peak) and the
card's total memory; a CPU device reports zeros there, as the JAX version
does on a backend without allocator stats.  The host figures are the
process's RSS and peak RSS from procfs.
"""
from __future__ import annotations

import gc
from typing import Any, Dict, Optional

import torch

from .logging import log_dist

_GiB = 1024 ** 3


def _host_memory() -> Dict[str, float]:
    """VmRSS / VmHWM (peak RSS) in GiB from procfs; zeros off Linux."""
    out = {"host_rss_gb": 0.0, "host_peak_rss_gb": 0.0}
    try:
        with open("/proc/self/status") as fh:
            for line in fh:
                if line.startswith("VmRSS:"):
                    out["host_rss_gb"] = int(line.split()[1]) / 1024 ** 2
                elif line.startswith("VmHWM:"):
                    out["host_peak_rss_gb"] = int(line.split()[1]) / 1024 ** 2
    except OSError:
        pass
    return out


def memory_stats(device=None) -> Dict[str, Any]:
    """Device and host memory snapshot: ``device_bytes_in_use``,
    ``device_peak_bytes``, ``device_bytes_limit`` (the card's, zeros for a
    CPU device or none at all), ``host_rss_gb``, ``host_peak_rss_gb``."""
    stats = {"device_bytes_in_use": 0, "device_peak_bytes": 0, "device_bytes_limit": 0}
    if device is None and torch.cuda.is_available():
        device = torch.device("cuda", torch.cuda.current_device())
    dev = None if device is None else torch.device(device)
    if dev is not None and dev.type == "cuda":
        raw = torch.cuda.memory_stats(dev)
        stats["device_bytes_in_use"] = int(raw.get("allocated_bytes.all.current", 0))
        stats["device_peak_bytes"] = int(raw.get("allocated_bytes.all.peak", 0))
        stats["device_bytes_limit"] = int(torch.cuda.get_device_properties(dev).total_memory)
    stats.update(_host_memory())
    return stats


def _tree_bytes(tree) -> int:
    if isinstance(tree, dict):
        return sum(_tree_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(_tree_bytes(v) for v in tree)
    if torch.is_tensor(tree):
        return tree.numel() * tree.element_size()
    return 0


def memory_breakdown_report(engine) -> Dict[str, Any]:
    """Bytes by state component of a training engine, exact from its
    buffers: the parameters it keeps (the fp32 masters; under the NVMe tier
    the compute copy, as JAX counts ``state.params``), the optimizer state
    (its moment buffers and step count), their total, and a
    ``memory_stats`` snapshot of the engine's device.

    An offloaded engine adds ``offload``: its tier, the host bytes of its
    state and, for the CPU tier, the bytes page-locked for it
    (``pinned_bytes``; 0 on a CPU device), beside what it keeps on the
    device: the compute copy, the fp32 gradient buffer and the staging
    chunks.  The NVMe tier gives the bytes of its swap files instead."""
    report = {
        "master_params_bytes": _tree_bytes(engine.params),
        "opt_state_bytes": _tree_bytes(engine.opt_state),
        "snapshot": memory_stats(engine.device),
    }
    report["state_total_bytes"] = report["master_params_bytes"] + report["opt_state_bytes"]
    compute = getattr(engine, "_compute", None)
    if compute is not None:
        off: Dict[str, Any] = {"device_compute_bytes": _tree_bytes(compute.flat)}
        host = getattr(engine, "_offload", None)
        if host is not None:
            off.update(tier="cpu", host_state_bytes=host.host_bytes,
                       pinned_bytes=host.pool.registered_bytes,
                       device_grad_bytes=_tree_bytes(engine._masters.grad),
                       device_staging_bytes=host.staging_bytes)
        else:
            nvme = engine._nvme_opt
            off.update(tier="nvme", swap_bytes=12 * _tree_bytes(engine._grad) // 4,
                       swap_dir=nvme.swapper.dir, device_grad_bytes=_tree_bytes(engine._grad),
                       pinned_bytes=engine._nvme_pool.registered_bytes)
        report["offload"] = off
    return report


def see_memory_usage(message: str, force: bool = False, collect: bool = False,
                     device=None) -> Optional[Dict[str, Any]]:
    """Log a one-line memory breakdown and return the ``memory_stats``
    snapshot (JAX ``see_memory_usage``, the reference's
    ``runtime/utils.py:771``).  Without ``force`` it does nothing and
    returns None, so call sites stay in the code and the engine's
    ``memory_breakdown`` switch turns them on.  ``collect`` runs the host's
    garbage collector and empties PyTorch's cache of free device blocks
    first, as the reference does."""
    if not force:
        return None
    if collect:
        gc.collect()
        if torch.cuda.is_available():
            torch.cuda.empty_cache()
    s = memory_stats(device)
    log_dist(
        f"MEMSTATS {message} | "
        f"HBM in-use {s['device_bytes_in_use'] / _GiB:.2f} GB "
        f"(peak {s['device_peak_bytes'] / _GiB:.2f} GB, "
        f"limit {s['device_bytes_limit'] / _GiB:.2f} GB) | "
        f"host RSS {s['host_rss_gb']:.2f} GB (peak {s['host_peak_rss_gb']:.2f} GB)")
    return s

"""Accelerator abstraction — counterpart of ``deepspeed_tpu/accelerator/
tpu_accelerator.py`` (``TpuAccelerator``, ``get_accelerator`` :124), the
reference's ``accelerator/cuda_accelerator.py`` and
``real_accelerator.py:51 get_accelerator()``.

``CudaAccelerator`` keeps the JAX class's method names over ``torch.cuda``:
device queries, memory stats (JAX's key names: ``bytes_in_use``,
``peak_bytes_in_use``, ``bytes_limit``), dtype support, platform naming,
``synchronize`` and the communication backend's name (``'nccl'``, as
the reference's ``cuda_accelerator.py:28``; ``'gloo'`` for the CPU).

The CPU is used only when asked: ``get_accelerator("cpu")`` or
``DSTPU_ACCELERATOR=cpu`` (JAX's override).  With no CUDA device and no
such request ``get_accelerator`` raises, as every entry point of the port
does (``ops.kernels.resolve_device``).
"""
from __future__ import annotations

import os
from typing import Dict, List, Optional

import torch

from ..ops.kernels import resolve_device


class CudaAccelerator:
    """Device and platform queries over ``torch.cuda`` (or the CPU, when
    asked for).  One instance a platform through ``get_accelerator``."""

    def __init__(self, platform: str = "cuda"):
        if platform not in ("cuda", "cpu"):
            raise ValueError(f"unknown accelerator platform {platform!r} (cuda | cpu)")
        self._platform = platform

    # --- naming (reference: accelerator/cuda_accelerator.py) ---
    def device_name(self, device_index: Optional[int] = None) -> str:
        if device_index is None:
            return self.platform()
        return f"{self.platform()}:{device_index}"

    def platform(self) -> str:
        return self._platform

    def is_available(self) -> bool:
        return self._platform == "cpu" or torch.cuda.is_available()

    def device_count(self) -> int:
        return 1 if self._platform == "cpu" else torch.cuda.device_count()

    def local_device_count(self) -> int:
        return self.device_count()

    def process_count(self) -> int:
        """``torch.distributed``'s world size once a group is up, else 1."""
        import torch.distributed as dist

        if dist.is_available() and dist.is_initialized():
            return dist.get_world_size()
        return 1

    def current_device(self) -> torch.device:
        if self._platform == "cpu":
            return torch.device("cpu")
        return torch.device("cuda", torch.cuda.current_device())

    def communication_backend_name(self) -> str:
        """reference ``cuda_accelerator.py:28``: ``'nccl'``; the CPU's
        ``'gloo'``."""
        return "nccl" if self._platform == "cuda" else "gloo"

    # --- memory (reference: memory_allocated / memory_stats family) ---
    def memory_stats(self, device=None) -> Dict[str, int]:
        """JAX's keys over the caching allocator: ``bytes_in_use``,
        ``peak_bytes_in_use``, ``bytes_limit`` (the card's memory); empty
        for the CPU, as JAX's CPU device gives none."""
        dev = torch.device(device) if device is not None else self.current_device()
        if dev.type != "cuda":
            return {}
        raw = torch.cuda.memory_stats(dev)
        return {"bytes_in_use": int(raw.get("allocated_bytes.all.current", 0)),
                "peak_bytes_in_use": int(raw.get("allocated_bytes.all.peak", 0)),
                "bytes_limit": int(torch.cuda.get_device_properties(dev).total_memory)}

    def memory_allocated(self, device=None) -> int:
        return self.memory_stats(device).get("bytes_in_use", 0)

    def total_memory(self, device=None) -> int:
        return self.memory_stats(device).get("bytes_limit", 0)

    def available_memory(self, device=None) -> int:
        s = self.memory_stats(device)
        return max(s.get("bytes_limit", 0) - s.get("bytes_in_use", 0), 0)

    # --- dtype support ---
    def is_bf16_supported(self) -> bool:
        return True

    def is_fp16_supported(self) -> bool:
        return True

    def supported_dtypes(self) -> List[str]:
        return ["float32", "bfloat16", "float16", "int8", "fp8_e4m3", "fp8_e5m2"]

    # --- misc parity shims ---
    def synchronize(self, obj=None) -> None:
        """Wait for the device: for ``obj`` (a tensor), its device's current
        stream; else the whole current device.  A no-op on the CPU."""
        if torch.is_tensor(obj):
            if obj.is_cuda:
                torch.cuda.current_stream(obj.device).synchronize()
        elif self._platform == "cuda":
            torch.cuda.synchronize()

    def manual_seed(self, seed: int) -> torch.Generator:
        """A ``torch.Generator`` on this platform's device seeded with
        ``seed`` (JAX returns a PRNG key)."""
        return torch.Generator(device=self.current_device()).manual_seed(seed)

    def device_kind(self) -> str:
        """The card's name (``torch.cuda.get_device_name``); ``'cpu'``."""
        if self._platform == "cpu":
            return "cpu"
        return torch.cuda.get_device_name(self.current_device())

    def on_tpu(self) -> bool:
        return False


_ACCELERATORS: Dict[str, CudaAccelerator] = {}


def get_accelerator(platform: Optional[str] = None) -> CudaAccelerator:
    """The accelerator of ``platform`` (``'cuda'`` | ``'cpu'``), else of
    ``DSTPU_ACCELERATOR``, else CUDA — which raises without a CUDA device
    (reference ``real_accelerator.py:51``)."""
    platform = platform or os.environ.get("DSTPU_ACCELERATOR") or None
    platform = resolve_device(platform).type
    if platform not in _ACCELERATORS:
        _ACCELERATORS[platform] = CudaAccelerator(platform)
    return _ACCELERATORS[platform]

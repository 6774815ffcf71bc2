"""Collectives over ``torch.distributed`` — counterpart of
``deepspeed_tpu/comm/comm.py`` (the reference's ``deepspeed/comm/comm.py``
and its ``TorchBackend``).

JAX's functions run inside ``shard_map`` and name a mesh axis; here each
name resolves to the process group of that axis in a process grid
(``parallel/topology.py`` ``ProcessGrid``): the grid passed as ``mesh=``,
else the current one (``parallel.sharding.set_current_mesh``).  A tuple of
names is the group over those axes together (``("data", "fsdp")``).

    all_reduce       -> dist.all_reduce (in place)          (comm/comm.py:489)
    reduce_scatter   -> dist.reduce_scatter_tensor          (comm/comm.py:286)
    all_gather       -> dist.all_gather_into_tensor         (comm/comm.py:303)
    all_to_all       -> dist.all_to_all_single              (comm/comm.py:337)
    ppermute / send_recv_next / _prev -> isend / irecv     (runtime/pipe/p2p.py:46)
    broadcast        -> dist.broadcast (in place)
    barrier          -> dist.barrier

An axis may also be a ``parallel.topology.GroupAxis``: one of the grouped
sets along an axis (JAX's ``axis_index_groups``), whose collectives the
logger records under the axis's own name.

The collectives above write into fresh tensors and carry no gradient: the
model's layers take their differentiable collectives from
``parallel/context.py``, ``qcomm.q_all_to_all`` its own (exact in
``'none'``, the reverse all-to-all its gradient).

A group of one is a group like any other: the collective is issued (a
world-1 run on the card calls NCCL).  The backend follows the device:
NCCL for CUDA, gloo for the CPU (``init_distributed``); nothing falls back
from one to the other.

``CommsLogger`` (JAX :64, the reference's ``utils/comms_logging.py:67``)
counts each op and its payload bytes under ``"<op>@<axis>"`` when the
``comms_logger`` section is enabled (``configure``): the tensor-parallel
collectives land under ``"all_reduce@model"`` / ``"all_gather@model"``
(and the quantized transport's ``"all_to_all@model"``) beside the
data-parallel ones.  JAX keeps one logger
a process; the port keeps it on the grid (``ProcessGrid.comms_logger``),
so each engine's collectives land in its own grid's logger.  JAX counts
at trace time; the port counts every call, as the reference does.
"""
from __future__ import annotations

import os
from dataclasses import dataclass, field
from datetime import timedelta
from typing import Dict, Optional, Sequence

import torch
import torch.distributed as dist

from ..utils.logging import log_dist

# the flat-tensor collectives under their current names (older torch has
# only the ``*_tensor`` ones)
_ALL_GATHER = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
_REDUCE_SCATTER = getattr(dist, "reduce_scatter_single", None) or dist.reduce_scatter_tensor


def configure(comms_config=None, mesh=None) -> None:
    """Enable the comms logger of a grid (``mesh``, else the current one;
    the reference's ``deepspeed.comm.configure``); a disabled or missing
    section turns it off."""
    grid = _grid(mesh)
    if comms_config is not None and getattr(comms_config, "enabled", False):
        grid.comms_logger = CommsLogger(verbose=bool(getattr(comms_config, "verbose", False)))
    else:
        grid.comms_logger = None


def get_comms_logger(mesh=None) -> Optional["CommsLogger"]:
    """The comms logger of a grid (``mesh``, else the current one), or None
    with no grid or no logger."""
    if mesh is None:
        from ..parallel.sharding import get_current_mesh

        mesh = get_current_mesh()
    return getattr(mesh, "comms_logger", None)


@dataclass
class _OpRecord:
    count: int = 0
    bytes: int = 0


@dataclass
class CommsLogger:
    """Count and payload bytes of each collective, by ``"<op>@<axis>"``
    (JAX's keys); ``calc_bw`` is the reference's algbw / busbw
    (``utils/comms_logging.py:34``)."""

    verbose: bool = False
    ops: Dict[str, _OpRecord] = field(default_factory=dict)

    def record(self, name: str, nbytes: int, axis: str) -> None:
        key = f"{name}@{axis}"
        rec = self.ops.setdefault(key, _OpRecord())
        rec.count += 1
        rec.bytes += nbytes
        if self.verbose:
            log_dist(f"comm op: {key} payload={nbytes / 1e6:.2f} MB")

    def counts(self) -> Dict[str, int]:
        return {k: r.count for k, r in sorted(self.ops.items())}

    def reset(self) -> None:
        self.ops.clear()

    @staticmethod
    def calc_bw(op: str, size_bytes: int, duration_s: float, n: int) -> Dict[str, float]:
        if duration_s <= 0:
            return {"algbw_gbps": 0.0, "busbw_gbps": 0.0}
        algbw = size_bytes / duration_s / 1e9
        if op in ("all_gather", "reduce_scatter"):
            busbw = algbw * (n - 1) / n
        elif op == "all_reduce":
            busbw = algbw * 2 * (n - 1) / n
        else:  # all_to_all, p2p
            busbw = algbw
        return {"algbw_gbps": algbw, "busbw_gbps": busbw}

    def summary(self) -> str:
        lines = ["Comm op summary:"]
        for key, rec in sorted(self.ops.items()):
            lines.append(f"  {key}: count={rec.count} total={rec.bytes / 1e6:.2f} MB")
        return "\n".join(lines)


def log_summary(mesh=None) -> None:
    logger = get_comms_logger(mesh)
    if logger is not None:
        log_dist(logger.summary())


def axis_key(axis_name) -> str:
    """The logger's axis text: the name, or the names joined by ``+``."""
    return axis_name if isinstance(axis_name, str) else "+".join(axis_name)


def _record(name: str, x: torch.Tensor, axis_name, grid) -> None:
    logger = getattr(grid, "comms_logger", None)
    if logger is not None:
        key = axis_name.name if hasattr(axis_name, "members") else axis_key(axis_name)
        logger.record(name, x.numel() * x.element_size(), key)


def _resolve(axis_name, mesh):
    """``(grid, group, size, this rank's index)`` of an axis (a name, names,
    or a ``GroupAxis``)."""
    grid = _grid(mesh)
    if hasattr(axis_name, "members"):
        return grid, axis_name.group, axis_name.size, axis_name.index
    return grid, grid.group(axis_name), grid.axis_size(axis_name), grid.axis_rank(axis_name)


def _grid(mesh):
    if mesh is not None:
        return mesh
    from ..parallel.sharding import get_current_mesh

    grid = get_current_mesh()
    if grid is None:
        raise RuntimeError("no process grid: pass mesh= or set_current_mesh(initialize_mesh())")
    return grid


def _group(axis_name, mesh):
    return _grid(mesh).group(axis_name)


# --------------------------------------------------------------------------
# collectives
# --------------------------------------------------------------------------
def all_reduce(x: torch.Tensor, axis_name, op: str = "sum", mesh=None) -> torch.Tensor:
    """Reduce ``x`` in place over the axis group and return it; ``op`` sum,
    avg / mean (the sum divided by the group's size), max or min."""
    ops = {"sum": dist.ReduceOp.SUM, "avg": dist.ReduceOp.SUM, "mean": dist.ReduceOp.SUM,
           "max": dist.ReduceOp.MAX, "min": dist.ReduceOp.MIN}
    if op not in ops:
        raise ValueError(f"unsupported reduce op {op}")
    grid, group, w, _ = _resolve(axis_name, mesh)
    _record("all_reduce", x, axis_name, grid)
    dist.all_reduce(x, op=ops[op], group=group)
    if op in ("avg", "mean"):
        x.div_(w)
    return x


def reduce_scatter(x: torch.Tensor, axis_name, scatter_dimension: int = 0,
                   out: Optional[torch.Tensor] = None, mesh=None) -> torch.Tensor:
    """The sum over the group of ``x``, this rank's ``1/W`` block of
    ``scatter_dimension`` (JAX ``psum_scatter(tiled=True)``)."""
    grid, group, w, _ = _resolve(axis_name, mesh)
    if x.shape[scatter_dimension] % w:
        raise ValueError(f"reduce_scatter: dim {scatter_dimension} ({x.shape}) does not "
                         f"divide over {w} ranks")
    src = x.movedim(scatter_dimension, 0).contiguous()
    shape = (src.shape[0] // w,) + tuple(src.shape[1:])
    res = out if out is not None and scatter_dimension == 0 else torch.empty(
        shape, dtype=x.dtype, device=x.device)
    _record("reduce_scatter", x, axis_name, grid)
    _REDUCE_SCATTER(res.view(-1), src.view(-1), group=group)
    return res if scatter_dimension == 0 else res.movedim(0, scatter_dimension)


def all_gather(x: torch.Tensor, axis_name, axis: int = 0, tiled: bool = True,
               out: Optional[torch.Tensor] = None, mesh=None) -> torch.Tensor:
    """Every rank's ``x`` in rank order: concatenated along ``axis``
    (``tiled``), else stacked on a new leading axis at ``axis``."""
    grid, group, w, _ = _resolve(axis_name, mesh)
    src = x.contiguous().reshape(-1)  # gloo and NCCL both take the flat form
    n = src.numel()
    flat_ok = out is not None and out.is_contiguous() and out.numel() == w * n
    res = out.view(-1) if flat_ok else torch.empty(w * n, dtype=x.dtype, device=x.device)
    _record("all_gather", x, axis_name, grid)
    _ALL_GATHER(res, src, group=group)
    if flat_ok:
        return out
    res = res.view((w,) + tuple(x.shape))
    if tiled:
        return torch.cat(res.unbind(0), dim=axis) if axis else res.reshape(
            (w * x.shape[0],) + tuple(x.shape[1:]))
    return res.movedim(0, axis) if axis else res


def all_to_all(x: torch.Tensor, axis_name, split_axis: int = 0, concat_axis: int = 0,
               mesh=None) -> torch.Tensor:
    """Block ``i`` of ``split_axis`` goes to rank ``i``; the blocks
    received concatenate along ``concat_axis`` in rank order (JAX
    ``all_to_all(tiled=True)``)."""
    grid, group, w, _ = _resolve(axis_name, mesh)
    if x.shape[split_axis] % w:
        raise ValueError(f"all_to_all: split dim {split_axis} ({x.shape}) does not divide "
                         f"over {w} ranks")
    src = x.movedim(split_axis, 0).contiguous()
    res = torch.empty_like(src)
    _record("all_to_all", x, axis_name, grid)
    dist.all_to_all_single(res, src, group=group)
    blocks = res.movedim(0, split_axis).chunk(w, dim=split_axis)
    return torch.cat(blocks, dim=concat_axis)


def ppermute(x: torch.Tensor, axis_name, perm: Sequence, mesh=None) -> torch.Tensor:
    """Point-to-point exchange by ``perm`` (pairs (source, destination) of
    indices in the axis group): what this rank receives, zeros if no
    one sends to it (JAX ``lax.ppermute``)."""
    grid, group, _, me = _resolve(axis_name, mesh)
    out = torch.zeros_like(x)
    src = x.contiguous()
    ops = []
    _record("ppermute", x, axis_name, grid)
    for s, d in perm:
        if s == me and d != me:
            ops.append(dist.P2POp(dist.isend, src, dist.get_global_rank(group, d), group))
        if d == me and s != me:
            ops.append(dist.P2POp(dist.irecv, out, dist.get_global_rank(group, s), group))
        if s == me and d == me:
            out.copy_(src)
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return out


def send_recv_next(x: torch.Tensor, axis_name, n: Optional[int] = None,
                   mesh=None) -> torch.Tensor:
    """Shift +1 along the axis ring: index i sends to i + 1."""
    n = n or _grid(mesh).axis_size(axis_name)
    return ppermute(x, axis_name, [(i, (i + 1) % n) for i in range(n)], mesh=mesh)


def send_recv_prev(x: torch.Tensor, axis_name, n: Optional[int] = None,
                   mesh=None) -> torch.Tensor:
    n = n or _grid(mesh).axis_size(axis_name)
    return ppermute(x, axis_name, [((i + 1) % n, i) for i in range(n)], mesh=mesh)


def broadcast(x: torch.Tensor, axis_name, src: int = 0, mesh=None) -> torch.Tensor:
    """Index ``src``'s ``x`` to every member of the axis group, in place."""
    grid = _grid(mesh)
    group = grid.group(axis_name)
    _record("broadcast", x, axis_name, grid)
    dist.broadcast(x, src=dist.get_global_rank(group, src), group=group)
    return x


def barrier(axis_name=None, mesh=None) -> None:
    """Every member of the axis group (the world when ``axis_name`` is
    None) reaches this point."""
    if axis_name is None:
        dist.barrier()
    else:
        dist.barrier(group=_group(axis_name, mesh))


def axis_rank(axis_name, mesh=None) -> int:
    return _grid(mesh).axis_rank(axis_name)


# --------------------------------------------------------------------------
# process bootstrap and world queries (reference comm/comm.py:625)
# --------------------------------------------------------------------------
def init_distributed(backend: Optional[str] = None, init_method: Optional[str] = None,
                     world_size: Optional[int] = None, rank: Optional[int] = None,
                     device: Optional[str] = None, timeout: Optional[float] = None) -> None:
    """Join the world the launcher described: ``MASTER_ADDR`` /
    ``MASTER_PORT`` / ``WORLD_SIZE`` / ``RANK`` / ``LOCAL_RANK`` (or the
    arguments).  On CUDA the rank's device is ``cuda:LOCAL_RANK``, set
    before the group forms, and the backend is NCCL; on the CPU
    (``device="cpu"``) gloo.  A second call is a no-op."""
    if dist.is_initialized():
        return
    world_size = int(world_size if world_size is not None else os.environ.get("WORLD_SIZE", 1))
    rank = int(rank if rank is not None else os.environ.get("RANK", 0))
    local_rank = int(os.environ.get("LOCAL_RANK", rank))
    platform = "cpu" if device is not None and torch.device(device).type == "cpu" else "cuda"
    if platform == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("init_distributed: no CUDA device; pass device='cpu' for gloo "
                               "ranks on the CPU")
        torch.cuda.set_device(local_rank)
    backend = backend or ("nccl" if platform == "cuda" else "gloo")
    if platform == "cuda" and backend != "nccl":
        raise ValueError(f"a CUDA rank communicates over NCCL, not {backend}")
    if init_method is None:
        os.environ.setdefault("MASTER_ADDR", "127.0.0.1")
        os.environ.setdefault("MASTER_PORT", "29500")
        init_method = "env://"
    kw = {"timeout": timedelta(seconds=timeout)} if timeout else {}
    import inspect

    if platform == "cuda" and "device_id" in inspect.signature(dist.init_process_group).parameters:
        kw["device_id"] = torch.device("cuda", local_rank)  # binds the rank's device
    dist.init_process_group(backend=backend, init_method=init_method, world_size=world_size,
                            rank=rank, **kw)
    log_dist(f"init_distributed: backend={backend} world={world_size}")


def is_initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def get_world_size() -> int:
    return dist.get_world_size() if is_initialized() else 1


def get_rank() -> int:
    return dist.get_rank() if is_initialized() else 0


def get_local_rank() -> int:
    return int(os.environ.get("LOCAL_RANK", get_rank()))


def destroy() -> None:
    """Leave the world (``destroy_process_group``)."""
    if is_initialized():
        dist.destroy_process_group()

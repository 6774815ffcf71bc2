"""Error-feedback 1-bit compressed all-reduce — counterpart of
``deepspeed_tpu/comm/compressed.py`` (:42; the reference's
``runtime/comm/nccl.py:51 NcclBackend.compressed_allreduce``).

The flat tensor plus this rank's worker error splits into ``W`` chunks;
each chunk is compressed to int8 signs and one fp32 scale (the mean of its
absolute values, 1-bit Adam's l1 scaling), and the residual becomes the
new worker error.  An all-to-all hands chunk ``r`` of every rank to rank
``r`` (the "server" of that chunk), which averages them, adds its server
error, compresses again (the residual is the new server error) and
all-gathers the result.  Both hops carry int8 and one scale a chunk, as
in JAX (the reference packs literal bits).
"""
from __future__ import annotations

from typing import Tuple

import torch

from . import comm


def _compress(buf: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per row of ``buf``: (int8 signs, fp32 scale = mean |row|, the
    residual ``buf - signs * scale``)."""
    scale = buf.abs().mean(dim=-1)
    signs = torch.where(buf >= 0, 1, -1).to(torch.int8)
    return signs, scale, buf - signs.float() * scale[..., None]


def compressed_allreduce(x: torch.Tensor, worker_error: torch.Tensor,
                         server_error: torch.Tensor, axis_name, mesh=None
                         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The mean of ``x`` over the axis group, sign-compressed with error
    feedback; ``worker_error`` / ``server_error`` are this rank's buffers
    (flat, ``padded`` and ``padded // W`` elements, ``error_buffer_sizes``).
    Returns ``(mean, new_worker_error, new_server_error)``."""
    w = comm._grid(mesh).axis_size(axis_name)
    n = x.numel()
    padded = worker_error.numel()
    chunk = padded // w
    flat = torch.nn.functional.pad(x.reshape(-1).float(), (0, padded - n))
    signs, scales, err = _compress((flat + worker_error).reshape(w, chunk))
    recv_signs = comm.all_to_all(signs, axis_name, mesh=mesh)  # row i: rank i's chunk
    recv_scales = comm.all_to_all(scales[:, None].contiguous(), axis_name, mesh=mesh)
    avg = (recv_signs.float() * recv_scales.reshape(w, 1)).mean(dim=0)  # the server's reduce
    signs2, scales2, err2 = _compress((avg + server_error)[None, :])
    all_signs = comm.all_gather(signs2.reshape(chunk), axis_name, tiled=False, mesh=mesh)
    all_scales = comm.all_gather(scales2.reshape(1), axis_name, tiled=False, mesh=mesh)
    full = all_signs.float() * all_scales.reshape(w, 1)
    return full.reshape(-1)[:n].reshape(x.shape), err.reshape(-1), err2.reshape(-1)


def error_buffer_sizes(n: int, world: int) -> Tuple[int, int]:
    """(worker, server) flat error-buffer sizes for an n-element tensor."""
    padded = -(-n // world) * world
    return padded, padded // world

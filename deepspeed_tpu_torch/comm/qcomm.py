"""The host-side payload codec of ``deepspeed_tpu/comm/qcomm.py``
(``quantize_payload`` / ``dequantize_payload`` / ``payload_wire_bytes``,
qcomm.py:487-560): the wire format of the paged-KV handoff between serving
workers.

An array flattens into ``chunk``-element groups with one fp32 amax scale
per group; ``int8`` rounds half to even and clips to +-127, ``fp8`` casts
to e4m3fn and ships the raw bytes as ``uint8`` (``torch.float8_e4m3fn``
viewed as ``uint8``; the JAX package casts through ``ml_dtypes``).  The
codec computes in torch on CPU tensors, in fp32, so its bytes and scales
equal JAX's numpy codec on the same input.  ``fmt='none'`` passes the
array through.

``wire_bytes`` is qcomm's per-collective wire accounting (qcomm.py:125),
which ``comm/budget.py`` and the autotuner's roofline read.  The quantized
collectives themselves (tensor-parallel serving) are not ported yet
(ROADMAP queue 1 item 7).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

FORMATS = ("none", "int8", "fp8")
_FMT_MAX = {"int8": 127.0, "fp8": 448.0}  # e4m3fn finfo max
_FMT_BYTES = {"none": 4, "int8": 1, "fp8": 1}
DEFAULT_CHUNK = 256  # elements per fp32 scale on the wire


class QCommError(ValueError):
    """Typed configuration error of the quantized-communication layer."""


def _check_fmt(fmt: str) -> str:
    if fmt not in FORMATS:
        raise QCommError(f"qcomm format {fmt!r} — expected one of {FORMATS}")
    return fmt


def _cpu(arr) -> torch.Tensor:
    t = arr if isinstance(arr, torch.Tensor) else torch.as_tensor(arr)
    return t.detach().cpu()


def quantize_payload(arr, fmt: str, chunk: int = DEFAULT_CHUNK
                     ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """``(payload, scales)`` of ``arr`` (a tensor or array, any device;
    the codec runs on the CPU): ``payload`` int8 (or fp8 bytes as uint8)
    of ``arr`` flattened into ``chunk``-element groups, ``scales`` one
    fp32 amax / format-max scale per group.  ``fmt='none'`` returns
    ``(arr on the CPU, None)``."""
    _check_fmt(fmt)
    if fmt == "none":
        return _cpu(arr), None
    flat = _cpu(arr).to(torch.float32).reshape(-1)
    pad = (-flat.shape[0]) % chunk
    if pad:
        flat = torch.nn.functional.pad(flat, (0, pad))
    buf = flat.reshape(-1, chunk)
    amax = buf.abs().amax(dim=-1)
    s = amax.clamp_min(1e-12) / torch.tensor(_FMT_MAX[fmt], dtype=torch.float32)
    if fmt == "int8":
        q = torch.round(buf / s[:, None]).clamp_(-127, 127).to(torch.int8)
    else:
        q = (buf / s[:, None]).to(torch.float8_e4m3fn).view(torch.uint8)
    return q, s


def dequantize_payload(q, s, shape, dtype, fmt: str, chunk: int = DEFAULT_CHUNK
                       ) -> torch.Tensor:
    """Decode a :func:`quantize_payload` pair into a CPU tensor of
    ``shape`` / ``dtype`` (fp32 groups un-padded and reshaped, then cast);
    ``fmt='none'`` casts the passthrough payload."""
    _check_fmt(fmt)
    if fmt == "none":
        return _cpu(q).reshape(shape).to(dtype)
    if fmt == "int8":
        buf = q.to(torch.float32) * s[:, None]
    else:
        buf = q.view(torch.float8_e4m3fn).to(torch.float32) * s[:, None]
    n = 1
    for d in shape:
        n *= int(d)
    return buf.reshape(-1)[:n].reshape(tuple(shape)).to(dtype)


def payload_wire_bytes(n_elements: int, fmt: str, chunk: int = DEFAULT_CHUNK,
                       none_bytes_per_el: int = 2) -> int:
    """Bytes ONE :func:`quantize_payload` encoding puts on a wire (payload
    + fp32 scales).  ``none_bytes_per_el`` defaults to 2: passthrough KV
    pages ship in the cache dtype (bf16)."""
    _check_fmt(fmt)
    if fmt == "none":
        return n_elements * none_bytes_per_el
    return n_elements * _FMT_BYTES[fmt] + 4 * (-(-n_elements // chunk))


def wire_bytes(op: str, n_elements: int, fmt: str, world: int,
               chunk: int = DEFAULT_CHUNK, none_bytes_per_el: int = 4) -> int:
    """Per-device payload bytes ONE collective call puts on the wire
    (payload + fp32 scales) — JAX's accounting.  ``op``: 'all_gather' |
    'reduce_scatter' | 'all_reduce' | 'all_to_all' | 'collective_permute'.
    ``n_elements`` is the FULL logical tensor (for all_to_all: this rank's
    local buffer).  Counts what a device SENDS on a ring: (W-1)/W of the
    buffer per hop, twice for all_reduce; a permute sends the whole buffer
    once."""
    _check_fmt(fmt)
    per_el = none_bytes_per_el if fmt == "none" else _FMT_BYTES[fmt]
    scale_b = 0 if fmt == "none" else 4 * (-(-n_elements // chunk))
    body = n_elements * per_el + scale_b
    if op in ("all_gather", "reduce_scatter", "all_to_all"):
        return body * (world - 1) // world
    if op == "all_reduce":
        return 2 * (body * (world - 1) // world)
    if op == "collective_permute":
        return body
    raise QCommError(f"wire_bytes op {op!r}")

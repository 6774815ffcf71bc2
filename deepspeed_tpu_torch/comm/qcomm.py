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
which ``comm/budget.py`` and the autotuner's roofline read.

The quantized collectives (qcomm.py:161-478: ``ring_permute``,
``q_all_gather``, ``q_reduce_scatter``, ``q_all_reduce``, ``q_all_to_all``,
``q_psum_tiled``, ``error_like``) run over a process grid's axis groups
(``comm/comm.py``).  A payload is cut into ``chunk``-element groups, one
fp32 scale each: ``s = max(amax, 1e-12) / qmax`` (127 for int8, 448 for
e4m3), ``q = clip(round(x / s), +-127)`` or ``fp8(x / s)``.  On a CUDA
tensor ``_q_chunks`` is the row quantizer K6a / K6c over the ``[n / chunk,
chunk]`` view and ``_dq_chunks`` the dequantizer K6b (``ops/kernels/
quant_kernel.py``, counted in ``ops.kernels.LAUNCHES``); on a CPU tensor
their plain versions, whose bytes and scales are the kernels'.  Reductions
dequantize every rank's payload and sum in fp32 (``accum='fp32'``); an
integer accumulation raises ``QCommOverflowError``, as in JAX.
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


class QCommOverflowError(QCommError):
    """A reducing collective asked to accumulate int8 / fp8 payloads in
    their own format: ``W`` addends span ``W * qmax``."""


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


# ---------------------------------------------------------------------------
# the quantized collectives (qcomm.py:161-478) over a process grid
# ---------------------------------------------------------------------------
_QDTYPE = {"int8": torch.int8, "fp8": torch.float8_e4m3fn}


def _check_reduce(fmt: str, accum: str, axis_name, op: str) -> None:
    _check_fmt(fmt)
    if accum == "fp32":
        return
    if accum not in FORMATS:
        raise QCommError(f"qcomm accum {accum!r} — expected 'fp32' (carry) or {FORMATS}")
    if fmt != "none":
        raise QCommOverflowError(
            f"{op}: accumulating {fmt} payloads in {accum!r} over the {axis_name!r} axis "
            f"would overflow the format's range (W addends of magnitude up to "
            f"{_FMT_MAX[fmt]:.0f}); use accum='fp32'")


def _world(axis_name, world, mesh) -> int:
    if world is not None:
        return int(world)
    from .comm import _grid

    return _grid(mesh).axis_size(axis_name)


def _pad_to(flat: torch.Tensor, mult: int) -> torch.Tensor:
    pad = (-flat.shape[0]) % mult
    return torch.nn.functional.pad(flat, (0, pad)) if pad else flat


def _q_chunks(flat: torch.Tensor, fmt: str, chunk: int):
    """fp32 ``[n]`` (``n % chunk == 0``) -> (payload ``[n / chunk, chunk]``,
    fp32 scales ``[n / chunk]``): K6a / K6c on CUDA, the plain rows on the
    CPU."""
    from ..ops.kernels import quant_kernel as QK

    buf = flat.reshape(-1, chunk)
    if fmt == "int8":
        return QK.quantize_int8(buf)
    return QK.quantize_fp8(buf, _QDTYPE[fmt])


def _dq_chunks(q: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """payload ``[..., G, chunk]`` and scales ``[..., G]`` -> fp32
    ``[..., G, chunk]`` (K6b on CUDA)."""
    from ..ops.kernels import quant_kernel as QK

    out = QK.dequantize(q.reshape(-1, q.shape[-1]), s.reshape(-1), torch.float32)
    return out.reshape(q.shape)


def ring_permute(x: torch.Tensor, axis_name, world: Optional[int] = None,
                 mesh=None) -> torch.Tensor:
    """One ring hop: index ``i`` sends ``x`` to ``i + 1`` and receives from
    ``i - 1`` (exact; JAX's seq-ring primitive)."""
    from . import comm

    n = _world(axis_name, world, mesh)
    return comm.ppermute(x, axis_name, [(i, (i + 1) % n) for i in range(n)], mesh=mesh)


def q_all_gather(x: torch.Tensor, axis_name, fmt: str = "int8", *, axis: int = 0,
                 tiled: bool = False, chunk: int = DEFAULT_CHUNK, out_dtype=None,
                 mesh=None) -> torch.Tensor:
    """All-gather whose wire payload is ``fmt`` plus one fp32 scale a
    ``chunk`` of this rank's ``x``, dequantized on arrival into
    ``out_dtype`` (the qwZ weight gather); ``'none'`` casts to
    ``out_dtype`` first and gathers exactly."""
    from . import comm

    _check_fmt(fmt)
    out_dtype = out_dtype or x.dtype
    if fmt == "none":
        return comm.all_gather(x.to(out_dtype), axis_name, axis=axis, tiled=tiled, mesh=mesh)
    n = x.numel()
    flat = _pad_to(x.reshape(-1).float(), chunk)
    q, s = _q_chunks(flat, fmt, chunk)
    wire_q = q.view(torch.uint8) if fmt == "fp8" else q  # gloo carries no fp8 type
    q_all = comm.all_gather(wire_q, axis_name, tiled=False, mesh=mesh)  # [W, G, chunk]
    s_all = comm.all_gather(s, axis_name, tiled=False, mesh=mesh)  # [W, G]
    if fmt == "fp8":
        q_all = q_all.view(_QDTYPE[fmt])
    w = q_all.shape[0]
    full = _dq_chunks(q_all, s_all).reshape(w, -1)[:, :n]
    full = full.reshape((w,) + tuple(x.shape)).to(out_dtype)
    if tiled:
        return torch.cat(full.unbind(0), dim=axis)
    return full.movedim(0, axis) if axis else full


def _pieces(x: torch.Tensor, w: int, dim: int) -> torch.Tensor:
    return torch.stack(torch.chunk(x, w, dim=dim))


def q_reduce_scatter(x: torch.Tensor, axis_name, fmt: str = "int8", *, scatter_axis: int = 0,
                     mean: bool = False, error: Optional[torch.Tensor] = None,
                     chunk: int = DEFAULT_CHUNK, accum: str = "fp32",
                     world: Optional[int] = None, mesh=None):
    """qgZ's reduce: split ``x`` (this rank's full-size partial) into one
    piece a destination, quantize each piece (its own chunks), all-to-all,
    dequantize and sum in fp32; returns this rank's reduced piece (or
    ``(piece, new_error)`` with ``error``, the residual of this call's
    quantization of ``x + error``)."""
    from . import comm

    _check_reduce(fmt, accum, axis_name, "q_reduce_scatter")
    w = _world(axis_name, world, mesh)
    if x.shape[scatter_axis] % w:
        raise QCommError(f"q_reduce_scatter: dim {scatter_axis} ({x.shape[scatter_axis]}) "
                         f"must divide the axis size {w}")
    xf = x.float()
    comp = xf + error if error is not None else xf
    if fmt == "none":
        out = comm.reduce_scatter(comp, axis_name, scatter_dimension=scatter_axis, mesh=mesh)
        out = out / w if mean else out
        return (out, torch.zeros_like(xf)) if error is not None else out
    pieces = _pieces(comp, w, scatter_axis)
    piece_elems = pieces[0].numel()
    flat2 = pieces.reshape(w, -1)
    pad = (-piece_elems) % chunk
    if pad:
        flat2 = torch.nn.functional.pad(flat2, (0, pad))
    gpr = flat2.shape[1] // chunk  # scale groups a piece
    q, s = _q_chunks(flat2.reshape(-1), fmt, chunk)
    if error is not None:
        res = flat2.reshape(-1) - _dq_chunks(q, s).reshape(-1)
        res = res.reshape(w, -1)[:, :piece_elems].reshape(pieces.shape)
        new_error = torch.cat(res.unbind(0), dim=scatter_axis)
    wire_q = q.view(torch.uint8) if fmt == "fp8" else q
    recv_q = comm.all_to_all(wire_q.reshape(w, gpr, chunk), axis_name, mesh=mesh)
    recv_s = comm.all_to_all(s.reshape(w, gpr), axis_name, mesh=mesh)
    if fmt == "fp8":
        recv_q = recv_q.view(_QDTYPE[fmt])
    total = _dq_chunks(recv_q, recv_s).sum(0).reshape(-1)[:piece_elems]
    out = total.reshape(pieces.shape[1:])
    out = out / w if mean else out
    return (out, new_error) if error is not None else out


def q_all_reduce(x: torch.Tensor, axis_name, fmt: str = "int8", *, mean: bool = False,
                 error: Optional[torch.Tensor] = None, chunk: int = DEFAULT_CHUNK,
                 accum: str = "fp32", world: Optional[int] = None, mesh=None):
    """All-reduce as quantized reduce-scatter, re-quantize, quantized
    all-gather (both hops narrow, the sum in fp32); exact in ``'none'``.
    ``error`` compensates the first hop."""
    from . import comm

    _check_reduce(fmt, accum, axis_name, "q_all_reduce")
    if fmt == "none":
        xf = x.float()
        comp = (xf + error if error is not None else xf).clone()
        out = comm.all_reduce(comp, axis_name, op="mean" if mean else "sum", mesh=mesh)
        return (out, torch.zeros_like(xf)) if error is not None else out
    w = _world(axis_name, world, mesh)
    n = x.numel()
    flat = _pad_to(x.reshape(-1).float(), w * chunk)
    err = _pad_to(error.reshape(-1), w * chunk) if error is not None else None
    res = q_reduce_scatter(flat, axis_name, fmt, mean=mean, world=w, error=err, chunk=chunk,
                           accum=accum, mesh=mesh)
    shard, new_error = (res if error is not None else (res, None))
    full = q_all_gather(shard, axis_name, fmt, tiled=True, chunk=chunk,
                        out_dtype=torch.float32, mesh=mesh)
    out = full[:n].reshape(x.shape)
    if error is not None:
        return out, new_error[:n].reshape(x.shape)
    return out


def _q_a2a_impl(x, axis_name, fmt, split_axis, concat_axis, chunk, out_dtype, w, mesh,
                a2a=None):
    from . import comm

    if a2a is None:
        def a2a(t, ax):
            return comm.all_to_all(t, ax, mesh=mesh)
    if fmt == "none":  # the exact slabs
        recv = a2a(_pieces(x, w, split_axis).contiguous(), axis_name)
        return torch.cat(recv.unbind(0), dim=concat_axis).to(out_dtype)
    pieces = _pieces(x.float(), w, split_axis)
    piece_shape = pieces.shape[1:]
    piece_elems = pieces[0].numel()
    flat2 = pieces.reshape(w, -1)
    pad = (-piece_elems) % chunk
    if pad:
        flat2 = torch.nn.functional.pad(flat2, (0, pad))
    gpr = flat2.shape[1] // chunk
    q, s = _q_chunks(flat2.reshape(-1), fmt, chunk)
    wire_q = q.view(torch.uint8) if fmt == "fp8" else q
    recv_q = a2a(wire_q.reshape(w, gpr, chunk), axis_name)
    recv_s = a2a(s.reshape(w, gpr), axis_name)
    if fmt == "fp8":
        recv_q = recv_q.view(_QDTYPE[fmt])
    deq = _dq_chunks(recv_q, recv_s).reshape(w, -1)[:, :piece_elems]
    deq = deq.reshape((w,) + tuple(piece_shape)).to(out_dtype)
    return torch.cat(deq.unbind(0), dim=concat_axis)


class _QAllToAll(torch.autograd.Function):
    """The quantized all-to-all with JAX's straight-through backward: the
    cotangent takes the transposed all-to-all at the same format."""

    @staticmethod
    def forward(ctx, x, axis_name, fmt, split_axis, concat_axis, chunk, out_dtype, w, mesh,
                a2a):
        ctx.args = (axis_name, fmt, concat_axis, split_axis, chunk, x.dtype, w, mesh, a2a)
        return _q_a2a_impl(x, axis_name, fmt, split_axis, concat_axis, chunk, out_dtype, w,
                           mesh, a2a)

    @staticmethod
    def backward(ctx, g):
        return (_q_a2a_impl(g, *ctx.args),) + (None,) * 9


def q_all_to_all(x: torch.Tensor, axis_name, fmt: str = "int8", *, split_axis: int = 0,
                 concat_axis: int = 0, chunk: int = DEFAULT_CHUNK, out_dtype=None,
                 world: Optional[int] = None, mesh=None, a2a=None) -> torch.Tensor:
    """All-to-all whose slabs each travel quantized with their own scales
    (the MoE dispatch wire); differentiable through the transposed
    all-to-all (straight-through, as JAX's custom VJP).  ``a2a(t, axis)``,
    when given, makes the wire's plain all-to-all (dim 0 to dim 0) in
    place of ``comm.all_to_all`` (``parallel.context``)."""
    _check_fmt(fmt)
    out_dtype = out_dtype or x.dtype
    w = _world(axis_name, world, mesh)
    if x.shape[split_axis] % w:
        raise QCommError(f"q_all_to_all: split dim {split_axis} ({x.shape[split_axis]}) "
                         f"must divide the axis size {w}")
    return _QAllToAll.apply(x, axis_name, fmt, split_axis, concat_axis, chunk, out_dtype, w,
                            mesh, a2a)


def q_psum_tiled(y: torch.Tensor, axis_name, fmt: str = "none", *, tiles: int = 1,
                 chunk: int = DEFAULT_CHUNK, out_dtype=None, world: Optional[int] = None,
                 mesh=None) -> torch.Tensor:
    """The row-parallel partial sum, tile by tile along the last dim (each
    tile one ``q_all_reduce``); ``'none'`` with one tile is the plain
    sum."""
    from . import comm

    _check_fmt(fmt)
    out_dtype = out_dtype or y.dtype
    tiles = max(int(tiles), 1)
    if tiles == 1 and fmt == "none":
        return comm.all_reduce(y.clone(), axis_name, mesh=mesh)
    n = y.shape[-1]
    tiles = min(tiles, n)
    tile_n = -(-n // tiles)
    outs = []
    for i in range(tiles):
        sl = y[..., i * tile_n:min((i + 1) * tile_n, n)]
        if sl.shape[-1] == 0:
            continue
        if fmt == "none":
            outs.append(comm.all_reduce(sl.contiguous().clone(), axis_name, mesh=mesh))
        else:
            outs.append(q_all_reduce(sl, axis_name, fmt, chunk=chunk, world=world,
                                     mesh=mesh).to(out_dtype))
    out = torch.cat(outs, dim=-1) if len(outs) > 1 else outs[0]
    return out.to(out_dtype)


def error_like(x) -> torch.Tensor:
    """A zero fp32 error-feedback buffer shaped like ``x``, on its device."""
    return torch.zeros(tuple(getattr(x, "shape", ())), dtype=torch.float32,
                       device=getattr(x, "device", None))

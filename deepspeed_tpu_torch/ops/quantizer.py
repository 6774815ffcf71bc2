"""Quantization ops and quantized-weight serving — counterpart of
``deepspeed_tpu/ops/quantizer.py``.

Quantizer API (the reference's ``deepspeed.ops.quantizer``): symmetric int8
and fp8 with one scale per group, where groups are the rows of the
``[-1, group_size]`` flattening (``group_size`` defaults to the trailing
dimension).  ``quantize_int8`` / ``quantize_fp8`` / ``dequantize`` run the
row kernels of ``ops/kernels/quant_kernel.py`` (K6) on a CUDA tensor and
their plain versions on a CPU one.

Serving (``InferenceEngineV2(quantize_weights=...)``): the big matmul
kernels ``[..., in, out]`` are stored compressed with ONE fp32 scale per
output channel, so the dequantization is exact as a post-matmul multiply
and the matmul reads only the compressed bytes: ``ServingQuant`` (int8 or
float8_e4m3fn) and ``ServingQuantFP6`` (e2m3 codes in three quarter-strided
byte planes, 0.75 bytes a weight).  ``serving_mm`` dispatches them to the
dequant-matmul kernels K4 / K5 (``ops/kernels/quant_matmul.py``).

Tensor-parallel serving (JAX's ``ServingContext`` / ``_shard_mm``,
``quantizer.py:138-330``): each rank of the ``model`` axis holds its shard
of every kernel (``shard_serving_weight``: a column kernel's output
channels with their scales, a row kernel's input rows with the whole
scales) and ``serving_mm`` runs K4 / K5 on it.  A column-parallel matmul
reads the local channels and adds its local bias; a row-parallel one makes
this rank's partial sum, reduces it over ``model`` through
``comm/qcomm.py``'s ``q_psum_tiled`` (``comm_fmt`` 'none' the exact sum,
'int8' / 'fp8' the quantized transport, K6 on CUDA; ``comm_tiles`` > 1
splits the output channels into tiles, each its own matmul and reduce;
a plain kernel's partial sum reduces exactly in one all-reduce, as in JAX)
and adds the bias once.  The scale is a per-output-channel multiplier, so
each shard's epilogue commutes with the sum.  An FP6 row kernel is packed
per K-chunk (``quantize_serving_params(row_parallel_shards=tp)``, JAX
``_fp6_pack(row_shards)``), so a rank's chunk is a standard pack.
"""
from __future__ import annotations

import warnings
from typing import NamedTuple, Optional, Tuple

import torch

from .kernels import quant_kernel as QK
from .kernels.quant_matmul import fp6_decode as _fp6_decode
from .kernels.quant_matmul import fp6_unpack, quant_matmul, quant_matmul_fp6

# ---------------------------------------------------------------------------
# quantizer API
# ---------------------------------------------------------------------------
class QuantizedTensor(NamedTuple):
    data: torch.Tensor  # int8 or fp8, original shape
    scales: torch.Tensor  # fp32 [groups]
    group_size: int
    orig_dtype: torch.dtype


def _grouped(x: torch.Tensor, group_size: Optional[int]) -> Tuple[torch.Tensor, int]:
    n = x.numel()
    gs = group_size or (x.shape[-1] if x.dim() else n)
    if n % gs:
        # one scale for the whole tensor: coarser than asked, so say so
        warnings.warn(
            f"quantizer: tensor size {n} not divisible by group_size {gs}; "
            "falling back to a SINGLE quantization group for the whole tensor",
            stacklevel=3)
        gs = n
    return x.reshape(n // gs, gs), gs


def quantize_int8(x: torch.Tensor, group_size: Optional[int] = None) -> QuantizedTensor:
    """Symmetric int8: q = round(x / s), s = amax / 127 per group."""
    x2d, gs = _grouped(x, group_size)
    q, s = QK.quantize_int8(x2d)
    return QuantizedTensor(q.reshape(x.shape), s, gs, x.dtype)


def dequantize(qt: QuantizedTensor, dtype=None) -> torch.Tensor:
    q2d = qt.data.reshape(-1, qt.group_size)
    out = QK.dequantize(q2d, qt.scales, dtype or qt.orig_dtype)
    return out.reshape(qt.data.shape)


def quantize_fp8(x: torch.Tensor, dtype=torch.float8_e4m3fn,
                 group_size: Optional[int] = None) -> QuantizedTensor:
    """Scaled fp8 cast (e4m3 default; e5m2 for gradients, as fp_quantizer)."""
    x2d, gs = _grouped(x, group_size)
    q, s = QK.quantize_fp8(x2d, dtype)
    return QuantizedTensor(q.reshape(x.shape), s, gs, x.dtype)


def fake_quantize_int8(x: torch.Tensor, group_size: Optional[int] = None) -> torch.Tensor:
    """quantize -> dequantize in one call (the reference's fake_quantizer)."""
    return dequantize(quantize_int8(x, group_size))


# ---------------------------------------------------------------------------
# quantized-weight serving
# ---------------------------------------------------------------------------
class ServingQuant(NamedTuple):
    """A kernel ``[..., in, out]`` stored as ``q`` (int8 or float8_e4m3fn,
    the original shape) with ONE fp32 scale per output channel ``s``
    ``[..., out]``; stacked layers get independent ``[L, out]`` scales."""

    q: torch.Tensor
    s: torch.Tensor


class ServingQuantFP6:
    """FP6 (e2m3) serving kernel: four 6-bit codes bit-packed into three
    uint8 planes ``packed`` ``[..., 3, in/4, out]`` + one fp32 scale per
    output channel ``s``.  Quarter-strided: packed row r carries the codes
    of weight rows (r, K/4 + r, K/2 + r, 3K/4 + r), so K5 decodes each
    quarter elementwise and contracts it against its own slice of x.
    ``row_shards > 1``: the quarter-stride runs within each of
    ``row_shards`` contiguous K-chunks, packed chunk after chunk along the
    packed dim (a tensor-parallel row kernel: each rank's chunk is a
    standard pack of its rows)."""

    def __init__(self, packed: torch.Tensor, s: torch.Tensor, in_dim: int, row_shards: int = 1):
        self.packed = packed
        self.s = s
        self.in_dim = int(in_dim)
        self.row_shards = int(row_shards)


QUANT_TYPES = (ServingQuant, ServingQuantFP6)


def map_quant(w, fn):
    """``fn`` applied to each tensor of a quantized serving weight."""
    if isinstance(w, ServingQuant):
        return ServingQuant(fn(w.q), fn(w.s))
    return ServingQuantFP6(fn(w.packed), fn(w.s), w.in_dim, w.row_shards)


def _encode_into(w: torch.Tensor, outs, encode) -> None:
    """Write ``encode`` (fp32 [in, out] -> tensors) of each [in, out] matrix
    of ``w`` [..., in, out] into ``outs`` (each ``[n matrices, ...]``), one
    matrix at a time, each moved to the outputs' device first: a stacked
    [L, in, out] leaf never has more than one layer's fp32 temporaries
    alive."""
    k, n = w.shape[-2:]
    mats = w.reshape(-1, k, n)
    device = outs[0].device
    for i in range(mats.shape[0]):
        for out, part in zip(outs, encode(mats[i].to(device=device, dtype=torch.float32))):
            out[i] = part


def _per_matrix(w: torch.Tensor, device, out_shapes, encode):
    """``_encode_into`` outputs preallocated on ``device``, reshaped to
    ``w``'s leading dims."""
    lead = w.shape[:-2]
    n_mats = w.reshape(-1, *w.shape[-2:]).shape[0]
    outs = [torch.empty((n_mats, *shape), dtype=dtype, device=device)
            for shape, dtype in out_shapes]
    _encode_into(w, outs, encode)
    return [o.reshape(*lead, *o.shape[1:]) for o in outs]


def _symmetric_encoder(fmt: str):
    """(payload dtype, the per-output-channel encoder) of 'int8' | 'fp8'."""
    if fmt == "int8":
        qdtype, qmax = torch.int8, 127.0
    elif fmt == "fp8":
        qdtype, qmax = torch.float8_e4m3fn, float(torch.finfo(torch.float8_e4m3fn).max)
    else:
        raise ValueError(f"quantize_weights format {fmt!r} (int8|fp8)")

    def encode(xf):
        s = QK.scales_from_amax(xf.abs().amax(dim=0), qmax)
        v = xf / s[None, :]
        q = torch.round(v).clamp(-127, 127).to(qdtype) if fmt == "int8" else v.to(qdtype)
        return q, s

    return qdtype, encode


def quantize_serving_weight(w: torch.Tensor, fmt: str = "int8", device=None) -> ServingQuant:
    """Per-output-channel symmetric compression of a ``[..., in, out]``
    kernel (``fmt``: 'int8' | 'fp8'); only the contraction dim (axis -2)
    folds into each scale.  The result lives on ``device`` (default: w's)."""
    qdtype, encode = _symmetric_encoder(fmt)
    k, n = w.shape[-2:]
    q, s = _per_matrix(w, device or w.device, [((k, n), qdtype), ((n,), torch.float32)], encode)
    return ServingQuant(q=q, s=s)


_FP6_MAX = 7.5  # e2m3: (1 + 7/8) * 2^2


def _fp6_encode(x: torch.Tensor) -> torch.Tensor:
    """|x| <= 7.5 (pre-scaled) -> 6-bit e2m3 codes (uint8, low 6 bits).  A
    negative denormal counts as zero, as under XLA, which flushes them: its
    code is +0, not -0."""
    sign = (x <= -torch.finfo(torch.float32).tiny).to(torch.uint8)
    a = x.abs().clamp(0.0, _FP6_MAX)
    # normal range needs e_real in [0, 2]; below 1.0 is subnormal (e = 0)
    e_real = torch.floor(torch.log2(a.clamp_min(1e-12))).clamp(0.0, 2.0)
    sub = a < 1.0
    m = torch.where(sub, torch.round(a * 8.0),
                    torch.round((a / torch.exp2(e_real) - 1.0) * 8.0))
    e = torch.where(sub, 0.0, e_real + 1.0)
    # mantissa carry: m == 8 rolls into the next exponent (this also absorbs
    # a log2 one ulp off at a power of two)
    carry = m >= 8.0
    m = torch.where(carry, 0.0, m)
    e = torch.where(carry, e + 1.0, e)
    over = e > 3.0
    e = torch.where(over, 3.0, e)
    m = torch.where(over, 7.0, m)
    return (sign << 5) | (e.to(torch.uint8) << 3) | m.to(torch.uint8)


def _fp6_pack(codes: torch.Tensor, row_shards: int = 1) -> torch.Tensor:
    """[..., in, out] 6-bit codes -> [..., 3, in/4, out] byte planes
    (in % 4 == 0), quarter-strided (see :class:`ServingQuantFP6`);
    ``row_shards`` > 1 packs each contiguous K-chunk on its own and lays
    the chunk packs after one another along the packed dim."""
    if row_shards > 1:
        *lead, n, out = codes.shape
        chunked = _fp6_pack(codes.reshape(*lead, row_shards, n // row_shards, out))
        # [..., R, 3, n/(4R), out] -> [..., 3, R, n/(4R), out] -> [..., 3, n/4, out]
        return chunked.movedim(-4, -3).reshape(*lead, 3, n // 4, out)
    *lead, n, out = codes.shape
    c = codes.reshape(*lead, 4, n // 4, out)
    c0, c1, c2, c3 = c[..., 0, :, :], c[..., 1, :, :], c[..., 2, :, :], c[..., 3, :, :]
    b0 = (c0 << 2) | (c1 >> 4)
    b1 = ((c1 & 0xF) << 4) | (c2 >> 2)
    b2 = ((c2 & 0x3) << 6) | c3
    return torch.stack([b0, b1, b2], dim=-3)


def _fp6_unpack(packed: torch.Tensor, in_dim: int, row_shards: int = 1) -> torch.Tensor:
    if row_shards > 1:
        *lead, _, k4, out = packed.shape
        chunked = packed.reshape(*lead, 3, row_shards, k4 // row_shards, out).movedim(-3, -4)
        codes = fp6_unpack(chunked, in_dim // row_shards)  # [..., R, in/R, out]
        return codes.reshape(*lead, in_dim, out)
    return fp6_unpack(packed, in_dim)


def quantize_serving_weight_fp6(w: torch.Tensor, row_shards: int = 1,
                                device=None) -> ServingQuantFP6:
    """Per-output-channel FP6 compression of a ``[..., in, out]`` kernel
    (in % (4 * row_shards) == 0), on ``device`` (default: w's);
    ``row_shards`` packs per K-chunk (see :class:`ServingQuantFP6`)."""
    k, n = w.shape[-2:]
    if k % (4 * row_shards):
        raise ValueError(f"fp6 packing needs in-dim % {4 * row_shards} == 0 "
                         f"(row_shards={row_shards}), got {tuple(w.shape)}")

    def encode(xf):
        return _fp6_matrix(xf, row_shards)

    packed, s = _per_matrix(w, device or w.device,
                            [((3, k // 4, n), torch.uint8), ((n,), torch.float32)], encode)
    return ServingQuantFP6(packed, s, k, row_shards)


def _fp6_matrix(xf, row_shards: int = 1):
    s = QK.scales_from_amax(xf.abs().amax(dim=0), _FP6_MAX)
    return _fp6_pack(_fp6_encode(xf / s[None, :]), row_shards), s


def requantize_serving_weight_(dst, w: torch.Tensor) -> None:
    """Encode ``w`` [..., in, out] into the payload tensors of ``dst`` (a
    :class:`ServingQuant` or :class:`ServingQuantFP6` of ``w``'s shape), in
    place, one matrix at a time, with the encoder that built ``dst``: the
    bytes equal those of a fresh ``quantize_serving_weight`` (or ``_fp6``)
    of ``w``, and every payload tensor keeps its address, so a captured
    CUDA graph that reads them reads the new weights."""
    if isinstance(dst, ServingQuant):
        fmt = {torch.int8: "int8", torch.float8_e4m3fn: "fp8"}[dst.q.dtype]
        outs, encode = (dst.q, dst.s), _symmetric_encoder(fmt)[1]
    elif isinstance(dst, ServingQuantFP6):
        outs = (dst.packed, dst.s)

        def encode(xf):
            return _fp6_matrix(xf, dst.row_shards)
    else:
        raise TypeError(f"not a quantized serving weight: {type(dst).__name__}")
    lead, (k, n) = w.shape[:-2], w.shape[-2:]
    if tuple(dst.s.shape) != (*lead, n) or (isinstance(dst, ServingQuantFP6) and dst.in_dim != k):
        raise ValueError(f"weight {tuple(w.shape)} does not fit the payload "
                         f"(scales {tuple(dst.s.shape)})")
    _encode_into(w, [o.view(-1, *o.shape[len(lead):]) for o in outs], encode)


_SERVING_QUANT_PATHS = (
    "attn/wq", "attn/wk", "attn/wv", "attn/wo",
    "mlp/w_up", "mlp/w_gate", "mlp/w_down",
    "lm_head/kernel",
)
# row-parallel under TP serving: in-features shard on the model axis
_SERVING_ROW_PATHS = ("attn/wo", "mlp/w_down")


def quantize_serving_params(params, fmt: str = "int8", row_parallel_shards: int = 1,
                            device=None):
    """Compress the big matmul kernels of a parameter tree (the nested dict
    of ``models.transformer``) for serving (``fmt``: 'int8' | 'fp8' |
    'fp6'); embeddings and norms keep their type.  Paths are JAX's
    ``path_str`` spelling (``"layers/attn/wq"``).  Every leaf lands on
    ``device`` (default: where it is); quantized leaves are encoded there one
    layer slice at a time.  Returns the mixed tree ``serving_mm`` consumes.
    ``row_parallel_shards``: the ``model`` axis size; FP6 row-parallel
    kernels (``wo``, ``w_down``) are packed per K-chunk for it (int8 / fp8
    layouts ignore it), as JAX's."""

    def leaf(path, x):
        if isinstance(x, dict):
            return {k: leaf(f"{path}/{k}" if path else k, v) for k, v in x.items()}
        if isinstance(x, QUANT_TYPES):
            return map_quant(x, lambda t: t.to(device) if device is not None else t)
        if x.dim() >= 2 and any(path.endswith(t) for t in _SERVING_QUANT_PATHS):
            if fmt == "fp6":
                shards = (row_parallel_shards
                          if any(path.endswith(t) for t in _SERVING_ROW_PATHS) else 1)
                return quantize_serving_weight_fp6(x, shards, device=device)
            return quantize_serving_weight(x, fmt, device=device)
        return x.to(device) if device is not None else x

    return leaf("", params)


def tree_nbytes(tree) -> int:
    """Bytes of every tensor in a (mixed) parameter tree."""
    if isinstance(tree, dict):
        return sum(tree_nbytes(v) for v in tree.values())
    if isinstance(tree, ServingQuant):
        return tree_nbytes(tree.q) + tree_nbytes(tree.s)
    if isinstance(tree, ServingQuantFP6):
        return tree_nbytes(tree.packed) + tree_nbytes(tree.s)
    return tree.numel() * tree.element_size() if torch.is_tensor(tree) else 0


# ---------------------------------------------------------------------------
# the serving matmul
# ---------------------------------------------------------------------------
class ServingContext(NamedTuple):
    """Per-engine serving-matmul policy, threaded through ``serving_mm``
    (JAX :138).  ``tp`` (a ``parallel.tensor_parallel.TensorParallel``)
    is the ``model`` axis of a tensor-parallel engine, None on one device;
    ``comm_fmt`` / ``comm_tiles`` the transport of a quantized kernel's
    row-parallel partial sums (``comm/qcomm.py``; a plain kernel's reduce
    exactly, as JAX's GSPMD product does).  JAX's ``fused=False`` lever (the jnp body) is not
    ported: on the card that body is the plain version of K4 / K5."""

    tp: object = None
    comm_fmt: str = "none"
    comm_tiles: int = 1


def _mm_local(x: torch.Tensor, w, bias: Optional[torch.Tensor]) -> torch.Tensor:
    """Single-device dispatch of a quantized weight to K4 (int8 / fp8) or
    K5 (fp6), or a plain matrix product."""
    if isinstance(w, ServingQuant):
        return quant_matmul(x, w.q, w.s, bias)
    if isinstance(w, ServingQuantFP6):
        if w.row_shards != 1:
            raise ValueError("a per-K-chunk FP6 pack runs as the row shards of a "
                             "tensor-parallel engine, one chunk a rank")
        return quant_matmul_fp6(x, w.packed, w.s, w.in_dim, bias)
    y = x @ w
    return y if bias is None else y + bias


def _out_slice(w, lo: int, hi: int):
    """Output channels ``[lo, hi)`` of a kernel (the scales with them)."""
    if isinstance(w, ServingQuant):
        return ServingQuant(w.q[..., lo:hi], w.s[..., lo:hi])
    if isinstance(w, ServingQuantFP6):
        return ServingQuantFP6(w.packed[..., lo:hi], w.s[..., lo:hi], w.in_dim, w.row_shards)
    return w[..., lo:hi]


def _row_reduce(x: torch.Tensor, w, ctx: ServingContext) -> torch.Tensor:
    """A row-parallel matmul: this rank's partial sum, reduced over
    ``model``.  A quantized kernel runs JAX's ``_shard_mm`` 'row' region:
    ``comm_tiles`` tiles of output channels, each its own matmul and
    reduce through the ``comm_fmt`` transport.  A plain kernel reduces
    exactly in one all-reduce, as JAX's GSPMD product does (JAX's
    ``serving_mm`` applies the transport policy to quantized weights
    only)."""
    from ..comm.qcomm import q_psum_tiled

    tp = ctx.tp
    quantized = isinstance(w, QUANT_TYPES)
    fmt = ctx.comm_fmt if quantized else "none"
    n = (w.q if isinstance(w, ServingQuant) else
         w.packed if isinstance(w, ServingQuantFP6) else w).shape[-1]
    tiles = min(max(int(ctx.comm_tiles), 1), n) if quantized else 1
    tile_n = -(-n // tiles)
    outs = []
    for lo in range(0, n, tile_n):
        y = _mm_local(x, _out_slice(w, lo, min(lo + tile_n, n)) if tiles > 1 else w, None)
        outs.append(q_psum_tiled(y, tp.axis, fmt, tiles=1, world=tp.size,
                                 out_dtype=y.dtype, mesh=tp.grid))
    return torch.cat(outs, dim=-1) if len(outs) > 1 else outs[0]


def serving_mm(x: torch.Tensor, w, bias: Optional[torch.Tensor] = None,
               kind: str = "col", ctx: Optional[ServingContext] = None) -> torch.Tensor:
    """``x @ w (+ bias)`` where ``w`` may be a :class:`ServingQuant` or a
    :class:`ServingQuantFP6` (K4 / K5: the compressed bytes are the only
    weight traffic, scale and bias ride the fp32 epilogue) or a plain
    tensor (``torch.matmul``, a plain matrix product outside any kernel, as
    the JAX package leaves it to XLA).  Under a tensor-parallel ``ctx``,
    ``kind`` 'row' makes this rank's partial sum and reduces it over
    ``model`` before the bias (``_row_reduce``); 'col' reads the rank's
    output channels as they are."""
    if kind == "row" and ctx is not None and ctx.tp is not None:
        y = _row_reduce(x, w, ctx)
        return y if bias is None else y + bias
    return _mm_local(x, w, bias)


def shard_serving_weight(w, placement):
    """This rank's shard of a (quantized) kernel ``[..., in, out]`` by its
    ``parallel.tensor_parallel.Placement``: the last dim (output channels,
    with their scales) or dim -2 (input rows; the scales whole, an FP6 pack
    per K-chunk reduced to this rank's chunk)."""
    ndim = (w.q.dim() if isinstance(w, ServingQuant) else
            w.s.dim() + 1 if isinstance(w, ServingQuantFP6) else w.dim())
    lo, hi = placement.lo, placement.hi
    if placement.dim == ndim - 1:  # output channels
        out = _out_slice(w, lo, hi)
        return map_quant(out, torch.Tensor.contiguous) if isinstance(w, QUANT_TYPES) \
            else out.contiguous()
    if isinstance(w, ServingQuant):
        return ServingQuant(w.q[..., lo:hi, :].contiguous(), w.s)
    if isinstance(w, ServingQuantFP6):
        shards = w.in_dim // (hi - lo)
        if w.row_shards != shards:
            raise ValueError(f"an FP6 row kernel packed for {w.row_shards} shards cannot "
                             f"split over {shards}: quantize with row_parallel_shards="
                             f"{shards}")
        k4 = w.packed.shape[-2] // shards
        r = lo // (hi - lo)
        return ServingQuantFP6(w.packed[..., r * k4:(r + 1) * k4, :].contiguous(), w.s,
                               hi - lo, 1)
    return w.narrow(-2, lo, hi - lo).contiguous()

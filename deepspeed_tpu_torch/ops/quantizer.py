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
dequant-matmul kernels K4 / K5 (``ops/kernels/quant_matmul.py``).  One
device only: the tensor-parallel regions, the row-sharded fp6 pack
(``row_shards > 1``) and the quantized transport are ROADMAP queue 1 item 7.
"""
from __future__ import annotations

import warnings
from typing import NamedTuple, Optional, Tuple

import torch

from .kernels import quant_kernel as QK
from .kernels.quant_matmul import fp6_decode as _fp6_decode
from .kernels.quant_matmul import fp6_unpack, quant_matmul, quant_matmul_fp6

_TP_ITEM = "is not ported yet (ROADMAP queue 1 item 7: tensor parallelism)"


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
    ``row_shards > 1`` (the per-K-chunk pack of tensor-parallel row layers)
    is refused."""

    def __init__(self, packed: torch.Tensor, s: torch.Tensor, in_dim: int, row_shards: int = 1):
        _one_shard(row_shards)
        self.packed = packed
        self.s = s
        self.in_dim = int(in_dim)
        self.row_shards = 1


QUANT_TYPES = (ServingQuant, ServingQuantFP6)


def map_quant(w, fn):
    """``fn`` applied to each tensor of a quantized serving weight."""
    if isinstance(w, ServingQuant):
        return ServingQuant(fn(w.q), fn(w.s))
    return ServingQuantFP6(fn(w.packed), fn(w.s), w.in_dim, w.row_shards)


def _one_shard(row_shards: int) -> None:
    if int(row_shards) != 1:
        raise NotImplementedError(f"fp6 row_shards={row_shards} (the row-parallel pack) {_TP_ITEM}")


def _per_matrix(w: torch.Tensor, device, out_shapes, encode):
    """Apply ``encode`` (fp32 [in, out] -> tensors) to each [in, out] matrix
    of ``w`` [..., in, out], one at a time, each moved to ``device`` first,
    into outputs preallocated there: a stacked [L, in, out] leaf never has
    more than one layer's fp32 temporaries alive."""
    lead, (k, n) = w.shape[:-2], w.shape[-2:]
    mats = w.reshape(-1, k, n)
    outs = [torch.empty((mats.shape[0], *shape), dtype=dtype, device=device)
            for shape, dtype in out_shapes]
    for i in range(mats.shape[0]):
        for out, part in zip(outs, encode(mats[i].to(device=device, dtype=torch.float32))):
            out[i] = part
    return [o.reshape(*lead, *o.shape[1:]) for o in outs]


def quantize_serving_weight(w: torch.Tensor, fmt: str = "int8", device=None) -> ServingQuant:
    """Per-output-channel symmetric compression of a ``[..., in, out]``
    kernel (``fmt``: 'int8' | 'fp8'); only the contraction dim (axis -2)
    folds into each scale.  The result lives on ``device`` (default: w's)."""
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
    (in % 4 == 0), quarter-strided (see :class:`ServingQuantFP6`)."""
    _one_shard(row_shards)
    *lead, n, out = codes.shape
    c = codes.reshape(*lead, 4, n // 4, out)
    c0, c1, c2, c3 = c[..., 0, :, :], c[..., 1, :, :], c[..., 2, :, :], c[..., 3, :, :]
    b0 = (c0 << 2) | (c1 >> 4)
    b1 = ((c1 & 0xF) << 4) | (c2 >> 2)
    b2 = ((c2 & 0x3) << 6) | c3
    return torch.stack([b0, b1, b2], dim=-3)


def _fp6_unpack(packed: torch.Tensor, in_dim: int, row_shards: int = 1) -> torch.Tensor:
    _one_shard(row_shards)
    return fp6_unpack(packed, in_dim)


def quantize_serving_weight_fp6(w: torch.Tensor, row_shards: int = 1,
                                device=None) -> ServingQuantFP6:
    """Per-output-channel FP6 compression of a ``[..., in, out]`` kernel
    (in % 4 == 0), on ``device`` (default: w's)."""
    _one_shard(row_shards)
    k, n = w.shape[-2:]
    if k % 4:
        raise ValueError(f"fp6 packing needs in-dim % 4 == 0 (row_shards=1), got {tuple(w.shape)}")

    def encode(xf):
        s = QK.scales_from_amax(xf.abs().amax(dim=0), _FP6_MAX)
        return _fp6_pack(_fp6_encode(xf / s[None, :])), s

    packed, s = _per_matrix(w, device or w.device,
                            [((3, k // 4, n), torch.uint8), ((n,), torch.float32)], encode)
    return ServingQuantFP6(packed, s, k)


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
    layer slice at a time.  Returns the mixed tree ``serving_mm`` consumes."""
    _one_shard(row_parallel_shards)

    def leaf(path, x):
        if isinstance(x, dict):
            return {k: leaf(f"{path}/{k}" if path else k, v) for k, v in x.items()}
        if isinstance(x, QUANT_TYPES):
            return map_quant(x, lambda t: t.to(device) if device is not None else t)
        if x.dim() >= 2 and any(path.endswith(t) for t in _SERVING_QUANT_PATHS):
            if fmt == "fp6":
                return quantize_serving_weight_fp6(x, device=device)
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
    """Per-engine serving-matmul policy, threaded through ``serving_mm``.
    Empty on one device: the JAX context's fields (the tensor-parallel mesh
    and axis, the quantized transport) come with the slices that read them,
    and its ``fused=False`` lever (the jnp body) is not ported, since on the
    card that body is the plain version of K4 / K5."""


def _mm_local(x: torch.Tensor, w, bias: Optional[torch.Tensor]) -> torch.Tensor:
    """Single-device dispatch of a quantized weight to K4 (int8 / fp8) or
    K5 (fp6)."""
    if isinstance(w, ServingQuant):
        return quant_matmul(x, w.q, w.s, bias)
    return quant_matmul_fp6(x, w.packed, w.s, w.in_dim, bias)


def serving_mm(x: torch.Tensor, w, bias: Optional[torch.Tensor] = None,
               kind: str = "col", ctx: Optional[ServingContext] = None) -> torch.Tensor:
    """``x @ w (+ bias)`` where ``w`` may be a :class:`ServingQuant` or a
    :class:`ServingQuantFP6` (K4 / K5: the compressed bytes are the only
    weight traffic, scale and bias ride the fp32 epilogue) or a plain
    tensor (``torch.matmul``, a plain matrix product outside any kernel, as
    the JAX package leaves it to XLA).  ``kind`` names the JAX package's TP
    placement and has no effect on one device."""
    if isinstance(w, QUANT_TYPES):
        return _mm_local(x, w, bias)
    y = x @ w
    return y if bias is None else y + bias

"""Per-row quantization kernels — counterpart of ``deepspeed_tpu/ops/pallas/
quant_kernel.py`` (K6a ``quantize_int8``, K6b ``dequantize_int8``, K6c
``quantize_fp8``).

Groups are the rows of a ``[G, N]`` tensor, one fp32 scale each:
``s = max(amax, 1e-12) * (1 / qmax)`` with qmax 127 (int8, ``q =
clip(round(x / s), +-127)``, round half to even) or the fp8 type's largest
value (``q = fp8(x / s)``).  The JAX kernels write ``/ qmax``, which XLA
compiles (as JAX always runs them: jitted, or interpreted) to a multiply by
the fp32 reciprocal; the port computes that multiply, so its scales are the
JAX kernels' bit for bit.  ``dequantize`` is ``q * s`` per row in fp32,
rounded to the output type; it takes int8, e4m3fn and e5m2 payloads.

Each function dispatches on the tensor's device: a CPU tensor runs the plain
version, a CUDA tensor ``csrc/quantize.cu`` (any G and N; fp32 / bf16 / fp16
floats), whose bytes and scales equal the plain version's.  The JAX kernels'
gate (N % 128, G % 8, ``quant_kernel.py:47-49``) does not apply.
"""
from __future__ import annotations

import ctypes

import torch

from . import launch, ptr

_FLOAT = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_QTYPE = {torch.int8: 0, torch.float8_e4m3fn: 1, torch.float8_e5m2: 2}
FP8_TYPES = (torch.float8_e4m3fn, torch.float8_e5m2)


def _qmax(dtype) -> float:
    return 127.0 if dtype == torch.int8 else float(torch.finfo(dtype).max)


def reciprocal(c: float) -> float:
    """1 / c rounded to fp32 (exact as a Python float)."""
    return float(torch.ones((), dtype=torch.float32) / torch.full((), c, dtype=torch.float32))


def scales_from_amax(amax: torch.Tensor, qmax: float) -> torch.Tensor:
    """max(amax, 1e-12) * fp32(1 / qmax): the compiled JAX scale."""
    return amax.clamp_min(1e-12) * reciprocal(qmax)


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------
def quantize_rows_plain(x2d: torch.Tensor, dtype=torch.int8):
    """[G, N] -> (q [G, N] of ``dtype``, fp32 scales [G])."""
    xf = x2d.float()
    s = scales_from_amax(xf.abs().amax(dim=-1), _qmax(dtype))
    v = xf / s[:, None]
    q = torch.round(v).clamp(-127, 127).to(torch.int8) if dtype == torch.int8 else v.to(dtype)
    return q, s


def dequantize_rows_plain(q2d: torch.Tensor, s: torch.Tensor, out_dtype=torch.bfloat16):
    return (q2d.float() * s[:, None]).to(out_dtype)


# ---------------------------------------------------------------------------
# dispatch (the JAX module's entry names)
# ---------------------------------------------------------------------------
def quantize_int8(x2d: torch.Tensor):
    return _quantize(x2d, torch.int8)


def quantize_fp8(x2d: torch.Tensor, dtype=torch.float8_e4m3fn):
    if dtype not in FP8_TYPES:
        raise TypeError(f"quantize_fp8: dtype must be one of {FP8_TYPES}, got {dtype}")
    return _quantize(x2d, dtype)


def dequantize(q2d: torch.Tensor, s: torch.Tensor, out_dtype=torch.bfloat16):
    if q2d.device.type == "cpu":
        return dequantize_rows_plain(q2d, s, out_dtype)
    if q2d.device.type != "cuda":
        raise ValueError(f"dequantize: unsupported device {q2d.device}")
    return dequantize_kernel(q2d, s, out_dtype)


def _quantize(x2d, dtype):
    if x2d.device.type == "cpu":
        return quantize_rows_plain(x2d, dtype)
    if x2d.device.type != "cuda":
        raise ValueError(f"quantize: unsupported device {x2d.device}")
    return quantize_kernel(x2d, dtype)


# ---------------------------------------------------------------------------
# the CUDA kernel wrappers
# ---------------------------------------------------------------------------
def _rows(name, t, types):
    if t.dim() != 2 or t.shape[0] == 0 or t.shape[1] == 0:
        raise ValueError(f"{name}: expected a non-empty [G, N] tensor, got {tuple(t.shape)}")
    if t.dtype not in types:
        raise TypeError(f"{name}: dtype {t.dtype} not in {tuple(types)}")
    return t.contiguous()


def quantize_kernel(x2d: torch.Tensor, dtype=torch.int8):
    name = "quantize_int8" if dtype == torch.int8 else "quantize_fp8"
    x = _rows(name, x2d, _FLOAT)
    if dtype not in _QTYPE:
        raise TypeError(f"{name}: output dtype {dtype} not in {tuple(_QTYPE)}")
    g, n = x.shape
    q = torch.empty((g, n), dtype=dtype, device=x.device)
    s = torch.empty((g,), dtype=torch.float32, device=x.device)
    launch(name, ptr(x), ptr(q), ptr(s), g, n, _FLOAT[x.dtype], _QTYPE[dtype],
           ctypes.c_float(reciprocal(_qmax(dtype))))
    return q, s


def dequantize_kernel(q2d: torch.Tensor, s: torch.Tensor, out_dtype=torch.bfloat16):
    q = _rows("dequantize", q2d, _QTYPE)
    if out_dtype not in _FLOAT:
        raise TypeError(f"dequantize: output dtype {out_dtype} not in {tuple(_FLOAT)}")
    if s.shape != (q.shape[0],) or s.device != q.device:
        raise ValueError(f"dequantize: scales {tuple(s.shape)} on {s.device} do not match "
                         f"q {tuple(q.shape)} on {q.device}")
    s32 = s.float().contiguous()
    out = torch.empty(q.shape, dtype=out_dtype, device=q.device)
    launch("dequantize", ptr(q), ptr(s32), ptr(out), q.shape[0], q.shape[1],
           _QTYPE[q.dtype], _FLOAT[out_dtype])
    return out

"""Fused dequant-matmul — counterpart of ``deepspeed_tpu/ops/pallas/
quant_matmul.py`` (K4 ``quant_matmul``, K5 ``quant_matmul_fp6``).

``quant_matmul(x, q, s, bias)`` is ``(x @ q) * s (+ bias)`` for an int8 or
float8_e4m3fn weight ``q`` [K, N] with one fp32 scale per output column;
``quant_matmul_fp6(x, planes, s, in_dim, bias)`` the same for FP6 e2m3 codes
in three quarter-strided uint8 planes ``[3, K/4, N]`` (packed row r holds
the codes of weight rows r, K/4 + r, K/2 + r, 3K/4 + r).  Both return
``[..., N]`` in x's type with the sum in fp32, and scale and bias applied in
fp32 before the one rounding: the Pallas kernels' epilogue, not the JAX jnp
body (which rounds before it adds the bias).

Each dispatches on x's device: a CPU tensor runs the plain version, a CUDA
tensor ``csrc/quant_matmul.cu``, which takes bf16 activations of any shape
(ragged M, N and K are masked; fp6 needs K % 4 == 0, as the pack does) and
raises on anything else.  There is no shape gate: the JAX kernels' K % 128
and N % 128 conditions (``quant_matmul.py:80-85``) do not apply.
"""
from __future__ import annotations

from typing import Optional

import torch

from . import launch, ptr

_FMT = {torch.int8: 0, torch.float8_e4m3fn: 1}
_FP6 = 2
_BN, _BK, _BK4 = 128, 64, 16  # the kernel's weight columns a CTA and K-step (csrc)
# The kernel's token tiles (the wgmma's N), each with the CTAs an SM holds at
# once there (their shared memory and registers): the cases of dispatch_bt
# and Plan::MIN_CTAS in csrc/quant_matmul.cu, which a CPU test holds to this.
TOKEN_TILES = {16: 2, 64: 2, 128: 1, 256: 1}
_SMS = {}  # device index -> SM count


# ---------------------------------------------------------------------------
# FP6 e2m3 codes (what K5 decodes); ops/quantizer.py packs them
# ---------------------------------------------------------------------------
def fp6_unpack(packed: torch.Tensor, in_dim: int) -> torch.Tensor:
    """[..., 3, in/4, out] byte planes -> [..., in, out] 6-bit codes (uint8);
    the quarters concatenate back in row order."""
    b0, b1, b2 = packed[..., 0, :, :], packed[..., 1, :, :], packed[..., 2, :, :]
    c0 = b0 >> 2
    c1 = ((b0 & 0x3) << 4) | (b1 >> 4)
    c2 = ((b1 & 0xF) << 2) | (b2 >> 6)
    c3 = b2 & 0x3F
    codes = torch.cat([c0, c1, c2, c3], dim=-2)
    if codes.shape[-2] != in_dim:
        raise ValueError(f"fp6 planes {tuple(packed.shape)} do not hold in_dim {in_dim}")
    return codes


def fp6_decode(code: torch.Tensor, dtype) -> torch.Tensor:
    """6-bit e2m3 codes -> values: m / 8 for e == 0, else (1 + m / 8) 2^(e-1)."""
    c = code.to(torch.int32)
    e = ((c >> 3) & 3).float()
    m = (c & 7).float()
    mag = torch.where(e == 0, m / 8.0, (1.0 + m / 8.0) * torch.exp2(e - 1.0))
    return torch.where(((c >> 5) & 1) == 1, -mag, mag).to(dtype)


# ---------------------------------------------------------------------------
# plain versions (the CPU path, and the card's reference in chip_smoke.py)
# ---------------------------------------------------------------------------
def _epilogue(acc: torch.Tensor, s, bias, dtype) -> torch.Tensor:
    y = acc * s.float()
    if bias is not None:
        y = y + bias.float()
    return y.to(dtype)


def quant_matmul_plain(x, q, s, bias=None):
    """``(x @ q) * s (+ bias)`` in fp32, rounded once to x's type.  The
    weight widens to fp32 first (PyTorch has no CPU matmul in fp8)."""
    return _epilogue(x.float() @ q.float(), s, bias, x.dtype)


def quant_matmul_fp6_plain(x, planes, s, in_dim: int, bias=None):
    w = fp6_decode(fp6_unpack(planes, in_dim), torch.float32)
    return _epilogue(x.float() @ w, s, bias, x.dtype)


# ---------------------------------------------------------------------------
# dispatch
# ---------------------------------------------------------------------------
def quant_matmul(x, q, s, bias=None):
    if x.device.type == "cpu":
        return quant_matmul_plain(x, q, s, bias)
    if x.device.type != "cuda":
        raise ValueError(f"quant_matmul: unsupported device {x.device}")
    return quant_matmul_kernel(x, q, s, bias)


def quant_matmul_fp6(x, planes, s, in_dim: int, bias=None):
    if x.device.type == "cpu":
        return quant_matmul_fp6_plain(x, planes, s, in_dim, bias)
    if x.device.type != "cuda":
        raise ValueError(f"quant_matmul_fp6: unsupported device {x.device}")
    return quant_matmul_fp6_kernel(x, planes, s, in_dim, bias)


# ---------------------------------------------------------------------------
# the CUDA kernel wrappers: checks, allocation, split-K choice, launch
# ---------------------------------------------------------------------------
def quant_matmul_kernel(x, q, s, bias=None):
    if q.dim() != 2 or q.dtype not in _FMT:
        raise TypeError(f"quant_matmul: weight must be 2-D int8 or float8_e4m3fn, got "
                        f"{q.dtype} {tuple(q.shape)}")
    name = "quant_matmul_int8" if q.dtype == torch.int8 else "quant_matmul_fp8"
    k, n = q.shape
    return _run(name, _FMT[q.dtype], x, q, s, bias, k, n, -(-k // _BK))


def quant_matmul_fp6_kernel(x, planes, s, in_dim: int, bias=None):
    if planes.dim() != 3 or planes.shape[0] != 3 or planes.dtype != torch.uint8:
        raise TypeError(f"quant_matmul_fp6: planes must be uint8 [3, K/4, N], got "
                        f"{planes.dtype} {tuple(planes.shape)}")
    k4, n = planes.shape[1], planes.shape[2]
    if in_dim != 4 * k4:
        raise ValueError(f"quant_matmul_fp6: in_dim {in_dim} != 4 x {k4} plane rows")
    return _run("quant_matmul_fp6", _FP6, x, planes, s, bias, in_dim, n, -(-k4 // _BK4))


def _sm_count(device: torch.device) -> int:
    idx = device.index if device.index is not None else torch.cuda.current_device()
    if idx not in _SMS:
        _SMS[idx] = torch.cuda.get_device_properties(idx).multi_processor_count
    return _SMS[idx]


def token_tile(m: int) -> int:
    """The kernel's token tile (the wgmma's N): the smallest of
    ``TOKEN_TILES`` that holds the m rows, 256 above that."""
    return next((t for t in TOKEN_TILES if t >= m), max(TOKEN_TILES))


def split_k(m: int, n: int, steps: int, sms: int):
    """(splits, K-steps per split).  K is split into as many parts as keep
    the whole grid resident at once, at the CTAs an SM that ``TOKEN_TILES``
    gives the token tile (two at 16 and 64, one at 128 and 256).  At
    decode (bytes-bound) every CTA then streams its weight bytes from the
    start, with no second wave; at prefill (operations-bound) a narrow N
    (wq / wo, wk / wv, w_down) keeps its 256-token tiles, the fewest bytes a
    product, and fills the SMs through K.  At least 4 K-steps (256 rows of
    K) a split, and no empty split."""
    bt = token_tile(m)
    tiles = -(-m // bt) * -(-n // _BN)
    slots = TOKEN_TILES[bt] * sms
    splits = max(1, min(slots // tiles, steps // 4, 65535))
    per = -(-steps // splits)
    return -(-steps // per), per


def _run(name, fmt, x, w, s, bias, k, n, steps):
    if x.dtype != torch.bfloat16:
        raise TypeError(f"{name}: the CUDA kernel takes bf16 activations, got {x.dtype}")
    if x.shape[-1] != k:
        raise ValueError(f"{name}: x {tuple(x.shape)} does not contract with K = {k}")
    if not w.is_contiguous():
        raise ValueError(f"{name}: the weight must be contiguous")
    dev = x.device
    if s.shape != (n,):
        raise ValueError(f"{name}: scales {tuple(s.shape)} != ({n},)")
    if bias is not None and bias.shape != (n,):
        raise ValueError(f"{name}: bias {tuple(bias.shape)} != ({n},)")
    for t in (w, s, bias):
        if t is not None and t.device != dev:
            raise ValueError(f"{name}: operands on {t.device} and {dev}")
    lead = x.shape[:-1]
    x2 = x.reshape(-1, k).contiguous()
    m = x2.shape[0]
    y = torch.empty((m, n), dtype=torch.bfloat16, device=dev)
    if m == 0:
        return y.reshape(*lead, n)
    s32 = s.float().contiguous()
    b32 = bias.float().contiguous() if bias is not None else None
    splits, per = split_k(m, n, steps, _sm_count(dev))
    ws = torch.empty((splits, m, n), dtype=torch.float32, device=dev) if splits > 1 else None
    xvec = k % 8 == 0 and (fmt != _FP6 or (k // 4) % 8 == 0) and x2.data_ptr() % 16 == 0
    wvec = n % 16 == 0 and w.data_ptr() % 16 == 0
    launch(name, ptr(x2), ptr(w), ptr(s32), ptr(b32), ptr(y), ptr(ws), m, n, k, fmt,
           token_tile(m), splits, per, int(xvec), int(wvec))
    return y.reshape(*lead, n)

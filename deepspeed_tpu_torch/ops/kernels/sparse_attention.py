"""Block-sparse flash attention, forward and backward — counterpart of the
block-sparse half of ``deepspeed_tpu/ops/pallas/flash_kernel.py``
(``_sparse_tables`` :482, ``_fwd_sparse`` :587, ``_bwd_sparse`` :638, the
``_flash_sparse`` custom VJP :709, ``sparse_supports`` :733 and
``pallas_block_sparse_attention`` :759).

A layout is a ``[n, n]`` numpy bool mask over blocks of ``block`` rows and
keys (``ops/sparse_attention.py``).  ``sparse_tables`` lists each query
block's active key blocks under the causal trim (and, transposed, each key
block's active query blocks); masked blocks are never read or computed.
The kernels (``csrc/sparse_flash.cu``: forward with lse, dq, dk/dv) are the
dense flash kernels' tensor-core bodies (``csrc/flash_tc.cuh``) walking
those tables; inside an active block they walk their own tiles, and the
causal mask bites only in the diagonal block.  The tables live on the
device in a ``SparsePlan``, built once per (layout, block, causal, device)
and cached, so a training step copies nothing to the device for them and
never waits on the host.

``SparseFlashFn`` is the same on both devices; only its two inner calls
dispatch on the tensor's device: the plain versions (fp32 masked bodies
that return the lse as ``flash_attention_fwd_plain`` does) on the CPU, the
kernels on CUDA.  The kernels take causal attention with GQA (any query
group: a CTA per query head), packed segments (query and key ids apart, as
JAX's ``kv_segment_ids``) and the soft cap, bf16, head_dim 64, 128 or 256 --
the head dims JAX's gate admits.  Head_dim 80 or 96 never reaches them
(``sparse_supports`` sends it to the masked dense body), and a direct call
raises ``NotImplementedError``.

Shapes: q / o / dO ``[b, s, hq, d]``, k / v ``[b, s, hkv, d]``, segment ids
``[b, s]`` int32, lse ``[b, hq, s]`` fp32 in capped scaled-score units,
delta ``[b, s, hq]`` fp32.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np
import torch

from . import add_flops, check_cuda, check_heads, launch, once_differentiable, ptr, scalars
from .flash_attention import (attention_pairs, flash_attention_bwd_plain,
                              flash_attention_fwd_plain)


def sparse_tables(layout: np.ndarray, causal: bool):
    """layout [n, n] bool -> (tbl, counts, tblT, countsT), tuples padded by
    repeating the last entry (JAX ``_sparse_tables``); None when some query
    block has no active key block under the causal trim."""
    n = layout.shape[0]
    rows = []
    for i in range(n):
        ks = [j for j in range(n) if layout[i, j] and (not causal or j <= i)]
        if not ks:
            return None
        rows.append(ks)
    max_a = max(len(r) for r in rows)
    tbl = tuple(tuple(r + [r[-1]] * (max_a - len(r))) for r in rows)
    counts = tuple(len(r) for r in rows)
    cols = [[i for i in range(n) if layout[i, j] and (not causal or j <= i)] for j in range(n)]
    max_t = max(1, max(len(c) for c in cols))
    tblT = tuple(tuple(c + [c[-1] if c else 0] * (max_t - len(c))) for c in cols)
    countsT = tuple(len(c) for c in cols)
    return tbl, counts, tblT, countsT


def sparse_supports(q, k, v, layout_block: int, causal: bool, q_offset,
                    segment_ids) -> bool:
    """Whether the compute-skipping kernels take this call (JAX's gate): a
    causal self-attention whose layout block is a viable kernel block,
    128 to 1024 and dividing s; finer layouts run the masked dense body."""
    if not causal:
        return False
    if not isinstance(q_offset, int) or q_offset != 0:
        return False
    b, sq, hq, d = q.shape
    _, sk, hk, _ = k.shape
    if sq != sk:
        return False
    if layout_block < 128 or layout_block > 1024 or sq % layout_block:
        return False
    if d not in (64, 128, 256):
        return False
    if hq % hk != 0:
        return False
    if segment_ids is not None and tuple(segment_ids.shape) != (b, sq):
        return False
    return True


def element_mask(layout: np.ndarray, block: int) -> torch.Tensor:
    """The block layout expanded to an [s, s] bool mask over positions."""
    return torch.from_numpy(np.repeat(np.repeat(layout, block, 0), block, 1))


@dataclass(frozen=True)
class SparsePlan:
    """The device form of a layout's tables: ``tbl`` [n, max_a] / ``cnt``
    [n] (active key blocks of each query block), ``tblT`` [n, max_t] /
    ``cntT`` [n] (active query blocks of each key block), int32; ``perm`` /
    ``permT`` order the query / key blocks by work, heaviest first, which is
    the order the kernels' CTAs start in (a global column of a ``fixed``
    layout is read by every later row: its dk/dv CTAs go first)."""

    layout: np.ndarray
    block: int
    tbl: torch.Tensor
    cnt: torch.Tensor
    perm: torch.Tensor
    tblT: torch.Tensor
    cntT: torch.Tensor
    permT: torch.Tensor

    @property
    def n(self) -> int:
        return self.layout.shape[0]


_PLANS: Dict[tuple, Optional[SparsePlan]] = {}


def sparse_plan(layout: np.ndarray, block: int, causal: bool,
                device) -> Optional[SparsePlan]:
    """The cached ``SparsePlan`` of a layout on ``device``; None where
    ``sparse_tables`` is None.  The first call for a key builds the tables
    and copies them to the device; later calls only look them up."""
    device = torch.device(device)
    key = (layout.tobytes(), layout.shape[0], block, causal, device)
    if key not in _PLANS:
        tables = sparse_tables(layout, causal)
        plan = None
        if tables is not None:
            tbl, counts, tblT, countsT = tables

            def i32(x):
                return torch.tensor(np.asarray(x, np.int32), device=device)

            plan = SparsePlan(
                layout=np.array(layout, bool), block=block,
                tbl=i32(tbl), cnt=i32(counts),
                perm=i32(np.argsort(-np.asarray(counts), kind="stable")),
                tblT=i32(tblT), cntT=i32(countsT),
                permT=i32(np.argsort(-np.asarray(countsT), kind="stable")))
        _PLANS[key] = plan
    return _PLANS[key]


# ---------------------------------------------------------------------------
# plain versions (the tests, and the card's reference in chip_smoke.py)
# ---------------------------------------------------------------------------
def sparse_attention_fwd_plain(q, k, v, qseg, kseg, layout, block, scale, cap):
    """(o [b, s, hq, d] in q's type, lse [b, hq, s] fp32): the flash
    forward's function restricted to the layout, in fp32."""
    return flash_attention_fwd_plain(q, k, v, qseg, scale, cap, kv_seg=kseg,
                                     mask=element_mask(layout, block))


def sparse_attention_bwd_plain(q, k, v, qseg, kseg, o, lse, do, layout, block, scale, cap):
    """(dq, dk, dv): the flash backward's FA2 formulas restricted to the
    layout, in fp32."""
    return flash_attention_bwd_plain(q, k, v, qseg, o, lse, do, scale, cap, kv_seg=kseg,
                                     mask=element_mask(layout, block))


# ---------------------------------------------------------------------------
# CUDA kernel wrappers
# ---------------------------------------------------------------------------
def _check(name, q, k, v, qseg, kseg, plan: SparsePlan):
    b, s, hq, d = q.shape
    if k.shape != (b, s, k.shape[2], d) or v.shape != k.shape:
        raise ValueError(f"{name}: q {tuple(q.shape)} k {tuple(k.shape)} v {tuple(v.shape)}")
    hkv = k.shape[2]
    check_heads(name, hq, hkv, d)
    if s != plan.n * plan.block:
        raise ValueError(f"{name}: s {s} != {plan.n} blocks of {plan.block}")
    check_cuda(name, torch.bfloat16, q, k, v)
    check_cuda(name, torch.int32, plan.tbl, plan.cnt, plan.perm, plan.tblT, plan.cntT,
               plan.permT)
    if plan.tbl.device != q.device:
        raise ValueError(f"{name}: the plan's tables are on {plan.tbl.device}, q on {q.device}")
    if qseg is None:
        return None, None
    for seg in (qseg, kseg):
        if seg.shape != (b, s):
            raise ValueError(f"{name}: segment ids {tuple(seg.shape)} != {(b, s)}")
        check_cuda(name, torch.int32, seg)
        if seg.device != q.device:
            raise ValueError(f"{name}: segment ids on another device than q")
    return ptr(qseg), ptr(kseg)


def _active_pairs(q, qseg, kseg, plan: SparsePlan) -> int:
    """(query, key) pairs one query head attends over under the plan's
    causal layout: B^2 a block below the diagonal, B (B + 1) / 2 on it, a
    batch row; with segment ids the allowed pairs counted on the device."""
    if qseg is None:
        below = int(np.tril(plan.layout, -1).sum())
        diag = int(np.diag(plan.layout).sum())
        bs = plan.block
        return q.shape[0] * (below * bs * bs + diag * bs * (bs + 1) // 2)
    return attention_pairs(q, qseg, kseg, element_mask(plan.layout, plan.block))


def sparse_attention_kernel(q, k, v, qseg, kseg, plan: SparsePlan, scale, cap):
    """K7f: (o, lse)."""
    qs, ks = _check("sparse_attention", q, k, v, qseg, kseg, plan)
    b, s, hq, d = q.shape
    out = torch.empty_like(q)
    lse = torch.empty((b, hq, s), dtype=torch.float32, device=q.device)
    sc, cp = scalars(scale, cap)
    launch("sparse_fwd", ptr(q), ptr(k), ptr(v), qs, ks, ptr(out), ptr(lse), ptr(plan.tbl),
           ptr(plan.cnt), ptr(plan.perm), b, s, hq, k.shape[2], d, plan.block,
           plan.tbl.shape[1], sc, cp)
    add_flops("sparse_fwd", lambda: 4 * d * hq * _active_pairs(q, qseg, kseg, plan))
    return out, lse


def sparse_attention_bwd_kernel(q, k, v, qseg, kseg, o, lse, do, plan: SparsePlan, scale,
                                cap):
    """K7b: (dq, dk, dv) in bf16.  delta = rowsum(dO * o) is one PyTorch
    reduction, as in JAX (``flash_kernel.py:644``)."""
    qs, ks = _check("sparse_attention_bwd", q, k, v, qseg, kseg, plan)
    check_cuda("sparse_attention_bwd", torch.bfloat16, o, do)
    b, s, hq, d = q.shape
    hkv = k.shape[2]
    if o.shape != q.shape or do.shape != q.shape or lse.shape != (b, hq, s):
        raise ValueError(f"sparse_attention_bwd: o {tuple(o.shape)} dO {tuple(do.shape)} "
                         f"lse {tuple(lse.shape)} for q {tuple(q.shape)}")
    check_cuda("sparse_attention_bwd", torch.float32, lse)
    delta = (o.float() * do.float()).sum(-1)  # [b, s, hq]
    dq = torch.empty_like(q)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    sc, cp = scalars(scale, cap)
    common = (ptr(q), ptr(k), ptr(v), qs, ks, ptr(do), ptr(lse), ptr(delta))
    launch("sparse_bwd_dq", *common, ptr(dq), ptr(plan.tbl), ptr(plan.cnt), ptr(plan.perm),
           b, s, hq, hkv, d, plan.block, plan.tbl.shape[1], sc, cp)
    launch("sparse_bwd_dkv", *common, ptr(dk), ptr(dv), ptr(plan.tblT), ptr(plan.cntT),
           ptr(plan.permT), b, s, hq, hkv, d, plan.block, plan.tblT.shape[1], sc, cp)
    add_flops("sparse_bwd", lambda: 10 * d * hq * _active_pairs(q, qseg, kseg, plan))
    return dq, dk, dv


# ---------------------------------------------------------------------------
# the autograd Function (the ``_flash_sparse`` custom VJP)
# ---------------------------------------------------------------------------
def _fwd(q, k, v, qseg, kseg, plan, scale, cap):
    if q.device.type == "cpu":
        return sparse_attention_fwd_plain(q, k, v, qseg, kseg, plan.layout, plan.block, scale,
                                          cap)
    return sparse_attention_kernel(q, k, v, qseg, kseg, plan, scale, cap)


def _bwd(q, k, v, qseg, kseg, o, lse, do, plan, scale, cap):
    if q.device.type == "cpu":
        return sparse_attention_bwd_plain(q, k, v, qseg, kseg, o, lse, do, plan.layout,
                                          plan.block, scale, cap)
    return sparse_attention_bwd_kernel(q, k, v, qseg, kseg, o, lse, do.contiguous(), plan,
                                       scale, cap)


class SparseFlashFn(torch.autograd.Function):
    """Block-sparse causal flash attention whose backward rebuilds the
    probabilities from the saved lse (``flash_kernel.py:709-730``)."""

    @staticmethod
    def forward(ctx, q, k, v, qseg, kseg, scale, cap, plan):
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        o, lse = _fwd(q, k, v, qseg, kseg, plan, scale, cap)
        ctx.save_for_backward(q, k, v, qseg, kseg, o, lse)
        ctx.scale, ctx.cap, ctx.plan = scale, cap, plan
        return o

    @staticmethod
    @once_differentiable
    def backward(ctx, do):
        q, k, v, qseg, kseg, o, lse = ctx.saved_tensors
        dq, dk, dv = _bwd(q, k, v, qseg, kseg, o, lse, do, ctx.plan, ctx.scale, ctx.cap)
        return dq, dk, dv, None, None, None, None, None


def block_sparse_flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    layout: np.ndarray,
    layout_block: int,
    causal: bool = True,
    scale: Optional[float] = None,
    segment_ids: Optional[torch.Tensor] = None,
    kv_segment_ids: Optional[torch.Tensor] = None,
    logits_soft_cap: Optional[float] = None,
) -> Optional[torch.Tensor]:
    """Compute-skipping block-sparse attention (JAX
    ``pallas_block_sparse_attention``): q [b, s, hq, d], k / v
    [b, s, hkv, d] -> [b, s, hq, d].  Returns None when the layout has an
    empty causal row (the caller runs the masked dense body)."""
    if not causal:
        raise ValueError("block_sparse_flash_attention is causal-only; use the masked "
                         "dense body")
    plan = sparse_plan(layout, layout_block, causal, q.device)
    if plan is None:
        return None
    sc = float(scale) if scale is not None else float(q.shape[-1]) ** -0.5
    cap = float(logits_soft_cap) if logits_soft_cap is not None else None
    qseg = kseg = None
    if segment_ids is not None:
        kv = kv_segment_ids if kv_segment_ids is not None else segment_ids
        qseg = segment_ids.to(torch.int32).contiguous()
        kseg = kv.to(torch.int32).contiguous()
    return SparseFlashFn.apply(q, k, v, qseg, kseg, sc, cap, plan)

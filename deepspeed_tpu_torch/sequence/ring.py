"""Ring attention over the ``seq`` axis — counterpart of
``deepspeed_tpu/sequence/ring.py``.

Each rank keeps its ``s / P`` queries; the kv chunks (k and v stacked)
rotate around the axis, ``P - 1`` hops of the differentiable ``ppermute``
(its gradient the reverse rotation), while the rank accumulates an online softmax in fp32
(running max, denominator and output, ``[b, h, s/P]``).  A chunk from a
rank above this one lies wholly above the causal diagonal and is skipped
(JAX ``:79``); the rotation still runs, so every rank makes the same
collectives.  Each step's attention runs under ``torch.utils.checkpoint``
and is recomputed in the backward (JAX ``:84``); the rotations are not.
The body is JAX's jnp math, outside any Pallas kernel: plain PyTorch
products, as in JAX.

The fallbacks (JAX ``:107-125``: non-causal, segments, a soft cap, a
``q_offset``, no seq axis or one of size 1) run JAX's reference body.
Across ranks that body must see the whole sequence:
``gathered_attention`` all-gathers q, k and v over ``seq``, runs a body
over the whole sequence and keeps this rank's rows (the gathers' gradient
reduce-scatters: each rank's rows read every key).  JAX's GSPMD does the
same with a body it cannot partition, so the Ulysses heads the axis does
not divide and a seq axis under ``none`` take it too, each with its own
body (the flash kernels, or the block-sparse ones under a layout).
``segment_ids`` are the whole sequence's ``[b, s]``.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint

from ..ops.attention import dot_product_attention, repeat_kv
from ..parallel.topology import SEQ_AXIS

NEG_INF = -1e30


def gathered_attention(q, k, v, base=dot_product_attention, par=None, **kw):
    """``base`` over the whole sequence (q / k / v all-gathered over
    ``seq``), this rank's rows of its output; ``base`` itself without a
    context."""
    if par is None:
        return base(q, k, v, **kw)
    sl = q.shape[1]
    lo = par.seq_rank * sl
    qf, kf, vf = (par.all_gather(t, SEQ_AXIS, 1) for t in (q, k, v))
    return base(qf, kf, vf, **kw)[:, lo:lo + sl]


def _attend(qf, kc, vc, m, l, acc, diagonal: bool, scale: float, n_rep: int):
    """One kv chunk folded into the running (max, denominator, output)."""
    kcr = repeat_kv(kc, n_rep).float()
    vcr = repeat_kv(vc, n_rep).float()
    s = torch.einsum("bqhd,bkhd->bhqk", qf, kcr) * scale
    if diagonal:  # the rank's own chunk: causal within it
        sq, sk = s.shape[-2:]
        allowed = torch.ones(sq, sk, dtype=torch.bool, device=s.device).tril()
        s = torch.where(allowed, s, torch.full_like(s, NEG_INF))
    m_new = torch.maximum(m, s.amax(-1))
    alpha = torch.exp(m - m_new)
    p = torch.exp(s - m_new[..., None])
    l2 = l * alpha + p.sum(-1)
    acc2 = acc * alpha[..., None] + torch.einsum("bhqk,bkhd->bhqd", p, vcr)
    return m_new, l2, acc2


class _Holds(torch.autograd.Function):
    """``acc`` as it is, with ``kv`` among its inputs (a zero cotangent): a
    skipped chunk stays in the graph, so every rank runs the backward of
    every rotation, in the same order."""

    @staticmethod
    def forward(ctx, acc, kv):
        ctx.kv = (kv.shape, kv.dtype, kv.device)
        return acc.view_as(acc)

    @staticmethod
    def backward(ctx, g):
        shape, dtype, device = ctx.kv
        return g, torch.zeros(shape, dtype=dtype, device=device)


def _ring_local(q, k, v, par, scale: float):
    b, sq, h, d = q.shape
    n_rep = h // k.shape[2]
    n = par.seq
    my = par.seq_rank
    qf = q.float()
    m = torch.full((b, h, sq), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, h, sq), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, h, sq, d), dtype=torch.float32, device=q.device)
    perm = [(i, (i + 1) % n) for i in range(n)]
    # k and v rotate as one tensor: one chain of rotations, whose backward
    # runs in one order on every rank
    kv = torch.stack([k, v])
    for t in range(n):
        src = (my - t) % n  # the rank whose kv chunk this one holds now
        if src <= my:
            m, l, acc = checkpoint(_attend, qf, kv[0], kv[1], m, l, acc, src == my, scale,
                                   n_rep, use_reentrant=False)
        else:  # a chunk above the diagonal is wholly masked: skipped
            acc = _Holds.apply(acc, kv)
        if t < n - 1:  # n - 1 rotations
            kv = par.ppermute(kv, SEQ_AXIS, perm)
    out = acc / l.clamp(min=1e-30)[..., None]
    return out.transpose(1, 2).to(q.dtype)  # [b, sq, h, d]


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool = True,
                   q_offset=0, segment_ids: Optional[torch.Tensor] = None,
                   kv_segment_ids: Optional[torch.Tensor] = None,
                   scale: Optional[float] = None, logits_soft_cap: Optional[float] = None,
                   par=None, **kw):
    """Drop-in attention body: q / k / v ``[b, s/P, h, d]``, this rank's
    positions of the ``seq`` axis of ``par``; the fallbacks as the module
    docstring says."""
    sp = par.seq if par is not None else 1
    unsupported = (not causal or segment_ids is not None or logits_soft_cap is not None
                   or not (isinstance(q_offset, int) and q_offset == 0) or kw)
    if par is None or sp == 1 or unsupported or q.shape[1] != k.shape[1]:
        return gathered_attention(q, k, v, par=par if sp > 1 else None, causal=causal,
                                  q_offset=q_offset, segment_ids=segment_ids,
                                  kv_segment_ids=kv_segment_ids, scale=scale,
                                  logits_soft_cap=logits_soft_cap, **kw)
    scale = float(scale) if scale is not None else float(q.shape[-1]) ** -0.5
    return _ring_local(q, k, v, par, scale)

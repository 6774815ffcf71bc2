"""Ulysses sequence parallelism across ranks — counterpart of
``deepspeed_tpu/sequence/layer.py`` (the reference's ``DistributedAttention``,
``sequence/layer.py:311``).

Each rank of the ``seq`` axis holds ``s / P`` positions of every head.
``DistributedAttention(base, par)`` moves q, k and v to ``P`` heads' worth
of the whole sequence by an all-to-all over ``seq`` (``[b, s/P, h, d] ->
[b, s, h/P, d]``, ``single_all_to_all``), runs the local attention
``base`` on the rank's heads (on CUDA the flash kernels K1f / K1b, or the
block-sparse K7f / K7b under a ``sparse_attention`` layout), and moves the
output back by the reverse all-to-all; each all-to-all's gradient is the
reverse one (``parallel/context.py``).  Under a ``model`` axis the heads
are cut by it first, then by ``seq`` (JAX's ``ulysses_spec``: heads over
``(model, seq)``).  ``segment_ids`` are the whole sequence's ``[b, s]``.

Kv heads that the axis does not divide:

- the uneven-heads path (JAX ``:73-148``; ``hkv < P``, ``P % hkv == 0``,
  ``hq % P == 0``, no model axis, no segments, ``q_offset`` 0): the
  grouped all-to-all over the cross groups gives each rank one kv head for
  the chunks of its group, the grouped all-gather of size ``G = P / hkv``
  over the inner groups the whole sequence of that head, and the
  ``(j, g') -> (g', j)`` reorder restores the sequence order; the gather's
  gradient reduce-scatters (the inner group's ranks read different q
  heads);
- otherwise the kv heads are replicated, as JAX's spec filter replicates
  them: k and v are all-gathered over ``seq`` and each rank keeps the kv
  heads its q heads read (the values are the same either way).  Where the
  q heads do not divide either, JAX's spec filter replicates them too: the
  rank runs ``base`` over the gathered q / k / v and keeps its rows
  (``sequence.ring.gathered_attention``).

Without a context (one process) ``DistributedAttention`` is ``base``, as
JAX's is without a mesh.
"""
from __future__ import annotations

from typing import Callable

import torch

from ..parallel.topology import SEQ_AXIS


def single_all_to_all(par, x: torch.Tensor, scatter_idx: int, gather_idx: int,
                      axis_name=SEQ_AXIS) -> torch.Tensor:
    """The explicit all-to-all (reference ``sequence/layer.py:221``): ``x``
    is this rank's shard; ``scatter_idx``'s dim is split over the axis,
    ``gather_idx``'s concatenated (differentiable)."""
    return par.all_to_all(x, axis_name, scatter_idx, gather_idx)


def _sequence_order(xg: torch.Tensor, g_size: int, hkv: int) -> torch.Tensor:
    """The grouped gather's chunks, ``(j, g')``-major, in sequence order
    ``(g', j)``."""
    b, s, h, d = xg.shape
    chunk = s // (g_size * hkv)
    return xg.reshape(b, g_size, hkv, chunk, h, d).transpose(1, 2).reshape(b, s, h, d)


class DistributedAttention:
    """Callable with the attention bodies' signature; wraps a local
    attention ``base`` over the ``seq`` axis of ``par``."""

    def __init__(self, local_attention: Callable, par=None):
        self.local_attention = local_attention
        self.par = par

    def __call__(self, q, k, v, **kw):
        par = self.par
        if par is None:
            return self.local_attention(q, k, v, **kw)
        out = self._gqa_uneven_heads(q, k, v, kw)
        if out is not None:
            return out
        p, r = par.seq, par.seq_rank
        hq, hkv = q.shape[2], k.shape[2]
        per = hq // p
        n_rep = hq // hkv
        q0 = r * per
        if hq % p or not (hkv % p == 0 or (per % n_rep == 0) or n_rep % per == 0):
            from .ring import gathered_attention

            return gathered_attention(q, k, v, self.local_attention, par, **kw)
        qh = single_all_to_all(par, q, 2, 1)
        if hkv % p == 0:
            kh, vh = single_all_to_all(par, k, 2, 1), single_all_to_all(par, v, 2, 1)
        else:  # replicated kv heads: the whole sequence, this rank's q heads' kv heads
            kv0, kv1 = q0 // n_rep, (q0 + per - 1) // n_rep + 1
            kh = par.all_gather(k, SEQ_AXIS, 1)[:, :, kv0:kv1]
            vh = par.all_gather(v, SEQ_AXIS, 1)[:, :, kv0:kv1]
        out = self.local_attention(qh, kh, vh, **kw)
        return single_all_to_all(par, out, 1, 2)

    def _gqa_uneven_heads(self, q, k, v, kw):
        """The grouped-collective path for ``hkv < P``; None where it does
        not apply."""
        par = self.par
        p = par.seq
        hq, hkv = q.shape[2], k.shape[2]
        q_offset = kw.get("q_offset", 0)
        model = par.tp.size if par.tp is not None else 1
        if not (p > 1 and hkv < p and p % hkv == 0 and hq % p == 0
                and q.shape[1] == k.shape[1] and model == 1
                and kw.get("segment_ids") is None and kw.get("kv_segment_ids") is None
                and isinstance(q_offset, int) and q_offset == 0):
            return None
        g_size = p // hkv
        me = par.seq_rank
        g, j = divmod(me, g_size)
        # rank p = g * G + j: the inner group shares the kv head g, the cross
        # group the inner index j
        inner = par.subgroup(SEQ_AXIS, [g * g_size + jj for jj in range(g_size)])
        cross = par.subgroup(SEQ_AXIS, [gg * g_size + j for gg in range(hkv)])

        def redistribute(x):
            xh = par.all_to_all(x, cross, 2, 1)  # [b, hkv * s/P, 1, d], chunks g'-major
            xg = par.all_gather(xh, inner, 1)  # [b, s, 1, d], j-major
            return _sequence_order(xg, g_size, hkv)

        qh = single_all_to_all(par, q, 2, 1)
        out = self.local_attention(qh, redistribute(k), redistribute(v), **kw)
        return single_all_to_all(par, out, 1, 2)

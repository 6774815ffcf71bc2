"""Gating math: top-1 / top-k routing with capacity and the aux loss —
counterpart of ``deepspeed_tpu/moe/sharded_moe.py``.

The semantics are JAX's: an fp32 softmax router, per-expert capacity
``int(n * k * cf / E + 0.9999)`` with a ``min_capacity`` floor, each
token's place in its expert's queue by a cumulative sum in priority order,
the occupancy carried across the k choices (a token's second choice queues
behind every first choice), tokens past capacity dropped, the weights
renormalised over the choices that survived, and the load-balancing loss
``mean(me * ce) * E^2 / k`` over the full top-k mask.

JAX keeps the routing as ``[N, E, C]`` one-hot dispatch / combine tensors
that its einsums contract.  Here a ``GatingResult`` keeps it as indices:
for each token and choice the expert, the place in the expert's queue and
whether it survived, so the layer (``moe/layer.py``) gathers tokens into
an ``[E, C, d]`` slab and combines by a weighted gather-sum.
``GatingResult.combine`` rebuilds JAX's dense tensor where a caller wants
it.

The top-k takes, among equal probabilities, the lower expert index first,
as ``jax.lax.top_k`` does (a stable sort on the descending probability);
``torch.topk`` leaves that order unspecified.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F


class GatingResult(NamedTuple):
    expert: torch.Tensor  # [N, k] int64: each choice's expert
    position: torch.Tensor  # [N, k] int64: its place in that expert's queue
    keep: torch.Tensor  # [N, k] bool: within capacity
    weights: torch.Tensor  # [N, k] fp32 combine weights (0 where dropped)
    aux_loss: torch.Tensor  # scalar load-balance loss
    expert_counts: torch.Tensor  # [E] choices routed to each expert (pre-drop)
    dropped_fraction: torch.Tensor  # scalar
    capacity: int

    def slot(self) -> torch.Tensor:
        """[N, k] flat index ``expert * C + position`` into the ``[E * C]``
        slab for a kept choice, ``E * C`` (one past the slab) for a dropped
        one."""
        e = self.expert_counts.shape[0]
        cap = self.capacity
        return torch.where(self.keep, self.expert * cap + self.position,
                           torch.full_like(self.expert, e * cap))

    def combine(self) -> torch.Tensor:
        """JAX's dense ``[N, E, C]`` fp32 combine tensor (its dispatch mask
        is ``combine > 0``)."""
        n, k = self.expert.shape
        e, cap = self.expert_counts.shape[0], self.capacity
        out = torch.zeros(n, e * cap + 1, dtype=torch.float32, device=self.expert.device)
        out.scatter_add_(1, self.slot(), self.weights.float())
        return out[:, :e * cap].reshape(n, e, cap)


def capacity_for(num_tokens: int, num_experts: int, k: int,
                 capacity_factor: float, min_capacity: int = 4) -> int:
    """Slots per expert (JAX ``capacity_for``)."""
    cap = int(num_tokens * k * capacity_factor / num_experts + 0.9999)
    return max(cap, min_capacity)


def top_k(probs: torch.Tensor, k: int):
    """(values, indices) [N, k] of the k largest entries of each row, the
    lower index first among equals (``jax.lax.top_k``'s order)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[:, :k], idx[:, :k]


def topk_gating(logits: torch.Tensor, k: int, capacity_factor: float = 1.25,
                min_capacity: int = 4, normalize_weights: bool = True,
                generator: Optional[torch.Generator] = None,
                random_token_priority: bool = False) -> GatingResult:
    """logits [N, E] -> the capacity-bounded top-k routing.

    ``random_token_priority`` draws the token order used for the capacity
    cumulative sum from ``generator`` (a permutation), so that dropping
    does not favour early positions; JAX draws it from an rng key."""
    order = None
    if random_token_priority:
        if generator is None:
            raise ValueError("random_token_priority=True requires a generator")
        order = torch.randperm(logits.shape[0], generator=generator,
                               device=generator.device)
    return _gating(logits, k, capacity_factor, min_capacity, normalize_weights, order)


def _gating(logits: torch.Tensor, k: int, capacity_factor: float, min_capacity: int,
            normalize_weights: bool, order: Optional[torch.Tensor]) -> GatingResult:
    """``topk_gating`` with the priority order given (None: token order)."""
    n, e = logits.shape
    cap = capacity_for(n, e, k, capacity_factor, min_capacity)
    probs = torch.softmax(logits.float(), dim=-1)
    topv, topi = top_k(probs, k)
    if order is not None:
        order = order.to(logits.device).long()
        inv_order = torch.argsort(order)
    occupancy = torch.zeros(e, dtype=torch.long, device=logits.device)
    positions, keeps = [], []
    for c in range(k):
        mask = F.one_hot(topi[:, c], e)  # [N, E]
        mask_p = mask[order] if order is not None else mask
        pos_p = torch.cumsum(mask_p, 0) - mask_p + occupancy[None, :]
        pos = pos_p[inv_order] if order is not None else pos_p
        loc = torch.gather(pos, 1, topi[:, c:c + 1])[:, 0]  # the chosen expert's place
        positions.append(loc)
        keeps.append(loc < cap)
        occupancy = occupancy + mask.sum(0)
    keep = torch.stack(keeps, 1)
    kept_vals = topv * keep.float()
    if normalize_weights and k > 1:
        weights = kept_vals / kept_vals.sum(1, keepdim=True).clamp(min=1e-9)
    else:
        weights = kept_vals
    counts = occupancy.float()
    me = probs.mean(0)
    ce = F.one_hot(topi, e).float().sum(1).mean(0)  # every one of the k choices
    aux = (me * ce).mean() * (e * e) / k
    dropped = 1.0 - keep.float().sum() / counts.sum().clamp(min=1.0)
    return GatingResult(topi, torch.stack(positions, 1), keep, weights, aux, counts,
                        dropped, cap)


def top1_gating(logits: torch.Tensor, capacity_factor: float = 1.0, **kw) -> GatingResult:
    """Top-1 routing (JAX ``top1_gating``)."""
    return topk_gating(logits, 1, capacity_factor, **kw)

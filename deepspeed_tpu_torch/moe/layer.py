"""MoE layer: the routed expert FFN — counterpart of ``deepspeed_tpu/moe/
layer.py`` at expert-parallel width 1 (one card).

``routed_ffn`` is JAX's gate -> dispatch -> experts -> combine pipeline
with the same function computed in PyTorch's idiom: where JAX contracts
``[N, E, C]`` one-hot tensors to move rows (``layer.py:54``, ``:58``), the
tokens are gathered by (expert, slot) index into a static ``[E, C, d]``
slab whose empty slots are zero, and the outputs come back by a weighted
gather-sum over each token's k choices.  Every shape is static (no host
sync on how many tokens an expert got), so the layer can run under a CUDA
graph.  The expert FFNs are batched matrix products over the stacked
``[E, d, f]`` weights, as JAX's einsums are.

``moe_block_dropless`` is JAX's serving formulation: every token through
every expert, the top-k outputs picked and weighted, no capacity and no
drop.  The router's product is fp32 with TF32 off, as JAX writes it: a
TF32 router flips near-tied expert choices.

Expert parallelism (``routed_ffn_ep``, an expert mesh axis above 1) is
ROADMAP queue 1 item 7 and raises.

``GATE_STATS``: None (the default) records nothing; a list receives, per
routed call, the gate's aux loss, dropped fraction and expert counts as
device tensors (no host sync), the gate metrics the reference logs.
"""
from __future__ import annotations

from typing import Any, Callable

import torch

from ..ops.optimizers import fp32_products
from .sharded_moe import _gating, top_k

GATE_STATS = None


def router_logits(xf: torch.Tensor, router: torch.Tensor) -> torch.Tensor:
    """[N, d] tokens @ [d, E] router -> [N, E] logits, in true fp32."""
    with fp32_products():
        return xf.float() @ router.float()


def routed_ffn(router_kernel: torch.Tensor, x: torch.Tensor, expert_apply: Callable,
               k: int, capacity_factor: float, min_capacity: int = 4,
               order=None):
    """x [b, s, d] -> (out [b, s, d], aux scalar).  ``expert_apply([E, C,
    d]) -> [E, C, d]`` runs every expert on its slab; ``order`` is the
    optional token priority (``sharded_moe._gating``)."""
    b, s, d = x.shape
    xf = x.reshape(b * s, d)
    n = xf.shape[0]
    gate = _gating(router_logits(xf, router_kernel), k, capacity_factor, min_capacity,
                   True, order)
    if GATE_STATS is not None:
        GATE_STATS.append({"aux_loss": gate.aux_loss.detach(),
                           "dropped_fraction": gate.dropped_fraction.detach(),
                           "expert_counts": gate.expert_counts.detach()})
    e, cap = gate.expert_counts.shape[0], gate.capacity
    slot = gate.slot()  # [N, k], dropped -> e * cap
    # slot -> token (n: the zero row past the tokens); a kept slot holds one
    # token, every dropped choice lands on the spare entry e * cap
    src = torch.full((e * cap + 1,), n, dtype=torch.long, device=x.device)
    tok = torch.arange(n, device=x.device)[:, None].expand(n, k)
    src.scatter_(0, slot.reshape(-1), tok.reshape(-1))
    xpad = torch.cat([xf, xf.new_zeros(1, d)])
    xe = xpad[src[:e * cap]].reshape(e, cap, d)
    ye = expert_apply(xe).reshape(e * cap, d)
    ypad = torch.cat([ye, ye.new_zeros(1, d)])
    picked = ypad[slot]  # [N, k, d]
    out = (picked * gate.weights.to(picked.dtype)[:, :, None]).sum(1)
    return out.reshape(b, s, d).to(x.dtype), gate.aux_loss


def _experts_fn(lw: Any, cfg) -> Callable:
    """The gated expert FFN over ``[E, C, d]`` slabs."""
    from ..models.transformer import _activation

    act = _activation(cfg.activation)

    def experts(xe):
        h = act(torch.bmm(xe, lw["w_gate"])) * torch.bmm(xe, lw["w_up"])
        return torch.bmm(h, lw["w_down"])

    return experts


def moe_block(lw: Any, x: torch.Tensor, cfg):
    """Routed gated FFN of a transformer block (training: capacity and
    drops).  lw: {'router' [d, E], 'w_gate' / 'w_up' [E, d, f], 'w_down'
    [E, f, d]}; x [b, s, d] -> (out [b, s, d], aux scalar)."""
    return routed_ffn(lw["router"], x, _experts_fn(lw, cfg), k=cfg.moe_top_k,
                      capacity_factor=cfg.moe_capacity_factor)


def moe_block_dropless(lw: Any, x: torch.Tensor, cfg):
    """Serving MoE: exact top-k routing with no capacity (JAX
    ``moe_block_dropless``).  Every token runs through every expert (E x
    the FFN's products, static in shape), then each token's top-k outputs
    are weighted and summed.  Returns (out [b, s, d], 0.0)."""
    b, s, d = x.shape
    xf = x.reshape(b * s, d)
    probs = torch.softmax(router_logits(xf, lw["router"]), dim=-1)
    topv, topi = top_k(probs, cfg.moe_top_k)
    weights = topv / topv.sum(-1, keepdim=True).clamp(min=1e-9)
    xb = xf[None].expand(lw["w_gate"].shape[0], -1, -1)  # [E, N, d]
    y = _experts_fn(lw, cfg)(xb)  # [E, N, d]
    picked = y.permute(1, 0, 2).gather(1, topi[:, :, None].expand(-1, -1, d))  # [N, k, d]
    out = (picked * weights.to(y.dtype)[:, :, None]).sum(1)
    return out.reshape(b, s, d).to(x.dtype), torch.zeros((), device=x.device)


def routed_ffn_ep(lw: Any, x: torch.Tensor, cfg, mesh, fmt: str = "none"):
    """The explicit expert-parallel region (JAX ``routed_ffn_ep``): needs
    the expert mesh axis and its all-to-alls."""
    raise NotImplementedError(
        "routed_ffn_ep (expert parallelism over an expert mesh axis) is not ported yet "
        "(ROADMAP queue 1 item 7)")


class MoE(torch.nn.Module):
    """API-parity wrapper (JAX ``MoE``, the reference's
    ``deepspeed.moe.layer.MoE``): a user's expert function as a routed
    layer.  ``expert_fn(expert_params, x_tokens) -> y_tokens`` runs once per
    expert over the leading expert dim of ``expert_params`` (a tensor or a
    dict of tensors), by ``torch.func.vmap``."""

    def __init__(self, hidden_size: int, expert_fn: Callable, num_experts: int, k: int = 1,
                 capacity_factor: float = 1.0, min_capacity: int = 4):
        super().__init__()
        self.hidden_size = hidden_size
        self.expert_fn = expert_fn
        self.num_experts = num_experts
        self.k = k
        self.capacity_factor = capacity_factor
        self.min_capacity = min_capacity

    def forward(self, router_kernel: torch.Tensor, expert_params, x: torch.Tensor):
        """x [b, s, d] -> (out [b, s, d], aux scalar)."""
        return routed_ffn(
            router_kernel, x,
            lambda xe: torch.func.vmap(self.expert_fn)(expert_params, xe),
            k=self.k, capacity_factor=self.capacity_factor, min_capacity=self.min_capacity)

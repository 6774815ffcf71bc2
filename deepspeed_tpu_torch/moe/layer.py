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

Across the ranks of a process grid (``par``, a ``parallel.context.
ParallelContext``) ``moe_block`` is ``moe_block_grid``: JAX's GSPMD
``moe_block`` with the gate over the global tokens, a rank's experts
(``expert`` axis) and its columns of them (``model`` axis).
``routed_ffn_ep`` is JAX's explicit expert-parallel region over the
quantized all-to-all (``moe_qcomm``).

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


def _dispatch(xf: torch.Tensor, slot: torch.Tensor, e: int, cap: int) -> torch.Tensor:
    """The ``[e, cap, d]`` slab of ``xf``'s rows by ``slot`` ([N, k] flat
    ``expert * cap + place``; ``e * cap`` for a choice that is not in the
    slab): a kept slot holds one token, an empty one zeros."""
    n, d = xf.shape
    k = slot.shape[1]
    src = torch.full((e * cap + 1,), n, dtype=torch.long, device=xf.device)
    tok = torch.arange(n, device=xf.device)[:, None].expand(n, k)
    src.scatter_(0, slot.reshape(-1), tok.reshape(-1))
    xpad = torch.cat([xf, xf.new_zeros(1, d)])
    return xpad[src[:e * cap]].reshape(e, cap, d)


def _combine(ye: torch.Tensor, slot: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """[N, d]: each token's k slab rows weighted and summed (a choice
    outside the slab adds nothing)."""
    e, cap, d = ye.shape
    ypad = torch.cat([ye.reshape(e * cap, d), ye.new_zeros(1, d)])
    picked = ypad[slot]  # [N, k, d]
    return (picked * weights.to(picked.dtype)[:, :, None]).sum(1)


def _record(gate) -> None:
    if GATE_STATS is not None:
        GATE_STATS.append({"aux_loss": gate.aux_loss.detach(),
                           "dropped_fraction": gate.dropped_fraction.detach(),
                           "expert_counts": gate.expert_counts.detach()})


def routed_ffn(router_kernel: torch.Tensor, x: torch.Tensor, expert_apply: Callable,
               k: int, capacity_factor: float, min_capacity: int = 4,
               order=None):
    """x [b, s, d] -> (out [b, s, d], aux scalar).  ``expert_apply([E, C,
    d]) -> [E, C, d]`` runs every expert on its slab; ``order`` is the
    optional token priority (``sharded_moe._gating``)."""
    b, s, d = x.shape
    xf = x.reshape(b * s, d)
    gate = _gating(router_logits(xf, router_kernel), k, capacity_factor, min_capacity,
                   True, order)
    _record(gate)
    e, cap = gate.expert_counts.shape[0], gate.capacity
    slot = gate.slot()  # [N, k], dropped -> e * cap
    ye = expert_apply(_dispatch(xf, slot, e, cap))
    out = _combine(ye, slot, gate.weights)
    return out.reshape(b, s, d).to(x.dtype), gate.aux_loss


def gather_tokens(par, t: torch.Tensor) -> torch.Tensor:
    """[b, s_local, c] per rank -> the global ``[N, c]`` in JAX's token
    order (``[B, S]`` flattened: rows by batch rank, positions by seq
    rank), all-gathered over the axes whose ranks hold different tokens;
    the cotangent reduce-scatters (each rank reads its own rows)."""
    b, sl, c = t.shape
    if not par.token_axes:
        return t.reshape(b * sl, c)
    seq = par.seq if "seq" in par.token_axes else 1
    w = par.axis_size(par.token_axes)
    g = par.all_gather(t.contiguous()[None], par.token_axes, 0, backward="sum")  # [w, b, sl, c]
    return g.reshape(w // seq, seq, b, sl, c).transpose(1, 2).reshape(w * b * sl, c)


def own_tokens(par, b: int, sl: int, device) -> torch.Tensor:
    """The indices of this rank's ``b x sl`` tokens (local order) in
    ``gather_tokens``'s global order."""
    if not par.token_axes:
        return torch.arange(b * sl, device=device)
    seq = par.seq if "seq" in par.token_axes else 1
    rb = par.axis_rank(par.batch_axes) if par.batch_axes else 0
    rs = par.seq_rank if seq > 1 else 0
    rows = rb * b + torch.arange(b, device=device)
    cols = rs * sl + torch.arange(sl, device=device)
    return (rows[:, None] * (seq * sl) + cols[None, :]).reshape(-1)


def moe_block_grid(lw: Any, x: torch.Tensor, cfg, par):
    """``moe_block`` across the ranks of a process grid (``par``, a
    ``parallel.context.ParallelContext``), JAX's GSPMD semantics: the gate
    runs once over the global tokens (the router's fp32 logits gathered
    over the batch and seq axes; every rank gates alike and keeps its own
    tokens' choices), so capacity, slot order, drops and the aux loss are
    the global batch's.  With an expert layout (``par.ep``) a rank runs its
    ``E / W`` experts; with a model axis (``par.tp``) its columns of each
    expert FFN; the output is the sum of the ranks' contributions over
    those axes (``f`` on the region's input and the combine weights, ``g``
    on its output: every rank then holds the whole gradient of its
    weights' and its input's)."""
    b, s, d = x.shape
    e, k = cfg.moe_num_experts, cfg.moe_top_k
    xf = x.reshape(b * s, d)
    logits = gather_tokens(par, router_logits(xf, lw["router"]).reshape(b, s, e))
    gate = _gating(logits, k, cfg.moe_capacity_factor, 4, True, None)
    _record(gate)
    mine = own_tokens(par, b, s, x.device)
    expert, pos, keep = gate.expert[mine], gate.position[mine], gate.keep[mine]
    cap = gate.capacity
    e0, el = (par.ep.e0, par.ep.local) if par.ep is not None else (0, e)
    local = keep & (expert >= e0) & (expert < e0 + el)
    slot = torch.where(local, (expert - e0) * cap + pos, torch.full_like(expert, el * cap))
    region = par.moe_region_axes
    xin = par.copy(xf, region)
    weights = par.copy(gate.weights[mine], region)
    ye = _experts_fn(lw, cfg)(_dispatch(xin, slot, el, cap))
    out = par.reduce(_combine(ye, slot, weights), region)
    return out.reshape(b, s, d).to(x.dtype), gate.aux_loss


def _experts_fn(lw: Any, cfg) -> Callable:
    """The gated expert FFN over ``[E, C, d]`` slabs."""
    from ..models.transformer import _activation

    act = _activation(cfg.activation)

    def experts(xe):
        h = act(torch.bmm(xe, lw["w_gate"])) * torch.bmm(xe, lw["w_up"])
        return torch.bmm(h, lw["w_down"])

    return experts


def moe_block(lw: Any, x: torch.Tensor, cfg, par=None):
    """Routed gated FFN of a transformer block (training: capacity and
    drops).  lw: {'router' [d, E], 'w_gate' / 'w_up' [E, d, f], 'w_down'
    [E, f, d]}; x [b, s, d] -> (out [b, s, d], aux scalar).  Across ranks
    (``par``) ``moe_block_grid``."""
    if par is not None:
        return moe_block_grid(lw, x, cfg, par)
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


def routed_ffn_ep(lw: Any, x: torch.Tensor, cfg, par, fmt: str = "none"):
    """The explicit expert-parallel region (JAX ``routed_ffn_ep``,
    ``moe/layer.py:93-186``; ``cfg.moe_qcomm`` routes a layer here over an
    expert axis above 1).  ``x`` [b, s, d] is this rank's rows (whole on
    every rank of its expert group); the region splits them over
    ``expert`` too, so each rank gates its own ``b / W`` rows (capacity per
    rank, unlike ``moe_block``).  The ``[E, C, d]`` slab travels to the
    experts' ranks and back through ``qcomm.q_all_to_all`` in ``fmt``
    (``'none'`` the exact all-to-all; int8 / fp8 a quantized payload with
    per-chunk fp32 scales: K6a / K6c and K6b on CUDA tensors); the rows come
    back by an all-gather over ``expert``.  The router's gradient sums over
    ``expert`` (each rank gated its own tokens); the aux loss is the mean
    over the token axes and ``expert``.  A batch that ``dp x expert`` does
    not divide, or ``E`` that the axis does not, is JAX's ``QCommError``;
    below an expert axis of 2 it is ``moe_block``."""
    from ..comm import qcomm
    from ..parallel.topology import EXPERT_AXIS

    w = par.expert if par is not None else 1
    if w <= 1:
        return moe_block(lw, x, cfg, par)
    b, s, d = x.shape
    e, k = cfg.moe_num_experts, cfg.moe_top_k
    dp = par.axis_size(par.batch_axes) if par.batch_axes else 1
    tok_div = dp * w
    if (b * dp) % tok_div or e % w:
        raise qcomm.QCommError(
            f"routed_ffn_ep: batch {b * dp} must divide the dp x expert extent "
            f"({tok_div}) and num_experts {e} the expert axis ({w})")
    if par.seq > 1 or par.tp is not None:
        raise NotImplementedError(
            "routed_ffn_ep (moe_qcomm) beside a seq or model axis is not ported yet "
            "(ROADMAP queue 1 item 7)")
    xl = par.scatter_rows(x, EXPERT_AXIS)
    xf = xl.reshape(-1, d)
    router = par.copy(lw["router"], (EXPERT_AXIS,))
    gate = _gating(router_logits(xf, router), k, cfg.moe_capacity_factor, 4, True, None)
    _record(gate)
    cap = gate.capacity
    slot = gate.slot()
    xe = _dispatch(xf, slot, e, cap)
    # dispatch hop: each destination rank's E / W experts -> [E / W, W * C, d]
    inbox = par.q_all_to_all(xe, EXPERT_AXIS, fmt, 0, 1, xl.dtype)
    ye = _experts_fn(lw, cfg)(inbox)
    # combine hop: results back to their tokens' rank -> [E, C, d]
    back = par.q_all_to_all(ye, EXPERT_AXIS, fmt, 1, 0, xl.dtype)
    out = _combine(back, slot, gate.weights).reshape(xl.shape)
    out = par.gather_rows(out.to(x.dtype), EXPERT_AXIS)
    aux = par.mean_over(gate.aux_loss.reshape(1), par.batch_axes + (EXPERT_AXIS,),
                        par.batch_axes)[0]
    return out, aux


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

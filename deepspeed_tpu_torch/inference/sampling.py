"""Token sampling — counterpart of ``deepspeed_tpu/inference/sampling.py``
(greedy, temperature, top-k, top-p, the non-finite guard, and the
speculative verify acceptance).

Randomness comes from a ``torch.Generator`` owned by the caller, on the
logits' device; it draws other numbers than ``jax.random`` for the same
seed, so only greedy sampling is token-identical across the two packages
(the tests compare sampled distributions).  Every draw is a Gumbel-max
(``gumbel_argmax``), which reads nothing back to the host: the engine's
decode bursts capture ``sample`` in a CUDA graph.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch


@dataclass(frozen=True)
class SamplingParams:
    temperature: float = 0.0  # 0 => greedy
    top_k: int = 0  # 0 => disabled
    top_p: float = 1.0  # 1.0 => disabled
    max_new_tokens: int = 128
    stop_token: Optional[int] = None


def _greedy_onehot(logits: torch.Tensor) -> torch.Tensor:
    """Argmax as log-probs: 0 at the argmax, -inf elsewhere."""
    hit = torch.arange(logits.shape[-1], device=logits.device) \
        == logits.argmax(dim=-1, keepdim=True)
    return torch.where(hit, 0.0, float("-inf"))


def filtered_log_probs(logits: torch.Tensor, temperature: float, top_p: float,
                       top_k: int) -> torch.Tensor:
    """Temperature / top-k / top-p filtering to log-probs for a verify
    tick: logits [B, k+1, v] fp32 -> [B, k+1, v].  Every row of a tick
    shares one ``SamplingParams`` (as every engine dispatch does), so the
    filters take plain scalars.  Greedy (temperature <= 0) is the one-hot
    argmax in log space, so acceptance collapses to exact token match and
    the final draw to argmax."""
    if temperature <= 0.0:
        return _greedy_onehot(logits)
    l = logits.float() / temperature
    # one descending sort serves both filters: masking the sorted array in
    # place equals sorting the masked one
    sorted_l = torch.sort(l, dim=-1, descending=True).values
    if top_k > 0:
        k = min(top_k, l.shape[-1])
        kth = sorted_l[..., k - 1:k]
        l = torch.where(l < kth, float("-inf"), l)
        sorted_l = torch.where(sorted_l < kth, float("-inf"), sorted_l)
    cum = torch.cumsum(torch.softmax(sorted_l, dim=-1), dim=-1)
    # smallest prefix with cumulative probability >= top_p; an index past
    # the end (cum never reaches top_p in fp32) masks nothing, as JAX's
    # out-of-range gather does
    cutoff_idx = (cum < top_p).sum(dim=-1, keepdim=True)
    cutoff = torch.gather(sorted_l, -1, cutoff_idx.clamp(max=l.shape[-1] - 1))
    cutoff = torch.where(cutoff_idx < l.shape[-1], cutoff, float("-inf"))
    l = torch.where(l < cutoff, float("-inf"), l)
    return torch.log_softmax(l, dim=-1)


def spec_verify_sample(logits: torch.Tensor, draft: torch.Tensor, n_draft: torch.Tensor,
                       temperature: float, top_p: float, top_k: int,
                       generator: Optional[torch.Generator] = None):
    """Distribution-preserving speculative acceptance (rejection sampling)
    for a deterministic drafter: logits [B, k+1, v] (position-ordered verify
    logits), draft [B, k], n_draft [B] (0 = plain decode).

    The draft distribution is a point mass, so draft d_i is accepted with
    probability p_i(d_i); at the first rejection the next token is drawn
    from p_i with d_i's mass removed; if every draft survives, the bonus
    token comes from p_{k+1}.  The emitted stream is distributed as plain
    sampling from p (greedy: token-identical to greedy decode).

    Returns (out [B, k+1] int32, the first n_out valid and the rest 0;
    n_out [B] int32 = accepted + 1)."""
    b, k1, v = logits.shape
    k = k1 - 1
    dev = logits.device
    logp = filtered_log_probs(logits, temperature, top_p, top_k)
    draft = draft.long()
    p_draft = torch.gather(logp[:, :k].exp(), -1, draft[..., None])[..., 0]  # [B, k]
    u = torch.rand((b, k), generator=generator, device=dev)
    # u < 1, so p(d) = 1 always accepts: a rejection leaves residual mass
    acc = (u < p_draft) & (torch.arange(k, device=dev)[None, :] < n_draft[:, None])
    n_acc = torch.cumprod(acc.int(), dim=-1).sum(dim=-1)  # [B]
    rows = torch.arange(b, device=dev)
    dist = logp[rows, n_acc]  # [B, v]: first rejection, or the bonus row
    if k > 0:
        d_j = torch.gather(draft, 1, n_acc.clamp(max=k - 1)[:, None])[:, 0]
    else:
        d_j = torch.zeros(b, dtype=torch.long, device=dev)
    rejected = n_acc < n_draft
    drop = rejected[:, None] & (torch.arange(v, device=dev)[None, :] == d_j[:, None])
    final = gumbel_argmax(torch.where(drop, float("-inf"), dist), generator).long()
    idx = torch.arange(k1, device=dev)[None, :]
    draft_pad = torch.nn.functional.pad(draft, (0, 1))
    out = torch.where(idx < n_acc[:, None], draft_pad,
                      torch.where(idx == n_acc[:, None], final[:, None], 0))
    return out.to(torch.int32), (n_acc + 1).to(torch.int32)


def finite_guard(logits: torch.Tensor, sampled: torch.Tensor) -> torch.Tensor:
    """Rows whose logits hold ANY non-finite value return the sentinel -1
    instead of a sample: the one-int channel that tells the host this row's
    forward produced garbage (the engine fails that request only)."""
    ok = torch.isfinite(logits.reshape(sampled.shape[0], -1)).all(dim=-1)
    if sampled.dim() > 1:
        ok = ok.reshape((-1,) + (1,) * (sampled.dim() - 1))
    return torch.where(ok, sampled, torch.full_like(sampled, -1))


def top_p_filter(logits: torch.Tensor, top_p: float) -> torch.Tensor:
    """Mask (to -inf) every logit of a row [B, v] outside the smallest
    prefix of its descending order whose cumulative probability reaches
    ``top_p``.  A row whose fp32 cumulative sum never reaches ``top_p``
    masks nothing, as JAX's out-of-range gather does: its cutoff index (v)
    never reaches the gather, which on CUDA would be a device-side assert
    that fails every request of the engine."""
    v = logits.shape[-1]
    sorted_logits = torch.sort(logits, dim=-1, descending=True).values
    cum = torch.cumsum(torch.softmax(sorted_logits, dim=-1), dim=-1)
    cutoff_idx = (cum < top_p).sum(dim=-1, keepdim=True)
    cutoff = torch.gather(sorted_logits, -1, cutoff_idx.clamp(max=v - 1))
    cutoff = torch.where(cutoff_idx < v, cutoff, float("-inf"))
    return torch.where(logits < cutoff, float("-inf"), logits)


def sample(logits: torch.Tensor, params: SamplingParams,
           generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """logits [B, v] (fp32) -> token ids [B] int32."""
    if params.temperature <= 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    logits = logits / params.temperature
    if params.top_k > 0:
        k = min(params.top_k, logits.shape[-1])  # k >= vocab: no-op filter
        kth = torch.topk(logits, k, dim=-1).values[:, -1:]
        logits = torch.where(logits < kth, float("-inf"), logits)
    if params.top_p < 1.0:
        logits = top_p_filter(logits, params.top_p)
    return gumbel_argmax(logits, generator)


def gumbel_argmax(logits: torch.Tensor, generator: Optional[torch.Generator] = None
                  ) -> torch.Tensor:
    """One categorical draw per row of ``logits`` [B, v] by Gumbel-max (as
    ``jax.random.categorical`` draws): argmax(logits - log(-log(u))), u
    uniform from ``generator``.  Unlike ``torch.multinomial`` it checks
    nothing on the host, so a CUDA graph can hold it; a non-finite row
    draws some index, which ``finite_guard`` turns into the sentinel."""
    u = torch.rand(logits.shape, generator=generator, device=logits.device)
    u.clamp_(min=torch.finfo(torch.float32).tiny)
    return torch.argmax(logits - torch.log(-torch.log(u)), dim=-1).to(torch.int32)

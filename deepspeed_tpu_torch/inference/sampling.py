"""Token sampling — counterpart of ``deepspeed_tpu/inference/sampling.py``
(greedy, temperature, top-k, top-p and the non-finite guard).

Randomness comes from a ``torch.Generator`` owned by the caller; it draws
other numbers than ``jax.random`` for the same seed, so only greedy
sampling is token-identical across the two packages.  Speculative verify
sampling comes with the speculation slice.
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


def finite_guard(logits: torch.Tensor, sampled: torch.Tensor) -> torch.Tensor:
    """Rows whose logits hold ANY non-finite value return the sentinel -1
    instead of a sample: the one-int channel that tells the host this row's
    forward produced garbage (the engine fails that request only)."""
    ok = torch.isfinite(logits.reshape(sampled.shape[0], -1)).all(dim=-1)
    if sampled.dim() > 1:
        ok = ok.reshape((-1,) + (1,) * (sampled.dim() - 1))
    return torch.where(ok, sampled, torch.full_like(sampled, -1))


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
        sorted_logits = torch.sort(logits, dim=-1, descending=True).values
        cum = torch.cumsum(torch.softmax(sorted_logits, dim=-1), dim=-1)
        # keep the smallest prefix with cumulative probability >= top_p
        cutoff_idx = (cum < params.top_p).sum(dim=-1, keepdim=True)
        cutoff = torch.gather(sorted_logits, -1, cutoff_idx)
        logits = torch.where(logits < cutoff, float("-inf"), logits)
    probs = torch.softmax(logits, dim=-1)
    # a non-finite row would make multinomial raise; it draws from uniform
    # weights instead and finite_guard turns its sample into the sentinel
    probs = torch.where(torch.isfinite(probs).all(-1, keepdim=True), probs, 1.0)
    return torch.multinomial(probs, 1, generator=generator)[:, 0].to(torch.int32)

"""Random layer token dropping (random-LTD) — counterpart of
``deepspeed_tpu/data/random_ltd.py`` (the reference's
``data_routing/basic_layer.py:14 RandomLayerTokenDrop`` and
``scheduler.py``): the middle layers process a random subset of the tokens,
whose count ramps to the full sequence over the schedule.

As in JAX these are functions a model composes; the engine does not call
them.  The kept count is a multiple of ``granularity`` (a shape bucket);
the reference's token-sort, gather and scatter kernels are one
``argsort``, ``take_along_dim`` and indexed assignment here, as they are
one ``jnp`` op each in JAX.  ``sample_kept_indices`` draws from a
``torch.Generator`` where JAX splits a PRNG key.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch


class RandomLTDScheduler:
    """Kept-token schedule: a linear ramp from ``start_tokens`` to
    ``seq_len`` over ``total_steps``, quantized down to ``granularity``
    (JAX's, with its end-point snap)."""

    def __init__(self, start_tokens: int, seq_len: int, total_steps: int,
                 granularity: int = 16):
        if start_tokens > seq_len:
            raise ValueError("start_tokens must be <= seq_len")
        self.start_tokens = start_tokens
        self.seq_len = seq_len
        self.total_steps = total_steps
        self.granularity = granularity
        self.current = max(start_tokens - start_tokens % granularity, granularity)

    def get_current_seq(self) -> int:
        return self.current

    def update_seq(self, global_step: int) -> int:
        frac = min(max(global_step / max(self.total_steps, 1), 0.0), 1.0)
        kept = int(self.start_tokens + frac * (self.seq_len - self.start_tokens))
        kept -= kept % self.granularity
        if kept + self.granularity > self.seq_len:
            # quantizing down must not leave the schedule short of the full length
            kept = self.seq_len
        self.current = min(max(kept, self.granularity), self.seq_len)
        return self.current

    def state_dict(self):
        return {"current": self.current}

    def load_state_dict(self, state):
        self.current = int(state["current"])


def sample_kept_indices(generator: Optional[torch.Generator], batch: int, seq_len: int,
                        kept: int, device=None) -> torch.Tensor:
    """``[b, kept]`` random token indices, sorted (order-preserving, the
    reference's token_sort)."""
    if device is None:
        device = generator.device if generator is not None else "cpu"
    noise = torch.rand((batch, seq_len), generator=generator, device=device)
    idx = torch.argsort(noise, dim=-1)[:, :kept]
    return torch.sort(idx, dim=-1).values


def gather_tokens(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``[b, s, d]`` -> ``[b, kept, d]`` at ``idx``."""
    return torch.take_along_dim(x, idx[:, :, None], dim=1)


def scatter_tokens(full: torch.Tensor, sub: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``sub`` ``[b, kept, d]`` written back into a copy of ``full`` at
    ``idx``; the other rows keep their values."""
    out = full.clone()
    out[torch.arange(full.shape[0], device=full.device)[:, None], idx] = sub.to(full.dtype)
    return out


def random_ltd_layer(x: torch.Tensor, layer_fn: Callable, generator: Optional[torch.Generator],
                     kept: int) -> torch.Tensor:
    """``layer_fn`` on a random ``kept``-token subset of ``x``, the results
    scattered back (the RandomLayerTokenDrop wrapper as a function)."""
    b, s, _ = x.shape
    if kept >= s:
        return layer_fn(x)
    idx = sample_kept_indices(generator, b, s, kept, device=x.device)
    return scatter_tokens(x, layer_fn(gather_tokens(x, idx)), idx)

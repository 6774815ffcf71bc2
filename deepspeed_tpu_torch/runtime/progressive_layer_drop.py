"""Progressive layer drop (PLD) — counterpart of ``deepspeed_tpu/runtime/
progressive_layer_drop.py`` (the reference's ``runtime/
progressive_layer_drop.py:10 ProgressiveLayerDrop``, engine hook at
``engine.py:1959``).

The keep probability anneals as theta(t) = (1 - theta) exp(-gamma t) +
theta.  ``layer_keep_mask`` draws one Bernoulli a layer from it on the
host with an explicit ``torch.Generator``, the first layer always kept
(the engine's comes from ``pld_generator``: one a step and micro-batch,
as JAX folds its step key);
``models.transformer.forward`` skips a dropped layer outright (it launches
nothing for it, as JAX's ``lax.cond`` runs one branch), so the layer is
the identity and its weights get no gradient.
"""
from __future__ import annotations

import math

import numpy as np
import torch


class ProgressiveLayerDrop:
    """theta(t) schedule (reference :10): the keep probability anneals from
    1 toward ``theta`` at rate ``gamma``."""

    def __init__(self, theta: float = 0.5, gamma: float = 0.001):
        self.theta = theta
        self.gamma = gamma
        self.current_theta = 1.0

    def get_state(self):
        return {"progressive_layer_drop": True, "pld_theta": self.get_theta()}

    def get_theta(self) -> float:
        return self.current_theta

    def theta_at(self, global_step: int) -> float:
        """theta at ``global_step`` (JAX computes it traced; here on the
        host, where the mask is drawn)."""
        return (1.0 - self.theta) * math.exp(-self.gamma * global_step) + self.theta

    def update_state(self, global_step: int) -> float:
        self.current_theta = self.theta_at(global_step)
        return self.current_theta


def layer_keep_mask(generator: torch.Generator, num_layers: int, theta: float,
                    always_keep_first: bool = True) -> torch.Tensor:
    """``[num_layers]`` bool mask on the CPU, drawn from the CPU
    ``generator``: True runs the layer, False skips it.  The first layer
    is kept (the reference keeps the embedding-adjacent block)."""
    probs = torch.full((num_layers,), float(theta), dtype=torch.float32)
    keep = torch.bernoulli(probs, generator=generator).bool()
    if always_keep_first and num_layers:
        keep[0] = True
    return keep


def pld_generator(seed: int, step: int, micro: int) -> torch.Generator:
    """A CPU generator for the mask of micro-batch ``micro`` of step
    ``step``, a pure function of the three (so a resumed run draws what
    the uninterrupted one did)."""
    key = np.random.SeedSequence([seed, 0x91D, step, micro]).generate_state(1, np.uint64)[0]
    return torch.Generator().manual_seed(int(key))

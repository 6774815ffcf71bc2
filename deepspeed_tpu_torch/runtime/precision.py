"""Mixed precision: fp32 masters cast to the compute type, and dynamic loss
scaling — counterpart of ``deepspeed_tpu/runtime/precision.py``.

The engine keeps fp32 master parameters and casts them to bf16 / fp16 inside
autograd, so the gradients land on the masters in fp32.  The fp16 loss
scaler's state is three device tensors updated with ``torch.where``: no
host sync decides an overflow.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Tuple

import torch

from ..ops.kernels import resolve_device

DTYPES = {
    "float32": torch.float32,
    "bfloat16": torch.bfloat16,
    "float16": torch.float16,
}


def compute_dtype(name: str) -> torch.dtype:
    return DTYPES[name]


def cast_floating(tree, dtype: torch.dtype):
    """Cast the floating leaves of a nested dict; other leaves stay."""
    if isinstance(tree, dict):
        return {k: cast_floating(v, dtype) for k, v in tree.items()}
    if torch.is_tensor(tree) and tree.is_floating_point():
        return tree.to(dtype)
    return tree


@dataclass
class LossScaleState:
    """Dynamic loss scaler state (scale fp32, good_steps and hysteresis
    int32), device tensors.  For bf16 / fp32 the scale is a static 1."""

    scale: torch.Tensor
    good_steps: torch.Tensor
    hysteresis: torch.Tensor


def init_loss_scale(dynamic: bool, initial_scale_power: int = 16, static_scale: float = 1.0,
                    hysteresis: int = 2, device=None) -> LossScaleState:
    """The scaler's state on ``device`` (CUDA unless the caller names
    another; see ``ops.kernels.resolve_device``)."""
    device = resolve_device(device)
    scale = float(2 ** initial_scale_power) if dynamic else float(static_scale or 1.0)
    return LossScaleState(
        scale=torch.tensor(scale, dtype=torch.float32, device=device),
        good_steps=torch.tensor(0, dtype=torch.int32, device=device),
        hysteresis=torch.tensor(hysteresis, dtype=torch.int32, device=device),
    )


def grads_finite(grads: List[torch.Tensor]) -> torch.Tensor:
    """A bool device tensor: every gradient element is finite."""
    finite = torch.ones((), dtype=torch.bool, device=grads[0].device)
    for g in grads:
        finite = finite & torch.isfinite(g).all()
    return finite


def update_loss_scale(state: LossScaleState, finite: torch.Tensor,
                      loss_scale_window: int = 1000, scale_factor: float = 2.0,
                      min_scale: float = 1.0, max_scale: float = 2.0 ** 24,
                      init_hysteresis: int = 2) -> LossScaleState:
    """On overflow consume hysteresis, then halve; after
    ``loss_scale_window`` clean steps double (``DynamicLossScaler``)."""
    good = state.good_steps + 1
    grow = good >= loss_scale_window
    ok_scale = torch.where(grow, torch.clamp(state.scale * scale_factor, max=max_scale),
                           state.scale)
    ok_good = torch.where(grow, torch.zeros_like(good), good)
    hys = state.hysteresis - 1
    shrink = hys <= 0
    bad_scale = torch.where(shrink, torch.clamp(state.scale / scale_factor, min=min_scale),
                            state.scale)
    bad_hys = torch.where(shrink, torch.full_like(hys, init_hysteresis), hys)
    return LossScaleState(
        scale=torch.where(finite, ok_scale, bad_scale),
        good_steps=torch.where(finite, ok_good, torch.zeros_like(good)),
        hysteresis=torch.where(finite, state.hysteresis, bad_hys),
    )


# elements squared at a time by global_grad_norm: the engine's flat
# gradient buffer holds 4 bytes a parameter, and squaring it whole would
# take as much again (30 GB for llama3_8b at 30 layers)
NORM_CHUNK = 1 << 26


def _sum_squares(g: torch.Tensor) -> torch.Tensor:
    if g.numel() <= NORM_CHUNK:
        return g.float().square().sum()
    return sum(c.float().square().sum() for c in g.reshape(-1).split(NORM_CHUNK))


def global_grad_norm(grads: List[torch.Tensor]) -> torch.Tensor:
    """The L2 norm over every gradient, fp32 (a device scalar); a tensor
    past ``NORM_CHUNK`` elements is squared and summed chunk by chunk."""
    if not grads:
        return torch.zeros((), dtype=torch.float32)
    return torch.sqrt(sum(_sum_squares(g) for g in grads))


def clip_factor(norm: torch.Tensor, max_norm: float) -> torch.Tensor:
    """``min(1, max_norm / (norm + 1e-6))``: the factor that clips a
    gradient of global norm ``norm`` to ``max_norm``."""
    return torch.clamp(max_norm / (norm + 1e-6), max=1.0)


def clip_by_global_norm(grads: List[torch.Tensor], max_norm: float,
                        norm: torch.Tensor = None) -> Tuple[List[torch.Tensor], torch.Tensor]:
    """Scale every gradient by ``clip_factor(norm, max_norm)``."""
    if norm is None:
        norm = global_grad_norm(grads)
    factor = clip_factor(norm, max_norm)
    return [g * factor.to(g.dtype) for g in grads], norm

"""Optimizer factory: config ``optimizer.type`` -> an update rule —
counterpart of ``deepspeed_tpu/ops/optimizers.py:41 build_optimizer``, with
optax's exact update rules.

An optimizer here is a plain object over lists of fp32 tensors:
``init(params) -> state`` and ``step(params, grads, state, lr, finite=None)``,
which updates ``params`` and ``state`` in place.  ``lr`` is a device scalar
(the engine computes it from its device step counter, so no host sync), and
``finite`` (fp16 only) is a device bool: where it is false every tensor
keeps its old value, the step counter included — the overflow-skip select
of JAX's ``_apply_grads``.

Rules (``g`` the gradient, ``t`` the 1-based update count):

- ``adamw``, and ``adam`` / ``fusedadam`` / ``deepspeedcpuadam`` in
  ``adam_w_mode`` (the default) or with weight decay:
  ``m = b1 m + (1-b1) g; v = b2 v + (1-b2) g^2;
  p -= lr (m/(1-b1^t) / (sqrt(v/(1-b2^t)) + eps) + wd p)`` — optax's
  ``scale_by_adam`` + ``add_decayed_weights`` + ``scale_by_learning_rate``,
  the decay applied to every leaf;
- ``adam`` / ``fusedadam`` with ``adam_w_mode: false`` and no decay: the
  same without ``wd p``;
- ``sgd``: ``buf = g + momentum buf; p -= lr (g + momentum buf if nesterov
  else buf)`` (optax ``trace``).

Every Adam-family update runs K8 (``ops/kernels/fused_adam.py``): the
CUDA kernel on CUDA tensors, its plain version on CPU ones.  The engine
keeps its parameters, gradients and moments as one flat fp32 buffer each,
so a step is one launch; a caller with several tensors gets one launch a
tensor.  ``sgd`` stays plain PyTorch (JAX has no kernel for it).

Refused, each naming itself: ``lamb``, ``lion``, ``adagrad`` (optax starts
its accumulator at 0.1, torch at 0), ``muon`` (ROADMAP queue 1 item 8) and
the 1-bit family (item 7).
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional

import torch

from .kernels.fused_adam import fused_adamw_flat

_ADAM_NAMES = ("adam", "adamw", "fusedadam", "deepspeedcpuadam")
_REFUSED = {
    "lamb": 8, "fusedlamb": 8, "lion": 8, "fusedlion": 8, "adagrad": 8, "muon": 8,
    "onebitadam": 7, "zerooneadam": 7, "onebitlamb": 7,
}


def _assign(dst: torch.Tensor, new: torch.Tensor, finite: Optional[torch.Tensor]) -> None:
    dst.copy_(new if finite is None else torch.where(finite, new, dst))


class Adam:
    """optax ``adamw`` (``weight_decay`` > 0) or ``adam`` (0), through K8."""

    def __init__(self, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                 weight_decay: float = 0.0):
        self.b1, self.b2, self.eps, self.wd = b1, b2, eps, weight_decay

    def init(self, params: List[torch.Tensor]) -> Dict[str, Any]:
        return {"count": torch.zeros((), dtype=torch.int32, device=params[0].device),
                "mu": [torch.zeros_like(p) for p in params],
                "nu": [torch.zeros_like(p) for p in params]}

    @torch.no_grad()
    def step(self, params, grads, state, lr: torch.Tensor, finite=None) -> None:
        count = state["count"]
        count += 1 if finite is None else finite.to(count.dtype)  # t of this update
        for p, g, m, v in zip(params, grads, state["mu"], state["nu"]):
            fused_adamw_flat(p, g, m, v, lr, count, self.b1, self.b2, self.eps, self.wd,
                             finite)


class SGD:
    """optax ``sgd`` (``trace`` momentum, optionally Nesterov)."""

    def __init__(self, momentum: float = 0.0, nesterov: bool = False):
        self.momentum, self.nesterov = momentum, nesterov

    def init(self, params: List[torch.Tensor]) -> Dict[str, Any]:
        return {"count": torch.zeros((), dtype=torch.int32, device=params[0].device),
                "trace": [torch.zeros_like(p) for p in params]}

    @torch.no_grad()
    def step(self, params, grads, state, lr: torch.Tensor, finite=None) -> None:
        for p, g, buf in zip(params, grads, state["trace"]):
            new_buf = g + self.momentum * buf
            upd = g + self.momentum * new_buf if self.nesterov else new_buf
            _assign(buf, new_buf, finite)
            _assign(p, p - lr * upd, finite)
        _assign(state["count"], state["count"] + 1, finite)


def build_optimizer(type_name: str, params: Optional[Dict[str, Any]] = None):
    """The update rule of config ``optimizer: {type, params}``; the learning
    rate is the engine's schedule, passed to ``step``."""
    params = dict(params or {})
    name = type_name.lower().replace("_", "")
    if name in _REFUSED:
        raise NotImplementedError(
            f"optimizer {type_name!r} is not ported yet (ROADMAP queue 1 item {_REFUSED[name]})")
    betas = params.get("betas", (0.9, 0.999))
    eps = params.get("eps", 1e-8)
    wd = params.get("weight_decay", 0.0)
    if name in _ADAM_NAMES:
        return Adam(b1=betas[0], b2=betas[1], eps=eps, weight_decay=wd)
    if name == "sgd":
        return SGD(momentum=params.get("momentum", 0.0), nesterov=params.get("nesterov", False))
    raise ValueError(f"unknown optimizer type '{type_name}'")

"""Hessian eigenvalue estimation by power iteration — counterpart of
``deepspeed_tpu/runtime/eigenvalue.py`` (the reference's
``runtime/eigenvalue.py:13 Eigenvalue``).

JAX takes each Hessian-vector product as ``jvp(grad(loss))``.  Here the
gradient is taken once with ``create_graph=True`` and each product is the
gradient of ``<g, v>`` through that graph (kept across the iterations), the
same second derivative.  A double backward cannot go through the flash
attention Functions (``once_differentiable``: their backward outputs carry
no graph), so the engine runs the estimator's loss with the plain attention
body (``attn_impl="reference"``), which is the body JAX's ``"auto"`` picks
off the TPU, where its own estimator runs.

The estimate is ``||H v||`` after normalising ``v``, so it is never
negative; the norm is clamped at ``stability``, and the loop stops when
``|eig - eig_prev| <= tol * |eig_prev + 1e-12|`` from the second iteration
on, as in JAX.  The start vector is drawn from a ``torch.Generator`` (JAX
splits a PRNG key), so the two packages start from different vectors.
"""
from __future__ import annotations

from typing import Any, Callable, List, Optional, Tuple

import torch

from ..utils.logging import log_dist


def _leaves(tree, out: List[torch.Tensor]) -> List[torch.Tensor]:
    for k in tree:
        v = tree[k]
        if isinstance(v, dict):
            _leaves(v, out)
        else:
            out.append(v)
    return out


def _rebuild(tree, it):
    return {k: _rebuild(v, it) if isinstance(v, dict) else next(it) for k, v in tree.items()}


def hvp_fn(loss_fn: Callable, params, batch) -> Tuple[Callable, List[torch.Tensor]]:
    """``(hvp, leaves)``: ``hvp(v)`` is the Hessian of ``loss_fn(params,
    batch, None)`` at ``params`` applied to ``v`` (a list shaped as
    ``leaves``), through one first-order graph built here."""
    leaves = [x.detach().requires_grad_(True) for x in _leaves(params, [])]
    loss = loss_fn(_rebuild(params, iter(leaves)), batch, None)
    grads = torch.autograd.grad(loss, leaves, create_graph=True, allow_unused=True)
    pairs = [(g, x) for g, x in zip(grads, leaves) if g is not None]

    def hvp(v: List[torch.Tensor]) -> List[torch.Tensor]:
        by_leaf = {id(x): vi for x, vi in zip(leaves, v)}
        dot = sum((g * by_leaf[id(x)]).sum() for g, x in pairs)
        hv = torch.autograd.grad(dot, leaves, retain_graph=True, allow_unused=True)
        return [torch.zeros_like(x) if h is None else h for h, x in zip(hv, leaves)]

    return hvp, leaves


class Eigenvalue:
    """Power-iteration estimator of the dominant Hessian eigenvalue, with
    the reference's constructor knobs."""

    def __init__(self, verbose: bool = False, max_iter: int = 100, tol: float = 1e-2,
                 stability: float = 1e-6, gas_boundary_resolution: int = 1,
                 layer_name: str = "", layer_num: int = 0):
        self.verbose = verbose
        self.max_iter = max_iter
        self.tol = tol
        self.stability = stability
        self.gas_boundary_resolution = gas_boundary_resolution
        self.layer_name = layer_name
        self.layer_num = layer_num

    def _normalize(self, v: List[torch.Tensor]):
        norm = torch.sqrt(sum((x.float() * x.float()).sum() for x in v))
        norm = torch.clamp_min(norm, self.stability)
        return [x / norm.to(x.dtype) for x in v], norm

    def compute_eigenvalue(self, loss_fn: Callable, params: Any, batch: Any,
                           generator: Optional[torch.Generator] = None
                           ) -> Tuple[float, Any]:
        """``(eigenvalue, eigenvector tree)`` of d2L/dp2 at ``params``."""
        hvp, leaves = hvp_fn(loss_fn, params, batch)
        if generator is None:
            generator = torch.Generator(device=leaves[0].device).manual_seed(0)
        v = [torch.randn(x.shape, generator=generator, device=x.device, dtype=x.dtype)
             for x in leaves]
        v, _ = self._normalize(v)
        eig_prev = 0.0
        eig = 0.0
        for i in range(self.max_iter):
            v, eig_t = self._normalize(hvp(v))
            eig = float(eig_t)
            if self.verbose:
                log_dist(f"eigenvalue iter {i}: {eig:.5f}")
            if i > 0 and abs(eig - eig_prev) <= self.tol * abs(eig_prev + 1e-12):
                break
            eig_prev = eig
        return eig, _rebuild(params, iter([x.detach() for x in v]))

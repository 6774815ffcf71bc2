"""Optimizer factory: config ``optimizer.type`` -> an update rule —
counterpart of ``deepspeed_tpu/ops/optimizers.py:41 build_optimizer``, with
optax's exact update rules.

An optimizer here is a plain object over lists of fp32 tensors (the leaves):
``init(params) -> state`` and ``step(params, grads, state, lr, finite=None)``,
which updates ``params`` and ``state`` in place.  ``lr`` is a device scalar
(the engine computes it from its device step counter, so no host sync), and
``finite`` (fp16 only) is a device bool: where it is false every tensor of
the state keeps its old value, the step counter included — the
overflow-skip select of JAX's ``_apply_grads``.

The engine hands over its leaves: views, in order, of its flat fp32 master
and gradient buffers.  Such leaves tile one buffer, and an optimizer then
keeps each moment as one flat buffer laid out like it (``_state_like``): an
elementwise rule is one pass over the flat buffers, and a rule that needs
the leaves (Lamb's trust ratio, Muon's 2-D rule) reads views of them at the
same offsets.  Tensors that do not tile one buffer are taken one by one.

Rules (``g`` the gradient, ``t`` the 1-based update count, ``bc_b(t) = 1 -
b^t``):

- ``adamw``, and ``adam`` / ``fusedadam`` / ``deepspeedcpuadam`` in
  ``adam_w_mode`` (the default) or with weight decay:
  ``m = b1 m + (1-b1) g; v = b2 v + (1-b2) g^2;
  p -= lr (m/bc_b1(t) / (sqrt(v/bc_b2(t)) + eps) + wd p)`` — optax's
  ``scale_by_adam`` + ``add_decayed_weights`` + ``scale_by_learning_rate``,
  the decay applied to every leaf; ``adam`` / ``fusedadam`` with
  ``adam_w_mode: false`` and no decay: the same without ``wd p``.  Every
  Adam-family update runs K8 (``ops/kernels/fused_adam.py``): one launch
  over the engine's flat buffers;
- ``lamb`` / ``fusedlamb`` (optax ``lamb``): the Adam direction above plus
  ``wd p`` (``eps`` from the config, default 1e-8), scaled per leaf by the
  trust ratio ``||p|| / ||u||`` (1 where either norm is 0): a stacked
  ``[L, ...]`` leaf takes one ratio over its L layers;
- ``lion`` / ``fusedlion`` (optax ``lion``, betas default (0.9, 0.99)):
  ``u = sign((1-b1) g + b1 m) + wd p; m = (1-b2) g + b2 m; p -= lr u``;
- ``adagrad`` (optax ``adagrad``, eps default 1e-10): the accumulator
  starts at 0.1; ``acc += g^2; p -= lr g where(acc > 0, rsqrt(acc + eps),
  0)``;
- ``muon`` (``optax.contrib.muon(lr)``; JAX passes no other argument):
  every 2-D leaf takes Nesterov momentum (beta 0.95, both bias corrections)
  orthogonalized by 5 Newton–Schulz steps (coefficients (3.4445, -4.775,
  2.0315), after a transpose when rows > cols and a division by
  ``||x||_F + 1e-8``), scaled by ``sqrt(max(1, cols / rows))``; every other
  leaf (the stacked ``[L, in, out]`` layer weights, 1-D norms) takes NAdamW
  (optax ``adamw(nesterov=True)``, eps 1e-8, no decay), which is not K8's
  plain AdamW.  The products are fp32 ``torch.matmul`` without TF32 (XLA's
  products in JAX);
- ``sgd``: ``buf = g + momentum buf; p -= lr (g + momentum buf if nesterov
  else buf)`` (optax ``trace``).

Each rule declares its per-element state as ``SLOTS`` (a path in the
state tree -> initial value; Muon's ``slots`` also says which leaves each
covers) and whether its update is ``ELEMENTWISE`` (no per-leaf reduction);
``init`` builds the state from them, and the ZeRO-Offload CPU tier
(``runtime/offload.py``) builds the same layout in pinned host memory and
streams it through the card in chunks: any cut of the buffers for an
elementwise rule, whole leaves for Lamb and Muon.

Only the Adam family has a kernel: JAX builds the others with optax and no
Pallas kernel.  The 1-bit family has no rule here: its update is the
engine's compressed step across ranks (``runtime/onebit.py``), and
``build_optimizer`` raises ``NotImplementedError`` naming it, as JAX's
does.  Reference keys JAX ignores (for example FusedLamb's
``max_coeff``) are ignored here too.
"""
from __future__ import annotations

import math
from contextlib import contextmanager
from typing import Any, Dict, List, Optional

import torch

from .kernels.fused_adam import fused_adamw_flat

_ADAM_NAMES = ("adam", "adamw", "fusedadam", "deepspeedcpuadam")
_ENGINE_ONLY = ("onebitadam", "zerooneadam", "onebitlamb")


def _assign(dst: torch.Tensor, new: torch.Tensor, finite: Optional[torch.Tensor]) -> None:
    dst.copy_(new if finite is None else torch.where(finite, new, dst))


def _span(tensors: List[torch.Tensor]) -> Optional[torch.Tensor]:
    """The 1-D buffer that ``tensors`` tile in order (contiguous, back to
    back in one storage, one type: the engine's leaves), or None."""
    first = tensors[0]
    storage = first.untyped_storage().data_ptr()
    start = end = first.storage_offset()
    for t in tensors:
        if (not t.is_contiguous() or t.dtype != first.dtype
                or t.untyped_storage().data_ptr() != storage or t.storage_offset() != end):
            return None
        end += t.numel()
    return first.detach().as_strided((end - start,), (1,), start)


def _aligned(params, grads, *states):
    """(params, grads, *states) as lists an elementwise rule zips: one span
    each when the parameters and the gradients both tile one buffer and the
    state was laid out over such a span (the engine), else leaf by leaf."""
    ps, gs = _span(params), _span(grads)
    if ps is not None and gs is not None and all(len(s) == 1 for s in states):
        return ([ps], [gs], *states)
    return ([p.detach() for p in params], [g.detach() for g in grads],
            *(_leaf_views(s, params) for s in states))


def _state_like(params: List[torch.Tensor], fill: float = 0.0) -> List[torch.Tensor]:
    """A state buffer filled with ``fill``: one flat buffer when ``params``
    tile one (the engine's leaves), else one tensor a leaf."""
    span = _span(params)
    return [torch.full_like(s, fill) for s in ([span] if span is not None else params)]


def _leaf_views(bufs: List[torch.Tensor], params: List[torch.Tensor]) -> List[torch.Tensor]:
    """The views, shaped like ``params``, of tensors laid out as
    ``_state_like(params)``."""
    if len(bufs) == len(params):
        return [b.view(p.shape) for b, p in zip(bufs, params)]
    parts = bufs[0].split([p.numel() for p in params])
    return [x.view(p.shape) for x, p in zip(parts, params)]


def _advance(count: torch.Tensor, finite: Optional[torch.Tensor]) -> torch.Tensor:
    """Count this update (not where ``finite`` is false); returns ``t`` as
    fp32, the exponent of the bias corrections."""
    count += 1 if finite is None else finite.to(count.dtype)
    return count.float()


def _count(params: List[torch.Tensor]) -> torch.Tensor:
    return torch.zeros((), dtype=torch.int32, device=params[0].device)


def slot_state(params: List[torch.Tensor], fill: float,
               idx: Optional[List[int]]) -> List[torch.Tensor]:
    """One slot's state filled with ``fill``: over every leaf laid out as
    ``_state_like`` (``idx`` None), else over the leaves ``idx``, one flat
    buffer with a view each."""
    if idx is None:
        return _state_like(params, fill)
    sub = [params[i] for i in idx]
    buf = torch.full((sum(t.numel() for t in sub),), fill, dtype=torch.float32,
                     device=params[0].device)
    return _leaf_views([buf], sub) if sub else []


def set_path(tree: Dict[str, Any], path, value) -> None:
    for key in path[:-1]:
        tree = tree.setdefault(key, {})
    tree[path[-1]] = value


class _Rule:
    """What the rules share: ``SLOTS`` (path -> initial value, each slot
    over every leaf unless ``slots`` says otherwise), ``ELEMENTWISE``, and
    ``init`` built from them."""

    SLOTS: Dict[tuple, float] = {}
    ELEMENTWISE = True

    def slots(self, params: List[torch.Tensor]):
        """``[(path, initial value, leaves)]``: ``leaves`` None for a slot
        over every leaf (``_state_like``), else the indices of the leaves it
        covers, a view each (``slot_state``)."""
        return [(path, fill, None) for path, fill in self.SLOTS.items()]

    def init(self, params: List[torch.Tensor]) -> Dict[str, Any]:
        state: Dict[str, Any] = {"count": _count(params)}
        for path, fill, idx in self.slots(params):
            set_path(state, path, slot_state(params, fill, idx))
        return state


class Adam(_Rule):
    """optax ``adamw`` (``weight_decay`` > 0) or ``adam`` (0), through K8."""

    SLOTS = {("mu",): 0.0, ("nu",): 0.0}

    def __init__(self, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                 weight_decay: float = 0.0):
        self.b1, self.b2, self.eps, self.wd = b1, b2, eps, weight_decay

    @torch.no_grad()
    def step(self, params, grads, state, lr: torch.Tensor, finite=None) -> None:
        _advance(state["count"], finite)  # t of this update
        for p, g, m, v in zip(*_aligned(params, grads, state["mu"], state["nu"])):
            fused_adamw_flat(p, g, m, v, lr, state["count"], self.b1, self.b2, self.eps,
                             self.wd, finite)


class Lamb(_Rule):
    """optax ``lamb``: ``scale_by_adam`` -> ``add_decayed_weights`` ->
    ``scale_by_trust_ratio`` (per leaf) -> the learning rate."""

    SLOTS = {("mu",): 0.0, ("nu",): 0.0}
    ELEMENTWISE = False  # the trust ratio's per-leaf norms

    def __init__(self, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                 weight_decay: float = 0.0):
        self.b1, self.b2, self.eps, self.wd = b1, b2, eps, weight_decay

    @torch.no_grad()
    def step(self, params, grads, state, lr: torch.Tensor, finite=None) -> None:
        b1, b2 = self.b1, self.b2
        t = _advance(state["count"], finite)
        bc1, bc2 = 1.0 - torch.pow(b1, t), 1.0 - torch.pow(b2, t)
        upd = []
        for p, g, m, v in zip(*_aligned(params, grads, state["mu"], state["nu"])):
            m_new = (1.0 - b1) * g + b1 * m
            v_new = (1.0 - b2) * g.square() + b2 * v
            upd.append((m_new / bc1) / (torch.sqrt(v_new / bc2) + self.eps) + self.wd * p)
            _assign(m, m_new, finite)
            _assign(v, v_new, finite)
        for p, u in zip(params, _leaf_views(upd, params)):
            p = p.detach()
            pn, un = torch.linalg.vector_norm(p), torch.linalg.vector_norm(u)
            ratio = torch.where((pn == 0) | (un == 0), 1.0, pn / un)
            _assign(p, p - lr * (u * ratio), finite)


class Lion(_Rule):
    """optax ``lion`` (+ ``add_decayed_weights``)."""

    SLOTS = {("mu",): 0.0}

    def __init__(self, b1: float = 0.9, b2: float = 0.99, weight_decay: float = 0.0):
        self.b1, self.b2, self.wd = b1, b2, weight_decay

    @torch.no_grad()
    def step(self, params, grads, state, lr: torch.Tensor, finite=None) -> None:
        b1, b2 = self.b1, self.b2
        _advance(state["count"], finite)
        for p, g, m in zip(*_aligned(params, grads, state["mu"])):
            u = torch.sign((1.0 - b1) * g + b1 * m)
            if self.wd:
                u = u + self.wd * p
            _assign(m, (1.0 - b2) * g + b2 * m, finite)
            _assign(p, p - lr * u, finite)


class Adagrad(_Rule):
    """optax ``adagrad`` (``scale_by_rss`` from 0.1, then the learning
    rate)."""

    INITIAL_ACCUMULATOR = 0.1
    SLOTS = {("sum_of_squares",): INITIAL_ACCUMULATOR}

    def __init__(self, eps: float = 1e-10):
        self.eps = eps

    @torch.no_grad()
    def step(self, params, grads, state, lr: torch.Tensor, finite=None) -> None:
        _advance(state["count"], finite)
        for p, g, acc in zip(*_aligned(params, grads, state["sum_of_squares"])):
            acc_new = g.square() + acc
            u = torch.where(acc_new > 0, torch.rsqrt(acc_new + self.eps), 0.0) * g
            _assign(acc, acc_new, finite)
            _assign(p, p - lr * u, finite)


@contextmanager
def fp32_products():
    """fp32 matmuls at full precision (no TF32) inside the block."""
    old = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(old)


def newton_schulz(x: torch.Tensor, coeffs=(3.4445, -4.7750, 2.0315), steps: int = 5,
                  eps: float = 1e-8) -> torch.Tensor:
    """optax ``orthogonalize_via_newton_schulz`` of a 2-D ``x``, its products
    in the same order."""
    c0, c1, c2 = coeffs
    transposed = x.shape[0] > x.shape[1]
    if transposed:
        x = x.T
    x = x / (torch.linalg.vector_norm(x) + eps)
    for _ in range(steps):
        a = x @ x.T
        b = c1 * a + (c2 * a) @ a
        x = c0 * x + b @ x
    return x.T if transposed else x


class Muon(_Rule):
    """``optax.contrib.muon(lr)``: Muon on the 2-D leaves, NAdamW on the
    others.  State: ``count`` (both of optax's counts), ``muon.mu`` over the
    2-D leaves and ``adam.mu`` / ``adam.nu`` over the others, each one flat
    buffer with a view a leaf."""

    ELEMENTWISE = False  # Newton-Schulz over each 2-D leaf

    def __init__(self, beta: float = 0.95, eps: float = 1e-8, ns_steps: int = 5,
                 adam_b1: float = 0.9, adam_b2: float = 0.999):
        self.beta, self.eps, self.ns_steps = beta, eps, ns_steps
        self.b1, self.b2 = adam_b1, adam_b2

    @staticmethod
    def _split(tensors):
        muon = [x for x in tensors if x.dim() == 2]
        return muon, [x for x in tensors if x.dim() != 2]

    def slots(self, params: List[torch.Tensor]):
        two_d = [i for i, p in enumerate(params) if p.dim() == 2]
        other = [i for i, p in enumerate(params) if p.dim() != 2]
        return [(("muon", "mu"), 0.0, two_d), (("adam", "mu"), 0.0, other),
                (("adam", "nu"), 0.0, other)]

    @torch.no_grad()
    def step(self, params, grads, state, lr: torch.Tensor, finite=None) -> None:
        t = _advance(state["count"], finite)
        (mp, ap), (mg, ag) = self._split(params), self._split(grads)
        beta = self.beta
        bc, bc_next = 1.0 - torch.pow(beta, t), 1.0 - torch.pow(beta, t + 1)
        with fp32_products():
            for p, g, m in zip(mp, mg, state["muon"]["mu"]):
                p = p.detach()
                m_new = (1.0 - beta) * g + beta * m
                mu_hat = beta * (m_new / bc_next) + (1.0 - beta) * (g / bc)
                o = newton_schulz(mu_hat, steps=self.ns_steps, eps=self.eps)
                o = math.sqrt(max(1.0, p.shape[1] / p.shape[0])) * o
                _assign(m, m_new, finite)
                _assign(p, p - lr * o, finite)
        b1, b2 = self.b1, self.b2
        bc1, bc1_next = 1.0 - torch.pow(b1, t), 1.0 - torch.pow(b1, t + 1)
        bc2 = 1.0 - torch.pow(b2, t)
        for p, g, m, v in zip(ap, ag, state["adam"]["mu"], state["adam"]["nu"]):
            p = p.detach()
            m_new = (1.0 - b1) * g + b1 * m
            v_new = (1.0 - b2) * g.square() + b2 * v
            mu_hat = b1 * (m_new / bc1_next) + (1.0 - b1) * (g / bc1)
            u = mu_hat / (torch.sqrt(v_new / bc2) + self.eps)
            _assign(m, m_new, finite)
            _assign(v, v_new, finite)
            _assign(p, p - lr * u, finite)


class SGD(_Rule):
    """optax ``sgd`` (``trace`` momentum, optionally Nesterov)."""

    SLOTS = {("trace",): 0.0}

    def __init__(self, momentum: float = 0.0, nesterov: bool = False):
        self.momentum, self.nesterov = momentum, nesterov

    @torch.no_grad()
    def step(self, params, grads, state, lr: torch.Tensor, finite=None) -> None:
        for p, g, buf in zip(*_aligned(params, grads, state["trace"])):
            new_buf = g + self.momentum * buf
            upd = g + self.momentum * new_buf if self.nesterov else new_buf
            _assign(buf, new_buf, finite)
            _assign(p, p - lr * upd, finite)
        _advance(state["count"], finite)


def build_optimizer(type_name: str, params: Optional[Dict[str, Any]] = None):
    """The update rule of config ``optimizer: {type, params}``; the learning
    rate is the engine's schedule, passed to ``step``."""
    params = dict(params or {})
    name = type_name.lower().replace("_", "")
    if name in _ENGINE_ONLY:
        raise NotImplementedError(
            f"optimizer {type_name!r} is the engine's compressed step across ranks "
            "(runtime/onebit.py): initialize() runs it in a process world")
    betas = params.get("betas", (0.9, 0.999))
    eps = params.get("eps", 1e-8)
    wd = params.get("weight_decay", 0.0)
    if name in _ADAM_NAMES:
        return Adam(b1=betas[0], b2=betas[1], eps=eps, weight_decay=wd)
    if name in ("lamb", "fusedlamb"):
        return Lamb(b1=betas[0], b2=betas[1], eps=eps, weight_decay=wd)
    if name in ("lion", "fusedlion"):
        b = params.get("betas", (0.9, 0.99))
        return Lion(b1=b[0], b2=b[1], weight_decay=wd)
    if name == "adagrad":
        return Adagrad(eps=params.get("eps", 1e-10))
    if name == "muon":
        return Muon()
    if name == "sgd":
        return SGD(momentum=params.get("momentum", 0.0), nesterov=params.get("nesterov", False))
    raise ValueError(f"unknown optimizer type '{type_name}'")

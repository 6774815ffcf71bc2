"""Fused AdamW — counterpart of ``deepspeed_tpu/ops/pallas/fused_adam.py``
(``fused_adamw_flat`` :46, ``fused_adamw_tree`` :74).

``fused_adamw_flat`` is one bias-corrected AdamW pass over fp32 buffers
(``csrc/fused_adam.cu`` on CUDA tensors, its plain version on CPU ones).
Unlike the JAX function, which returns new buffers, it updates ``p``, ``m``
and ``v`` in place (and returns them): the optimizer state is the largest
thing the training step keeps, and a copy of it a step is what the fusion
exists to avoid.  ``lr`` and ``step`` (the 1-based update count ``t``) may
be device scalars, and ``finite`` (the fp16 overflow flag, a device bool)
makes the whole update a no-op where it is false, so an engine step never
waits on the host.  Any length works (the TPU kernel's ``N % 128`` and its
block-halving loop have no counterpart).

``fused_adamw_tree`` ravels dicts of tensors into flat buffers, updates
them and unravels new dicts, as JAX's does with ``ravel_pytree``.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import torch

from . import launch, ptr


def _scalar(x, dtype, device) -> torch.Tensor:
    """A one-element ``dtype`` tensor on ``device`` (no copy when it is one)."""
    if torch.is_tensor(x):
        return x.to(device=device, dtype=dtype).reshape(())
    return torch.tensor(x, dtype=dtype, device=device)


def fused_adamw_flat_plain(p, g, m, v, lr, step, b1=0.9, b2=0.999, eps=1e-8, wd=0.0,
                           finite: Optional[torch.Tensor] = None):
    """The kernel's function in PyTorch, in place on ``p``, ``m``, ``v`` (any
    shape, fp32): optax's adamw update for ``t = step``."""
    t = _scalar(step, torch.float32, p.device)
    lr = _scalar(lr, torch.float32, p.device)
    bc1 = 1.0 - torch.pow(b1, t)
    bc2 = 1.0 - torch.pow(b2, t)
    m_new = m * b1 + g * (1.0 - b1)
    v_new = v * b2 + g.square() * (1.0 - b2)
    upd = (m_new / bc1) / (torch.sqrt(v_new / bc2) + eps)
    if wd:
        upd = upd + wd * p
    p_new = p - lr * upd
    for dst, new in ((m, m_new), (v, v_new), (p, p_new)):
        dst.copy_(new if finite is None else torch.where(finite, new, dst))
    return p, m, v


def fused_adamw_kernel(p, g, m, v, lr, step, b1=0.9, b2=0.999, eps=1e-8, wd=0.0,
                       finite: Optional[torch.Tensor] = None):
    """K8 on CUDA tensors, in place; one launch."""
    dev = p.device
    for name, t in (("p", p), ("g", g), ("m", m), ("v", v)):
        if t.device != dev or t.device.type != "cuda":
            raise ValueError(f"fused_adamw: {name} on {t.device}, needs CUDA ({dev})")
        if t.dtype != torch.float32:
            raise TypeError(f"fused_adamw: {name} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"fused_adamw: {name} must be contiguous")
        if t.numel() != p.numel():
            raise ValueError(f"fused_adamw: {name} has {t.numel()} elements, p {p.numel()}")
    lr = _scalar(lr, torch.float32, dev)
    step = _scalar(step, torch.int32, dev)
    if finite is not None:
        finite = _scalar(finite, torch.bool, dev)
    f = ctypes.c_float
    launch("fused_adamw", ptr(p), ptr(g), ptr(m), ptr(v), ctypes.c_longlong(p.numel()),
           ptr(lr), ptr(step), ptr(finite), f(b1), f(b2), f(1.0 - b1), f(1.0 - b2), f(eps),
           f(wd))
    return p, m, v


def fused_adamw_flat(p, g, m, v, lr, step, b1: float = 0.9, b2: float = 0.999,
                     eps: float = 1e-8, wd: float = 0.0,
                     finite: Optional[torch.Tensor] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """fp32 buffers of one length -> (p, m, v) updated in place: K8 on a
    CUDA tensor, the plain version on a CPU one."""
    if p.device.type == "cpu":
        return fused_adamw_flat_plain(p, g, m, v, lr, step, b1, b2, eps, wd, finite)
    return fused_adamw_kernel(p, g, m, v, lr, step, b1, b2, eps, wd, finite)


def _ravel(tree: Dict) -> Tuple[torch.Tensor, list]:
    leaves, paths = [], []

    def walk(node, path):
        for key, val in node.items():
            if isinstance(val, dict):
                walk(val, path + (key,))
            else:
                leaves.append(val)
                paths.append((path + (key,), val.shape))

    walk(tree, ())
    return torch.cat([x.reshape(-1).float() for x in leaves]), paths


def _unravel(flat: torch.Tensor, paths: list) -> Dict:
    out: Dict = {}
    off = 0
    for path, shape in paths:
        n = 1
        for d in shape:
            n *= d
        node = out
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = flat[off:off + n].reshape(shape)
        off += n
    return out


def fused_adamw_tree(params, grads, m_tree, v_tree, lr, step, **kw):
    """Dicts of tensors -> (new params, new m, new v): ravel into flat fp32
    buffers, one ``fused_adamw_flat``, unravel.  The inputs are not
    changed."""
    pf, paths = _ravel(params)
    gf, _ = _ravel(grads)
    mf, _ = _ravel(m_tree)
    vf, _ = _ravel(v_tree)
    pf, mf, vf = fused_adamw_flat(pf, gf, mf, vf, lr, step, **kw)
    return _unravel(pf, paths), _unravel(mf, paths), _unravel(vf, paths)

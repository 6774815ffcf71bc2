"""LoRA / OptimizedLinear: parameter-efficient fine-tuning — counterpart of
``deepspeed_tpu/linear/lora.py`` (the reference's
``linear/optimized_linear.py:18 OptimizedLinear``, ``:76
LoRAOptimizedLinear``).

As in JAX there is no module surgery: a model wrapper keeps a ``lora``
subtree beside the frozen ``base`` parameters, ``{"base": <the model's
tree>, "lora": {"layers.attn.wq": {"a", "b"}, ...}}`` (adapter keys are the
base paths with dots, as JAX writes them), and merges ``W + (alpha / r) *
A @ B`` inside the loss: ``(base.float() + (a.float() @ b.float()) *
scale).to(base.dtype)``, a plain product.  ``trainable_mask`` marks the
base frozen; the engine then keeps fp32 masters, gradients and optimizer
state for the adapters alone, and leaves the base in its storage type
without ``requires_grad`` (``runtime/engine.py``), so no base gradient is
computed at all (JAX stops it and masks its update).
"""
from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch

from ..utils.logging import log_dist

DEFAULT_TARGETS = (r"layers/attn/w[qkvo]$", r"layers/(mlp|moe)/w_(gate|up|down)$")


@dataclass
class LoRAConfig:
    """The reference's ``LoRAConfig``: rank, alpha, the target leaves
    (regexes over JAX's flat paths) and the frozen base's storage type."""

    lora_r: int = 8
    lora_alpha: float = 16.0
    target_modules: Sequence[str] = DEFAULT_TARGETS
    base_dtype: torch.dtype = torch.bfloat16

    @property
    def scale(self) -> float:
        return self.lora_alpha / self.lora_r


def _match(path: str, patterns: Sequence[str]) -> bool:
    return any(re.search(p, path) for p in patterns)


def _paths_and_leaves(tree, prefix: str = ""):
    """``(path, leaf)`` in JAX's order (sorted keys)."""
    for k in sorted(tree):
        v = tree[k]
        path = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, dict):
            yield from _paths_and_leaves(v, path)
        else:
            yield path, v


def _map_tree(tree, fn, prefix: str = ""):
    return {k: _map_tree(v, fn, f"{prefix}/{k}" if prefix else str(k))
            if isinstance(v, dict) else fn(f"{prefix}/{k}" if prefix else str(k), v)
            for k, v in tree.items()}


class LoRACausalLM:
    """Any model adapter (``CausalLM``-shaped) with LoRA adapters.
    ``trainable_mask(params)`` is what ``initialize`` hands the engine."""

    def __init__(self, inner, lora_config: Optional[LoRAConfig] = None):
        self.inner = inner
        self.cfg = getattr(inner, "cfg", None)
        self.lora = lora_config or LoRAConfig()

    def init_params(self, seed: int = 0, device=None):
        """The inner model's parameters cast to ``base_dtype``, and for each
        target leaf ``[..., in, out]`` an ``a [..., in, r]`` drawn normal /
        sqrt(in) and a zero ``b [..., r, out]`` (the adapter starts as the
        identity), fp32, from a ``torch.Generator`` seeded with ``seed``."""
        base = self.inner.init_params(seed=seed, device=device)
        base = _map_tree(base, lambda _, x: x.to(self.lora.base_dtype)
                         if x.is_floating_point() else x)
        first = next(_paths_and_leaves(base))[1]
        gen = torch.Generator(device=first.device).manual_seed(seed + 1)
        lora: Dict[str, Dict[str, torch.Tensor]] = {}
        for path, leaf in _paths_and_leaves(base):
            if leaf.dim() < 2 or not _match(path, self.lora.target_modules):
                continue
            *lead, fan_in, fan_out = leaf.shape
            r = self.lora.lora_r
            a = torch.randn((*lead, fan_in, r), generator=gen, device=leaf.device,
                            dtype=torch.float32) / float(np.sqrt(fan_in))
            b = torch.zeros((*lead, r, fan_out), device=leaf.device, dtype=torch.float32)
            lora[path.replace("/", ".")] = {"a": a, "b": b}
        if not lora:
            raise ValueError(
                f"no parameters matched LoRA target_modules {self.lora.target_modules}")
        n = sum(t.numel() for g in lora.values() for t in g.values())
        log_dist(f"LoRA: {len(lora)} adapted tensors, {n / 1e6:.2f}M trainable params")
        return {"base": base, "lora": lora}

    def merge(self, params):
        """The base tree with ``base + scale * a @ b`` on the adapted leaves,
        each in the base leaf's type."""
        lora = params["lora"]

        def one(path, leaf):
            key = path.replace("/", ".")
            if key not in lora:
                return leaf
            delta = (lora[key]["a"].float() @ lora[key]["b"].float()) * self.lora.scale
            return (leaf.float() + delta).to(leaf.dtype)

        return _map_tree(params["base"], one)

    def loss_fn(self, params, batch, rng=None):
        return self.inner.loss_fn(self.merge(params), batch, rng)

    def prepare_batch(self, batch, rng=None):
        return self.inner.prepare_batch(batch, rng)

    def trainable_mask(self, params) -> Any:
        """True for the adapters, False for the base."""
        return {"base": _map_tree(params["base"], lambda *_: False),
                "lora": _map_tree(params["lora"], lambda *_: True)}

    @property
    def param_count(self):
        return getattr(self.inner, "param_count", 0)

    def flops_per_token(self, seq_len: int) -> float:
        return getattr(self.inner, "flops_per_token", lambda s: 0.0)(seq_len)

    @torch.no_grad()
    def export_merged(self, params):
        """The merged weights (deploy without the adapters; the reference's
        LoRA fuse, ``runtime/hybrid_engine.py:132``)."""
        return self.merge(params)


def lora_params_from_numpy(tree, device=None, base_dtype: Optional[torch.dtype] = None):
    """JAX's LoRA tree (``LoRACausalLM.init_params``, after
    ``jax.tree_util.tree_map(np.asarray, ...)``) as the port's: the same
    nested dict, the base in ``base_dtype`` (default: the arrays' own
    floating type, bf16 through an fp32 copy) and the adapters in fp32, on
    ``device`` (CUDA unless the caller names another)."""
    from ..ops.kernels import resolve_device

    device = resolve_device(device)

    def conv(node, dtype):
        if isinstance(node, dict):
            return {k: conv(v, dtype) for k, v in node.items()}
        a = np.asarray(node)
        want = dtype
        if want is None:
            want = torch.bfloat16 if a.dtype.name == "bfloat16" else torch.float32
        return torch.from_numpy(np.array(a, dtype=np.float32)).to(device=device, dtype=want)

    return {"base": conv(tree["base"], base_dtype), "lora": conv(tree["lora"], torch.float32)}


def optimized_linear(x, base_w, lora_a=None, lora_b=None, scale: float = 1.0):
    """The functional ``OptimizedLinear``: ``x @ W`` plus the low-rank
    adapter ``(x @ a) @ b * scale``."""
    y = x @ base_w
    if lora_a is not None and lora_b is not None:
        y = y + (x @ lora_a.to(x.dtype)) @ lora_b.to(x.dtype) * scale
    return y

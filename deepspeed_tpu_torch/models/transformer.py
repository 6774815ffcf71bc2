"""Decoder-only transformer building blocks — counterpart of
``deepspeed_tpu/models/transformer.py`` (the subset serving reads).

Parameters keep the JAX layout so converting a JAX checkpoint is a copy: a
nested dict with stacked ``[L, ...]`` layer weights and ``[in, out]``
kernels (``params_from_numpy``).  The training half (forward, remat, loss)
comes with the training slice.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

Params = Dict[str, Any]


@dataclass(frozen=True)
class TransformerConfig:
    vocab_size: int = 32000
    hidden_size: int = 512
    intermediate_size: int = 1408
    num_layers: int = 4
    num_heads: int = 8
    num_kv_heads: int = 8  # < num_heads => GQA
    head_dim: Optional[int] = None  # default hidden_size // num_heads
    max_seq_len: int = 2048
    norm: str = "rmsnorm"  # 'rmsnorm' | 'layernorm'
    activation: str = "silu"  # 'silu' | 'gelu' | 'relu'
    gated_mlp: bool = True
    position: str = "rope"  # 'rope' | 'learned' | 'alibi' | 'none'
    rope_theta: float = 500_000.0
    rotary_dim: Optional[int] = None
    qkv_bias: bool = False
    tie_embeddings: bool = False
    norm_eps: float = 1e-5
    logits_soft_cap: Optional[float] = None
    parallel_block: bool = False
    attn_out_bias: bool = False
    mlp_bias: bool = False
    embedding_norm: bool = False
    head_bias: bool = False
    moe_num_experts: int = 0
    dtype: torch.dtype = torch.bfloat16

    @property
    def hd(self) -> int:
        return self.head_dim or self.hidden_size // self.num_heads

    def replace(self, **kw) -> "TransformerConfig":
        return dataclasses.replace(self, **kw)


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------
def init_params(cfg: TransformerConfig, seed: int = 0, device=None,
                dtype: Optional[torch.dtype] = None) -> Params:
    """Random parameters in the JAX layout (normal / sqrt(fan_in), norms at
    1, biases at 0), drawn from a ``torch.Generator`` seeded with ``seed``.
    The numbers differ from JAX ``init_params`` for the same seed; tests
    that compare the two packages use ``params_from_numpy`` instead."""
    if cfg.moe_num_experts:
        raise NotImplementedError("MoE layers are not ported yet")
    dtype = dtype or cfg.dtype
    device = torch.device(device) if device is not None else torch.device("cpu")
    gen = torch.Generator(device=device).manual_seed(seed)
    d, f, L, v = cfg.hidden_size, cfg.intermediate_size, cfg.num_layers, cfg.vocab_size
    hq, hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.hd

    def dense(shape, fan_in):
        w = torch.randn(shape, generator=gen, device=device, dtype=torch.float32)
        return (w * fan_in ** -0.5).to(dtype)

    def const(shape, val):
        return torch.full(shape, val, device=device, dtype=dtype)

    layers: Params = {
        "attn": {
            "wq": dense((L, d, hq * hd), d),
            "wk": dense((L, d, hkv * hd), d),
            "wv": dense((L, d, hkv * hd), d),
            "wo": dense((L, hq * hd, d), hq * hd),
        },
        "attn_norm": {"scale": const((L, d), 1.0)},
        "mlp_norm": {"scale": const((L, d), 1.0)},
        "mlp": {"w_up": dense((L, d, f), d), "w_down": dense((L, f, d), f)},
    }
    if cfg.gated_mlp:
        layers["mlp"]["w_gate"] = dense((L, d, f), d)
    if cfg.qkv_bias:
        for name, width in (("bq", hq * hd), ("bk", hkv * hd), ("bv", hkv * hd)):
            layers["attn"][name] = const((L, width), 0.0)
    if cfg.attn_out_bias:
        layers["attn"]["bo"] = const((L, d), 0.0)
    if cfg.mlp_bias:
        layers["mlp"]["b_up"] = const((L, f), 0.0)
        layers["mlp"]["b_down"] = const((L, d), 0.0)
        if cfg.gated_mlp:
            layers["mlp"]["b_gate"] = const((L, f), 0.0)
    params: Params = {
        "embed": {"embedding": dense((v, d), d)},
        "layers": layers,
        "final_norm": {"scale": const((d,), 1.0)},
    }
    if cfg.position == "learned":
        params["pos_embed"] = {"embedding": dense((cfg.max_seq_len, d), d)}
    if cfg.embedding_norm:
        params["embed_norm"] = {"scale": const((d,), 1.0)}
    if cfg.norm == "layernorm":
        for blk in (layers["attn_norm"], layers["mlp_norm"], params["final_norm"]):
            blk["bias"] = torch.zeros_like(blk["scale"])
        if cfg.embedding_norm:
            params["embed_norm"]["bias"] = const((d,), 0.0)
    if not cfg.tie_embeddings:
        params["lm_head"] = {"kernel": dense((d, v), d)}
        if cfg.head_bias:
            params["lm_head"]["bias"] = const((v,), 0.0)
    return params


def params_from_numpy(tree, cfg: TransformerConfig, device=None,
                      dtype: Optional[torch.dtype] = None) -> Params:
    """The JAX parameter tree, after ``jax.tree_util.tree_map(np.asarray,
    ...)`` (a nested dict of numpy arrays), as the port's parameters: the
    same nested dict of tensors on ``device`` in ``dtype`` (default
    ``cfg.dtype``).  The layouts are identical, so this is a copy."""
    dtype = dtype or cfg.dtype
    device = torch.device(device) if device is not None else torch.device("cpu")

    def conv(x):
        if isinstance(x, dict):
            return {k: conv(v) for k, v in x.items()}
        a = np.array(x, dtype=np.float32)  # a writable copy
        return torch.from_numpy(a).to(device=device, dtype=dtype)

    params = conv(tree)
    if "moe" in params.get("layers", {}):
        raise NotImplementedError("MoE layers are not ported yet")
    return params


# ---------------------------------------------------------------------------
# building blocks
# ---------------------------------------------------------------------------
def norm(x: torch.Tensor, w: Params, kind: str, eps: float) -> torch.Tensor:
    """RMS/LayerNorm: fp32 math, cast back to ``x``'s type, then ``* scale``
    (+ bias) — the JAX order of operations."""
    xf = x.float()
    if kind == "rmsnorm":
        xf = xf * torch.rsqrt(xf.pow(2).mean(-1, keepdim=True) + eps)
    else:
        mu = xf.mean(-1, keepdim=True)
        var = (xf - mu).pow(2).mean(-1, keepdim=True)
        xf = (xf - mu) * torch.rsqrt(var + eps)
    out = xf.to(x.dtype) * w["scale"]
    if "bias" in w:
        out = out + w["bias"]
    return out


def rope_tables(positions: torch.Tensor, d: int, theta: float):
    """(cos, sin) [b, s, 1, d/2] for per-token ``positions`` [b, s] or [s];
    computed once per dispatch and shared by every layer's q and k."""
    freqs = 1.0 / (theta ** (torch.arange(0, d, 2, dtype=torch.float32,
                                          device=positions.device) / d))
    if positions.dim() == 1:
        positions = positions[None, :]
    angles = positions[:, :, None].float() * freqs[None, None, :]
    return torch.cos(angles)[:, :, None, :], torch.sin(angles)[:, :, None, :]


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Half-split rotation (NOT interleaved), fp32, cast back."""
    x1, x2 = x.float().chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding, [b, s, h, d] with ``positions`` [b, s] or [s]."""
    return apply_rope(x, *rope_tables(positions, x.shape[-1], theta))


def _activation(name: str):
    return {
        "silu": F.silu,
        "gelu": lambda x: F.gelu(x, approximate="tanh"),
        "relu": F.relu,
    }[name]


def mlp_block(lw: Params, x: torch.Tensor, cfg: TransformerConfig) -> torch.Tensor:
    act = _activation(cfg.activation)
    up = x @ lw["w_up"]
    if "b_up" in lw:
        up = up + lw["b_up"]
    if cfg.gated_mlp:
        gate = x @ lw["w_gate"]
        if "b_gate" in lw:
            gate = gate + lw["b_gate"]
        h = act(gate) * up
    else:
        h = act(up)
    out = h @ lw["w_down"]
    if "b_down" in lw:
        out = out + lw["b_down"]
    return out


def head_kernel(params: Params, cfg: TransformerConfig) -> torch.Tensor:
    """[d, v] output projection (transposed embedding when tied)."""
    if cfg.tie_embeddings:
        return params["embed"]["embedding"].t().to(cfg.dtype)
    return params["lm_head"]["kernel"]


def head_bias_vec(params: Params):
    """[v] lm_head bias or None."""
    lm = params.get("lm_head")
    return lm.get("bias") if lm else None

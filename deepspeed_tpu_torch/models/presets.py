"""Named architecture presets — counterpart of ``deepspeed_tpu/models/
presets.py``.  Ported so far: the flagship of the serving and training
slices, Llama-3-8B (quantized serving), GPT-2 small (serving at head_dim
64) and the test configs; other families follow with the modules they
need."""
from __future__ import annotations

from .transformer import TransformerConfig

_REGISTRY = {}


def register(name: str, cfg: TransformerConfig) -> TransformerConfig:
    _REGISTRY[name] = cfg
    return cfg


def get_preset(name: str, **overrides) -> TransformerConfig:
    cfg = _REGISTRY[name]
    return cfg.replace(**overrides) if overrides else cfg


# Llama-3-8B: served with int8 / fp8 / fp6 weights on one card (its bf16
# weights alone are 15 GB).  Training refuses remat="dots" (not ported).
register("llama3_8b", TransformerConfig(
    vocab_size=128256, hidden_size=4096, intermediate_size=14336, num_layers=32,
    num_heads=32, num_kv_heads=8, max_seq_len=8192, rope_theta=500_000.0,
    remat="dots", attn_impl="auto"))

# ~410M-parameter Llama-3-shaped model: GQA 4:1, head_dim 128, RMSNorm,
# SwiGLU, RoPE (the repository's serving and training benchmark model);
# trains with selective remat and the flash kernels, as in JAX
register("llama3_proxy_410m", TransformerConfig(
    vocab_size=32128, hidden_size=1024, intermediate_size=4096, num_layers=24,
    num_heads=8, num_kv_heads=2, max_seq_len=4096, rope_theta=500_000.0,
    remat="selective", attn_impl="auto"))

# GPT-2 small: LayerNorm, learned positions, GELU, tied embeddings, 12
# heads of 64 with no GQA (the port's only served preset at head_dim 64)
register("gpt2_small", TransformerConfig(
    vocab_size=50257, hidden_size=768, intermediate_size=3072, num_layers=12,
    num_heads=12, num_kv_heads=12, max_seq_len=1024, norm="layernorm",
    activation="gelu", gated_mlp=False, position="learned", tie_embeddings=True))

# tiny configs for tests
register("tiny", TransformerConfig(
    vocab_size=256, hidden_size=64, intermediate_size=128, num_layers=2,
    num_heads=4, num_kv_heads=2, max_seq_len=128))
register("tiny_gpt2", TransformerConfig(
    vocab_size=256, hidden_size=64, intermediate_size=128, num_layers=2,
    num_heads=4, num_kv_heads=4, max_seq_len=128, norm="layernorm",
    activation="gelu", gated_mlp=False, position="learned", tie_embeddings=True))

"""Named architecture presets — counterpart of ``deepspeed_tpu/models/
presets.py``, every JAX preset whose layers the port has, with JAX's field
values: the Llama, Mistral, Mixtral, Qwen-2, Falcon, GPT-J, Phi-2,
GPT-NeoX, Bloom, OPT and GPT-2 families, the 410M flagship and the test
configs.

``mixtral_8x7b`` and ``tiny_moe`` run their routed experts on one card
(expert-parallel width 1).  ``llama3_70b`` is registered for its
configuration; on one card its fp32 masters and moments do not fit (item 7
shards them).  ``phi_2`` (head
dim 80) and ``gpt_neox_20b`` (96) train through K1 padded to head dim 128
(``ops/kernels/flash_attention.py``).  Serving takes the presets without a
parallel block or ALiBi, as JAX's v2 engine does; the dense v1 engine
(``inference.init_inference``) serves every preset.
"""
from __future__ import annotations

from .transformer import TransformerConfig

_REGISTRY = {}


def register(name: str, cfg: TransformerConfig) -> TransformerConfig:
    _REGISTRY[name] = cfg
    return cfg


def get_preset(name: str, **overrides) -> TransformerConfig:
    cfg = _REGISTRY[name]
    return cfg.replace(**overrides) if overrides else cfg


def list_presets():
    return sorted(_REGISTRY)


# --- Llama family (RMSNorm + RoPE + SwiGLU (+GQA for v3)) -------------------
register("llama2_7b", TransformerConfig(
    vocab_size=32000, hidden_size=4096, intermediate_size=11008, num_layers=32,
    num_heads=32, num_kv_heads=32, max_seq_len=4096, rope_theta=10_000.0,
    remat="dots", attn_impl="auto"))
register("llama3_8b", TransformerConfig(
    vocab_size=128256, hidden_size=4096, intermediate_size=14336, num_layers=32,
    num_heads=32, num_kv_heads=8, max_seq_len=8192, rope_theta=500_000.0,
    remat="dots", attn_impl="auto"))
register("llama3_70b", TransformerConfig(
    vocab_size=128256, hidden_size=8192, intermediate_size=28672, num_layers=80,
    num_heads=64, num_kv_heads=8, max_seq_len=8192, rope_theta=500_000.0,
    remat="full", attn_impl="auto"))

# ~410M-parameter Llama-3-shaped model: GQA 4:1, head_dim 128, RMSNorm,
# SwiGLU, RoPE (the repository's serving and training benchmark model);
# trains with selective remat and the flash kernels, as in JAX
register("llama3_proxy_410m", TransformerConfig(
    vocab_size=32128, hidden_size=1024, intermediate_size=4096, num_layers=24,
    num_heads=8, num_kv_heads=2, max_seq_len=4096, rope_theta=500_000.0,
    remat="selective", attn_impl="auto"))

# --- Mistral ---------------------------------------------------------------
register("mistral_7b", TransformerConfig(
    vocab_size=32000, hidden_size=4096, intermediate_size=14336, num_layers=32,
    num_heads=32, num_kv_heads=8, max_seq_len=8192, rope_theta=10_000.0,
    remat="dots", attn_impl="auto"))
register("mixtral_8x7b", TransformerConfig(
    vocab_size=32000, hidden_size=4096, intermediate_size=14336, num_layers=32,
    num_heads=32, num_kv_heads=8, max_seq_len=8192, rope_theta=1_000_000.0,
    moe_num_experts=8, moe_top_k=2, remat="full", attn_impl="auto"))

# --- GPT-2 (LayerNorm + learned positions + GELU, tied embeddings) ----------
register("gpt2_small", TransformerConfig(
    vocab_size=50257, hidden_size=768, intermediate_size=3072, num_layers=12,
    num_heads=12, num_kv_heads=12, max_seq_len=1024, norm="layernorm",
    activation="gelu", gated_mlp=False, position="learned", tie_embeddings=True))

# --- Qwen-2 style (qkv bias) ------------------------------------------------
register("qwen2_7b", TransformerConfig(
    vocab_size=152064, hidden_size=3584, intermediate_size=18944, num_layers=28,
    num_heads=28, num_kv_heads=4, max_seq_len=8192, rope_theta=1_000_000.0,
    qkv_bias=True, remat="dots", attn_impl="auto"))

# --- Falcon (parallel attn+MLP, MQA, no biases) -----------------------------
register("falcon_7b", TransformerConfig(
    vocab_size=65024, hidden_size=4544, intermediate_size=18176, num_layers=32,
    num_heads=71, num_kv_heads=1, head_dim=64, max_seq_len=2048,
    norm="layernorm", activation="gelu", gated_mlp=False,
    parallel_block=True, rope_theta=10_000.0,
    remat="dots", attn_impl="auto"))

# --- GPT-J (parallel block, partial rotary, mlp biases) ---------------------
register("gptj_6b", TransformerConfig(
    vocab_size=50400, hidden_size=4096, intermediate_size=16384, num_layers=28,
    num_heads=16, num_kv_heads=16, max_seq_len=2048, rotary_dim=64,
    norm="layernorm", activation="gelu", gated_mlp=False,
    parallel_block=True, mlp_bias=True, rope_theta=10_000.0,
    remat="dots", attn_impl="auto"))

# --- Phi-2 (parallel block, partial rotary, biases everywhere) --------------
register("phi_2", TransformerConfig(
    vocab_size=51200, hidden_size=2560, intermediate_size=10240, num_layers=32,
    num_heads=32, num_kv_heads=32, max_seq_len=2048, rotary_dim=32,
    norm="layernorm", activation="gelu", gated_mlp=False,
    parallel_block=True, qkv_bias=True, attn_out_bias=True, mlp_bias=True,
    rope_theta=10_000.0, remat="dots", attn_impl="auto"))

# --- GPT-NeoX-20B (parallel residual, rotary_pct=0.25, biases) --------------
register("gpt_neox_20b", TransformerConfig(
    vocab_size=50432, hidden_size=6144, intermediate_size=24576, num_layers=44,
    num_heads=64, num_kv_heads=64, max_seq_len=2048, rotary_dim=24,
    norm="layernorm", activation="gelu", gated_mlp=False,
    parallel_block=True, qkv_bias=True, attn_out_bias=True, mlp_bias=True,
    rope_theta=10_000.0, remat="full", attn_impl="auto"))

# --- Bloom (ALiBi, embedding LN, all biases, tied) --------------------------
register("bloom_7b1", TransformerConfig(
    vocab_size=250880, hidden_size=4096, intermediate_size=16384, num_layers=30,
    num_heads=32, num_kv_heads=32, max_seq_len=2048, position="alibi",
    norm="layernorm", activation="gelu", gated_mlp=False,
    qkv_bias=True, attn_out_bias=True, mlp_bias=True, embedding_norm=True,
    tie_embeddings=True, remat="dots", attn_impl="reference"))

# --- OPT (learned positions, ReLU, all biases, tied) ------------------------
register("opt_6_7b", TransformerConfig(
    vocab_size=50272, hidden_size=4096, intermediate_size=16384, num_layers=32,
    num_heads=32, num_kv_heads=32, max_seq_len=2048, position="learned",
    norm="layernorm", activation="relu", gated_mlp=False,
    qkv_bias=True, attn_out_bias=True, mlp_bias=True, tie_embeddings=True,
    remat="dots", attn_impl="auto"))

# --- tiny configs for tests -------------------------------------------------
register("tiny", TransformerConfig(
    vocab_size=256, hidden_size=64, intermediate_size=128, num_layers=2,
    num_heads=4, num_kv_heads=2, max_seq_len=128))
register("tiny_moe", TransformerConfig(
    vocab_size=256, hidden_size=64, intermediate_size=128, num_layers=2,
    num_heads=4, num_kv_heads=2, max_seq_len=128,
    moe_num_experts=4, moe_top_k=2))
register("tiny_gpt2", TransformerConfig(
    vocab_size=256, hidden_size=64, intermediate_size=128, num_layers=2,
    num_heads=4, num_kv_heads=4, max_seq_len=128, norm="layernorm",
    activation="gelu", gated_mlp=False, position="learned", tie_embeddings=True))
register("tiny_parallel", TransformerConfig(
    # falcon/phi-shaped: parallel block, partial rotary, biases
    vocab_size=256, hidden_size=64, intermediate_size=128, num_layers=2,
    num_heads=4, num_kv_heads=4, max_seq_len=128, rotary_dim=8,
    norm="layernorm", activation="gelu", gated_mlp=False,
    parallel_block=True, qkv_bias=True, attn_out_bias=True, mlp_bias=True))
register("tiny_alibi", TransformerConfig(
    # bloom-shaped: alibi + embedding LN + biases, tied
    vocab_size=256, hidden_size=64, intermediate_size=128, num_layers=2,
    num_heads=4, num_kv_heads=4, max_seq_len=128, position="alibi",
    norm="layernorm", activation="gelu", gated_mlp=False,
    qkv_bias=True, attn_out_bias=True, mlp_bias=True, embedding_norm=True,
    tie_embeddings=True, attn_impl="reference"))

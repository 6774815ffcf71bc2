"""Mixture-of-Experts: gating and the routed expert layer — counterpart of
``deepspeed_tpu/moe/`` on one card (expert-parallel width 1)."""
from .layer import MoE, moe_block, moe_block_dropless, routed_ffn  # noqa: F401
from .sharded_moe import GatingResult, capacity_for, top1_gating, topk_gating  # noqa: F401

"""Compression: QAT weight quantization, activation quantization, pruning,
layer reduction and distillation (JAX ``deepspeed_tpu/compression/``)."""
from .compress import (  # noqa: F401
    CompressionManager,
    fake_quantize,
    init_compression,
    kd_loss,
    layer_reduction_init,
    magnitude_prune_mask,
    make_kd_loss_fn,
    quantize_activation,
    structured_keep_mask,
)

"""LoRA / OptimizedLinear (JAX ``deepspeed_tpu/linear/``, the reference's
``deepspeed/linear/``)."""
from .lora import LoRACausalLM, LoRAConfig, lora_params_from_numpy, optimized_linear  # noqa: F401

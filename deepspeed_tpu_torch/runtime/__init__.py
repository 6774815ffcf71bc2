"""Training runtime (counterpart of ``deepspeed_tpu/runtime``)."""

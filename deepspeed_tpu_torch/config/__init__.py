"""Training configuration (counterpart of ``deepspeed_tpu/config``)."""

"""The data pipeline's resumable sampler (JAX ``deepspeed_tpu/data/``)."""
from .sampler import DeepSpeedDataSampler, find_fit_int_dtype  # noqa: F401

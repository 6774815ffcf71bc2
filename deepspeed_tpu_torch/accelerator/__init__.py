"""The accelerator abstraction (JAX ``deepspeed_tpu/accelerator``)."""
from .cuda_accelerator import CudaAccelerator, get_accelerator  # noqa: F401

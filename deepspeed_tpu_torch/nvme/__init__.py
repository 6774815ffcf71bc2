"""Async file I/O and tensor swapping to local NVMe — counterpart of
``deepspeed_tpu/nvme`` (the reference's ``deepspeed/nvme`` ds_io bench,
``csrc/aio`` and ``runtime/swap_tensor``), over torch CPU tensors."""
from .aio import AsyncIOEngine  # noqa: F401
from .swap import TensorSwapper  # noqa: F401

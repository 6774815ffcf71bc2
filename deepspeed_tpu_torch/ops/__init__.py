"""Ops: attention reference body, serving matmul, and the CUDA kernels
(``ops.kernels``, the counterpart of ``deepspeed_tpu/ops/pallas``)."""

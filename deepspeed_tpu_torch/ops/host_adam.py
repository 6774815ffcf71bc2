"""Host (CPU) fused AdamW / Lion for offloaded optimizer state —
counterpart of ``deepspeed_tpu/ops/host_adam.py`` (the reference's
``DeepSpeedCPUAdam`` over ``csrc/adam/cpu_adam.cpp``).

They update contiguous fp32 CPU tensors in place, pinned or not, through
``csrc/host/host_adam.cpp`` (``ops/op_builder.py``).  bf16 gradients go
to ``host_adamw_bf16grad`` as their raw bits (a ``torch.int16`` view: no
upcast copy).  ``HostAdamW.step_count`` is incremented on every call and
is the bias correction's step, as in JAX: a caller that owns the step
(``runtime/offload.py``) sets it to ``step_num - 1`` first.
"""
from __future__ import annotations

from typing import Optional

import torch

from .op_builder import HostAdamBuilder


def _check(name: str, t: torch.Tensor, dtypes) -> None:
    if t.device.type != "cpu":
        raise ValueError(f"host optimizer: {name} on {t.device}, needs a CPU tensor")
    if t.dtype not in dtypes:
        raise TypeError(f"host optimizer: {name} has dtype {t.dtype}, needs one of {dtypes}")
    if not t.is_contiguous():
        raise ValueError("host adam buffers must be contiguous")


class HostAdamW:
    """In-place AdamW on host tensors (one instance a parameter group)."""

    def __init__(self, lr=1e-3, betas=(0.9, 0.999), eps=1e-8, weight_decay=0.0):
        self.lr, self.betas, self.eps, self.wd = lr, betas, eps, weight_decay
        self.step_count = 0
        self._lib = HostAdamBuilder().load()

    @staticmethod
    def is_compatible() -> bool:
        return HostAdamBuilder().is_compatible()

    def step(self, param: torch.Tensor, grad: torch.Tensor, m: torch.Tensor, v: torch.Tensor,
             lr: Optional[float] = None) -> None:
        """One fused update of ``param`` / ``m`` / ``v`` (fp32) in place;
        ``grad`` fp32, or bf16 (or its int16 bits)."""
        f32 = (torch.float32,)
        _check("param", param, f32)
        _check("m", m, f32)
        _check("v", v, f32)
        _check("grad", grad, (torch.float32, torch.bfloat16, torch.int16))
        n = param.numel()
        for name, t in (("grad", grad), ("m", m), ("v", v)):
            if t.numel() != n:
                raise ValueError(f"host adam: {name} has {t.numel()} elements, param {n}")
        self.step_count += 1
        fn = (self._lib.host_adamw_fp32 if grad.dtype == torch.float32
              else self._lib.host_adamw_bf16grad)
        if grad.dtype == torch.bfloat16:
            grad = grad.view(torch.int16)  # the bits, as the C side reads them
        fn(param.data_ptr(), grad.data_ptr(), m.data_ptr(), v.data_ptr(), n,
           self.lr if lr is None else lr, self.betas[0], self.betas[1], self.eps, self.wd,
           self.step_count)


class HostLion:
    """In-place Lion on host tensors (the reference's ``ops/lion`` CPU
    path)."""

    def __init__(self, lr=1e-4, betas=(0.9, 0.99), weight_decay=0.0):
        self.lr, self.betas, self.wd = lr, betas, weight_decay
        self._lib = HostAdamBuilder().load()

    def step(self, param: torch.Tensor, grad: torch.Tensor, m: torch.Tensor,
             lr: Optional[float] = None) -> None:
        f32 = (torch.float32,)
        for name, t in (("param", param), ("grad", grad), ("m", m)):
            _check(name, t, f32)
            if t.numel() != param.numel():
                raise ValueError(f"host lion: {name} has {t.numel()} elements, "
                                 f"param {param.numel()}")
        self._lib.host_lion_fp32(param.data_ptr(), grad.data_ptr(), m.data_ptr(),
                                 param.numel(), self.lr if lr is None else lr,
                                 self.betas[0], self.betas[1], self.wd)

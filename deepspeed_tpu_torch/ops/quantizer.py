"""Serving matmul — counterpart of ``deepspeed_tpu/ops/quantizer.py``
(``serving_mm`` / ``ServingContext``) for plain weights only.

``serving_mm`` is ``x @ w (+ bias)`` through ``torch.matmul``: a plain
matrix product outside any kernel, as the JAX package leaves it to XLA.
Quantized weight payloads (int8 / fp8 / fp6 and their fused dequant-matmul
kernels) come with the quantized-serving slice and raise until then.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch


class ServingContext(NamedTuple):
    """Per-engine serving-matmul policy, threaded through ``serving_mm``.
    Empty on one device with plain weights: the JAX context's fields (the
    tensor-parallel mesh and axis, the quantized-kernel gate, the transport
    format) come with the slices that read them."""


def serving_mm(x: torch.Tensor, w, bias: Optional[torch.Tensor] = None,
               kind: str = "col", ctx: Optional[ServingContext] = None) -> torch.Tensor:
    """``x @ w (+ bias)``; ``kind`` names the TP placement of the JAX
    package and has no effect on one device."""
    if not isinstance(w, torch.Tensor):
        raise NotImplementedError(
            f"quantized serving weights ({type(w).__name__}) are not ported yet")
    y = x @ w
    return y if bias is None else y + bias

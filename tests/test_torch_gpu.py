"""The port's CUDA kernels on the card (``gpu`` marker; they skip without a
CUDA device, since a CUDA kernel has no CPU mode).

Each kernel wrapper against its plain PyTorch version on the CPU in fp32,
on the same bf16 inputs: max abs err <= 2e-2 (bf16 output rounding of
unit-scale values plus a different fp32 summation order), and each call
counts exactly one launch.  This file imports neither JAX nor the JAX
package, so it runs where only PyTorch is installed::

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py
"""
import pytest
import torch

import chip_smoke
from deepspeed_tpu_torch.ops import kernels as K
from deepspeed_tpu_torch.ops.kernels.ctx_attention import paged_attention_packed_ctx
from deepspeed_tpu_torch.ops.kernels.flash_attention import flash_attention
from deepspeed_tpu_torch.ops.kernels.paged_attention import paged_attention_decode

TOL = 2e-2


def _cpu_f32(case):
    return {k: (v.cpu().float() if v.is_floating_point() else v.cpu())
            if isinstance(v, torch.Tensor) else v for k, v in case.items()}


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["flash_fwd", "paged_decode", "ctx_attention"])
def test_cuda_kernel_matches_plain(name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    gen = torch.Generator(device="cuda").manual_seed(0)
    if name == "flash_fwd":
        c = chip_smoke.flash_case(torch, gen, [100, 28], 0)
        del c["cap"]
        fn = flash_attention
    elif name == "paged_decode":
        c = chip_smoke.decode_case(torch, gen, B=8, inactive=2, max_len=300)
        fn = paged_attention_decode
    else:
        c = chip_smoke.ctx_case(torch, gen)
        fn = paged_attention_packed_ctx
    K.reset_launches()
    got = fn(**c)
    torch.cuda.synchronize()
    assert K.LAUNCHES[name] == 1
    ref = fn(**_cpu_f32(c))
    assert float((got.float().cpu() - ref).abs().max()) <= TOL

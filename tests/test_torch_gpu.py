"""The port's CUDA kernels on the card (``gpu`` marker; they skip without a
CUDA device, since a CUDA kernel has no CPU mode).

Each kernel wrapper against its plain PyTorch version on the CPU in fp32,
on the same bf16 inputs: max abs err <= 2e-2 (bf16 output rounding of
unit-scale values plus a different fp32 summation order), and each call
counts exactly one launch.  The training backward: K1f's lse within 1e-3,
and dq, dk and dv within ``chip_smoke.BWD_TOL`` relative Frobenius error,
over the whole tensor and in every 64-row block of one head (the kernels
round only their bf16 outputs), each launched once per call.  This file
imports neither JAX nor the JAX package, so it runs where only PyTorch is
installed::

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py
"""
import pytest
import torch

import chip_smoke
from deepspeed_tpu_torch.ops import kernels as K
from deepspeed_tpu_torch.ops.kernels import flash_attention as K1
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


@pytest.mark.gpu
@pytest.mark.parametrize("seg_lens,cap,hd", [(None, None, 128), ([70, 100, 30], 2.0, 128),
                                             (None, None, 64)])
def test_flash_backward_kernels_match_plain(seg_lens, cap, hd):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    gen = torch.Generator(device="cuda").manual_seed(0)
    c = chip_smoke.bwd_case(torch, gen, 2, 200, 8, 2, hd, seg_lens=seg_lens, cap=cap)
    q, k, v, do, seg = c["q"], c["k"], c["v"], c["do"], c["seg"]
    sc = hd ** -0.5
    K.reset_launches()
    o, lse = K1.flash_attention_kernel(q, k, v, seg, sc, cap, return_lse=True)
    dq, dk, dv = K1.flash_attention_bwd_kernel(q, k, v, seg, o, lse, do, sc, cap)
    torch.cuda.synchronize()
    assert (K.LAUNCHES["flash_fwd"], K.LAUNCHES["flash_bwd_dq"],
            K.LAUNCHES["flash_bwd_dkv"]) == (1, 1, 1)
    f = [x.cpu().float() for x in (q, k, v, o, do)]
    segc = seg.cpu() if seg is not None else None
    _, lse_ref = K1.flash_attention_fwd_plain(f[0], f[1], f[2], segc, sc, cap)
    assert float((lse.cpu() - lse_ref).abs().max()) <= 1e-3
    refs = K1.flash_attention_bwd_plain(f[0], f[1], f[2], segc, f[3], lse.cpu(), f[4], sc, cap)
    for name, got, ref in zip(("dq", "dk", "dv"), (dq, dk, dv), refs):
        whole, worst = chip_smoke.rel_errs(torch, got.cpu(), ref)
        assert max(whole, worst) <= chip_smoke.BWD_TOL, (name, whole, worst)


@pytest.mark.gpu
def test_training_step_with_packed_segments_on_the_card():
    """``initialize`` -> ``train_batch`` on a packed batch (``segment_ids``)
    at head_dim 64 against the port on the CPU in fp32 from the same
    weights: layer 0's wq / wk / wv / wo gradients of the first micro-batch
    agree in direction (cosine > ``chip_smoke.GRAD_COS_MIN``), while the
    same batch without its segments gives gradients below that on the CPU
    (so the check sees a kernel that ignores them); the step-1 loss agrees
    within 1e-2 relative (alone it would not: about ln 256 whatever the
    attention computes), and each micro-batch launches the forward and both
    backward kernels once per layer."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    import numpy as np

    import deepspeed_tpu_torch as dst
    from deepspeed_tpu_torch.models.presets import get_preset
    from deepspeed_tpu_torch.models.transformer import CausalLM, init_params

    cfg = get_preset("tiny", hidden_size=256, intermediate_size=512, attn_impl="flash",
                     remat="selective")
    params = init_params(cfg, seed=0, device="cpu", dtype=torch.float32)
    rng = np.random.default_rng(0)
    seg = np.ones((2, 2, 97), np.int32)
    seg[..., 40:] = 2
    seg[1, :, 70:] = 3
    batch = {"input_ids": rng.integers(0, 256, (2, 2, 97)), "segment_ids": seg}
    conf = {"train_micro_batch_size_per_gpu": 2, "gradient_accumulation_steps": 2}
    card, _, _, _ = dst.initialize(model=CausalLM(cfg), params=params, config=conf)
    cpu, _, _, _ = dst.initialize(model=CausalLM(cfg.replace(dtype=torch.float32)),
                                  params=params, config={**conf, "bf16": {"enabled": False}},
                                  device="cpu")
    micro = {k: v[0] for k, v in batch.items()}
    g_card = chip_smoke._attn_grads(torch, card, micro)
    g_cpu = chip_smoke._attn_grads(torch, cpu, micro)
    g_unpacked = chip_smoke._attn_grads(torch, cpu, {"input_ids": micro["input_ids"]})
    cos = torch.nn.functional.cosine_similarity
    for n in g_cpu:
        assert float(cos(g_card[n], g_cpu[n], dim=0)) > chip_smoke.GRAD_COS_MIN, n
        assert float(cos(g_unpacked[n], g_cpu[n], dim=0)) < chip_smoke.GRAD_COS_MIN, n
    K.reset_launches()
    got = float(card.train_batch(batch))
    assert (K.LAUNCHES["flash_fwd"], K.LAUNCHES["flash_bwd_dq"],
            K.LAUNCHES["flash_bwd_dkv"]) == (4, 4, 4)
    want = float(cpu.train_batch(batch))
    assert abs(got - want) <= 1e-2 * abs(want)
    assert all(bool(torch.isfinite(p).all()) for p in card._params_list)

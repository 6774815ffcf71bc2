"""The port's CUDA kernels on the card (``gpu`` marker; they skip without a
CUDA device, since a CUDA kernel has no CPU mode).

Each kernel wrapper against its plain PyTorch version on the CPU in fp32,
on the same bf16 inputs: max abs err <= 2e-2 (bf16 output rounding of
unit-scale values plus a different fp32 summation order), and each call
counts exactly one launch (K2 at head_dim 64, gpt2_small's MHA heads and
a GQA group of 4, under ``paged_decode_hd64``; K3 also on a verify tick's
pack, contexts ending mid-page; the partial modes of K3 and K2 on striped
pools, and their merge against the non-partial kernels; both at head_dim
256 and a query group of 71, ``PAGED_WIDE``).  The training backward: K1f's o within 2e-2 and lse within 1e-3,
and dq, dk and dv within ``chip_smoke.BWD_TOL`` relative Frobenius error,
over the whole tensor and in every 64-row block of one head (the kernels
round only their bf16 outputs), each launched once per call, also at
head_dim 256 and a query group of 71; the block-sparse K7f / K7b the same
way, also at head_dim 256 and a group of 71.  Quantized
serving: K4 / K5 within ``chip_smoke.QMM_TOL`` relative Frobenius error,
K6 byte-identical (also on ``chip_smoke.row_quant_inputs``: inf, NaN,
subnormal and outlier rows, ragged and unaligned shapes, fp32 / fp16), and
a call the kernels refuse raises without reaching a plain body.  The
reference API: top-p sampling on CUDA over rows whose cumulative sum never
reaches top_p (``chip_smoke.sampling_phase``), and the training engine's
forward / backward / step against ``train_batch`` on the card.  Decode
bursts: a captured K2 call counts one launch per replay; a sampled burst
draws from the filtered softmax (a frequency test over 2,048 draws); a
burst after a copy-on-write clone reads the clone.  The serve front end:
a burst graph captured before a paged-KV injection replays over the
injected pages; the router's routed and migrated streams near-argmax
against the CPU; a kernel error in a worker's tick raises through
``Router.tick``.  The out-of-process plane: a spawned CUDA worker serves a
request with the in-process engine's tokens and its own kernel launches; a
bf16 handoff makes a round trip over a socket bit for bit; spawned
children keep their reply caches under the byte cap.  Resumable training:
an async save mid-``train_on_loader`` and a resume, bitwise; an HF round
trip served with the original's tokens.  MoE and the v1 engine: the
routed path's loss and gradients in fp32 against the CPU
(``chip_smoke.moe_narrow_check``), a MoE ``step_n`` burst token-identical
to per-tick steps, ``init_inference`` in fp32 token-identical to the CPU
on the MoE, ALiBi and parallel-block families, and a prefill that fills
its dense cache on K1f.  ZeRO-Offload: the CPU tier bit-identical to the
plain engine on a 2-layer model (its state in pinned host memory, the
card's bytes the compute copy, the gradients and the staging chunks), the
NVMe tier within ``chip_smoke.NVME_TOL``, and a save / load resume under
each tier bit for bit.  The scheduled step: ``get_accelerator`` and a timer
fence on the card; the flops profiler's count of K1 at its closed form on a
520-token partial tile, with and without segments; a 3-layer engine with
the curriculum, progressive layer drop and the profiler bit-identical to
the same run unprofiled, K1f / K1b launched the kept layers x GAS.  The
kernels as ``torch.library`` ops: each op on CUDA against its plain
version with one launch a kernel; a compiled step (inductor) launching
what its eager twin launches, dense and block-sparse; a quantized hybrid
refreshed under a burst graph captured before training, token-identical
to a fresh quantized engine.  ZeRO across processes: ``chip_smoke``'s
zero_train at 2 layers, one rank through the launcher over NCCL, its
collectives and launches at the plan's counts, stages 1-3 at stage 0's
losses, ZeRO++ and 1-bit Adam at the CPU's, two planted faults outside
that gate.  Tensor parallelism: the same rank at 2 layers trains stages
0 and 3 over a model axis of one to the plain runs' losses (a planted
loss fault outside that gate) and serves each format over it
token-identical to the engine without a grid; the vocab-parallel loss
equals the plain cross-entropy (``chip_smoke.tp_ce_check``) and one
backward over the model axis of one the plain backward, bit for bit; each
rank's shard of a full-width layer at tp 2 and 4, the ranks' all-reduces
made in lockstep, equals the whole layer
(``chip_smoke.tp_shard_train_check``), the kernels on each rank's heads
and column / row shards to the whole call (``tp_shard_serve_check``),
each planted fault outside its gate.  This
file imports neither JAX nor the JAX package, so it
runs where only PyTorch is installed::

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
@pytest.mark.parametrize("hq,hkv", [(12, 12), (8, 2)])
def test_decode_kernel_at_head_dim_64_matches_plain(hq, hkv):
    """K2 at head_dim 64 (the counterpart of the TPU's K2p): gpt2_small's
    MHA heads (g = 1) and a GQA group of 4, counted under its own name."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    gen = torch.Generator(device="cuda").manual_seed(0)
    c = chip_smoke.decode_case(torch, gen, B=16, nb=256, P=16, hq=hq, hkv=hkv, hd=64,
                               inactive=2, max_len=300)
    K.reset_launches()
    got = paged_attention_decode(**c)
    torch.cuda.synchronize()
    assert (K.LAUNCHES["paged_decode_hd64"], K.LAUNCHES["paged_decode"]) == (1, 0)
    ref = paged_attention_decode(**_cpu_f32(c))
    assert float((got.float().cpu() - ref).abs().max()) <= TOL


@pytest.mark.gpu
@pytest.mark.parametrize("hq,hkv,hd", [(12, 12, 64), (8, 2, 128)])
def test_ctx_kernel_on_a_mid_page_verify_pack(hq, hkv, hd):
    """K3 on a verify tick's pack: 8 slots x 5 rows, contexts that end
    mid-page, a slot with no drafts; pad rows exactly 0."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    gen = torch.Generator(device="cuda").manual_seed(0)
    c = chip_smoke.verify_case(torch, gen, hq, hkv, hd)
    K.reset_launches()
    got = paged_attention_packed_ctx(**c)
    torch.cuda.synchronize()
    assert K.LAUNCHES["ctx_attention"] == 1
    ref = paged_attention_packed_ctx(**_cpu_f32(c))
    assert float((got.float().cpu() - ref).abs().max()) <= TOL
    pad = (c["segment_ids"] == 0).cpu()
    assert bool(pad.any()) and not bool(got.cpu()[pad].ne(0).any())


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["ctx", "verify_hd64", "decode", "decode_hd64"])
@pytest.mark.parametrize("S", [2, 4])
def test_partial_kernels_match_plain_and_merge_to_the_full_kernel(case, S):
    """The partial modes (seq-sharded serving) on each shard's view of a
    pool striped over ``S`` shards, against their plain versions on the
    same inputs (``chip_smoke.partial_errs``: the triple in output units
    within ``TOL``, rows with no key here exactly (0, -1e30, 0)), one launch
    each under its own name; the partials merged equal the non-partial
    kernel on the whole pool within ``TOL`` (idle decode slots, which K2
    clamps to page 0, excepted: the merge gives 0 there)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    from deepspeed_tpu_torch.inference.paged import merge_partials
    from deepspeed_tpu_torch.ops.kernels import ctx_attention as K3
    from deepspeed_tpu_torch.ops.kernels import paged_attention as K2

    gen = torch.Generator(device="cuda").manual_seed(0)
    if case.startswith("decode"):
        kw = chip_smoke.GPT2_DECODE if case == "decode_hd64" else {}
        c = chip_smoke.decode_case(torch, gen, **dict(kw, B=16, inactive=2, stripes=S))
        key, name = "block_table", "paged_decode_partial"
        partial, plain, full = (K2.paged_attention_decode_partial_kernel,
                                K2.paged_attention_decode_partial_plain,
                                K2.paged_attention_decode_kernel)
        live = c["block_table"][:, 0] >= 0
    else:
        c = (chip_smoke.ctx_case(torch, gen, stripes=S) if case == "ctx"
             else chip_smoke.verify_case(torch, gen, 12, 12, 64, stripes=S))
        key, name = "ctx_tables", "ctx_attention_partial"
        partial, plain, full = (K3.paged_attention_packed_ctx_partial_kernel,
                                K3.paged_attention_packed_ctx_partial_plain,
                                K3.paged_attention_packed_ctx_kernel)
        live = torch.ones(c["q"].shape[0], dtype=torch.bool, device="cuda")
    parts = []
    for s in range(S):
        sh = chip_smoke.shard_view(torch, c, s, S, key)
        kw = {} if key == "block_table" else dict(include_pack=s == 0)
        K.reset_launches()
        got = partial(**sh, **kw)
        torch.cuda.synchronize()
        assert K.LAUNCHES[name] == 1 and sum(K.LAUNCHES.values()) == 1
        ref = plain(**_cpu_f32(sh), **kw)
        err, _ = chip_smoke.partial_errs(torch, [x.cpu() for x in got], ref, f"{case} {s}")
        assert err <= TOL, (s, err)
        parts.append(got)
    merged = merge_partials(parts, torch.bfloat16)
    want = full(**c)
    assert float((merged[live].float() - want[live].float()).abs().max()) <= TOL
    assert not bool(merged[~live].ne(0).any())


# K2 / K3 at the shapes their tensor-core kernels took on in their redesign:
# head_dim 256 (gptj_6b's MHA heads, blocks of 16) and falcon_7b's 71 query
# heads on one kv head (blocks of 8 and 16), a 4,096-key slot, soft caps
PAGED_WIDE = [
    ("decode", dict(B=8, nb=1024, bs=16, P=256, hq=16, hkv=16, hd=256, inactive=1,
                    first_len=4096), None),
    ("decode", dict(B=8, nb=1024, bs=8, P=160, hq=71, hkv=1, hd=64, inactive=1), 5.0),
    ("verify", dict(hq=16, hkv=16, hd=256, bs=16), None),
    ("verify", dict(hq=71, hkv=1, hd=64), 5.0),
    ("ctx", dict(hq=71, hkv=1, hd=64, bs=16, P=40, nb=256), None),
]


@pytest.mark.gpu
@pytest.mark.parametrize("kind,kw,cap", PAGED_WIDE)
@pytest.mark.parametrize("partial", [False, True])
def test_paged_kernels_at_head_dim_256_and_group_71(kind, kw, cap, partial):
    """K2 / K3 (and their partial modes, on shard 0 of a pool striped over 2)
    against the plain versions: within ``TOL`` (partials in output units,
    ``chip_smoke.partial_errs``), pad rows exactly 0 / (0, -1e30, 0), one
    launch under the wrapper's own name."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    from deepspeed_tpu_torch.ops.kernels import ctx_attention as K3
    from deepspeed_tpu_torch.ops.kernels import paged_attention as K2

    gen = torch.Generator(device="cuda").manual_seed(0)
    if kind == "decode":
        c = chip_smoke.decode_case(torch, gen, stripes=2 if partial else 1, **kw)
        key, mod, fn = "block_table", K2, "paged_attention_decode"
        name = "paged_decode_hd64" if kw["hd"] == 64 else "paged_decode"
    else:
        c = chip_smoke.paged_case(torch, gen, kind, kw, stripes=2 if partial else 1)
        key, mod, fn, name = "ctx_tables", K3, "paged_attention_packed_ctx", "ctx_attention"
    kwargs = dict(logits_soft_cap=cap)
    if partial:
        c = chip_smoke.shard_view(torch, c, 0, 2, key)
        fn, name = fn + "_partial", name.replace("_hd64", "") + "_partial"
        if kind != "decode":
            kwargs["include_pack"] = True
    K.reset_launches()
    got = getattr(mod, fn + "_kernel")(**c, **kwargs)
    torch.cuda.synchronize()
    assert K.LAUNCHES[name] == 1 and sum(K.LAUNCHES.values()) == 1
    ref = getattr(mod, fn + "_plain")(**_cpu_f32(c), **kwargs)
    if partial:
        err, _ = chip_smoke.partial_errs(torch, [x.cpu() for x in got], ref, f"{kind} {kw}")
        assert err <= TOL
        return
    assert float((got.float().cpu() - ref).abs().max()) <= TOL
    if kind != "decode":
        pad = (c["segment_ids"] == 0).cpu()
        assert bool(pad.any()) and not bool(got.cpu()[pad].ne(0).any())


@pytest.mark.gpu
@pytest.mark.parametrize("b,s,hq,hkv,hd,seg_lens,cap", [
    (2, 200, 8, 2, 128, None, None),
    (2, 200, 8, 2, 128, [70, 100, 30], 2.0),
    (2, 200, 8, 2, 64, None, None),
    (1, 600, 8, 2, 128, None, None),
    (1, 200, 4, 2, 256, None, None),
    (1, 200, 4, 1, 256, [90, 70, 40], 5.0),
    (1, 200, 71, 1, 64, None, None),
    (1, 200, 71, 1, 64, [120, 80], 2.0),
])
def test_flash_backward_kernels_match_plain(b, s, hq, hkv, hd, seg_lens, cap):
    """K1f's o within ``TOL`` (and ``chip_smoke.BWD_TOL`` per 64-row block)
    and lse within 1e-3, dq / dk / dv within ``chip_smoke.BWD_TOL`` per
    64-row block, one launch of each kernel; at
    head_dim 64 / 128 / 256, falcon_7b's 71 query heads on one kv head, and
    s 600 (five key tiles at head_dim 128, so the K/V ring is refilled)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    gen = torch.Generator(device="cuda").manual_seed(0)
    c = chip_smoke.bwd_case(torch, gen, b, s, hq, hkv, hd, seg_lens=seg_lens, cap=cap)
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
    o_ref, lse_ref = K1.flash_attention_fwd_plain(f[0], f[1], f[2], segc, sc, cap)
    assert float((o.cpu().float() - o_ref).abs().max()) <= TOL
    assert max(chip_smoke.rel_errs(torch, o.cpu(), o_ref)) <= chip_smoke.BWD_TOL
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


# ---------------------------------------------------------------------------
# quantized serving: K4 (int8, e4m3), K5 (fp6), K6 (row quantizers)
# ---------------------------------------------------------------------------
def _quant_setup():
    from deepspeed_tpu_torch.ops.kernels import quant_kernel as QK
    from deepspeed_tpu_torch.ops.kernels import quant_matmul as QM
    from deepspeed_tpu_torch.ops import quantizer as Q

    return QK, QM, Q


@pytest.mark.gpu
@pytest.mark.parametrize("fmt", ["int8", "fp8", "fp6"])
@pytest.mark.parametrize("m,k,n,with_bias", [
    (16, 4096, 1024, False),   # decode at the 8B wk / wv shape: n16 tiles, K split
    (512, 4096, 1024, False),  # prefill at the same shape: 256-token tiles, K split
    (100, 1028, 1000, True),   # ragged M, K and N (unaligned rows), 128 tokens, a bias
])
def test_quant_matmul_kernels_match_plain(fmt, m, k, n, with_bias):
    """``serving_mm`` launches K4 / K5 once and agrees with the plain
    version on the CPU in fp32 within ``chip_smoke.QMM_TOL`` relative
    Frobenius error, at a decode batch, a prefill pack and a ragged shape."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    _, QM, Q = _quant_setup()
    gen = torch.Generator(device="cuda").manual_seed(0)
    w = chip_smoke._randn(torch, (k, n), gen, torch.bfloat16) * k ** -0.5
    p = chip_smoke._payloads(torch, w)[chip_smoke.QMM_NAMES[fmt]]
    x = chip_smoke._randn(torch, (m, k), gen, torch.bfloat16)
    bias = chip_smoke._randn(torch, (n,), gen, torch.float32) if with_bias else None
    K.reset_launches()
    got = Q.serving_mm(x, p, bias)
    torch.cuda.synchronize()
    assert {n: c for n, c in K.LAUNCHES.items() if c} == {chip_smoke.QMM_NAMES[fmt]: 1}
    pc = Q.map_quant(p, lambda t: t.cpu())
    ref = Q.serving_mm(x.cpu().float(), pc, None if bias is None else bias.cpu())
    assert float((got.cpu().float() - ref).norm() / ref.norm()) <= chip_smoke.QMM_TOL


@pytest.mark.gpu
def test_row_quantizers_match_plain_bytes():
    """K6a/b/c on [4096, 14336] bf16 rows with a zero row: the q bytes,
    scales and dequantized values equal the plain version's on the CPU, one
    launch a call."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    QK, _, _ = _quant_setup()
    gen = torch.Generator(device="cuda").manual_seed(1)
    x = chip_smoke._randn(torch, (4096, 14336), gen, torch.bfloat16)
    x[3] = 0.0
    xc = x.cpu()
    for dtype in (torch.int8, torch.float8_e4m3fn, torch.float8_e5m2):
        K.reset_launches()
        q, s = QK.quantize_int8(x) if dtype == torch.int8 else QK.quantize_fp8(x, dtype)
        d = QK.dequantize(q, s, torch.bfloat16)
        torch.cuda.synchronize()
        name = "quantize_int8" if dtype == torch.int8 else "quantize_fp8"
        assert {n: c for n, c in K.LAUNCHES.items() if c} == {name: 1, "dequantize": 1}
        qp, sp = QK.quantize_rows_plain(xc, dtype)
        assert torch.equal(q.cpu().view(torch.uint8), qp.view(torch.uint8))
        assert torch.equal(s.cpu(), sp)
        assert torch.equal(d.cpu(), QK.dequantize_rows_plain(qp, sp, torch.bfloat16))


@pytest.mark.gpu
def test_row_quantizers_match_plain_on_edge_rows():
    """K6a/b/c against the plain version on the card, bytes, scales (two
    NaNs agree) and dequantized bits identical, on every
    ``chip_smoke.row_quant_inputs`` case and code format."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    QK, _, _ = _quant_setup()
    gen = torch.Generator(device="cuda").manual_seed(2)
    for label, x in chip_smoke.row_quant_inputs(torch, gen):
        for dtype in chip_smoke.K6_DTYPES:
            row = chip_smoke.row_quant_agreement(torch, QK, x, dtype)
            assert (row["q_bytes_differing"], row["scales_differing"],
                    row["dequantized_bits_differing"]) == (0, 0, 0), (label, dtype, row)


@pytest.mark.gpu
def test_top_p_sampling_past_the_vocab_on_cuda():
    """ROADMAP queue 3 fault 1 on the card: ``sample`` with top-p over rows
    whose fp32 cumulative probability never reaches top_p draws a kept
    token in every row and raises no device-side assert."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    res = chip_smoke.sampling_phase(torch, "test")
    assert any(c["rows_cutoff_past_vocab"] for c in res["cases"].values())


@pytest.mark.gpu
def test_forward_backward_step_equals_train_batch_on_the_card():
    """The reference API on the card (bf16, GAS 2, two steps) against
    ``train_batch`` from the same weights: the step losses within
    ``chip_smoke.SHIM_LOSS_RTOL``, ``step()`` a no-op off the boundary,
    and the launches of ``train_batch``: the flash kernels once per layer
    and micro-batch, K8 once a step."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    import numpy as np

    import deepspeed_tpu_torch as dst
    from deepspeed_tpu_torch.models.presets import get_preset
    from deepspeed_tpu_torch.models.transformer import CausalLM, init_params

    cfg = get_preset("tiny", hidden_size=256, intermediate_size=512, attn_impl="flash",
                     remat="selective")
    params = init_params(cfg, seed=0, device="cpu", dtype=torch.float32)
    batch = {"input_ids": np.random.default_rng(0).integers(0, 256, (2, 2, 97))}
    conf = {"train_micro_batch_size_per_gpu": 2, "gradient_accumulation_steps": 2,
            "optimizer": {"type": "adamw", "params": {"lr": 1e-3}}}
    fused, _, _, _ = dst.initialize(model=CausalLM(cfg), params=params, config=conf)
    shim, _, _, _ = dst.initialize(model=CausalLM(cfg), params=params, config=conf)
    want = [float(fused.train_batch(batch)) for _ in range(2)]
    K.reset_launches()
    got = []
    for _ in range(2):
        losses = []
        for i in range(2):
            losses.append(float(shim.forward({"input_ids": batch["input_ids"][i]})))
            shim.backward()
            shim.step()
            assert shim.global_steps == len(got) + i  # a step only at the boundary
        got.append(sum(losses) / 2)
    chip_smoke.check_train_launches("test", dict(K.LAUNCHES), cfg.num_layers, 2, 2, False)
    for g, w in zip(got, want):
        assert abs(g - w) <= chip_smoke.SHIM_LOSS_RTOL * abs(w), (got, want)


@pytest.mark.gpu
def test_a_refused_call_raises_and_never_runs_the_plain_body(monkeypatch):
    """What the kernels do not take (fp32 activations, a wrong fp6 in_dim,
    an fp64 tensor to quantize) raises on a CUDA tensor: no launch, and the
    plain body is never reached."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    QK, QM, _ = _quant_setup()

    def boom(*a, **k):
        raise AssertionError("a plain body ran on a CUDA tensor")

    for mod, name in ((QM, "quant_matmul_plain"), (QM, "quant_matmul_fp6_plain"),
                      (QK, "quantize_rows_plain"), (QK, "dequantize_rows_plain")):
        monkeypatch.setattr(mod, name, boom)
    dev = "cuda"
    K.reset_launches()
    with pytest.raises(TypeError, match="bf16"):
        QM.quant_matmul(torch.zeros(4, 64, device=dev), torch.zeros(64, 32, dtype=torch.int8,
                                                                     device=dev),
                        torch.ones(32, device=dev))
    with pytest.raises(ValueError, match="in_dim"):
        QM.quant_matmul_fp6(torch.zeros(4, 60, dtype=torch.bfloat16, device=dev),
                            torch.zeros(3, 16, 32, dtype=torch.uint8, device=dev),
                            torch.ones(32, device=dev), 60)
    with pytest.raises(TypeError):
        QK.quantize_int8(torch.zeros(4, 8, dtype=torch.float64, device=dev))
    assert sum(K.LAUNCHES.values()) == 0


# ---------------------------------------------------------------------------
# block-sparse training: K7f / K7b (sparse attention), K8 (fused AdamW)
# ---------------------------------------------------------------------------
@pytest.mark.gpu
@pytest.mark.parametrize("spec,s,hq,hkv,hd,seg_lens,cap", [
    (chip_smoke.SPARSE_CHECK, 512, 8, 2, 128, None, None),
    ({"mode": "bigbird", "block": 128}, 512, 8, 2, 64, [100, 250, 62], 30.0),
    ({"mode": "bsLongformer", "block": 256, "global_block_indices": [1]}, 1024, 8, 2, 128,
     None, None),
    (chip_smoke.SPARSE_FLAGSHIP, 512, 4, 2, 256, [200, 312], 5.0),
    (chip_smoke.SPARSE_CHECK, 512, 71, 1, 64, None, None),
])
def test_sparse_kernels_match_plain(spec, s, hq, hkv, hd, seg_lens, cap):
    """K7f's o (``chip_smoke.KERNEL_TOL``, and ``BWD_TOL`` per 64-row block)
    and lse (``LSE_TOL``), K7b's dq / dk / dv (``BWD_TOL`` per 64-row block)
    against the plain versions in fp32 on the same bf16 inputs, also at
    head_dim 256 and falcon_7b's group of 71; one launch of each kernel."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    gen = torch.Generator(device="cuda").manual_seed(0)
    case = chip_smoke.bwd_case(torch, gen, 2, s, hq, hkv, hd, seg_lens=seg_lens, cap=cap)
    layout, block = chip_smoke.sparse_layout(spec, s)
    K.reset_launches()
    results = chip_smoke.sparse_results(torch, case, layout, block)
    torch.cuda.synchronize()
    assert {n: K.LAUNCHES[n] for n in chip_smoke.ATTN_KERNELS[True]} == {
        "sparse_fwd": 1, "sparse_bwd_dq": 1, "sparse_bwd_dkv": 1}
    for name, suffix, got, ref, tol, relative in results:
        assert bool(torch.isfinite(got).all()), name + suffix
        if relative:
            whole, worst = chip_smoke.rel_errs(torch, got, ref)
            assert max(whole, worst) <= tol, (name + suffix, whole, worst)
        else:
            assert float((got.float() - ref.float()).abs().max()) <= tol, name + suffix


@pytest.mark.gpu
def test_fused_adamw_matches_plain_and_skips_on_overflow():
    """K8 against its plain version on the same fp32 inputs, aligned and one
    element off alignment, within ``chip_smoke.K8_TOL``; a ``finite = False``
    step through the optimizer changes no bit and not the count."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    from deepspeed_tpu_torch.ops.kernels import fused_adam as K8
    from deepspeed_tpu_torch.ops.optimizers import build_optimizer

    gen = torch.Generator(device="cuda").manual_seed(0)
    lr = torch.tensor(1e-3, device="cuda")
    for _, step, wd, p, g, m, v in chip_smoke.adam_cases(torch, gen, 100_003):
        t = torch.tensor(step, dtype=torch.int32, device="cuda")
        for off in (0, 1):
            got = [x.clone()[off:] for x in (p, m, v)]
            ref = [x[off:].clone() for x in (p, m, v)]
            K.reset_launches()
            K8.fused_adamw_flat(got[0], g[off:], got[1], got[2], lr, t, wd=wd)
            assert K.LAUNCHES["fused_adamw"] == 1
            K8.fused_adamw_flat_plain(ref[0], g[off:], ref[1], ref[2], lr, t, wd=wd)
            for a, r in zip(got, ref):
                assert float((a - r).abs().max()) <= chip_smoke.K8_TOL * float(r.abs().max())
    opt = build_optimizer("adam", {"weight_decay": 0.1})
    state = opt.init([p])
    opt.step([p], [g], state, lr)
    before = [x.clone() for x in (p, state["mu"][0], state["nu"][0], state["count"])]
    opt.step([p], [g], state, lr, finite=torch.tensor(False, device="cuda"))
    for a, b in zip(before, (p, state["mu"][0], state["nu"][0], state["count"])):
        assert torch.equal(a, b)


@pytest.mark.gpu
def test_sparse_training_step_on_the_card():
    """``initialize`` with ``sparse_attention`` (fixed(128, 2, 1) at seq 512)
    and FusedAdam -> ``train_batch`` on the card (bf16) against the port on
    the CPU (fp32) from the same weights: layer 0's attention gradients agree
    in direction, the step-1 loss within 1e-2 relative, and a step launches
    the sparse kernels once per layer and micro-batch, K8 once and no flash
    kernel."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    import numpy as np

    import deepspeed_tpu_torch as dst
    from deepspeed_tpu_torch.models.presets import get_preset
    from deepspeed_tpu_torch.models.transformer import CausalLM, init_params

    cfg = get_preset("tiny", hidden_size=256, intermediate_size=512, num_heads=4,
                     num_kv_heads=2, head_dim=64, max_seq_len=512, remat="selective")
    params = init_params(cfg, seed=0, device="cpu", dtype=torch.float32)
    batch = {"input_ids": np.random.default_rng(0).integers(0, 256, (2, 2, 513))}
    conf = {"train_micro_batch_size_per_gpu": 2, "gradient_accumulation_steps": 2,
            "optimizer": {"type": "FusedAdam", "params": {"lr": 1e-3, "weight_decay": 0.1}},
            "sparse_attention": dict(chip_smoke.SPARSE_CHECK)}
    card, _, _, _ = dst.initialize(model=CausalLM(cfg), params=params, config=conf)
    cpu, _, _, _ = dst.initialize(model=CausalLM(cfg.replace(dtype=torch.float32)),
                                  params=params, config={**conf, "bf16": {"enabled": False}},
                                  device="cpu")
    micro = {"input_ids": batch["input_ids"][0]}
    g_card = chip_smoke._attn_grads(torch, card, micro)
    g_cpu = chip_smoke._attn_grads(torch, cpu, micro)
    for n in g_cpu:
        cos = torch.nn.functional.cosine_similarity(g_card[n], g_cpu[n], dim=0)
        assert float(cos) > chip_smoke.GRAD_COS_MIN, n
    K.reset_launches()
    got = float(card.train_batch(batch))
    chip_smoke.check_train_launches("test", dict(K.LAUNCHES), cfg.num_layers, 2, 1, True)
    want = float(cpu.train_batch(batch))
    assert abs(got - want) <= 1e-2 * abs(want)
    assert all(bool(torch.isfinite(p).all()) for p in card._params_list)


# ---------------------------------------------------------------------------
# decode bursts: the tick as a captured CUDA graph
# ---------------------------------------------------------------------------
def _small_serving_cfg():
    """``tiny`` at head_dim 64 (the kernels' smallest), bf16."""
    from deepspeed_tpu_torch.models.presets import get_preset

    return get_preset("tiny", hidden_size=128, num_heads=2, num_kv_heads=1, head_dim=64)


@pytest.mark.gpu
def test_captured_kernel_launches_count_per_replay():
    """K2 captured in a ``CapturedGraph`` and replayed 3 times adds 3 to
    ``LAUNCHES`` (the capture itself adds nothing), and the replays compute
    what an eager call computes.  A timing graph captured outside
    ``CapturedGraph`` (``chip_smoke.graph_ms``) counts its calls as eager
    ones, at capture."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    gen = torch.Generator(device="cuda").manual_seed(0)
    c = chip_smoke.decode_case(torch, gen, B=8, inactive=2, max_len=300)
    want = paged_attention_decode(**c)  # eager: builds and configures K2
    K.reset_launches()
    graph = K.CapturedGraph()
    out = graph.capture(lambda: paged_attention_decode(**c))
    assert K.LAUNCHES["paged_decode"] == 0 and graph.launches == {"paged_decode": 1}
    for _ in range(3):
        graph.replay()
    torch.cuda.synchronize()
    assert K.LAUNCHES["paged_decode"] == 3
    assert torch.equal(out, want)
    # graph_ms: one eager warm-up call, then two calls captured
    chip_smoke.graph_ms(torch, lambda: paged_attention_decode(**c), iters=2, reps=1)
    assert K.LAUNCHES["paged_decode"] == 6


def _constant_logits_params(cfg, logits):
    """Weights whose logits are ``logits`` [v] at every row and position:
    every token embeds to ones, the attention and MLP outputs are zeroed
    (K2 still runs and writes the pools), the final norm of ones is ones,
    and the head's column j sums to logits[j]."""
    from deepspeed_tpu_torch.models.transformer import init_params

    p = init_params(cfg, seed=0, device="cuda")
    d = cfg.hidden_size
    p["embed"]["embedding"].fill_(1.0)
    p["layers"]["attn"]["wo"].zero_()
    p["layers"]["mlp"]["w_down"].zero_()
    p["lm_head"]["kernel"].copy_((logits / d)[None, :].expand(d, -1))
    return p


@pytest.mark.gpu
def test_sampled_burst_draws_from_the_filtered_softmax():
    """A temperature > 0 burst (top_p 0.9, temperature 0.8) on weights whose
    logits are the same at every row and tick: 64 rows x 16 ticks x 2 bursts
    (the first captures, the second only replays) are 2,048 draws from one
    distribution.  Each token's frequency is within 5 standard errors of its
    filtered-softmax probability, no filtered-out token is drawn, and the
    replayed ticks draw anew (the engine's generator is registered with the
    graph)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    from deepspeed_tpu_torch.inference import model_runner
    from deepspeed_tpu_torch.inference.engine_v2 import InferenceEngineV2
    from deepspeed_tpu_torch.inference.sampling import SamplingParams, top_p_filter

    cfg = _small_serving_cfg()
    v, B, n = cfg.vocab_size, 64, 16
    target = torch.where(torch.arange(v) < 48, 3.0 - 0.08 * torch.arange(v), -8.0)
    params = _constant_logits_params(cfg, target.cuda())
    eng = InferenceEngineV2(params, cfg, max_seqs=B, num_blocks=256, block_size=16,
                            prefill_buckets=(64,), prefill_budget=64)
    samp = SamplingParams(temperature=0.8, top_p=0.9, max_new_tokens=64)
    eng.put(list(range(1, B + 1)), [[1, 2, 3, 4]] * B, samp)
    logits, _ = model_runner.decode_step(eng.params, cfg, [5], [4], eng._tables_np[:1],
                                         [False], eng.kv)
    probs = torch.softmax(top_p_filter(logits[0].float().cpu() / 0.8, 0.9), dim=-1)
    draws = []
    for _ in range(2):
        before = [len(eng.mgr.seqs[u].tokens) for u in range(1, B + 1)]
        eng.step_n(n, samp)
        draws.append(torch.tensor([eng.mgr.seqs[u].tokens[b:] for u, b in
                                   zip(range(1, B + 1), before)]))  # [B, n]
    assert eng.stats["decode_bursts"] == 2 and eng.stats["burst_ticks"] == 2 * n
    ticks = torch.cat(draws, dim=1)  # [B, 2n]
    assert any(not torch.equal(ticks[:, 1], ticks[:, t]) for t in range(2, 2 * n))
    freq = torch.bincount(ticks.reshape(-1), minlength=v).double() / ticks.numel()
    assert float(freq[probs == 0].sum()) == 0.0
    se = (probs * (1 - probs) / ticks.numel()).sqrt()
    assert bool((freq - probs).abs().le(5 * se + 1e-3).all()), (freq - probs).abs().max()
    assert eng.close()["blocks_in_use"] == 0


@pytest.mark.gpu
def test_burst_after_copy_on_write_reads_the_clone_on_the_card():
    """The first burst captures the tick; then the page the sequence writes
    next gets a second owner, so the next burst's reservation clones it in
    place (``cow_hook``) in the same pool tensors the graph reads: the
    replayed ticks read the clone, and the tokens equal an engine that never
    shared the page.  K2 launched layers x (1 eager + 1 replayed) ticks in
    the first burst and layers x 6 replays in the second."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    from deepspeed_tpu_torch.inference.engine_v2 import InferenceEngineV2
    from deepspeed_tpu_torch.models.transformer import init_params

    cfg = _small_serving_cfg()
    params = init_params(cfg, seed=0, device="cuda")
    L = cfg.num_layers
    prompt = list(range(3, 14))  # 11 tokens: the 12th to 16th land in page 0 (bs 16)

    def run(share):
        eng = InferenceEngineV2(params, cfg, max_seqs=4, num_blocks=32, block_size=16,
                                prefill_buckets=(64,), prefill_budget=64)
        eng.put([1], [prompt])
        K.reset_launches()
        eng.step_n(2)
        assert K.LAUNCHES["paged_decode_hd64"] == 2 * L
        seq = eng.mgr.seqs[1]
        page = seq.blocks[(seq.cur_len - 1) // 16]
        if share:
            eng.mgr.allocator.ref(page)
        K.reset_launches()
        eng.step_n(6)
        assert K.LAUNCHES["paged_decode_hd64"] == 6 * L
        clones = eng.mgr.cow_copies
        if share:
            assert page not in seq.blocks
            eng.mgr.allocator.free([page])
        toks = list(seq.tokens)
        assert eng.close()["blocks_in_use"] == 0
        return toks, clones

    (shared, clones), (plain, none) = run(True), run(False)
    assert shared == plain and clones == 1 and none == 0


@pytest.mark.gpu
@pytest.mark.parametrize("hd,hq,hkv", [(80, 8, 2), (96, 16, 16)])
def test_padded_head_dims_match_plain(hd, hq, hkv):
    """K1f / K1b at head dims 80 and 96 through the ``flash_attention``
    entry (the kernels run at 128 on zero-padded q / k / v): o within 2e-2
    and dq / dk / dv within ``chip_smoke.BWD_TOL`` relative per block of
    the plain versions at the real head dim, one launch of each kernel."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    gen = torch.Generator(device="cuda").manual_seed(3)
    c = chip_smoke.bwd_case(torch, gen, 2, 200, hq, hkv, hd, seg_lens=[90, 70], cap=5.0)
    q, k, v = (c[n].requires_grad_(True) for n in ("q", "k", "v"))
    K.reset_launches()
    o = flash_attention(q, k, v, segment_ids=c["seg"], logits_soft_cap=5.0)
    grads = torch.autograd.grad(o, (q, k, v), c["do"])
    assert {n: K.LAUNCHES[n] for n in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")} == {
        "flash_fwd": 1, "flash_bwd_dq": 1, "flash_bwd_dkv": 1}
    f = [x.detach().float() for x in (q, k, v)]
    o_ref, lse = K1.flash_attention_fwd_plain(*f, c["seg"], hd ** -0.5, 5.0)
    refs = K1.flash_attention_bwd_plain(*f, c["seg"], o_ref, lse, c["do"].float(), hd ** -0.5,
                                        5.0)
    assert o.shape[-1] == hd and float((o.detach().float() - o_ref).abs().max()) <= TOL
    for got, ref in zip(grads, refs):
        assert got.shape == ref.shape
        assert max(chip_smoke.rel_errs(torch, got, ref)) <= chip_smoke.BWD_TOL


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(chip_smoke.NEW_OPTIMIZERS))
def test_new_optimizers_on_cuda_match_the_cpu(name):
    """Lamb, Lion, Adagrad and Muon on the engine's layout (leaves tiling
    one flat buffer): three updates on the card against the CPU from the
    same fp32 gradients, within ``chip_smoke.OPT_TOL`` (Muon
    ``OPT_NS_TOL``) of max |p|; no kernel launches; an overflowing step
    changes nothing."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from deepspeed_tpu_torch.ops.optimizers import build_optimizer
    from deepspeed_tpu_torch.runtime.engine import _flat_masters

    gen = torch.Generator().manual_seed(5)
    tree = {"embed": torch.randn(300, 64, generator=gen) * 0.1,
            "w": torch.randn(2, 64, 96, generator=gen) * 0.1,
            "norm": torch.ones(2, 64), "final": torch.ones(64)}
    grads = [{k: torch.randn(v.shape, generator=gen) * 1e-2 for k, v in tree.items()}
             for _ in range(3)]
    out = {}
    K.reset_launches()
    for dev in ("cuda", "cpu"):
        masters = _flat_masters(tree, torch.device(dev))
        leaves, gviews = masters.leaves, masters.grads
        opt = build_optimizer(name, chip_smoke.NEW_OPTIMIZERS[name])
        state = opt.init(leaves)
        lr = torch.tensor(1e-3, device=dev)
        for g in grads:
            for view, x in zip(gviews, g.values()):
                view.copy_(x)
            opt.step(leaves, gviews, state, lr)
        before = masters.flat.detach().clone()
        for view in gviews:
            view.fill_(float("inf"))
        opt.step(leaves, gviews, state, lr, finite=torch.tensor(False, device=dev))
        assert torch.equal(masters.flat, before) and int(state["count"]) == 3
        out[dev] = before.cpu()
    assert sum(K.LAUNCHES.values()) == 0
    tol = chip_smoke.OPT_NS_TOL if name == "muon" else chip_smoke.OPT_TOL
    assert float((out["cuda"] - out["cpu"]).abs().max()) <= tol * float(out["cpu"].abs().max())


@pytest.mark.gpu
@pytest.mark.parametrize("remat", ["dots", "offload"])
def test_dots_and_offload_gradients_equal_none_on_the_card(remat):
    """``tiny`` with one head of 64, bf16, through K1f / K1b: the same
    gradients, bit for bit, under ``remat`` as under ``none``; under
    ``dots`` K1f runs twice a layer, under ``offload`` once, and offload's
    copies are counted."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from deepspeed_tpu_torch.models import transformer as T
    from deepspeed_tpu_torch.models.presets import get_preset

    # one head of 64 (no query group: K1b sums no heads into a kv head)
    cfg = get_preset("tiny", num_heads=1, num_kv_heads=1, attn_impl="flash")
    params = T.init_params(cfg, seed=0, device="cuda")
    tokens = torch.randint(0, 256, (2, 129), generator=torch.Generator().manual_seed(1)).cuda()

    def grads(r):
        leaves = []

        def walk(node):
            if isinstance(node, dict):
                return {k: walk(v) for k, v in node.items()}
            leaves.append(node.detach().clone().requires_grad_(True))
            return leaves[-1]

        tree = walk(params)
        K.reset_launches()
        T.CausalLM(cfg.replace(remat=r)).loss_fn(tree, {"input_ids": tokens}).backward()
        return [x.grad for x in leaves], K.LAUNCHES["flash_fwd"]

    want, fwd_none = grads("none")
    before = dict(T.OFFLOAD_BYTES)
    got, fwd = grads(remat)
    moved = {k: T.OFFLOAD_BYTES[k] - before[k] for k in before}
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert fwd_none == cfg.num_layers
    assert fwd == (2 if remat == "dots" else 1) * cfg.num_layers
    if remat == "offload":  # every copy to the host comes back (o twice: two readers)
        assert 0 < moved["to_host"] <= moved["to_device"]


@pytest.mark.gpu
def test_offload_keeps_its_saved_tensors_in_pinned_host_memory():
    """Under ``offload_saved`` a CUDA tensor saved for the backward lives in
    pinned host memory until the backward brings it back; the tensors it is
    told to keep stay on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from deepspeed_tpu_torch.models import transformer as T

    x = torch.randn(64, 64, device="cuda", requires_grad=True)
    keep = torch.randn(64, 64, device="cuda", requires_grad=True)
    copies: list = []
    with T.offload_saved(lambda t: t is keep, copies):
        y = (x.sin() * keep).sum()
    assert copies and all(h.device.type == "cpu" and h.is_pinned() for _, h in copies)
    assert all(h.shape == (64, 64) for _, h in copies)
    y.backward()
    torch.testing.assert_close(x.grad, x.detach().cos() * keep.detach())
    torch.testing.assert_close(keep.grad, x.detach().sin())


@pytest.mark.gpu
def test_inject_under_a_captured_graph_reads_the_injected_pages():
    """The paged-KV handoff writes the destination's pool tensors in place:
    a burst graph captured BEFORE the injection replays over the injected
    pages (no recapture, the pool's addresses unchanged) and its picks stay
    near-argmax against the port on the CPU in fp32."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    from deepspeed_tpu_torch.inference.engine_v2 import InferenceEngineV2
    from deepspeed_tpu_torch.models.transformer import init_params
    from deepspeed_tpu_torch.serving import extract_request

    cfg = _small_serving_cfg()
    params = init_params(cfg, seed=0, device="cuda")
    kw = dict(max_seqs=4, num_blocks=32, block_size=16, prefill_buckets=(64,),
              prefill_budget=64)
    src, dst = InferenceEngineV2(params, cfg, **kw), InferenceEngineV2(params, cfg, **kw)
    prompt = list(range(3, 43))
    src.put([1], [prompt])
    dst.put([9], [list(range(50, 70))])
    dst.step_n(2)  # captures the greedy tick over dst's pool
    dst.flush([9])
    graph, ptrs = dst._burst.graphs[chip_smoke.GREEDY], [p.data_ptr() for p in dst._pool_leaves()]
    for fmt in ("none", "int8"):
        ho = extract_request(src, 1, fmt)
        assert ho.n_pages == 3 and ho.fmt == fmt
        seq = chip_smoke._adopt_injected(dst, ho)
        K.reset_launches()
        dst.step_n(6)
        assert K.LAUNCHES["paged_decode_hd64"] == 6 * cfg.num_layers
        assert dst._burst.graphs[chip_smoke.GREEDY] is graph
        assert [p.data_ptr() for p in dst._pool_leaves()] == ptrs
        gen = seq.tokens[len(prompt):]
        worst, _, _ = chip_smoke.replay_on_cpu(torch, chip_smoke._tree_cpu(params), cfg,
                                               {1: prompt}, {1: gen})
        assert len(gen) == 7 and worst <= chip_smoke.ARGMAX_TOL_FRAC, (fmt, worst)
        dst.flush([1])
    for eng in (src, dst):
        assert eng.close()["blocks_in_use"] == 0


@pytest.mark.gpu
def test_router_on_the_card_matches_the_cpu():
    """The router over 3 workers (1 prefill) on the card, 2 layers of the
    410M model: every routed and migrated stream near-argmax against the
    port on the CPU in fp32, for the 'none' and 'int8' handoffs
    (``chip_smoke.router_check_phase``)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    from deepspeed_tpu_torch.models.presets import get_preset

    res = chip_smoke.router_check_phase(torch, K, "test", get_preset("llama3_proxy_410m"))
    assert res["runs"]["int8"]["codec_bytes_equal_numpy"] is True
    assert all(r["migrated_streams"] and r["routed_streams"] for r in res["runs"].values())


@pytest.mark.gpu
def test_kernel_errors_surface_through_the_router_on_the_card():
    """A ``KernelError`` from one worker's paged-decode launch raises out of
    ``Router.tick``: no request FAILED, no retry, no worker death
    (``chip_smoke.kernel_errors_phase``)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    from deepspeed_tpu_torch.models.presets import get_preset

    res = chip_smoke.kernel_errors_phase(torch, K, "test", get_preset("llama3_proxy_410m"))
    assert res["launches_refused"] >= 1 and "cudaError" in res["raised"]


@pytest.mark.gpu
def test_spawned_cuda_worker_serves_a_request():
    """A subprocess worker on the card (its own CUDA context; the kernels
    built here first): one request's tokens equal an in-process engine's on
    the same seeded weights, its ``stats`` show its own K1f and K2 launches
    and device memory, its close audit holds 0 blocks, and it is reaped."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    from deepspeed_tpu_torch.inference.engine_v2 import build_serve_engine
    from deepspeed_tpu_torch.inference.sampling import SamplingParams
    from deepspeed_tpu_torch.models.transformer import init_params
    from deepspeed_tpu_torch.serving import RemotePool, Router

    from deepspeed_tpu_torch.models.presets import get_preset

    # the spec names a registered preset (hd 128: K2's paged_decode)
    cfg = get_preset("llama3_proxy_410m", max_seq_len=256, dtype=torch.bfloat16)
    sec = dict(max_seqs=4, num_blocks=32, block_size=16, prefill_buckets=[64], prefill_budget=64)
    spec = {"preset": "llama3_proxy_410m", "seed": 0, "dtype": "bfloat16",
            "max_seq_len": cfg.max_seq_len, "sec": sec, "device": "cuda"}
    samp = SamplingParams(temperature=0.0, max_new_tokens=8)
    prompt = list(range(3, 43))
    ref = build_serve_engine(init_params(cfg, seed=0, device="cuda", dtype=torch.bfloat16),
                             cfg, sec)
    want = ref.generate(prompt, samp)
    assert ref.close()["blocks_in_use"] == 0
    pool = RemotePool(spec, n_workers=1, config=dict(n_workers=1, heartbeat_interval_ms=40.0,
                                                     lease_ms=1500.0))
    router = Router(pool, pool.config)
    handle = pool.workers[0].handle
    try:
        router.submit(1, prompt, samp)
        assert router.run(max_ticks=200)[1] == ("finished", want)
        st = pool.workers[0].stats()
        assert st["launches"]["flash_fwd"] >= cfg.num_layers
        assert st["launches"]["paged_decode"] >= 7 * cfg.num_layers
        assert st["memory_allocated"] > 0
        audits = router.close()
    finally:
        pool.close()
    assert audits == [{"blocks_in_use": 0, "cached_blocks": audits[0]["cached_blocks"]}]
    assert handle.proc.poll() is not None


@pytest.mark.gpu
def test_bf16_handoff_round_trips_over_a_socket_on_the_card():
    """bf16 pages extracted on the card go over a socket as ``"bfloat16"``
    leaves into a ``WorkerServer``'s engine (``adopt``), come back out of it
    (``extract``) bit for bit, and the adopter decodes the source's own
    continuation."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    import threading

    from deepspeed_tpu_torch.inference.engine_v2 import InferenceEngineV2
    from deepspeed_tpu_torch.models.transformer import init_params
    from deepspeed_tpu_torch.serving import extract_request, transport as T

    cfg = _small_serving_cfg()
    params = init_params(cfg, seed=0, device="cuda")
    kw = dict(max_seqs=4, num_blocks=32, block_size=16, prefill_buckets=(64,), prefill_budget=64)
    src, dst = InferenceEngineV2(params, cfg, **kw), InferenceEngineV2(params, cfg, **kw)
    prompt = list(range(3, 43))
    src.put([1], [prompt])
    ho = extract_request(src, 1, "none")
    meta, blobs = T.encode_handoff(ho)
    assert {leaf["dtype"] for leaf in meta["leaves"]} == {"bfloat16"}
    srv = T.WorkerServer(dst)
    srv.bind()
    t = threading.Thread(target=srv.serve_socket, daemon=True)
    t.start()
    try:
        c = T.RpcClient(lambda: T.dial("127.0.0.1", srv.port, "rpc"))
        reply, _ = c.call({"op": "adopt", "handoff": meta, "sampling": {"max_new_tokens": 5}},
                          blobs)
        assert reply["ok"] and reply["result"]["reason"] == "queued", reply
        reply, back = c.call({"op": "extract", "uid": 1, "fmt": "none"})
        assert back == blobs  # the pages, bit for bit, after a round trip
        for _ in range(8):
            reply, _ = c.call({"op": "tick"})
            if reply["requests"]["1"]["state"] == "finished":
                break
        reply, _ = c.call({"op": "pop", "uid": 1})
        for _ in range(4):
            src.step()
        assert reply["result"]["tokens"] == src.mgr.seqs[1].tokens[len(prompt):]
        c.call({"op": "close"})
        c.close()
    finally:
        srv.shutdown()
        t.join(timeout=5.0)
    assert srv.close_audit["blocks_in_use"] == 0 and src.close()["blocks_in_use"] == 0


def _flat_tree(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        out.update(_flat_tree(v, prefix + k + "/") if isinstance(v, dict) else {prefix + k: v})
    return out


@pytest.mark.gpu
def test_async_save_and_resume_on_the_card_is_bitwise(tmp_path):
    """A 2-layer model of the 410M's width on CUDA (bf16 over fp32 masters,
    K1 and K8): 3 uninterrupted steps; a fresh engine takes 1, saves
    asynchronously mid-``train_on_loader`` and takes its next step during
    the write; a third loads and takes 2.  The resumed losses equal the
    uninterrupted ones to the bit and the state after the load the saved
    one byte for byte."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    chip_smoke.CKPT_SIZES = dict(seq=512, micro=2, gas=2, rows=24)
    from deepspeed_tpu_torch import initialize
    from deepspeed_tpu_torch.models.presets import get_preset
    from deepspeed_tpu_torch.models.transformer import CausalLM

    def make():
        model = CausalLM(get_preset("llama3_proxy_410m", num_layers=2))
        conf = chip_smoke.bench_config(2, 2)
        conf["checkpoint"] = {"async_save": True}
        engine, _, loader, _ = initialize(
            model=model, config=conf,
            training_data=chip_smoke.TokenRows(model.cfg.vocab_size, 24, 512))
        return engine, loader

    a, la = make()
    want = [float(x) for x in a.train_on_loader(la, num_steps=3)]
    b, lb = make()
    gen = b.train_on_loader(lb)
    got = [float(next(gen))]
    b.save_checkpoint(str(tmp_path), tag="t")
    at_save = chip_smoke._state_snapshot(torch, b)
    assert b._ckpt_engine.pending
    assert float(next(gen)) == want[1]
    b.wait_pending_checkpoint()
    gen.close()
    c, lc = make()
    K.reset_launches()
    c.load_checkpoint(str(tmp_path))
    assert chip_smoke._byte_diff(torch, chip_smoke._state_snapshot(torch, c), at_save) == []
    got += [float(x) for x in c.train_on_loader(lc, num_steps=2)]
    assert got == want
    assert K.LAUNCHES["flash_fwd"] == 2 * 2 * 2 and K.LAUNCHES["fused_adamw"] == 2


@pytest.mark.gpu
def test_hf_round_trip_serves_the_same_tokens_on_the_card(tmp_path):
    """The 410M model cut to 2 layers, bf16: exported to safetensors,
    streamed back onto the card (bitwise), and served greedily with the
    original's tokens (K1f and K2 launched)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    from deepspeed_tpu_torch.checkpoint.hf_import import export_hf_checkpoint, load_hf_checkpoint
    from deepspeed_tpu_torch.inference.engine_v2 import InferenceEngineV2
    from deepspeed_tpu_torch.inference.sampling import SamplingParams
    from deepspeed_tpu_torch.models.presets import get_preset
    from deepspeed_tpu_torch.models.transformer import init_params

    cfg = get_preset("llama3_proxy_410m", num_layers=2)
    params = init_params(cfg, seed=1, device="cuda")
    export_hf_checkpoint(params, cfg, str(tmp_path))
    loaded, lcfg = load_hf_checkpoint(str(tmp_path), dtype=torch.bfloat16)
    fo, fl = _flat_tree(params), _flat_tree(loaded)
    assert set(fo) == set(fl)
    assert all(fl[k].is_cuda and chip_smoke._same_bytes(torch, fl[k], fo[k]) for k in fo)
    prompts = [list(range(5 + i, 45 + i)) for i in range(4)]
    samp = SamplingParams(temperature=0.0, max_new_tokens=16)
    out = {}
    for name, tree, c in (("original", params, cfg), ("imported", loaded, lcfg)):
        eng = InferenceEngineV2(tree, c, max_seqs=4, num_blocks=64, block_size=32,
                                prefill_budget=256)
        K.reset_launches()
        out[name] = chip_smoke._serve_greedy(eng, prompts, samp)
        assert K.LAUNCHES["flash_fwd"] >= 2 and K.LAUNCHES["paged_decode"] >= 2 * 15
        assert eng.close()["blocks_in_use"] == 0
    assert out["imported"] == out["original"]


@pytest.mark.gpu
def test_spawned_children_keep_their_reply_caches_under_the_byte_cap():
    """Long prompts migrate from a spawned prefill child to a decode child
    (each handoff's pages ride a cached ``extract`` reply): every child's
    ``reply_cache_bytes`` stays within ``WorkerServer``'s byte cap."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    from deepspeed_tpu_torch.inference.sampling import SamplingParams
    from deepspeed_tpu_torch.serving import RemotePool, Router

    sec = dict(max_seqs=4, num_blocks=64, block_size=16, prefill_buckets=[64, 128, 256],
               prefill_budget=256)
    spec = {"preset": "llama3_proxy_410m", "seed": 0, "dtype": "bfloat16", "max_seq_len": 512,
            "sec": sec, "device": "cuda"}
    pool = RemotePool(spec, n_workers=2, prefill_workers=1,
                      config=dict(n_workers=2, prefill_workers=1,
                                  disagg_threshold=64, heartbeat_interval_ms=40.0,
                                  lease_ms=1500.0))
    router = Router(pool, pool.config)
    handles = [w.handle for w in pool.workers]
    try:
        samp = SamplingParams(temperature=0.0, max_new_tokens=4)
        for u in range(6):
            router.submit(u + 1, list(range(3 + u, 203 + u)), samp)
        out = router.run(max_ticks=400)
        assert all(s == "finished" for s, _ in out.values())
        assert router.stats["handoffs"] >= 1
        caches = [w.stats()["reply_cache_bytes"] for w in pool.workers]
        audits = router.close()
    finally:
        pool.close()
    assert max(caches) > 0 and all(c <= chip_smoke.reply_cache_cap() for c in caches)
    assert all(a["blocks_in_use"] == 0 for a in audits)
    assert all(h.proc.poll() is not None for h in handles)


def _narrow_moe(dtype, **over):
    """mixtral_8x7b's switches at the smoke's narrow width
    (``chip_smoke.MOE_NARROW``)."""
    from deepspeed_tpu_torch.models.presets import get_preset

    return get_preset("mixtral_8x7b", dtype=dtype, max_seq_len=256,
                      **{**chip_smoke.MOE_NARROW, **over})


@pytest.mark.gpu
def test_moe_loss_and_grads_on_the_card_match_the_cpu():
    """The routed path (gather into the [E, C, d] slab, batched expert
    products, weighted combine) in fp32 on the card against the CPU:
    ``chip_smoke.moe_narrow_check`` (loss and every gradient leaf within
    ``MOE_CHECK_TOL`` relative Frobenius error)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    res = chip_smoke.moe_narrow_check(torch)
    assert res["worst_grad_rel_err"] <= chip_smoke.MOE_CHECK_TOL


@pytest.mark.gpu
def test_moe_burst_is_token_identical_to_per_tick_steps_on_the_card():
    """A narrow bf16 MoE tree on the v2 engine: ``step_n`` (the captured
    decode graph, dropless experts inside) gives the tokens of per-tick
    ``step()``s, and K2 launches layers x ticks in both."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    from deepspeed_tpu_torch.inference.engine_v2 import InferenceEngineV2
    from deepspeed_tpu_torch.inference.sampling import SamplingParams
    from deepspeed_tpu_torch.models.transformer import init_params

    cfg = _narrow_moe(torch.bfloat16)
    params = init_params(cfg, seed=2, device="cuda")
    prompts = [list(range(3 + i, 60 + i)) for i in range(3)]
    samp = SamplingParams(temperature=0.0, max_new_tokens=40)
    streams = []
    for burst in (False, True):
        eng = InferenceEngineV2(params, cfg, max_seqs=4, num_blocks=32, block_size=32)
        eng.put([1, 2, 3], prompts, samp)
        eng.step_n(2, samp) if burst else [eng.step(samp) for _ in range(2)]  # capture
        K.reset_launches()
        if burst:
            eng.step_n(12, samp)
        else:
            for _ in range(12):
                eng.step(samp)
        assert K.LAUNCHES["paged_decode"] == cfg.num_layers * 12
        streams.append([list(eng.mgr.seqs[u].tokens) for u in (1, 2, 3)])
        assert eng.close()["blocks_in_use"] == 0
    assert streams[0] == streams[1]


@pytest.mark.gpu
@pytest.mark.parametrize("family", ["moe", "alibi", "parallel"])
def test_v1_engine_on_the_card_is_token_identical_to_the_cpu(family):
    """``init_inference`` in fp32 on the card (the plain attention body over
    the dense cache) against the CPU: the narrow MoE config, and
    ``tiny_alibi`` / ``tiny_parallel`` at hidden 256."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    import numpy as np
    from deepspeed_tpu_torch.inference import init_inference
    from deepspeed_tpu_torch.inference.sampling import SamplingParams
    from deepspeed_tpu_torch.models.presets import get_preset
    from deepspeed_tpu_torch.models.transformer import CausalLM, init_params

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = (_narrow_moe(torch.float32) if family == "moe" else
           get_preset(f"tiny_{family}", dtype=torch.float32, hidden_size=256,
                      intermediate_size=512))
    params = init_params(cfg, seed=3, device="cpu", dtype=torch.float32)
    prompts = np.random.default_rng(3).integers(1, cfg.vocab_size, (2, 33))
    samp = SamplingParams(max_new_tokens=12)
    cpu = init_inference(CausalLM(cfg), params, device="cpu").generate(prompts, samp)
    card = init_inference(CausalLM(cfg), chip_smoke._to(params, "cuda")).generate(prompts, samp)
    np.testing.assert_array_equal(card, cpu)


@pytest.mark.gpu
def test_v1_full_cache_prefill_takes_the_flash_kernel_on_the_card():
    """A prompt that fills the whole dense cache (s = max_seq_len = 128,
    head dim 64, bf16): every layer's attention is K1f (one launch each),
    the decode after it the plain body, as JAX's ``supports()`` chooses."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    import numpy as np
    from deepspeed_tpu_torch.inference import init_inference
    from deepspeed_tpu_torch.inference.sampling import SamplingParams
    from deepspeed_tpu_torch.models import transformer as T
    from deepspeed_tpu_torch.models.presets import get_preset

    cfg = get_preset("tiny", hidden_size=256, num_heads=4, num_kv_heads=2, attn_impl="auto")
    eng = init_inference(T.CausalLM(cfg), seed=4, max_seq_len=128)
    prompts = np.random.default_rng(4).integers(1, cfg.vocab_size, (2, 128))
    T.CACHE_ATTENTION.update(flash=0, plain=0)
    K.reset_launches()
    out = eng.generate(prompts, SamplingParams(max_new_tokens=3))
    assert out.shape == (2, 1)
    assert T.CACHE_ATTENTION == {"flash": cfg.num_layers, "plain": 0}
    assert K.LAUNCHES["flash_fwd"] == cfg.num_layers


def _offload_engines(tmp_path, **zero):
    """A 2-layer flagship-width engine (seq 256, micro 2, GAS 2, bf16,
    AdamW) with the given ``zero_optimization`` keys, and 3 batches."""
    import numpy as np

    from deepspeed_tpu_torch import initialize
    from deepspeed_tpu_torch.models.presets import get_preset
    from deepspeed_tpu_torch.models.transformer import CausalLM

    cfg = get_preset("llama3_proxy_410m", num_layers=2, loss_chunk_size=2048)
    batches = [{"input_ids": b} for b in np.random.default_rng(0).integers(
        0, cfg.vocab_size, (3, 2, 2, 257), dtype=np.int64)]
    conf = chip_smoke._offload_conf(2, 2, **zero)
    return initialize(model=CausalLM(cfg), config=conf, device="cuda")[0], batches


def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the offload tiers stream through the card)")


@pytest.mark.gpu
def test_cpu_tier_is_bit_identical_to_the_plain_engine_on_the_card(tmp_path, monkeypatch):
    _needs_card()
    from deepspeed_tpu_torch.runtime import offload

    monkeypatch.setattr(offload, "CHUNK_ELEMS", 1 << 20)  # several chunks a step
    plain, batches = _offload_engines(tmp_path)
    p_losses = [float(plain.train_batch(b)) for b in batches]
    p_masters = chip_smoke._masters_cpu(torch, plain)
    del plain
    tier, _ = _offload_engines(tmp_path, offload_optimizer="cpu")
    K.reset_launches()
    t_losses = [float(tier.train_batch(b)) for b in batches]
    assert K.LAUNCHES["fused_adamw"] == 3 * len(tier._offload.chunks) > 3
    assert t_losses == p_losses
    got = chip_smoke._masters_cpu(torch, tier)
    assert all(torch.equal(got[k], p_masters[k]) for k in p_masters)
    chip_smoke._close_engine(tier)


@pytest.mark.gpu
def test_cpu_tier_state_is_pinned_and_the_card_holds_the_rest(tmp_path):
    _needs_card()
    torch.cuda.empty_cache()
    before = torch.cuda.memory_allocated()
    tier, _ = _offload_engines(tmp_path, offload_param="cpu")
    used = torch.cuda.memory_allocated() - before
    off = tier.memory_breakdown()["offload"]
    want = off["device_compute_bytes"] + off["device_grad_bytes"] + off["device_staging_bytes"]
    assert abs(used - want) <= chip_smoke.OFFLOAD_MEM_TOL * want, (used, want)
    host = [tier._offload.masters, *tier._offload.slot_flat]
    assert all(t.device.type == "cpu" and t.is_pinned() for t in host)
    assert off["pinned_bytes"] == off["host_state_bytes"] == sum(t.numel() * 4 for t in host)
    chip_smoke._close_engine(tier)


@pytest.mark.gpu
def test_nvme_tier_within_tolerance_of_the_plain_engine_on_the_card(tmp_path):
    _needs_card()
    plain, batches = _offload_engines(tmp_path)
    nv, _ = _offload_engines(tmp_path, offload_optimizer={
        "device": "nvme", "nvme_path": str(tmp_path / "swap")}, offload_grad_dtype="bf16")
    for i, b in enumerate(batches):
        n_loss, p_loss = float(nv.train_batch(b)), float(plain.train_batch(b))
        assert i or n_loss == p_loss  # step 1 runs the same bf16 weights
        ref = chip_smoke._masters_cpu(torch, plain)
        err = chip_smoke._rel_to_max(torch, chip_smoke._masters_cpu(torch, nv), ref)
        assert err <= chip_smoke.nvme_drift_bound(1e-4, i + 1, ref), (i, err)
    chip_smoke._close_engine(nv)


@pytest.mark.gpu
@pytest.mark.parametrize("tier", ["cpu", "nvme"])
def test_offload_resume_on_the_card_is_bitwise(tmp_path, tier):
    _needs_card()

    def zero(name):
        if tier == "cpu":
            return {"offload_optimizer": "cpu"}
        return {"offload_optimizer": {"device": "nvme", "nvme_path": str(tmp_path / name)}}

    run, batches = _offload_engines(tmp_path, **zero("a"))
    run.train_batch(batches[0])
    run.save_checkpoint(str(tmp_path / "ckpt"), tag="s1")
    ref = [float(run.train_batch(b)) for b in batches[1:]]
    ref_m = chip_smoke._masters_cpu(torch, run)
    chip_smoke._close_engine(run)
    del run
    resumed, _ = _offload_engines(tmp_path, **zero("b"))
    resumed.load_checkpoint(str(tmp_path / "ckpt"), tag="s1")
    assert [float(resumed.train_batch(b)) for b in batches[1:]] == ref
    got = chip_smoke._masters_cpu(torch, resumed)
    assert all(torch.equal(got[k], ref_m[k]) for k in ref_m)
    chip_smoke._close_engine(resumed)


# ---------------------------------------------------------------------------
# the instrumented, scheduled step (timers, accelerator, flops profiler,
# progressive layer drop, curriculum lengths)
# ---------------------------------------------------------------------------
@pytest.mark.gpu
def test_accelerator_and_timer_fence_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    from deepspeed_tpu_torch.accelerator import get_accelerator
    from deepspeed_tpu_torch.utils import timer

    acc = get_accelerator()
    assert acc.platform() == "cuda" and acc.device_kind() == torch.cuda.get_device_name(0)
    assert acc.communication_backend_name() == "nccl"
    x = torch.ones(1 << 20, device="cuda")
    stats = acc.memory_stats()
    assert stats["bytes_in_use"] >= x.numel() * 4 and stats["bytes_limit"] > 0
    before = timer.TIMER_SYNCS["count"]
    y = x * 2
    timer._block(y)
    assert timer.TIMER_SYNCS["count"] == before + 1 and torch.cuda.current_stream().query()


@pytest.mark.gpu
@pytest.mark.parametrize("seg_lens", [None, [300, 220]])
def test_profiler_counts_k1_at_its_closed_form_on_the_card(seg_lens):
    """K1f / K1b under ``executed_analysis`` on the card: the kernels' own
    count (4 hd a causal pair and query head, 10 hd backward) at s 520,
    a partial tile; with segments, the pairs within them."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    from deepspeed_tpu_torch.profiling import executed_analysis

    b, s, hq, hkv, hd = 2, 520, 8, 2, 128
    gen = torch.Generator(device="cuda").manual_seed(0)
    q, k, v = (torch.randn(b, s, h, hd, generator=gen, device="cuda", dtype=torch.bfloat16)
               .requires_grad_(True) for h in (hq, hkv, hkv))
    seg = None
    pairs = b * s * (s + 1) // 2
    if seg_lens is not None:
        seg = torch.tensor([[0] * seg_lens[0] + [1] * seg_lens[1]] * b, dtype=torch.int32,
                           device="cuda")
        pairs = b * sum(n * (n + 1) // 2 for n in seg_lens)
    with executed_analysis("cuda") as out:
        flash_attention(q, k, v, segment_ids=seg).float().square().sum().backward()
    assert out["kernel_flops"] == {"flash_fwd": 4 * hd * hq * pairs,
                                   "flash_bwd": 10 * hd * hq * pairs}
    assert out["peak_bytes"] > 0 and out["flops"] == out["aten_flops"] + 14 * hd * hq * pairs


@pytest.mark.gpu
def test_scheduled_step_on_the_card_is_bit_identical_with_the_profiler():
    """A 2-layer engine with the curriculum (cut to 520), PLD and the
    profiler on, against the same engine with the profiler off: the same
    losses and masters to the bit; K1f / K1b the kept layers x GAS a step."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    import numpy as np

    import deepspeed_tpu_torch as dst
    from deepspeed_tpu_torch.models.presets import get_preset
    from deepspeed_tpu_torch.models.transformer import CausalLM, init_params

    cfg = get_preset("tiny", hidden_size=256, intermediate_size=512, num_heads=2,
                     num_kv_heads=1, num_layers=3, attn_impl="flash", remat="selective")
    params = init_params(cfg, seed=0, device="cpu", dtype=torch.float32)
    batch = {"input_ids": np.random.default_rng(0).integers(0, 256, (2, 2, 1025))}
    conf = {"train_micro_batch_size_per_gpu": 2, "gradient_accumulation_steps": 2,
            "optimizer": {"type": "adamw", "params": {"lr": 1e-3}},
            "progressive_layer_drop": {"enabled": True, "theta": 0.3, "gamma": 1.0},
            "data_efficiency": chip_smoke._curriculum(520, 1024, 4, 8)}
    runs = {}
    for prof in (False, True):
        eng, _, _, _ = dst.initialize(model=CausalLM(cfg), params=params, config=dict(
            conf, flops_profiler={"enabled": prof, "profile_step": 2}))
        losses, kept, launches = [], [], []
        for _ in range(3):
            before = dict(K.LAUNCHES)
            losses.append(float(eng.train_batch(batch)))
            kept.append([int(m.sum()) for m in eng.pld_masks])
            launches.append(chip_smoke._launch_diff(K, before))
        runs[prof] = (losses, kept, launches, eng._masters.flat.clone())
    assert runs[True][:2] == runs[False][:2]
    assert torch.equal(runs[True][3], runs[False][3])
    for ks, ls in zip(runs[True][1], runs[True][2]):
        chip_smoke._step_launch_gate("test", ls, ks)
    assert any(k < cfg.num_layers for ks in runs[True][1] for k in ks)


# ---------------------------------------------------------------------------
# compression-aware and parameter-efficient training
# ---------------------------------------------------------------------------
@pytest.mark.gpu
@pytest.mark.parametrize("kernel", ["K1", "K7"])
def test_double_backward_through_the_flash_kernels_raises_on_the_card(kernel):
    """A second derivative through K1's or K7's Function raises on the card
    (the kernels' backward outputs carry no graph) instead of returning a
    second derivative without the attention's term."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    import numpy as np

    from deepspeed_tpu_torch.ops.kernels.sparse_attention import block_sparse_flash_attention

    layout = np.tril(np.ones((2, 2), bool))
    attn = {"K1": lambda q, k, v: flash_attention(q, k, v, causal=True),
            "K7": lambda q, k, v: block_sparse_flash_attention(q, k, v, layout, 128)}[kernel]
    assert chip_smoke._double_backward_raises(torch, attn, "cuda", torch.bfloat16)


def _narrow_cfg(**over):
    from deepspeed_tpu_torch.models.presets import get_preset

    return get_preset("tiny", hidden_size=256, intermediate_size=512, num_heads=4,
                      num_kv_heads=2, num_layers=2, max_seq_len=512, **over)


@pytest.mark.gpu
def test_compression_transform_is_identical_on_the_card_and_the_cpu():
    """``CompressionManager.transform`` of every technique (``chip_smoke.
    compression_config``) at steps around the offsets, fp32 and bf16: the
    card's masks, kept units and fake-quantized bits equal the CPU's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    from deepspeed_tpu_torch.compression.compress import CompressionManager
    from deepspeed_tpu_torch.models.transformer import init_params

    cfg = _narrow_cfg()
    params = init_params(cfg, seed=0, device="cpu", dtype=torch.float32)
    mgr = CompressionManager(chip_smoke.compression_config(cfg, 2, 3))
    for dtype in (torch.float32, torch.bfloat16):
        cpu_p, card_p = chip_smoke._to(params, "cpu", dtype), chip_smoke._to(params, "cuda", dtype)
        for step in (0, 1, 2, 3, 6):
            got = mgr.transform(card_p, torch.tensor(step, dtype=torch.int32, device="cuda"))
            want = mgr.transform(cpu_p, torch.tensor(step, dtype=torch.int32))
            assert chip_smoke._tree_mismatches(torch, got, want) == {}, (dtype, step)
    a, ia = mgr.redundancy_clean(chip_smoke._to(params, "cuda"))
    b, ib = mgr.redundancy_clean(chip_smoke._to(params, "cpu"))
    assert ia == ib and chip_smoke._tree_mismatches(torch, a, b) == {}


@pytest.mark.gpu
def test_hybrid_burst_after_a_refresh_equals_per_tick_decoding_on_the_card():
    """A LoRA engine's hybrid with ``decode_megastep`` 4 captures its burst
    graph before training; after two steps its refresh writes the merged
    weights into the same serving tensors, and the replayed bursts give
    the per-tick hybrid's tokens (and not the stale weights' tokens)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    import numpy as np

    import deepspeed_tpu_torch as dst
    from deepspeed_tpu_torch.inference.sampling import SamplingParams
    from deepspeed_tpu_torch.linear import LoRACausalLM, LoRAConfig
    from deepspeed_tpu_torch.models.transformer import CausalLM
    from deepspeed_tpu_torch.runtime.hybrid_engine import DeepSpeedHybridEngine

    cfg = _narrow_cfg(attn_impl="flash", remat="selective")
    model = LoRACausalLM(CausalLM(cfg), LoRAConfig(lora_r=8, lora_alpha=16.0))
    engine, _, _, _ = dst.initialize(model=model, params=model.init_params(seed=0), config={
        "train_micro_batch_size_per_gpu": 2,
        "optimizer": {"type": "adamw", "params": {"lr": 1e-2}}})
    serve = dict(max_seqs=2, num_blocks=64, block_size=16, max_seq_len=256)
    burst = DeepSpeedHybridEngine(engine, serve={"decode_megastep": 4}, **serve)
    tick = DeepSpeedHybridEngine(engine, **serve)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, 256, 24).tolist() for _ in range(2)]
    samp = SamplingParams(temperature=0.0, max_new_tokens=12)
    before = [burst.generate(p, samp) for p in prompts]
    graphs = dict(burst._inference._burst.graphs)
    assert graphs and burst._inference.stats["decode_bursts"] > 0
    batch = {"input_ids": rng.integers(0, 256, (2, 129))}
    for _ in range(2):
        engine.train_batch(batch)
    after = [burst.generate(p, samp) for p in prompts]
    assert after == [tick.generate(p, samp) for p in prompts]
    assert after != before
    assert {k: v for k, v in burst._inference._burst.graphs.items()} == graphs  # no recapture
    for h in (burst, tick):
        assert h._inference.close()["blocks_in_use"] == 0


# ---------------------------------------------------------------------------
# the kernels as torch.library ops, under torch.compile; the quantized
# hybrid refresh
# ---------------------------------------------------------------------------
@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["flash", "sparse"])
def test_custom_ops_on_the_card_equal_their_plain_versions(kind):
    """``dstpu::flash_fwd`` / ``flash_bwd`` (K1) and ``dstpu::sparse_fwd`` /
    ``sparse_bwd`` (K7) called on CUDA bf16 tensors: one launch of each
    kernel a call, o within ``KERNEL_TOL`` and lse within ``LSE_TOL`` of
    the plain version on the CPU in fp32, dq / dk / dv within ``BWD_TOL``
    relative Frobenius error (segments and a soft cap, a query group of
    4)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    from deepspeed_tpu_torch.ops.kernels import sparse_attention as K7

    gen = torch.Generator().manual_seed(0)
    b, s, d = 1, 512, 128
    q, k, v, do = (torch.randn(b, s, h, d, generator=gen).bfloat16() for h in (8, 2, 2, 8))
    seg = torch.tensor([[0] * 200 + [1] * 312], dtype=torch.int32)
    sc, cap = d ** -0.5, 20.0
    if kind == "flash":
        fwd, bwd, names = torch.ops.dstpu.flash_fwd, torch.ops.dstpu.flash_bwd, \
            ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")

        def extra(dev):
            return (seg.to(dev),)
    else:
        fwd, bwd, names = torch.ops.dstpu.sparse_fwd, torch.ops.dstpu.sparse_bwd, \
            ("sparse_fwd", "sparse_bwd_dq", "sparse_bwd_dkv")
        import numpy as np

        layout = np.tril(np.ones((s // 128, s // 128), bool))
        layout[3, 1] = False

        def extra(dev):
            return (seg.to(dev), seg.to(dev))

        tables = {dev: K7.sparse_plan(layout, 128, True, dev).tables for dev in ("cpu", "cuda")}
    outs = {}
    for dev, dtype in (("cpu", torch.float32), ("cuda", torch.bfloat16)):
        args = [t.to(dev, dtype) for t in (q, k, v)]
        tail = (sc, cap) if kind == "flash" else (*tables[dev], 128, sc, cap)
        K.reset_launches()
        o, lse = fwd(*args, *extra(dev), *tail)
        grads = bwd(*args, *extra(dev), o, lse, do.to(dev, dtype), *tail)
        outs[dev] = (o, lse, grads, dict(K.LAUNCHES))
    o, lse, grads, launches = outs["cuda"]
    assert {n: launches[n] for n in names} == {n: 1 for n in names}
    ro, rlse, rgrads, _ = outs["cpu"]
    assert float((o.float().cpu() - ro).abs().max()) <= chip_smoke.KERNEL_TOL
    assert float((lse.cpu() - rlse).abs().max()) <= chip_smoke.LSE_TOL
    for g, r in zip(grads, rgrads):
        whole, worst = chip_smoke.rel_errs(torch, g.cpu(), r)
        assert whole <= chip_smoke.BWD_TOL and worst <= chip_smoke.BWD_TOL


@pytest.mark.gpu
@pytest.mark.parametrize("sparse", [False, True])
def test_compiled_step_launches_what_its_eager_twin_launches_on_the_card(sparse):
    """``chip_smoke._compile_twins`` at 2 layers of the flagship's width,
    seq 1024, under inductor: K1 (K7) layers x GAS a step and K8 once, as
    the eager twin from the same weights, losses within
    ``COMPILE_LOSS_RTOL``, every leaf's update at a cosine of at least
    ``COMPILE_UPDATE_COS_MIN`` with the eager twin's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    z = dict(chip_smoke.COMPILE_TRAIN, seq=1024, micro=2)
    old = chip_smoke.COMPILE_TRAIN
    chip_smoke.COMPILE_TRAIN = z
    try:
        twins = chip_smoke._compile_twins(torch, K, 2, 2, "inductor",
                                          sparse=chip_smoke.SPARSE_FLAGSHIP if sparse else None)
    finally:
        chip_smoke.COMPILE_TRAIN = old
    for run in twins.values():
        chip_smoke.check_train_launches("compiled twin", run["launches"], 2, z["gas"], 2, sparse)
    for a, b in zip(twins["compiled"]["losses"], twins["eager"]["losses"]):
        assert abs(a - b) <= chip_smoke.COMPILE_LOSS_RTOL * abs(b)
    print("compiled twin", sparse, max(twins["compiled"]["loss_rel_diff"]),
          twins["compiled"]["update_cos_min"], twins["compiled"]["update_cos_worst_leaf"])
    assert twins["compiled"]["update_cos_min"] >= chip_smoke.COMPILE_UPDATE_COS_MIN


@pytest.mark.gpu
def test_quantized_hybrid_refresh_with_a_captured_burst_on_the_card():
    """``chip_smoke.hybrid_quant_phase`` at 2 layers of a narrow model: for
    int8, fp8 and fp6 the refresh re-quantizes in place under the burst
    graph captured before training, token-identical to a fresh quantized
    engine built from the trained weights (the phase raises otherwise)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    old = chip_smoke.COMPILE_PRESET, chip_smoke.HYBRID_QUANT, chip_smoke.emit
    chip_smoke.HYBRID_QUANT = dict(old[1], seq=256, prompt_len=32, new=8)
    chip_smoke.emit = lambda obj: None
    try:
        res = chip_smoke.hybrid_quant_phase(torch, K, "test")
    finally:
        chip_smoke.COMPILE_PRESET, chip_smoke.HYBRID_QUANT, chip_smoke.emit = old
    assert all(f["tokens_equal_fresh"] and f["burst_graphs_kept"] for f in res["formats"].values())


@pytest.mark.gpu
def test_zero_train_through_the_launcher_over_nccl_on_the_card(tmp_path):
    """``chip_smoke``'s zero_train at 2 layers of the flagship's width: one
    rank through ``launcher/runner.py --num_gpus 1`` trains stages 0-3,
    ZeRO++ and 1-bit Adam over NCCL at world 1, and a gloo rank the
    ZeRO++ and 1-bit runs on the CPU; ``zero_train_run`` raises unless the
    collectives are the plan's, the launches the closed form, stages 1-3
    at stage 0's losses, the card at the CPU's and each planted fault
    outside that gate."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    K.build(["flash_fwd", "flash_bwd_dq", "fused_adamw", "quantize_int8"])  # the rank loads them
    cpu_out, card_out = str(tmp_path / "cpu.json"), str(tmp_path / "card.json")
    cpu = chip_smoke.zero_worker("cpu", chip_smoke.ZERO_CPU_CASES, cpu_out, layers=2)
    card = chip_smoke.zero_worker("cuda", chip_smoke.ZERO_CASES, card_out, layers=2)
    try:
        runs, refs, gaps = chip_smoke.zero_train_run(torch, K, card, card_out, cpu, cpu_out,
                                                     2)
    finally:
        for p in (cpu, card):
            if p.poll() is None:
                p.terminate()
    assert set(runs) == set(chip_smoke.ZERO_CASES) and set(refs) == set(chip_smoke.ZERO_CPU_CASES)
    assert runs["zeropp"]["launches"]["quantize_int8"] > 0
    print("zero_train twin", {c: r["losses"] for c, r in runs.items()},
          {c: r["losses"] for c, r in refs.items()}, gaps,
          {c: r["seconds"] for c, r in runs.items()})


@pytest.mark.gpu
def test_one_backward_over_a_model_axis_of_one_is_the_plain_backward_bit_for_bit(monkeypatch):
    """The flagship at 4 layers in bf16, one batch: the loss and every
    leaf's gradient through the tensor-parallel path at a model axis of
    one (its all-reduces over a group of one: the identity) equal the plain
    path's bit for bit, and each path repeats itself."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    from deepspeed_tpu_torch.models import transformer as tt
    from deepspeed_tpu_torch.models.presets import get_preset
    from deepspeed_tpu_torch.parallel.context import ParallelContext
    from deepspeed_tpu_torch.parallel.tensor_parallel import TensorParallel

    K.build(["flash_fwd", "flash_bwd_dq"])
    cfg = get_preset("llama3_proxy_410m", num_layers=4)
    model = tt.CausalLM(cfg)
    master = model.init_params(seed=0, device="cuda")
    ids = torch.randint(0, cfg.vocab_size, (1, 257),
                        generator=torch.Generator().manual_seed(0)).cuda()

    def leaves(tree, path=()):
        for k, v in tree.items():
            yield from leaves(v, path + (k,)) if isinstance(v, dict) else [(path + (k,), v)]

    def bf16(tree):
        return {k: bf16(v) if isinstance(v, dict)
                else v.detach().to(torch.bfloat16).requires_grad_(True) for k, v in tree.items()}

    def run(par):
        model.par = par
        params = bf16(master)
        loss = model.loss_fn(params, {"input_ids": ids})
        loss.backward()
        return loss.detach(), {p: leaf.grad for p, leaf in leaves(params)}

    plain = [run(None), run(None)]
    par = ParallelContext(sizes={"model": 1}, coords={"model": 0},
                          tp=TensorParallel(None, cfg, rank=0, size=1))
    monkeypatch.setattr(par, "_all_reduce", lambda x, axis, op="sum": x.clone())
    over = [run(par), run(par)]
    for a, b in ((plain[0], plain[1]), (over[0], over[1]), (plain[0], over[0])):
        assert torch.equal(a[0], b[0])
        differ = [p for p in a[1] if not torch.equal(a[1][p], b[1][p])]
        assert not differ, differ


@pytest.mark.gpu
def test_tp_train_and_serve_over_a_model_axis_of_one_on_the_card(tmp_path):
    """``chip_smoke``'s tp_train / tp_serve runs at 2 layers of the
    flagship's width: one rank through the launcher over NCCL trains stages
    0 and 3 beside the same runs over a model axis of one (and the planted
    loss fault) and serves each format over it; ``tp_train_phase`` and
    ``tp_serve_phase`` raise unless the collectives, launches, losses and
    tokens hold (their loss and shard checks included)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    K.build(["flash_fwd", "flash_bwd_dq", "fused_adamw", "quantize_int8", "paged_decode",
             "ctx_attention", "quant_matmul_int8"])  # the rank loads them
    out = str(tmp_path / "card.json")
    card = chip_smoke.zero_worker("cuda", ("stage0", "stage3") + chip_smoke.TP_CASES
                                  + (chip_smoke.TP_PLANTED, "tp_serve"), out, layers=2)
    try:
        runs = chip_smoke.zero_results(card, out, "card")
    finally:
        if card.poll() is None:
            card.terminate()
    tp = {c: runs.pop(c) for c in list(runs) if c.startswith("tp_")}
    old = chip_smoke.emit
    chip_smoke.emit = lambda obj: None
    try:
        train = chip_smoke.tp_train_phase(torch, K, "test", tp, runs)
        serve = chip_smoke.tp_serve_phase(torch, K, "test", tp)
    finally:
        chip_smoke.emit = old
    assert train["launches"]["flash_fwd"] == 2 * 2 * 2 * 3
    assert serve["launches"]["paged_decode"] > 0
    print("tp twin", {c: r["losses"] for c, r in tp.items() if "losses" in r},
          {c: r["counts"] for c, r in tp.items()})


@pytest.mark.gpu
@pytest.mark.parametrize("seq", [2, 4])
def test_flash_kernels_on_a_ulysses_ranks_heads_match_the_plain_body(seq):
    """Ulysses over ``seq`` ranks in lockstep (``chip_smoke._Collectives``):
    each rank's heads at the whole sequence through K1f / K1b (4 q / 1 kv
    heads a rank at 2, the uneven heads' grouped path at 4) against the
    same ranks through the plain body; output and q / k / v gradients."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    from deepspeed_tpu_torch.ops.attention import dot_product_attention
    from deepspeed_tpu_torch.sequence.layer import DistributedAttention

    K.build(["flash_fwd", "flash_bwd_dq"])
    gen = torch.Generator(device="cuda").manual_seed(24)
    b, s, hq, hkv, hd = 1, 2048, 8, 2, 128
    q, k, v, w = (torch.randn((b, s, h, hd), generator=gen, device="cuda").bfloat16()
                  for h in (hq, hkv, hkv, hq))
    n = s // seq

    def ranks(base):
        lock = chip_smoke._Collectives(torch, seq)

        def rank(r):
            par = chip_smoke._lockstep_context(torch, lock, "seq", r)
            ql, kl, vl = (t[:, r * n:(r + 1) * n].clone().requires_grad_(True)
                          for t in (q, k, v))
            out = DistributedAttention(base, par)(ql, kl, vl, causal=True)
            (out.float() * w[:, r * n:(r + 1) * n].float()).sum().backward()
            return [out.detach(), ql.grad, kl.grad, vl.grad]

        return [torch.cat(parts, 1) for parts in zip(*lock.run(rank))]

    K.reset_launches()
    got = ranks(flash_attention)
    assert K.LAUNCHES["flash_fwd"] > 0 and K.LAUNCHES["flash_bwd_dq"] > 0
    ref = ranks(dot_product_attention)
    for name, a, r in zip(("out", "dq", "dk", "dv"), got, ref):
        err = float((a.float() - r.float()).norm() / r.float().norm())
        assert err < 2e-2, (name, err)


@pytest.mark.gpu
@pytest.mark.parametrize("fmt", ["int8", "fp8"])
def test_routed_ffn_ep_dispatch_payload_on_the_card_equals_the_cpus(fmt):
    """The dispatch hop of ``routed_ffn_ep`` (an ``[E, C, d]`` slab over an
    expert axis of 2, in lockstep): the payload and scales that K6a / K6c
    write on the card are the CPU codec's bytes, and K6b's dequantized inbox
    equals the CPU's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    K.build(["quantize_int8", "quantize_fp8", "dequantize"])
    gen = torch.Generator().manual_seed(25)
    xe = torch.randn((8, 96, 512), generator=gen).bfloat16()

    def hop(x):
        lock = chip_smoke._Collectives(torch, 2)
        wire = {}

        def rank(r):
            par = chip_smoke._lockstep_context(torch, lock, "expert", r)
            real = par._all_to_all
            wire[r] = []  # a rank's run restarts until every exchange is known

            def record(t, ax, s_, c_):
                wire[r].append(t.detach().cpu())
                return real(t, ax, s_, c_)

            par._all_to_all = record
            return par.q_all_to_all(x, "expert", fmt, 0, 1, x.dtype).cpu()

        return lock.run(rank), wire

    K.reset_launches()
    card, card_wire = hop(xe.cuda())
    assert K.LAUNCHES["dequantize"] > 0
    cpu, cpu_wire = hop(xe)
    for r in (0, 1):
        for a, b in zip(card_wire[r], cpu_wire[r]):
            assert torch.equal(a, b), r
        assert torch.equal(card[r], cpu[r]), r

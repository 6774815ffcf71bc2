"""The port's flops profiler against the JAX package, on the CPU.

- ``model_tree`` equals JAX's node by node (name, params, MACs) on
  ``tiny``, ``tiny_gpt2``, ``tiny_moe`` and the flagship
  ``llama3_proxy_410m``; its parameter total equals the port's real tree
  (exact integers).
- ``get_model_profile`` and a standalone ``print_model_profile`` give
  JAX's numbers and report text.
- The engine hook: the step ``flops_profiler.profile_step`` runs under
  ``executed_analysis`` and writes its report then, with the analytic and
  the executed FLOPs; a run with the profiler on is bit-identical to the
  same run with it off (losses and fp32 masters, exact).
- The kernels' own count (``ops.kernels.count_kernel_flops``, which a CUDA
  launch feeds): off outside the block; the pair counts behind K1's 4 hd /
  10 hd and K7's active pairs equal brute-force counts of the allowed
  (query, key) mask, with packed segments too.
"""
import contextlib

import numpy as np
import pytest
import torch

from deepspeed_tpu.models.presets import get_preset as j_preset
from deepspeed_tpu.profiling import flops_profiler as jfp

import deepspeed_tpu_torch as tds
from deepspeed_tpu_torch.models import transformer as tt
from deepspeed_tpu_torch.models.presets import get_preset
from deepspeed_tpu_torch.ops import kernels as K
from deepspeed_tpu_torch.ops.kernels.flash_attention import attention_pairs
from deepspeed_tpu_torch.ops.kernels.sparse_attention import _active_pairs, sparse_plan
from deepspeed_tpu_torch.profiling import flops_profiler as tfp
from torch_threads import one_torch_thread  # noqa: F401  (one intra-op thread)


def _nodes(node, depth=0):
    out = [(depth, node.name, node.params, node.macs, node.flops)]
    for c in node.children:
        out.extend(_nodes(c, depth + 1))
    return out


@pytest.mark.parametrize("name", ["tiny", "tiny_gpt2", "tiny_moe", "llama3_proxy_410m"])
@pytest.mark.parametrize("batch,seq", [(1, 16), (16, 520)])
def test_model_tree_equals_jax_node_by_node(name, batch, seq):
    want = jfp.model_tree(j_preset(name), batch, seq)
    got = tfp.model_tree(get_preset(name), batch, seq)
    assert _nodes(got) == _nodes(want)
    assert (got.total_params(), got.total_macs()) == (want.total_params(), want.total_macs())


@pytest.mark.parametrize("name", ["tiny", "tiny_gpt2", "tiny_moe"])
def test_model_tree_params_equal_the_real_tree(name):
    cfg = get_preset(name, dtype=torch.float32)
    params = tt.init_params(cfg, device="cpu")
    leaves = []

    def walk(t):
        for v in t.values():
            walk(v) if isinstance(v, dict) else leaves.append(v)

    walk(params)
    n = sum(x.numel() for x in leaves)
    assert tfp.model_tree(cfg, 1, 8).total_params() == n


def test_flagship_tree_params_equal_its_param_count():
    cfg = get_preset("llama3_proxy_410m")
    assert tfp.model_tree(cfg, 8, 4096).total_params() == cfg.param_count == 430_752_768


def test_standalone_profile_reports_as_jax():
    jm, tm = type("M", (), {"cfg": j_preset("tiny")})(), tt.CausalLM(get_preset("tiny"))
    want = jfp.get_model_profile(jm, batch=4, seq_len=64, as_string=False, print_profile=False)
    got = tfp.get_model_profile(tm, batch=4, seq_len=64, as_string=False, print_profile=False)
    assert got == want
    assert tfp.get_model_profile(tm, 4, 64, print_profile=False) == jfp.get_model_profile(
        jm, 4, 64, print_profile=False)
    jp, tp = jfp.FlopsProfiler(model=jm), tfp.FlopsProfiler(model=tm)
    for p in (jp, tp):
        p.observe_batch({"input_ids": np.zeros((2, 3, 33), np.int32)})
        p._duration = 0.5
    assert tp.print_model_profile(profile_step=2, module_depth=2) == jp.print_model_profile(
        profile_step=2, module_depth=2)
    assert (tp._batch, tp._seq) == (6, 32)


def _config(**over):
    return {"train_micro_batch_size_per_gpu": 2, "gradient_accumulation_steps": 2,
            "optimizer": {"type": "adamw", "params": {"lr": 3e-3, "weight_decay": 0.1}},
            "bf16": {"enabled": False}, "steps_per_print": 1000, "seed": 5, **over}


def _run(conf, steps=3):
    cfg = get_preset("tiny", dtype=torch.float32, attn_impl="flash", remat="selective")
    eng, _, _, _ = tds.initialize(model=tt.CausalLM(cfg), config=conf, device="cpu")
    rng = np.random.default_rng(11)
    losses = [eng.train_batch({"input_ids": rng.integers(0, 256, (2, 2, 33))})
              for _ in range(steps)]
    return eng, [float(x) for x in losses]


def test_engine_profiles_its_step_and_stays_bit_identical(tmp_path):
    out = tmp_path / "prof.txt"
    off, off_losses = _run(_config())
    on, on_losses = _run(_config(flops_profiler={"enabled": True, "profile_step": 2,
                                                 "output_file": str(out)}))
    assert on_losses == off_losses
    assert torch.equal(on._masters.flat, off._masters.flat)
    text = out.read_text()
    assert "profile step: 2" in text and "train FLOPs (fwd+bwd)" in text
    assert "executed FLOPs:" in text and "step latency:" in text
    prof = on.flops_profiler
    ex = prof.get_executed()
    # the CPU runs the plain attention bodies: aten counts everything
    assert ex["kernel_flops"] == {} and ex["flops"] == ex["aten_flops"] > 0
    # the executed step (forward, backward, selective remat's recompute, the
    # dense causal mask of the plain bodies) exceeds the analytic 6 x MACs
    assert ex["flops"] > 3 * prof.get_total_flops() > 0
    assert (prof._batch, prof._seq) == (4, 32) and prof.get_total_duration() > 0
    assert off.flops_profiler is None


def test_engine_writes_the_report_at_profile_step_only(tmp_path):
    out = tmp_path / "prof.txt"
    eng, _ = _run(_config(flops_profiler={"enabled": True, "profile_step": 3,
                                          "output_file": str(out)}), steps=2)
    assert not out.exists()
    eng.train_batch({"input_ids": np.ones((2, 2, 17), np.int64)})
    assert out.exists() and eng.flops_profiler._seq == 16


def test_analyze_train_step_counts_a_step_it_takes():
    eng, _ = _run(_config(), steps=1)
    got = tfp.analyze_train_step(eng, {"input_ids": np.ones((2, 2, 17), np.int64)})
    assert eng.global_steps == 2 and got["flops"] > 0 and "peak_bytes" not in got


def test_kernel_flop_counting_is_off_outside_the_block():
    calls = []
    K.add_flops("flash_fwd", lambda: calls.append(1) or 7)
    assert calls == []
    with K.count_kernel_flops() as counts:
        K.add_flops("flash_fwd", lambda: 7)
        K.add_flops("flash_fwd", lambda: 5)
        K.add_flops("flash_bwd", lambda: 2)
    assert counts == {"flash_fwd": 12, "flash_bwd": 2}
    with K.count_kernel_flops() as counts:
        pass
    assert counts == {}


def _brute_pairs(s, qseg=None, kseg=None, mask=None):
    allowed = np.tril(np.ones((s, s), bool))
    if mask is not None:
        allowed &= mask
    if qseg is None:
        return allowed.sum()
    return sum((allowed & (q[:, None] == k[None, :])).sum() for q, k in zip(qseg, kseg))


def test_attention_pair_counts_are_the_allowed_pairs():
    q = torch.zeros(3, 50, 2, 8)
    assert attention_pairs(q) == 3 * _brute_pairs(50)
    seg = torch.tensor([[0] * 20 + [1] * 30, [5] * 50, [0] * 10 + [1] * 15 + [2] * 25],
                       dtype=torch.int32)
    assert attention_pairs(q, seg) == _brute_pairs(50, seg.numpy(), seg.numpy())


def test_block_sparse_pair_counts_are_the_layouts_pairs():
    from deepspeed_tpu_torch.ops.sparse_attention import FixedSparsityConfig

    block, n = 16, 8
    layout = np.asarray(FixedSparsityConfig(block=block, num_local_blocks=2,
                                            num_global_blocks=1).make_layout(n * block), bool)
    plan = sparse_plan(layout, block, True, "cpu")
    mask = np.repeat(np.repeat(layout, block, 0), block, 1)
    q = torch.zeros(2, n * block, 4, 8)
    assert _active_pairs(q, None, None, plan) == 2 * _brute_pairs(n * block, mask=mask)
    seg = torch.tensor([[0] * 40 + [1] * 88, [3] * 128], dtype=torch.int32)
    assert _active_pairs(q, seg, seg, plan) == _brute_pairs(n * block, seg.numpy(),
                                                            seg.numpy(), mask)


def test_aten_count_is_flop_counter_modes_and_changes_no_bit():
    """``AtenFlops`` sums ``FlopCounterMode``'s formulas over the same
    forward and backward (equal totals), and the gradients under it are the
    bits of an uncounted run."""
    from torch.utils.flop_counter import FlopCounterMode

    cfg = get_preset("tiny", dtype=torch.float32, attn_impl="flash", remat="selective")
    params = tt.init_params(cfg, device="cpu")
    tok = torch.as_tensor(np.random.default_rng(0).integers(0, 256, (2, 33)))

    def leaf_copy(t, leaves):
        if isinstance(t, dict):
            return {k: leaf_copy(v, leaves) for k, v in t.items()}
        leaves.append(t.detach().clone().requires_grad_(True))
        return leaves[-1]

    def grads(mode):
        leaves = []
        p = leaf_copy(params, leaves)
        with mode:
            tt.CausalLM(cfg).loss_fn(p, {"input_ids": tok}).backward()
        return [v.grad for v in leaves]

    plain = grads(contextlib.nullcontext())
    counted = tfp.AtenFlops()
    got = grads(counted)
    reference = FlopCounterMode(display=False)
    grads(reference)
    assert counted.flops == reference.get_total_flops() > 0
    assert all(torch.equal(a, b) for a, b in zip(got, plain))

"""The port's training path against the JAX package, on the CPU in fp32.

(c) ``CausalLM.loss_fn`` and every gradient leaf against
    ``jax.value_and_grad(CausalLM.loss_fn)`` on the same weights (JAX
    ``init_params`` -> ``params_from_numpy``) and tokens: ``tiny`` and its
    family variants, and ``llama3_proxy_410m`` cut to 2 layers at seq 64.
    The port runs the flash Function (its plain versions on the CPU) under
    selective remat; JAX runs its reference body (Pallas needs a TPU).
(d) remat ``full`` / ``selective`` / ``dots`` / ``offload`` give gradients
    identical to ``none`` (``tiny`` and ``tiny_parallel``); ``dots`` saves
    the products JAX's ``checkpoint_dots_with_no_batch_dims`` saves and
    ``offload`` moves JAX's offloaded names to the host, and the attention
    forward runs as often as those sets imply; the chunked cross-entropy
    equals the full one.
(e) A 5-step loss trajectory and the final parameters of the port's engine
    against the JAX engine on a one-device mesh, for AdamW, Lamb, Lion,
    Adagrad and Muon, and the optimizer state's bytes against JAX's.
(f) The five LR schedules and ``build_optimizer``'s updates against JAX's
    schedules and optax on the same gradients.
(g) ``parse_config`` errors.  (h) ``train_on_loader`` equals a
    ``train_batch`` loop.  And the device rule of the entry points.

Tolerances (fp32): loss atol 1e-5 / rtol 1e-5 and gradients atol 1e-5 /
rtol 1e-3 — the two frameworks sum the same products in different orders,
which moves fp32 sums of a few hundred terms by a few ulps and the small
gradient entries (1e-4 and below) by relatively more.  Engine trajectories:
atol 1e-5 / rtol 1e-4 on losses and parameters after five AdamW steps (the
update divides by sqrt(v) + eps, which amplifies ulp-level gradient
differences of near-zero entries; the same for Lamb, Lion, Adagrad and
Muon: Muon's Newton-Schulz products are fp32 matmuls in both frameworks, 15
of them a 2-D leaf a step, which round like the model's own).  Schedules:
rtol 1e-6 / atol 1e-7, one fp32 expression each; optimizer steps atol 1e-6
/ rtol 1e-5 after four updates.
"""
import dataclasses
import itertools
import re

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import deepspeed_tpu as jds
from deepspeed_tpu.config.config import ConfigError as JConfigError
from deepspeed_tpu.config.config import parse_config as j_parse_config
from deepspeed_tpu.models import transformer as jt
from deepspeed_tpu.models.presets import get_preset as j_preset
from deepspeed_tpu.ops.optimizers import build_optimizer as j_build_optimizer
from deepspeed_tpu.parallel.topology import initialize_mesh
from deepspeed_tpu.runtime import lr_schedules as jlr
from deepspeed_tpu.runtime import precision as jprec

import deepspeed_tpu_torch as tds
from deepspeed_tpu_torch.config.config import ConfigError, parse_config
from deepspeed_tpu_torch.inference.paged import init_paged_cache
from deepspeed_tpu_torch.models import transformer as tt
from deepspeed_tpu_torch.models.presets import get_preset
from deepspeed_tpu_torch.ops.optimizers import build_optimizer
from deepspeed_tpu_torch.ops.sparse_attention import FixedSparsityConfig
from deepspeed_tpu_torch.runtime import lr_schedules as tlr
from deepspeed_tpu_torch.runtime import precision as tprec
from deepspeed_tpu_torch.runtime.engine import StepMetrics
from deepspeed_tpu_torch.runtime.prefetch import HOST_READS
from deepspeed_tpu_torch.sequence.cross_entropy import chunked_cross_entropy
from torch_threads import one_torch_thread  # noqa: F401  (one intra-op thread)

LOSS_TOL = dict(atol=1e-5, rtol=1e-5)
GRAD_TOL = dict(atol=1e-5, rtol=1e-3)
ENGINE_TOL = dict(atol=1e-5, rtol=1e-4)
FN_TOL = dict(atol=1e-7, rtol=1e-6)

# tiny and the family variants that change the forward
VARIANTS = {
    "llama": {},
    "layernorm_biases": dict(norm="layernorm", qkv_bias=True, attn_out_bias=True,
                             mlp_bias=True, head_bias=True),
    "parallel_block": dict(parallel_block=True, norm="layernorm", rotary_dim=8,
                           gated_mlp=False, activation="gelu", qkv_bias=True,
                           attn_out_bias=True, mlp_bias=True),
    "learned_positions": dict(position="learned", embedding_norm=True, gated_mlp=False,
                              activation="relu"),
    "tied_embeddings": dict(tie_embeddings=True, loss_chunk_size=12),
    "soft_cap": dict(logits_soft_cap=3.0),
    "alibi": dict(position="alibi", num_kv_heads=4, norm="layernorm"),
}


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, prefix + k + "/"))
        else:
            out[prefix + k] = v
    return out


def _pair(name, over, seed=0):
    jcfg = j_preset(name, dtype=jnp.float32, **over)
    jp = jax.tree_util.tree_map(np.asarray, jt.init_params(jax.random.PRNGKey(seed), jcfg))
    return jcfg, jp


def _torch_params(jp, tcfg):
    tp = tt.params_from_numpy(jp, tcfg, device="cpu")
    for leaf in _flat(tp).values():
        leaf.requires_grad_(True)
    return tp


def _tokens(b, s, vocab, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, (b, s)).astype(np.int32)


def _loss_and_grads_match(name, over, tokens, segment_ids=None, port_over=None):
    jcfg, jp = _pair(name, over)
    batch = {"input_ids": tokens}
    if segment_ids is not None:
        batch["segment_ids"] = segment_ids
    # jitted: one compile, not an op-by-op dispatch of the whole model
    jloss, jgrads = jax.jit(jax.value_and_grad(jt.CausalLM(jcfg).loss_fn))(
        jax.tree_util.tree_map(jnp.asarray, jp), jax.tree_util.tree_map(jnp.asarray, batch))
    tcfg = get_preset(name, dtype=torch.float32, **{**over, **(port_over or {})})
    tp = _torch_params(jp, tcfg)
    loss = tt.CausalLM(tcfg).loss_fn(tp, {k: torch.from_numpy(v) for k, v in batch.items()})
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), **LOSS_TOL)
    fj, ft = _flat(jax.tree_util.tree_map(np.asarray, jgrads)), _flat(tp)
    assert set(fj) == set(ft)
    for key in fj:
        np.testing.assert_allclose(ft[key].grad.numpy(), fj[key], err_msg=key, **GRAD_TOL)


# ---------------------------------------------------------------------------
# (c) loss and gradients against JAX
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_loss_and_grads_match_jax_tiny(variant):
    over = VARIANTS[variant]
    port = dict(remat="selective")
    if over.get("position") != "alibi":
        port["attn_impl"] = "flash"  # the autograd Function (plain inner calls on CPU)
    _loss_and_grads_match("tiny", over, _tokens(2, 25, 256), port_over=port)


def test_loss_and_grads_match_jax_packed_segments():
    seg = np.ones((2, 25), np.int32)
    seg[:, 9:] = 2
    seg[1, 17:] = 3
    _loss_and_grads_match("tiny", {}, _tokens(2, 25, 256, seed=3), segment_ids=seg,
                          port_over=dict(attn_impl="flash", remat="full"))


def test_loss_and_grads_match_jax_llama3_proxy_two_layers():
    _loss_and_grads_match("llama3_proxy_410m", dict(num_layers=2, loss_chunk_size=32),
                          _tokens(1, 65, 32128, seed=4), port_over=dict(attn_impl="flash"))


def test_param_count_and_flops_per_token_match_jax():
    for name in ("tiny", "llama3_proxy_410m"):
        jcfg = j_preset(name)
        tcfg = get_preset(name)
        assert tcfg.param_count == jcfg.param_count
        assert tt.CausalLM(tcfg).flops_per_token(4096) == jt.CausalLM(jcfg).flops_per_token(4096)


def test_alibi_bias_matches_jax():
    pos = np.array([[0, 1, 2, 3, 4], [3, 4, 5, 6, 7]], np.int32)
    for heads in (4, 6, 8):
        np.testing.assert_allclose(tt.alibi_slopes(heads).numpy(), jt.alibi_slopes(heads),
                                   **FN_TOL)
        np.testing.assert_allclose(
            tt.alibi_bias(heads, torch.from_numpy(pos), torch.from_numpy(pos)).numpy(),
            jt.alibi_bias(heads, jnp.asarray(pos), jnp.asarray(pos)), **FN_TOL)
        np.testing.assert_allclose(
            tt.alibi_bias(heads, torch.from_numpy(pos[0]), torch.from_numpy(pos[0])).numpy(),
            jt.alibi_bias(heads, jnp.asarray(pos[0]), jnp.asarray(pos[0])), **FN_TOL)


# MoE layers run (tests/test_torch_moe.py); the ids are the names these
# cases have had since the list began.  Ulysses and ring run now
# (test_ported_model_options_run; tests/test_torch_sequence.py across
# ranks); what stays refused, as in JAX, is their composition with ALiBi
@pytest.mark.parametrize("over,match", [
    pytest.param(dict(sequence_parallel="ulysses", position="alibi"), "sequence_parallel",
                 id="over1-sequence_parallel"),
    # domino_chunks runs (test_ported_model_options_run)
    pytest.param(dict(sequence_parallel="ring", position="alibi"), "sequence_parallel",
                 id="over2-sequence_parallel_ring"),
    # block-sparse attention is ported; what stays refused, as in JAX, is
    # its composition with ALiBi (the sparse bodies take no bias)
    pytest.param(dict(sparse_attention=FixedSparsityConfig(block=16), position="alibi"),
                 "sparse_attention", id="over4-sparse_attention"),
])
def test_unported_model_options_are_refused(over, match):
    with pytest.raises(NotImplementedError, match=match):
        tt.CausalLM(get_preset("tiny", **over))


# act_quant_bits runs now (tests/test_torch_compression.py holds
# its loss and gradients against JAX); the case refused it before
@pytest.mark.parametrize("over", [pytest.param(dict(act_quant_bits=8), id="act_quant_bits"),
                                  pytest.param(dict(domino_chunks=2), id="domino_chunks"),
                                  pytest.param(dict(sequence_parallel="ulysses"), id="ulysses"),
                                  pytest.param(dict(sequence_parallel="ring"), id="ring")])
def test_ported_model_options_run(over):
    cfg = get_preset("tiny", dtype=torch.float32, **over)
    tokens = torch.from_numpy(_tokens(2, 17, 256))
    loss = tt.CausalLM(cfg).loss_fn(tt.init_params(cfg, device="cpu"), {"input_ids": tokens})
    assert np.isfinite(loss.item())
    if "sequence_parallel" in over:  # one process: the base body (JAX without a mesh)
        whole = tt.CausalLM(cfg.replace(sequence_parallel="none")).loss_fn(
            tt.init_params(cfg, device="cpu"), {"input_ids": tokens})
        np.testing.assert_allclose(loss.item(), whole.item(), rtol=1e-6)
    if "domino_chunks" in over:  # the value of one chunk (test_torch_tp.py holds it to JAX)
        whole = tt.CausalLM(cfg.replace(domino_chunks=1)).loss_fn(
            tt.init_params(cfg, device="cpu"), {"input_ids": tokens})
        np.testing.assert_allclose(loss.item(), whole.item(), rtol=1e-6)


def test_unported_forward_arguments_are_refused():
    cfg = get_preset("tiny", dtype=torch.float32)
    params = tt.init_params(cfg, device="cpu")
    tok = torch.zeros(1, 4, dtype=torch.long)
    with pytest.raises(NotImplementedError, match="stack_apply"):
        tt.CausalLM(cfg, stack_apply=lambda *a: None)
    # a batch's pld_theta runs since slice 19 (tests/test_torch_pld.py)
    tt.CausalLM(cfg).loss_fn(params, {"input_ids": tok, "pld_theta": 0.5})
    with pytest.raises(NotImplementedError, match="alibi"):
        tt.get_attn_fn(cfg.replace(position="alibi", attn_impl="flash"), "cpu")


# ---------------------------------------------------------------------------
# (d) remat policies and chunked cross-entropy
# ---------------------------------------------------------------------------
def _remat_grads(name, remat, jp, tokens):
    cfg = get_preset(name, dtype=torch.float32, remat=remat)
    cfg = cfg.replace(attn_impl="reference" if cfg.position == "alibi" else "flash")
    tp = _torch_params(jp, cfg)
    tt.CausalLM(cfg).loss_fn(tp, {"input_ids": tokens}).backward()
    return {k: v.grad for k, v in _flat(tp).items()}


@pytest.mark.parametrize("name,remat", [(n, r) for n in ("tiny", "tiny_parallel")
                                        for r in ("full", "selective", "dots", "offload")])
def test_remat_policies_give_identical_grads(name, remat):
    _, jp = _pair(name, {})
    tokens = torch.from_numpy(_tokens(2, 33, 256, seed=5)).long()
    want = _remat_grads(name, "none", jp, tokens)
    got = _remat_grads(name, remat, jp, tokens)
    for key, g in want.items():
        assert torch.equal(got[key], g), (remat, key)


def _jax_layer_residuals(name, remat, b, s):
    """The per-layer residuals of JAX's layer scan under ``remat`` (the
    stacked outputs of the scan, at 3 layers), as (shape, on host) pairs."""
    from jax._src.ad_checkpoint import saved_residuals  # print_saved_residuals' data

    jcfg = j_preset(name, dtype=jnp.float32, remat=remat, num_layers=3)
    jp = jt.init_params(jax.random.PRNGKey(0), jcfg)
    tok = jnp.zeros((b, s + 1), jnp.int32)
    res = saved_residuals(lambda p: jt.CausalLM(jcfg).loss_fn(p, {"input_ids": tok}), jp)
    return sorted((tuple(a.shape[1:]), "<host>" in str(a)) for a, what in res
                  if "output of scan" in what and a.ndim >= 4 and a.shape[0] == 3)


@pytest.mark.parametrize("name", ["tiny", "tiny_parallel", "tiny_alibi"])
def test_remat_saves_what_jax_saves(name, monkeypatch):
    """``dots``: the products the policy saves and the layer input the
    checkpoint keeps are JAX's per-layer residuals (a product only the
    residual sum reads, ``w_down``'s and a parallel block's ``wo``'s, in
    neither).  ``offload``: what goes to the host is JAX's four offloaded
    names (q, k, v and the attention output; the flash Function's lse
    besides, on the flash path) and the layer input stays.  The attention
    forward (K1f on the card) runs once a layer under ``none`` /
    ``selective`` / ``offload`` and twice under ``full`` / ``dots``."""
    from torch.utils.checkpoint import CheckpointPolicy

    from deepspeed_tpu_torch.ops.kernels import flash_attention as F1

    b, s = 2, 15
    flash = get_preset(name).position != "alibi"
    saved, host, fwd = [], [], []
    make_ctx = tt.create_selective_checkpoint_contexts

    def spy_ctx(policy):
        def spy(ctx, op, *args, **kw):
            out = policy(ctx, op, *args, **kw)
            if out == CheckpointPolicy.MUST_SAVE and not ctx.is_recompute:
                saved.append((b, s, args[-1].shape[-1]))
            return out
        return make_ctx(spy)

    to_host = tt._to_host
    monkeypatch.setattr(tt, "create_selective_checkpoint_contexts", spy_ctx)
    monkeypatch.setattr(tt, "_to_host", lambda t: host.append(tuple(t.shape)) or to_host(t))
    fwd_with_lse = F1._fwd_with_lse
    monkeypatch.setattr(F1, "_fwd_with_lse", lambda *a: fwd.append(1) or fwd_with_lse(*a))
    _, jp = _pair(name, {}, seed=1)
    tokens = torch.from_numpy(_tokens(b, s + 1, 256)).long()
    cfg = get_preset(name)
    layers, d, hd = cfg.num_layers, cfg.hidden_size, cfg.hd
    counts = {}
    for remat in ("none", "full", "selective", "dots", "offload"):
        saved.clear(), host.clear(), fwd.clear()
        _remat_grads(name, remat, jp, tokens)
        counts[remat] = len(fwd)
        if remat == "dots":
            want = [x for x, _ in _jax_layer_residuals(name, "dots", b, s)]
            assert sorted(saved + [(b, s, d)] * layers) == sorted(want * layers)
        if remat == "offload" and flash:
            want = _jax_layer_residuals(name, "offload", b, s)
            assert [x for x, on_host in want if not on_host] == [(b, s, d)]
            # q, k, v and o as the Function saves them, at the kernels' head
            # dim; the sliced o besides when that is padded (one copy else)
            wide = F1.padded_head_dim(hd)
            named = [x[:3] + (wide,) for x, on_host in want if on_host]
            extra = [(b, s, cfg.num_heads, hd)] if wide != hd else []
            assert sorted(x for x in host if len(x) == 4) == sorted((named + extra) * layers)
    if flash:
        assert counts == {"none": layers, "full": 2 * layers, "selective": layers,
                          "dots": 2 * layers, "offload": layers}


@pytest.mark.parametrize("s,chunk", [(32, 8), (30, 8), (7, 16)])
def test_chunked_cross_entropy_equals_full(s, chunk):
    rng = np.random.default_rng(6)
    hidden = torch.from_numpy(rng.normal(size=(2, s, 16)).astype(np.float32)).requires_grad_()
    w = torch.from_numpy(rng.normal(size=(16, 50)).astype(np.float32)).requires_grad_()
    bias = torch.from_numpy(rng.normal(size=(50,)).astype(np.float32)).requires_grad_()
    labels = torch.from_numpy(rng.integers(0, 50, (2, s)))
    labels[0, :3] = -100
    full = tt.cross_entropy_loss(hidden @ w + bias, labels)
    g_full = torch.autograd.grad(full, (hidden, w, bias))
    chunked = chunked_cross_entropy(hidden, w, labels, chunk_size=chunk, head_bias=bias)
    g_chunk = torch.autograd.grad(chunked, (hidden, w, bias))
    torch.testing.assert_close(chunked, full, **FN_TOL)
    for a, b in zip(g_chunk, g_full):
        torch.testing.assert_close(a, b, atol=1e-6, rtol=1e-5)
    jl = jt.cross_entropy_loss(jnp.asarray((hidden @ w + bias).detach().numpy()),
                               jnp.asarray(labels.numpy()))
    np.testing.assert_allclose(full.item(), float(jl), **LOSS_TOL)


# ---------------------------------------------------------------------------
# (e) the engine against the JAX engine
# ---------------------------------------------------------------------------
def _engine_config(**over):
    cfg = {
        "train_micro_batch_size_per_gpu": 2,
        "gradient_accumulation_steps": 2,
        "optimizer": {"type": "adamw", "params": {"weight_decay": 0.1}},
        "scheduler": {"type": "WarmupCosineLR",
                      "params": {"total_num_steps": 6, "warmup_num_steps": 2, "lr": 3e-3}},
        "gradient_clipping": 0.5,
        "bf16": {"enabled": False},
        "steps_per_print": 1000,
    }
    cfg.update(over)
    return cfg


def _batches(n, vocab=256, seed=7):
    rng = np.random.default_rng(seed)
    return [{"input_ids": rng.integers(0, vocab, (2, 2, 17)).astype(np.int32)}
            for _ in range(n)]


def _torch_engine(jp, dtype=torch.float32, **cfg_over):
    tcfg = get_preset("tiny", dtype=dtype, attn_impl="flash", remat="selective")
    params = tt.params_from_numpy(jp, tcfg, device="cpu")
    engine, _, _, sched = tds.initialize(model=tt.CausalLM(tcfg), params=params,
                                         config=_engine_config(**cfg_over), device="cpu")
    return engine


ENGINE_OPTIMIZERS = {
    "adamw": {"type": "adamw", "params": {"weight_decay": 0.1}},
    "lamb": {"type": "lamb", "params": {"weight_decay": 0.1}},
    "lion": {"type": "lion", "params": {"weight_decay": 0.1}},
    "adagrad": {"type": "adagrad", "params": {}},
    "muon": {"type": "muon", "params": {}},
}


def _jax_engine(jcfg, jp, **cfg_over):
    engine, _, _, _ = jds.initialize(
        model=jt.CausalLM(jcfg), params=jax.tree_util.tree_map(jnp.asarray, jp),
        config=_engine_config(**cfg_over), mesh=initialize_mesh(devices=jax.devices()[:1], data=1))
    return engine


@pytest.mark.parametrize("opt", sorted(ENGINE_OPTIMIZERS))
def test_engine_trajectory_matches_jax_engine(opt):
    jcfg, jp = _pair("tiny", {})
    batches = _batches(5)
    over = dict(optimizer=ENGINE_OPTIMIZERS[opt])
    jengine = _jax_engine(jcfg, jp, **over)
    j_losses = [float(jengine.train_batch(b)) for b in batches]
    engine = _torch_engine(jp, **over)
    t_losses = [float(engine.train_batch(b)) for b in batches]
    np.testing.assert_allclose(t_losses, j_losses, **ENGINE_TOL)
    np.testing.assert_allclose(engine.get_global_grad_norm(),
                               jengine.get_global_grad_norm(), **ENGINE_TOL)
    np.testing.assert_allclose(engine.get_lr(), jengine.get_lr(), **FN_TOL)
    fj = _flat(jax.tree_util.tree_map(np.asarray, jengine.state.params))
    ft = _flat(engine.params)
    assert set(fj) == set(ft)
    for key in fj:
        np.testing.assert_allclose(ft[key].detach().numpy(), fj[key], err_msg=key,
                                   **ENGINE_TOL)
    assert int(engine.device_step) == 5 and engine.global_steps == 5


@pytest.mark.parametrize("opt", sorted(ENGINE_OPTIMIZERS))
def test_optimizer_state_bytes_match_jax_engine(opt):
    """``memory_breakdown()["opt_state_bytes"]`` against the JAX engine's on
    the same tree: the moments agree exactly, the step counters (int32
    scalars: optax keeps one a transform, Muon two and its 3 fp32
    coefficients; the port one) within 32 bytes."""
    jcfg, jp = _pair("tiny", {})
    over = dict(optimizer=ENGINE_OPTIMIZERS[opt])
    got = _torch_engine(jp, **over).memory_breakdown()["opt_state_bytes"]
    want = _jax_engine(jcfg, jp, **over).memory_breakdown()["opt_state_bytes"]
    masters = sum(x.size * 4 for x in jax.tree_util.tree_leaves(jp))
    moments = {"adamw": 2, "lamb": 2, "lion": 1, "adagrad": 1, "muon": None}[opt]
    if moments is not None:
        assert got == moments * masters + 4
    else:  # mu over every leaf, nu over the leaves that are not 2-D
        nu = sum(x.size * 4 for x in jax.tree_util.tree_leaves(jp) if x.ndim != 2)
        assert got == masters + nu + 4
    assert abs(got - want) <= 32, (got, want)


# ---------------------------------------------------------------------------
# (h) train_on_loader against a train_batch loop
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def loop_ref():
    """The ``train_batch`` loop every prefetch depth is held against, made
    once for the module (no case trains it further)."""
    _, jp = _pair("tiny", {})
    ref = _torch_engine(jp)
    losses = [float(ref.train_batch(b)) for b in _batches(4, seed=8)]
    return jp, ref, losses


@pytest.mark.parametrize("depth", [0, 2])
def test_train_on_loader_equals_train_batch_loop(loop_ref, depth):
    jp, ref, ref_losses = loop_ref
    batches = _batches(4, seed=8)
    engine = _torch_engine(jp, train_data={"prefetch_depth": depth})
    losses = [float(x) for x in engine.train_on_loader(iter(batches))]
    assert losses == ref_losses
    assert engine.get_last_loss() == ref.get_last_loss()
    for key, p in _flat(ref.params).items():
        assert torch.equal(_flat(engine.params)[key], p), key
    # num_steps stops early; the generator can run again afterwards
    again = list(engine.train_on_loader(itertools.repeat(batches[0]), num_steps=2))
    assert len(again) == 2 and engine.global_steps == 6


@pytest.mark.parametrize("depth", [0, 2])
def test_train_on_loader_reads_the_host_only_at_print_boundaries(depth):
    """The step metrics stay on the device: ``host_scalar`` runs at a
    ``steps_per_print`` boundary (one step's metrics), when the loop ends
    (the newest step's) and in ``get_last_loss`` (the loss), never per step."""
    _, jp = _pair("tiny", {})
    engine = _torch_engine(jp, steps_per_print=3, train_data={"prefetch_depth": depth})
    per_flush = len(StepMetrics._fields)
    start = HOST_READS["count"]
    seen = [HOST_READS["count"] - start for _ in engine.train_on_loader(iter(_batches(4)))]
    assert seen == [0, 0, per_flush, per_flush]
    assert HOST_READS["count"] - start == 2 * per_flush
    engine.get_last_loss()
    assert HOST_READS["count"] - start == 2 * per_flush + 1


def test_flat_batch_is_folded_like_a_folded_one():
    _, jp = _pair("tiny", {})
    folded = _batches(1, seed=9)[0]
    flat = {"input_ids": folded["input_ids"].reshape(4, 17)}
    a, b = _torch_engine(jp), _torch_engine(jp)
    assert float(a.train_batch(folded)) == float(b.train_batch(flat))


# ---------------------------------------------------------------------------
# (f) schedules, optimizers, precision against JAX / optax
# ---------------------------------------------------------------------------
SCHEDULES = [
    ("LRRangeTest", dict(lr_range_test_min_lr=1e-3, lr_range_test_step_size=3,
                         lr_range_test_step_rate=0.5, lr_range_test_staircase=True)),
    ("LRRangeTest", dict(lr_range_test_step_size=4)),
    ("OneCycle", dict(cycle_min_lr=1e-4, cycle_max_lr=1e-2, cycle_first_step_size=4,
                      cycle_second_step_size=6, decay_step_size=2, decay_lr_rate=0.3)),
    ("WarmupLR", dict(warmup_min_lr=1e-5, warmup_max_lr=1e-3, warmup_num_steps=7)),
    ("WarmupLR", dict(warmup_num_steps=5, warmup_type="linear")),
    ("WarmupDecayLR", dict(total_num_steps=20, warmup_num_steps=5, warmup_max_lr=2e-3)),
    ("WarmupCosineLR", dict(total_num_steps=20, warmup_num_steps=4, warmup_min_ratio=0.1,
                            lr=5e-3)),
    (None, dict(lr=2e-4)),
]


@pytest.mark.parametrize("name,params", SCHEDULES)
def test_lr_schedules_match_jax(name, params):
    jfn = jlr.get_lr_schedule_fn(name, params)
    tfn = tlr.get_lr_schedule_fn(name, params)
    steps = np.arange(0, 30)
    want = np.array([float(jfn(jnp.asarray(s, jnp.int32))) for s in steps])
    got = np.array([float(tfn(int(s))) for s in steps])
    np.testing.assert_allclose(got, want, **FN_TOL)
    dev = tfn(torch.tensor(13, dtype=torch.int32))  # the engine's device-step form
    np.testing.assert_allclose(float(dev), want[13], **FN_TOL)
    sched = tlr.LRScheduler(tfn)
    sched.step(3)
    assert sched.get_last_lr() == [float(tfn(3))]


OPTIMIZERS = [
    ("adamw", dict(lr=1e-2, weight_decay=0.1, betas=(0.8, 0.95), eps=1e-6)),
    ("adam", dict(lr=1e-2)),
    ("adam", dict(lr=1e-2, adam_w_mode=False, weight_decay=0.05)),
    ("adam", dict(lr=1e-2, adam_w_mode=False)),
    ("fusedadam", dict(lr=3e-3, weight_decay=0.01)),
    ("sgd", dict(lr=0.1)),
    ("sgd", dict(lr=0.1, momentum=0.9)),
    ("sgd", dict(lr=0.1, momentum=0.9, nesterov=True)),
    ("lamb", dict(lr=1e-2, weight_decay=0.1, betas=(0.8, 0.95), eps=1e-6)),
    ("fusedlamb", dict(lr=1e-2, max_coeff=10.0)),
    ("lion", dict(lr=1e-3, weight_decay=0.1)),
    ("fusedlion", dict(lr=1e-3, betas=(0.95, 0.98))),
    ("adagrad", dict(lr=0.1)),
    ("adagrad", dict(lr=0.1, eps=1e-6)),
    ("muon", dict(lr=1e-2)),
]


@pytest.mark.parametrize("name,params", OPTIMIZERS)
def test_optimizer_updates_match_optax(name, params):
    rng = np.random.default_rng(11)
    shapes = [(5, 3), (7,), (2, 5, 3)]  # 2-D, 1-D and a stacked [L, in, out] leaf
    p0 = [rng.normal(size=s).astype(np.float32) for s in shapes]
    grads = [[rng.normal(size=s).astype(np.float32) for s in shapes] for _ in range(4)]
    tx = j_build_optimizer(name, params)
    jparams = [jnp.asarray(p) for p in p0]
    state = tx.init(jparams)
    for g in grads:
        upd, state = tx.update([jnp.asarray(x) for x in g], state, jparams)
        jparams = optax.apply_updates(jparams, upd)
    opt = build_optimizer(name, params)
    tparams = [torch.from_numpy(p.copy()) for p in p0]
    tstate = opt.init(tparams)
    lr = torch.tensor(params["lr"], dtype=torch.float32)
    for g in grads:
        opt.step(tparams, [torch.from_numpy(x) for x in g], tstate, lr)
    for t, j in zip(tparams, jparams):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=1e-6, rtol=1e-5)
    assert int(tstate["count"]) == 4


def test_optimizer_skips_the_whole_update_on_overflow():
    opt = build_optimizer("adamw", dict(weight_decay=0.1))
    p = [torch.ones(4)]
    state = opt.init(p)
    opt.step(p, [torch.ones(4)], state, torch.tensor(0.1), finite=torch.tensor(False))
    assert torch.equal(p[0], torch.ones(4)) and int(state["count"]) == 0
    assert not state["mu"][0].any() and not state["nu"][0].any()


@pytest.mark.parametrize("name", ["lamb", "lion", "adagrad", "muon", "sgd"])
def test_every_optimizer_keeps_its_whole_state_on_overflow(name):
    """A ``finite = False`` step, on the engine's layout (leaves tiling one
    buffer) and on separate tensors, changes no bit of the parameters or of
    any state tensor, the count included; a finite step then moves them."""
    rng = np.random.default_rng(13)
    shapes = [(5, 3), (7,), (2, 5, 3)]
    flat = torch.from_numpy(rng.normal(size=sum(int(np.prod(x)) for x in shapes))
                            .astype(np.float32))
    views, off = [], 0
    for shape in shapes:
        n = int(np.prod(shape))
        views.append(flat[off:off + n].view(shape))
        off += n
    separate = [v.clone() for v in views]
    for params in (views, separate):
        opt = build_optimizer(name, dict(weight_decay=0.1, momentum=0.9))
        state = opt.init(params)
        lr = torch.tensor(1e-2)
        opt.step(params, [torch.ones_like(p) for p in params], state, lr)
        tensors = lambda: [*params, *_flat_state(state)]  # noqa: E731
        before = [t.clone() for t in tensors()]
        bad = [torch.full_like(p, float("inf")) for p in params]
        opt.step(params, bad, state, lr, finite=torch.tensor(False))
        assert all(torch.equal(a, b) for a, b in zip(before, tensors()))
        assert int(state["count"]) == 1
        opt.step(params, [torch.ones_like(p) for p in params], state, lr,
                 finite=torch.tensor(True))
        assert int(state["count"]) == 2 and not torch.equal(before[0], params[0])


def _flat_state(state):
    out = []
    for v in state.values():
        if isinstance(v, dict):
            out += _flat_state(v)
        elif isinstance(v, list):
            out += v
        else:
            out.append(v)
    return out


@pytest.mark.parametrize("name", ["onebitadam", "zerooneadam", "onebitlamb"])
def test_unported_optimizers_are_refused(name):
    with pytest.raises(NotImplementedError, match=name):
        build_optimizer(name, {})


def test_loss_scale_update_matches_jax():
    flags = [True, False, False, True, True, False, True, False, False, False]
    js = jprec.init_loss_scale(True, initial_scale_power=4, hysteresis=2)
    ts = tprec.init_loss_scale(True, initial_scale_power=4, hysteresis=2, device="cpu")
    for f in flags:
        js = jprec.update_loss_scale(js, jnp.asarray(f), loss_scale_window=2, min_scale=2.0)
        ts = tprec.update_loss_scale(ts, torch.tensor(f), loss_scale_window=2, min_scale=2.0)
        assert float(ts.scale) == float(js.scale)
        assert int(ts.good_steps) == int(js.good_steps)
        assert int(ts.hysteresis) == int(js.hysteresis)


def test_grad_norm_and_clip_match_jax():
    rng = np.random.default_rng(12)
    grads = [rng.normal(size=s).astype(np.float32) for s in ((4, 3), (9,))]
    jg, jn = jprec.clip_by_global_norm([jnp.asarray(g) for g in grads], 1.5)
    tg, tn = tprec.clip_by_global_norm([torch.from_numpy(g) for g in grads], 1.5)
    np.testing.assert_allclose(float(tn), float(jn), **FN_TOL)
    for a, b in zip(tg, jg):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **FN_TOL)
    assert bool(tprec.grads_finite([torch.ones(2)]))
    assert not bool(tprec.grads_finite([torch.ones(2), torch.tensor([float("inf")])]))


def test_fp16_engine_skips_an_overflowing_step():
    _, jp = _pair("tiny", {})
    engine = _torch_engine(jp, dtype=torch.float16, bf16={"enabled": False},
                           fp16={"enabled": True, "initial_scale_power": 127, "hysteresis": 1})
    before = {k: v.detach().clone() for k, v in _flat(engine.params).items()}
    engine.train_batch(_batches(1)[0])
    assert engine.get_last_loss() is not None and engine.skipped_steps == 1
    assert int(engine.device_step) == 0 and engine.loss_scale == 2.0 ** 126
    for key, p in _flat(engine.params).items():
        assert torch.equal(p, before[key]), key


# ---------------------------------------------------------------------------
# (g) config errors
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("raw,match", [
    ({"train_batch_sizee": 8}, "train_batch_sizee"),
    ({"optimizer": {"type": "adamw", "parms": {}}}, "parms"),
    ({"zero_optimization": {"stage": 4}}, "stage must be 0-3"),
    ({"zero_optimization": {"stagee": 1}}, "stagee"),
    ({"train_data": {"prefetch_depth": 99}}, "prefetch_depth"),
])
def test_parse_config_errors_match_jax(raw, match):
    with pytest.raises(JConfigError, match=match):
        j_parse_config(raw)
    with pytest.raises(ConfigError, match=match):
        parse_config(raw)


@pytest.mark.parametrize("raw,match", [
    ({"train_batch_size": 10, "train_micro_batch_size_per_gpu": 2,
      "gradient_accumulation_steps": 2}, "batch invariant"),
    ({"train_batch_size": 10, "train_micro_batch_size_per_gpu": 4}, "not divisible"),
    ({"fp16": {"enabled": True}, "bf16": {"enabled": True}}, "cannot both"),
])
def test_finalize_errors_match_jax(raw, match):
    with pytest.raises(JConfigError, match=match):
        j_parse_config(raw, dp_world_size=1)
    with pytest.raises(ConfigError, match=match):
        parse_config(raw, dp_world_size=1)


def test_parse_config_batch_triangulation_matches_jax():
    for raw in ({"train_batch_size": 16, "gradient_accumulation_steps": 2},
                {"train_micro_batch_size_per_gpu": 4}, {"train_batch_size": 6}, {}):
        j, t = j_parse_config(raw, dp_world_size=1), parse_config(raw, dp_world_size=1)
        assert (t.train_batch_size, t.train_micro_batch_size_per_gpu,
                t.gradient_accumulation_steps) == (
            j.train_batch_size, j.train_micro_batch_size_per_gpu,
            j.gradient_accumulation_steps)
        assert t.precision_dtype == j.precision_dtype


@pytest.mark.parametrize("raw,key", [
    # offload_optimizer runs since slice 18 (tests/test_torch_offload.py),
    # the ZeRO++ keys since slice 22 (test_keys_on_that_run_parse_as_jax),
    # the tensor-parallel section and the model, seq and expert axes run
    # now; what stays refused is the stage
    # axis (pipeline parallelism)
    ({"tensor_parallel": {"enabled": True, "tp_size": 2}, "mesh": {"model": 2, "stage": 2}},
     "mesh"),
    ({"mesh": {"fsdp": 2, "stage": 2}}, "mesh"),
    # progressive_layer_drop and curriculum_learning run since slice 19
    # (tests/test_torch_pld.py, test_torch_curriculum.py), compression_training,
    # hybrid_engine and eigenvalue now
    # (test_item_9_keys_that_run_parse_as_jax), compile and elasticity since
    # slice 21 (tests/test_torch_compile.py, test_torch_elasticity.py)
])
def test_unported_config_keys_are_refused(raw, key):
    with pytest.raises(NotImplementedError, match=key):
        parse_config(raw)


def _section(cfg, name):
    """A parsed section as a dict (JAX's ``elasticity`` is one already), or
    a dotted key's value."""
    value = cfg
    for part in name.split("."):
        value = getattr(value, part)
    return dataclasses.asdict(value) if dataclasses.is_dataclass(value) else value


@pytest.mark.parametrize("raw,section", [
    ({"compression_training": {"enabled": True}}, "compression_training"),
    ({"hybrid_engine": {"enabled": True}}, "hybrid_engine"),
    ({"eigenvalue": {"enabled": True}}, "eigenvalue"),
    ({"compile": {"enabled": False}}, "compile"),
    ({"elasticity": {"enabled": True}}, "elasticity"),
])
def test_item_9_keys_that_run_parse_as_jax(raw, section):
    """The cases of ``test_unported_config_keys_are_refused`` whose sections
    the port now runs: they parse into JAX's dataclass."""
    j, t = j_parse_config(raw, dp_world_size=1), parse_config(raw, dp_world_size=1)
    assert _section(t, section) == _section(j, section)


OFF_CONFIGS = [
    {"wall_clock_breakdown": False}, {"memory_breakdown": False},
    {"prescale_gradients": True}, {"dump_state": True},
    {"activation_checkpointing": {"partition_activations": True, "number_checkpoints": 4}},
    {"mesh": {"data": 0, "model": 1}}, {"moe": {"enabled": False}},
    {"tensor_parallel": {"tp_size": 1}}, {"comms_logger": {"enabled": False}},
    {"flops_profiler": {"enabled": False}}, {"tensorboard": {"enabled": False}},
    {"csv_monitor": {}}, {"wandb": {"enabled": False}}, {"comet": {"enabled": False}},
    {"compression_training": {}}, {"data_efficiency": {"enabled": False}},
    {"curriculum_learning": {}}, {"elasticity": {}},
    {"progressive_layer_drop": {"enabled": False}}, {"eigenvalue": {"enabled": False}},
    {"compile": {"enabled": True}}, {"hybrid_engine": {"enabled": False}},
    {"aio": {"thread_count": 8}},
    {"checkpoint": {"async_save": True}}, {"nebula": {"enabled": True}},
    {"zero_optimization": {"stage": 1, "offload_optimizer": None, "zero_quantized_weights": False,
                           "mics_shard_size": -1, "offload_grad_dtype": "fp32"}},
]
ON_CONFIGS = [
    # the timers, the profiler, the monitors and data_efficiency run since
    # slice 19 (tests/test_torch_timer_monitor.py), compression_training,
    # eigenvalue and hybrid_engine now (ON_NOW_CONFIGS)
    # the model axis and the tensor_parallel section run since slice 23
    # (ON_NOW_CONFIGS); pipeline stages beside them stay refused
    ({"mesh": {"model": 2, "stage": 2}}, "mesh", 7),
    # the moe section is parsed (tests/test_torch_moe.py); the expert and
    # seq axes run now (ON_NOW_CONFIGS), pipeline stages beside
    # them stay refused
    ({"moe": {"enabled": True}, "mesh": {"expert": 2, "stage": 2}}, "mesh", 7),
    ({"tensor_parallel": {"enabled": True, "tp_size": 2},
      "mesh": {"model": 2, "expert": 2, "stage": 2}}, "mesh", 7),
    # elasticity and compile run since slice 21, the comms logger and the
    # ZeRO++ keys since slice 22 (ON_NOW_CONFIGS); aio and offload_param
    # parse since slice 18 (tests/test_torch_offload.py)
    ({"mesh": {"data": 2, "seq": 2, "stage": 2}}, "mesh", 7),
]


@pytest.mark.parametrize("raw", OFF_CONFIGS, ids=lambda r: next(iter(r)))
def test_keys_off_or_at_jax_default_parse_as_jax(raw):
    """What JAX's parser takes with the feature off (or at its default), the
    port takes too; the sections the port carries equal JAX's."""
    j, t = j_parse_config(raw, dp_world_size=1), parse_config(raw, dp_world_size=1)
    for name in ("checkpoint", "nebula", "activation_checkpointing"):
        assert dataclasses.asdict(getattr(t, name)) == dataclasses.asdict(getattr(j, name))
    for name in ("prescale_gradients", "dump_state"):
        assert getattr(t, name) == getattr(j, name)
    assert t.zero_optimization.stage == j.zero_optimization.stage


@pytest.mark.parametrize("raw,key,item", ON_CONFIGS, ids=lambda r: str(r))
def test_keys_on_are_refused_with_their_one_item(raw, key, item):
    j_parse_config(raw, dp_world_size=1)  # JAX runs it
    with pytest.raises(NotImplementedError,
                       match=rf"config key '{re.escape(key)}' .*queue 1 item {item}\)"):
        parse_config(raw)


# ON_CONFIGS's item-9 cases whose sections the port now runs
ON_NOW_CONFIGS = [
    ({"eigenvalue": {"max_iter": 5}}, "eigenvalue"),
    ({"hybrid_engine": {"enabled": True}}, "hybrid_engine"),
    ({"hybrid_engine": {"max_out_tokens": 8}}, "hybrid_engine"),
    ({"compression_training": {"weight_quantization": {"enabled": True}}},
     "compression_training"),
    ({"compression_training": {"enabled": True}}, "compression_training"),
    ({"eigenvalue": {"enabled": True}}, "eigenvalue"),
    ({"elasticity": {"enabled": True}}, "elasticity"),
    ({"compile": {"backend": "inductor"}}, "compile"),
    ({"compile": {"disable": True}}, "compile"),
    ({"comms_logger": {"enabled": True}}, "comms_logger"),
    ({"mesh": {"data": 2, "fsdp": 2}}, "mesh"),
    ({"mesh": {"model": 2}}, "mesh"),
    ({"mesh": {"data": 2, "seq": 2}}, "mesh"),
    ({"moe": {"enabled": True}, "mesh": {"expert": 2}}, "mesh"),
    ({"mesh": {"model": 2, "expert": 2}}, "mesh"),
    ({"tensor_parallel": {"enabled": True, "tp_size": 2}}, "tensor_parallel"),
    ({"tensor_parallel": {"domino_chunks": 2}}, "tensor_parallel"),
    ({"zero_optimization": {"mics_shard_size": 2}}, "zero_optimization.mics_shard_size"),
    ({"zero_optimization": {"zeropp_loco_param": {"err_beta": 0.8}}},
     "zero_optimization.zeropp_loco_param"),
    ({"zero_optimization": {"zero_hpz_partition_size": 2}},
     "zero_optimization.zero_hpz_partition_size"),
    ({"zero_optimization": {"stage": 3, "zero_quantized_weights": True,
                            "zero_quantized_gradients": True}},
     "zero_optimization.zero_quantized_gradients"),
    ({"zero_optimization": {"zero_quantized_weights": True}},
     "zero_optimization.zero_quantized_weights"),
]


@pytest.mark.parametrize("raw,section", ON_NOW_CONFIGS, ids=lambda r: str(r))
def test_keys_on_that_run_parse_as_jax(raw, section):
    j, t = j_parse_config(raw, dp_world_size=1), parse_config(raw, dp_world_size=1)
    assert _section(t, section) == _section(j, section)


@pytest.mark.parametrize("raw", [{"flops_profiler": {"enabeld": False}},
                                 {"moe": {"experts": 4}}, {"checkpoint": {"async": True}}])
def test_unknown_fields_of_those_sections_raise_as_jax(raw):
    with pytest.raises(JConfigError) as jerr:
        j_parse_config(raw)
    with pytest.raises(ConfigError) as terr:
        parse_config(raw)
    assert str(terr.value) == str(jerr.value)


def test_reference_passthrough_keys_are_accepted():
    cfg = parse_config({"zero_allow_untested_optimizer": True, "amp": {},
                        "zero_optimization": {"stage": 2, "overlap_comm": True,
                                              "stage3_param_persistence_threshold": 7}})
    assert cfg.zero_optimization.stage == 2
    assert cfg.zero_optimization.param_persistence_threshold == 7


# ---------------------------------------------------------------------------
# entry points and the device rule
# ---------------------------------------------------------------------------
def test_entry_points_need_cuda_or_an_explicit_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_preset("tiny", dtype=torch.float32)
    _, jp = _pair("tiny", {})
    model = tt.CausalLM(cfg)
    for call in (lambda: tt.init_params(cfg), lambda: tt.params_from_numpy(jp, cfg),
                 lambda: model.init_params(), lambda: tds.initialize(model=model),
                 lambda: init_paged_cache(2, 4, 8, 1, 16), lambda: tprec.init_loss_scale(True)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    assert tt.init_params(cfg, device="cpu")["embed"]["embedding"].device.type == "cpu"
    assert tt.params_from_numpy(jp, cfg, device="cpu")["embed"]["embedding"].device.type == "cpu"
    assert init_paged_cache(2, 4, 8, 1, 16, device="cpu")[0][1].device.type == "cpu"
    assert tprec.init_loss_scale(True, device="cpu").scale.device.type == "cpu"
    engine, opt, loader, sched = tds.initialize(model=model, config={"bf16": {"enabled": False}},
                                                device="cpu")
    assert opt is engine and loader is None and sched is engine.lr_scheduler
    assert engine.device.type == "cpu"


def test_initialize_refuses_unported_arguments(tmp_path):
    """A ``mesh`` that is not a process grid stays refused (item 7; the
    grid trains, ``test_torch_zero.py``); ``training_data`` and a Hugging Face
    directory now work (``test_torch_dataloader.py`` and
    ``test_torch_hf_import.py`` hold them against JAX)."""
    from deepspeed_tpu_torch.checkpoint.hf_import import export_hf_checkpoint

    cfg = get_preset("tiny", dtype=torch.float32)
    model = tt.CausalLM(cfg)
    with pytest.raises(NotImplementedError, match="mesh"):
        tds.initialize(device="cpu", model=model, mesh=object())
    rows = [{"input_ids": np.full(9, i, np.int64)} for i in range(8)]
    conf = {"train_micro_batch_size_per_gpu": 2, "bf16": {"enabled": False}}
    engine, _, loader, _ = tds.initialize(device="cpu", model=model, training_data=rows,
                                          config=conf)
    assert engine.training_dataloader is loader and len(loader) == 4
    assert tuple(next(iter(loader))["input_ids"].shape) == (1, 2, 9)
    export_hf_checkpoint(engine.params, cfg, str(tmp_path))
    hf_engine, _, _, _ = tds.initialize(device="cpu", model=str(tmp_path), config=conf)
    got, want = _flat(hf_engine.params), _flat(engine.params)
    assert set(got) == set(want)
    for k in want:
        assert torch.equal(got[k].detach(), want[k].detach()), k


def test_initialize_from_seed_is_reproducible():
    model = tt.CausalLM(get_preset("tiny", dtype=torch.float32))
    conf = {"seed": 3, "bf16": {"enabled": False}}
    a, _, _, _ = tds.initialize(model=model, config=conf, device="cpu")
    b, _, _, _ = tds.initialize(model=model, config=conf, device="cpu")
    for key, p in _flat(a.params).items():
        assert p.dtype == torch.float32 and torch.equal(p, _flat(b.params)[key])

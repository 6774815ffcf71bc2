"""Quantized-weight serving in the port against the JAX package on the CPU.

- Payload bytes: ``quantize_serving_weight`` (int8, e4m3) and
  ``quantize_serving_weight_fp6`` give the JAX bytes and scales exactly, on
  2-D and stacked ``[L, in, out]`` leaves.  JAX is run jitted, as its engine
  runs it: XLA compiles the division of amax by the constant qmax to a
  multiply by the fp32 reciprocal, and the port computes that multiply
  (called eagerly, JAX divides, and its scales can sit one ulp away).
- The FP6 encoder at every boundary (powers of two, their neighbours,
  7.5 and above, zeros, midpoints between codes) and the pack / unpack
  round trip.
- ``quantize_serving_params`` and ``tree_nbytes`` on a tiny tree, and
  ``params_from_numpy`` carrying a JAX-quantized tree across unchanged.
- The engine: greedy decoding with int8, fp8 and fp6 weights is
  TOKEN-IDENTICAL to the JAX engine (Pallas dequant-matmuls interpreted),
  both when each package quantizes the same fp32 weights and when the port
  serves the JAX engine's own payloads; a quantized scheduler run finishes
  every request and leaks no block.
- Refusals: an unknown format, ``row_shards > 1``, ``fused_serving=False``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.inference.engine_v2 import InferenceEngineV2 as JEngine
from deepspeed_tpu.inference.sampling import SamplingParams as JSampling
from deepspeed_tpu.models import CausalLM as JCausalLM
from deepspeed_tpu.models.presets import get_preset as j_preset
from deepspeed_tpu.ops import quantizer as JQ
from deepspeed_tpu.ops.pallas import quant_matmul as jqm
from deepspeed_tpu_torch.inference.engine_v2 import InferenceEngineV2
from deepspeed_tpu_torch.inference.sampling import SamplingParams
from deepspeed_tpu_torch.models.presets import get_preset
from deepspeed_tpu_torch.models.transformer import CausalLM, _payload, params_from_numpy
from deepspeed_tpu_torch.ops import quantizer as TQ
from torch_threads import one_torch_thread  # noqa: F401  (one intra-op thread)

FMTS = ("int8", "fp8", "fp6")
J_QUANT = jax.jit(JQ.quantize_serving_weight, static_argnums=1)
J_QUANT6 = jax.jit(JQ.quantize_serving_weight_fp6)
J_PARAMS = jax.jit(JQ.quantize_serving_params, static_argnums=1)


def _b(t):
    """Bytes of a tensor or array, fp8 through a uint8 view."""
    t = t if isinstance(t, torch.Tensor) else _payload(t)
    return t.contiguous().view(torch.uint8).numpy() if t.element_size() == 1 else t.numpy()


def _same_quant(jw, tw):
    if isinstance(tw, TQ.ServingQuantFP6):
        np.testing.assert_array_equal(_b(tw.packed), _b(jw.packed))
        assert tw.in_dim == jw.in_dim and tw.packed.dtype == torch.uint8
    else:
        np.testing.assert_array_equal(_b(tw.q), _b(jw.q))
        assert tw.q.dtype == {"int8": torch.int8, "float8_e4m3fn": torch.float8_e4m3fn}[
            np.asarray(jw.q).dtype.name]
    np.testing.assert_array_equal(tw.s.numpy(), np.asarray(jw.s))
    assert tw.s.dtype == torch.float32


# ---------------------------------------------------------------------------
# payload bytes
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("fmt", FMTS)
@pytest.mark.parametrize("shape", [(256, 384), (3, 128, 96), (2, 2, 64, 40)])
def test_quantize_serving_weight_bytes_match_jax(fmt, shape):
    w = (np.random.default_rng(sum(shape)).normal(size=shape) * 0.05).astype(np.float32)
    if fmt == "fp6":
        jw, tw = J_QUANT6(jnp.asarray(w)), TQ.quantize_serving_weight_fp6(torch.from_numpy(w))
        assert tw.packed.shape == (*shape[:-2], 3, shape[-2] // 4, shape[-1])
    else:
        jw, tw = J_QUANT(jnp.asarray(w), fmt), TQ.quantize_serving_weight(torch.from_numpy(w), fmt)
        assert tw.q.shape == shape
    assert tw.s.shape == (*shape[:-2], shape[-1])  # per layer, per output channel
    _same_quant(jw, tw)


def test_stacked_leaf_is_quantized_layer_by_layer():
    """A stacked [L, in, out] leaf gives each layer the scales and bytes of
    that layer quantized alone."""
    w = torch.from_numpy(np.random.default_rng(1).normal(size=(3, 64, 32)).astype(np.float32))
    for fmt in ("int8", "fp8"):
        st = TQ.quantize_serving_weight(w, fmt)
        for l in range(3):
            one = TQ.quantize_serving_weight(w[l], fmt)
            assert torch.equal(_b_t(st.q[l]), _b_t(one.q)) and torch.equal(st.s[l], one.s)
    st6 = TQ.quantize_serving_weight_fp6(w)
    for l in range(3):
        one = TQ.quantize_serving_weight_fp6(w[l])
        assert torch.equal(st6.packed[l], one.packed) and torch.equal(st6.s[l], one.s)


def _b_t(t):
    return t.view(torch.uint8) if t.element_size() == 1 else t


def test_eager_jax_divides_and_its_scales_sit_within_one_ulp():
    w = np.random.default_rng(2).normal(size=(512, 256)).astype(np.float32)
    eager = JQ.quantize_serving_weight(jnp.asarray(w), "int8")
    tw = TQ.quantize_serving_weight(torch.from_numpy(w), "int8")
    s_e, s_t = np.asarray(eager.s), tw.s.numpy()
    assert (np.abs(s_e.view(np.int32) - s_t.view(np.int32)) <= 1).all()
    np.testing.assert_array_equal(tw.q.numpy(), np.asarray(eager.q))


def _fp6_boundaries():
    codes = jnp.arange(64, dtype=jnp.uint8)
    vals = np.asarray(JQ._fp6_decode(codes, jnp.float32))
    mids = (vals[:-1] + vals[1:]) / 2
    extra = [0.0, -0.0, 1.0, 2.0, 4.0, 7.5, 7.5001, 8.0, 100.0, -100.0, 1e-30, -1e-30,
             1.4e-45, -1.4e-45, 0.0625, 0.0624]
    out = np.concatenate([vals, np.nextafter(vals, np.inf), np.nextafter(vals, -np.inf),
                          mids, -mids, np.asarray(extra)]).astype(np.float32)
    return out


def test_fp6_encode_matches_jax_at_every_boundary():
    x = _fp6_boundaries()
    got = TQ._fp6_encode(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, np.asarray(JQ._fp6_encode(jnp.asarray(x))))
    np.testing.assert_array_equal(got, np.asarray(jax.jit(JQ._fp6_encode)(jnp.asarray(x))))
    # every code but -0 (32) round-trips, and each value gets the nearest code
    codes = torch.arange(64, dtype=torch.uint8)
    vals = TQ._fp6_decode(codes, torch.float32)
    keep = codes != 32
    assert torch.equal(TQ._fp6_encode(vals)[keep], codes[keep])
    dec = TQ._fp6_decode(torch.from_numpy(got), torch.float32).numpy()
    clipped = np.clip(x, -7.5, 7.5)
    gap = np.abs(dec - clipped)
    nearest = np.abs(vals.numpy()[None, :] - clipped[:, None]).min(axis=1)
    np.testing.assert_array_equal(gap, nearest)


def test_fp6_pack_unpack_round_trip_and_jax_layout():
    rng = np.random.default_rng(3)
    codes = rng.integers(0, 64, size=(2, 48, 24)).astype(np.uint8)
    packed = TQ._fp6_pack(torch.from_numpy(codes))
    assert packed.shape == (2, 3, 12, 24) and packed.dtype == torch.uint8
    np.testing.assert_array_equal(packed.numpy(), np.asarray(JQ._fp6_pack(jnp.asarray(codes))))
    np.testing.assert_array_equal(TQ._fp6_unpack(packed, 48).numpy(), codes)
    np.testing.assert_array_equal(
        TQ._fp6_unpack(packed, 48).numpy(),
        np.asarray(JQ._fp6_unpack(jnp.asarray(packed.numpy()), 48)))


# ---------------------------------------------------------------------------
# trees
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def tiny():
    """The JAX quantized-serving test config (``tests/test_quant_matmul.py``:
    ``tiny``, fp32, hidden 128, intermediate 256, 2 / 2 heads)."""
    over = dict(hidden_size=128, intermediate_size=256, num_heads=2, num_kv_heads=2)
    jcfg = j_preset("tiny", max_seq_len=128, dtype=jnp.float32).replace(**over)
    tcfg = get_preset("tiny", max_seq_len=128, dtype=torch.float32).replace(**over)
    jp = JCausalLM(jcfg).init_params(jax.random.PRNGKey(0))
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), tcfg, device="cpu")
    return jcfg, jp, tcfg, tp


def _flat(tree, prefix=""):
    for k, v in tree.items():
        p = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            yield from _flat(v, p)
        else:
            yield p, v


@pytest.mark.parametrize("fmt", FMTS)
def test_quantize_serving_params_matches_jax_tree(tiny, fmt):
    _, jp, _, tp = tiny
    jq = J_PARAMS(jp, fmt)
    tq = TQ.quantize_serving_params(tp, fmt)
    jflat = dict(_flat(jq))
    quantized = []
    for path, tw in _flat(tq):
        jw = jflat[path]
        if isinstance(tw, TQ.QUANT_TYPES):
            quantized.append(path)
            _same_quant(jw, tw)
        else:
            np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))
    assert sorted(quantized) == sorted(
        p for p, _ in _flat(tp) if any(p.endswith(t) for t in TQ._SERVING_QUANT_PATHS))
    assert len(quantized) == 8
    assert TQ.tree_nbytes(tq) == JQ.tree_nbytes(jq) < TQ.tree_nbytes(tp)


@pytest.mark.parametrize("fmt", FMTS)
def test_params_from_numpy_carries_a_jax_quantized_tree(tiny, fmt):
    jcfg, jp, tcfg, _ = tiny
    jq = J_PARAMS(jp, fmt)
    tq = params_from_numpy(jax.tree_util.tree_map(np.asarray, jq), tcfg, device="cpu")
    jflat = dict(_flat(jq))
    for path, tw in _flat(tq):
        if isinstance(tw, TQ.QUANT_TYPES):
            _same_quant(jflat[path], tw)
    assert TQ.tree_nbytes(tq) == JQ.tree_nbytes(jq)


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------
ENGINE_KW = dict(max_seqs=3, num_blocks=64, block_size=8, prefill_buckets=(16, 32))
PROMPTS = [[3, 1, 4, 1, 5, 9, 2, 6], [2, 7, 1, 8, 2, 8, 1, 8, 2, 8, 4, 5, 9],
           [1, 6, 1, 8, 0, 3, 3, 9, 8, 8, 7, 4, 9, 8, 9, 4, 8, 4, 8, 2]]


@pytest.fixture
def interpret():
    jqm.set_interpret(True)
    yield
    jqm.set_interpret(False)


def _greedy(je, te, steps=6):
    uids = [1, 2, 3]
    assert te.put(uids, PROMPTS, SamplingParams()) == je.put(uids, PROMPTS, JSampling())
    for _ in range(steps):
        assert te.step(SamplingParams()) == je.step(JSampling())
    for u in uids:
        assert te.mgr.seqs[u].tokens == je.mgr.seqs[u].tokens
    assert te.close() == je.close()


@pytest.mark.parametrize("fmt", FMTS)
def test_quantized_engine_token_identity(tiny, interpret, fmt):
    """Each package quantizes the same fp32 weights at engine construction;
    the payloads agree byte for byte and greedy decoding token for token."""
    jcfg, jp, tcfg, tp = tiny
    je = JEngine(jp, jcfg, quantize_weights=fmt, **ENGINE_KW)
    te = InferenceEngineV2(tp, tcfg, device="cpu", quantize_weights=fmt, **ENGINE_KW)
    assert te.quantize_weights == fmt
    jflat = dict(_flat(je.params))
    for path, tw in _flat(te.params):
        if isinstance(tw, TQ.QUANT_TYPES):
            _same_quant(jflat[path], tw)
    _greedy(je, te)


@pytest.mark.parametrize("fmt", FMTS)
def test_port_serves_the_jax_engines_payloads(tiny, interpret, fmt):
    """The JAX-quantized tree through ``params_from_numpy`` into a port
    engine with no quantization of its own: the same greedy tokens."""
    jcfg, jp, tcfg, _ = tiny
    je = JEngine(jp, jcfg, quantize_weights=fmt, **ENGINE_KW)
    tq = params_from_numpy(jax.tree_util.tree_map(np.asarray, je.params), tcfg, device="cpu")
    _greedy(je, InferenceEngineV2(tq, tcfg, device="cpu", **ENGINE_KW))


@pytest.mark.parametrize("fmt", FMTS)
def test_quantized_scheduler_finishes_everything_without_leaks(tiny, fmt):
    _, _, tcfg, tp = tiny
    eng = InferenceEngineV2(tp, tcfg, device="cpu", quantize_weights=fmt, max_seqs=2,
                            num_blocks=24, block_size=8, prefill_buckets=(16, 32),
                            enable_prefix_caching=True, prefill_chunk=16)
    sched = eng.scheduler
    rng = np.random.default_rng(4)
    sys_prompt = rng.integers(1, 256, 16).tolist()
    prompts = {u: sys_prompt + rng.integers(1, 256, 5).tolist() for u in range(1, 6)}
    for u, p in prompts.items():
        sched.submit(u, p, SamplingParams(max_new_tokens=7))
    results = sched.run()
    assert sorted(results) == list(prompts)
    assert all(len(r) == 7 and sched.requests[u].state == "finished" for u, r in results.items())
    assert eng.mgr.cached_prompt_tokens > 0
    assert eng.close()["blocks_in_use"] == 0


# ---------------------------------------------------------------------------
# presets and refusals
# ---------------------------------------------------------------------------
def test_llama3_8b_preset_matches_jax():
    j, t = j_preset("llama3_8b"), get_preset("llama3_8b")
    for f in ("vocab_size", "hidden_size", "intermediate_size", "num_layers", "num_heads",
              "num_kv_heads", "max_seq_len", "rope_theta", "remat", "attn_impl", "hd"):
        assert getattr(t, f) == getattr(j, f), f
    assert t.param_count == j.param_count
    assert CausalLM(t).cfg.remat == "dots"  # trains under the dots policy


def test_refusals(tiny):
    _, jp, tcfg, tp = tiny
    with pytest.raises(ValueError, match="quantize_weights format 'int4'"):
        InferenceEngineV2(tp, tcfg, device="cpu", num_blocks=8, quantize_weights="int4")
    with pytest.raises(ValueError, match="quantize_weights format"):
        TQ.quantize_serving_weight(torch.zeros(8, 4), "fp6")
    with pytest.raises(NotImplementedError, match="fused_serving"):
        InferenceEngineV2(tp, tcfg, device="cpu", num_blocks=8, quantize_weights="int8",
                          fused_serving=False)
    InferenceEngineV2(tp, tcfg, device="cpu", num_blocks=8, fused_serving=True).close()
    # the per-K-chunk FP6 pack of tensor-parallel row kernels runs since
    # slice 23 (tests/test_torch_tp.py serves it): its bytes are
    # JAX's, and a whole chunked pack is refused on one device, where it
    # would run as one standard pack
    w = torch.randn(16, 8, generator=torch.Generator().manual_seed(1))
    got = TQ.quantize_serving_weight_fp6(w, row_shards=2)
    want = JQ.quantize_serving_weight_fp6(jnp.asarray(w.numpy()), row_shards=2)
    np.testing.assert_array_equal(got.packed.numpy(), np.asarray(want.packed))
    assert (got.in_dim, got.row_shards) == (16, 2)
    tq = TQ.quantize_serving_params(tp, "fp6", row_parallel_shards=2)
    jq = params_from_numpy(jax.tree_util.tree_map(
        np.asarray, JQ.quantize_serving_params(jp, "fp6", row_parallel_shards=2)),
        tcfg, device="cpu")
    for name in ("wo", "wq"):
        a, b = tq["layers"]["attn"][name], jq["layers"]["attn"][name]
        assert a.row_shards == b.row_shards == (2 if name == "wo" else 1)
        assert torch.equal(a.packed, b.packed)
    with pytest.raises(ValueError, match="per-K-chunk"):
        TQ.serving_mm(torch.zeros(1, 16), got)
    with pytest.raises(ValueError, match="in-dim % 4"):
        TQ.quantize_serving_weight_fp6(torch.zeros(6, 8))

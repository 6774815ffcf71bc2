"""The port's serving slice as a whole — ``InferenceEngineV2`` and its
``ServeScheduler`` — against the JAX engine on the CPU: greedy decoding is
TOKEN-IDENTICAL on the ``tiny`` preset in fp32 (same weights through
``params_from_numpy``), and so are the engine's dispatch counters and the
prefix-cache hit counts.  Every engine closes with zero leaked blocks.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.inference.engine_v2 import InferenceEngineV2 as JEngine
from deepspeed_tpu.inference.sampling import SamplingParams as JSampling
from deepspeed_tpu.models.presets import get_preset as j_preset
from deepspeed_tpu.models.transformer import init_params as j_init
from deepspeed_tpu_torch.inference.engine_v2 import InferenceEngineV2
from deepspeed_tpu_torch.inference.sampling import SamplingParams
from deepspeed_tpu_torch.inference.scheduler import (
    QUEUED,
    REJECT_DUPLICATE_UID,
    REJECT_EMPTY_PROMPT,
    REJECT_POOL_IMPOSSIBLE,
    REJECT_PROMPT_TOO_LONG,
)
from deepspeed_tpu_torch.models.presets import get_preset
from deepspeed_tpu_torch.models.transformer import params_from_numpy

SHARED_STATS = ("prefill_tokens_dispatched", "prefill_dispatches", "decode_ticks",
                "decode_emitted")


@pytest.fixture(scope="module")
def pair():
    jcfg = j_preset("tiny", dtype=jnp.float32, max_seq_len=256)
    tcfg = get_preset("tiny", dtype=torch.float32, max_seq_len=256)
    jp = j_init(jax.random.PRNGKey(0), jcfg)
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), tcfg, device="cpu")
    return jcfg, jp, tcfg, tp


def _engines(pair, **kw):
    jcfg, jp, tcfg, tp = pair
    return JEngine(jp, jcfg, **kw), InferenceEngineV2(tp, tcfg, device="cpu", **kw)


def _close_both(je, te):
    assert te.close() == je.close()
    assert te.close()["blocks_in_use"] == 0


def test_put_step_token_identity(pair):
    """(a) put() of several cold prompts (two packs under the budget), then
    greedy step()s."""
    je, te = _engines(pair, max_seqs=4, num_blocks=40, block_size=16,
                      prefill_buckets=(64, 128, 256), prefill_budget=128)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, 256, n).tolist() for n in (5, 40, 33, 70)]
    assert te.put([1, 2, 3, 4], prompts, SamplingParams()) == \
        je.put([1, 2, 3, 4], prompts, JSampling())
    for _ in range(8):
        assert te.step(SamplingParams()) == je.step(JSampling())
    for u in range(1, 5):
        assert te.mgr.seqs[u].tokens == je.mgr.seqs[u].tokens
    assert {k: te.stats[k] for k in SHARED_STATS} == {k: je.stats[k] for k in SHARED_STATS}
    _close_both(je, te)


def _run_sched(engine, prompts, sampling):
    s = engine.scheduler
    for u, p in prompts.items():
        s.submit(u, p, sampling)
    return s.run(), s


def test_scheduler_prefix_caching_token_identity(pair):
    """(b) a shared system prompt: later requests hit the prefix cache and
    their suffixes go down the packed-context path."""
    kw = dict(max_seqs=4, num_blocks=48, block_size=16, prefill_buckets=(64, 128),
              enable_prefix_caching=True, prefill_chunk=64)
    je, te = _engines(pair, **kw)
    rng = np.random.default_rng(1)
    sys_prompt = rng.integers(1, 256, 48).tolist()
    prompts = {u: sys_prompt + rng.integers(1, 256, 10).tolist() for u in range(1, 7)}
    t_res, ts = _run_sched(te, prompts, SamplingParams(max_new_tokens=8))
    j_res, js = _run_sched(je, prompts, JSampling(max_new_tokens=8))
    assert t_res == j_res
    assert {k: te.stats[k] for k in SHARED_STATS} == {k: je.stats[k] for k in SHARED_STATS}
    assert te.mgr.cached_prompt_tokens == je.mgr.cached_prompt_tokens > 0
    assert te.mgr.prompt_tokens_total == je.mgr.prompt_tokens_total
    assert ts.stats["prefill_chunks"] == js.stats["prefill_chunks"]
    _close_both(je, te)


def test_scheduler_chunked_prefill_and_preemption_token_identity(pair):
    """(c) a prompt longer than prefill_chunk is prefilled in chunks, and a
    pool too small for every request's growth forces preemption by
    recompute."""
    kw = dict(max_seqs=4, num_blocks=14, block_size=16, max_seq_len=128,
              prefill_buckets=(32, 64, 128), prefill_chunk=32,
              enable_prefix_caching=True)
    je, te = _engines(pair, **kw)
    rng = np.random.default_rng(2)
    prompts = {1: rng.integers(1, 256, 100).tolist()}
    prompts.update({u: rng.integers(1, 256, 30).tolist() for u in (2, 3, 4)})
    t_res, ts = _run_sched(te, prompts, SamplingParams(max_new_tokens=24))
    j_res, js = _run_sched(je, prompts, JSampling(max_new_tokens=24))
    assert t_res == j_res
    assert all(len(r) == 24 for r in t_res.values())
    assert ts.stats["preemptions"] == js.stats["preemptions"] > 0
    assert ts.stats["prefill_chunks"] == js.stats["prefill_chunks"]
    assert {k: te.stats[k] for k in SHARED_STATS} == {k: je.stats[k] for k in SHARED_STATS}
    _close_both(je, te)


def test_submit_reasons_and_generate(pair):
    _, _, tcfg, tp = pair
    eng = InferenceEngineV2(tp, tcfg, device="cpu", max_seqs=2, num_blocks=8, block_size=16,
                            max_seq_len=256, prefill_buckets=(64, 128))
    s = eng.scheduler
    assert s.try_submit(1, [3, 4, 5], SamplingParams(max_new_tokens=4)).reason == QUEUED
    assert s.try_submit(1, [3], SamplingParams()).reason == REJECT_DUPLICATE_UID
    assert s.try_submit(2, [], SamplingParams()).reason == REJECT_EMPTY_PROMPT
    assert s.try_submit(3, [1] * 256, SamplingParams()).reason == REJECT_PROMPT_TOO_LONG
    res = s.try_submit(4, [1] * 100, SamplingParams(max_new_tokens=100))
    assert res.reason == REJECT_POOL_IMPOSSIBLE and res.budget_blocks == 8
    assert len(s.run()[1]) == 4
    assert s.cancel(1) is False  # already terminal
    assert len(eng.generate([7, 8, 9], SamplingParams(max_new_tokens=3))) == 3
    assert eng.close()["blocks_in_use"] == 0


def test_unsupported_arguments_raise(pair):
    from deepspeed_tpu_torch.parallel.topology import Grid, MeshSpec

    jcfg, jp, tcfg, tp = pair
    # a tensor-parallel grid is refused with the rest (ROADMAP queue 1 item
    # 7); seq shards are ported (tests/test_torch_seq_shard.py)
    tp_grid = Grid(spec=MeshSpec(model=2), devices=[torch.device("cpu")] * 2)
    for kw in (dict(fused_serving=False), dict(offload_weights=True), dict(grid=tp_grid),
               dict(serve_replicas=2)):
        with pytest.raises(NotImplementedError):
            InferenceEngineV2(tp, tcfg, device="cpu", num_blocks=8, **kw)
    # seq_shards without a grid whose seq axis matches, as in JAX
    with pytest.raises(ValueError, match="seq axis"):
        InferenceEngineV2(tp, tcfg, device="cpu", num_blocks=8, seq_shards=2)
    with pytest.raises(TypeError):
        InferenceEngineV2(tp, tcfg, device="cpu", num_blocks=8, grid=object())
    # speculation is ported; its arguments are checked as in JAX
    for kw in (dict(spec_max_draft=0), dict(spec_min_match=0)):
        with pytest.raises(ValueError):
            InferenceEngineV2(tp, tcfg, device="cpu", num_blocks=8, enable_speculation=True,
                              **kw)
    # step_n is ported (tests/test_torch_megastep.py): a burst of two ticks
    # returns the last token of each sequence, as JAX's does
    eng = InferenceEngineV2(tp, tcfg, device="cpu", num_blocks=8)
    je = JEngine(jp, jcfg, num_blocks=8)
    assert eng.put([1], [[5, 6, 7, 8]]) == je.put([1], [[5, 6, 7, 8]])
    out = eng.step_n(2)
    assert out == je.step_n(2) and set(out) == {1} and out[1] >= 0
    assert eng.mgr.seqs[1].tokens == je.mgr.seqs[1].tokens
    assert len(eng.mgr.seqs[1].tokens) == 4 + 1 + 2
    _close_both(je, eng)


def test_no_device_and_no_cuda_raises(pair):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    _, _, tcfg, tp = pair
    with pytest.raises(RuntimeError, match="no CUDA device"):
        InferenceEngineV2(tp, tcfg, num_blocks=8)

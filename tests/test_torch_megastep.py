"""Device-resident decode bursts in the port — ``InferenceEngineV2.step_n``
and the scheduler's megastep (``serve={"decode_megastep": n}``) — against
per-tick ``step()`` and against the JAX package on the CPU, fp32, weights
from JAX ``init_params(PRNGKey(0))`` through ``params_from_numpy``.
from torch_threads import one_torch_thread  # noqa: F401  (one intra-op thread)

On the CPU the burst's tick body runs eagerly n times (on CUDA it is a
captured graph, replayed: ``tests/test_torch_gpu.py``).  Each test mirrors
one of JAX's (``tests/test_megastep.py``, ``tests/test_inference.py``):

- greedy bursts are token-identical to per-tick ``step()`` and to JAX's
  ``step_n`` on ``tiny`` and ``tiny_gpt2``, and the burst stats
  (``decode_bursts``, ``burst_ticks``, ``burst_emitted``) equal JAX's;
- a stop token, ``max_new_tokens`` and ``max_seq_len`` that land mid-burst
  end each row exactly there, with the descriptors' lengths and block lists
  equal to JAX's;
- int8 weights, and ``seq_shards`` 2 against the JAX single pool;
- the workload of ``bench.py --serving --megastep`` (its CPU branch) and
  the megastep's collapse under mixed work;
- ``ServeConfig``'s checks with JAX's texts, and its refusals;
- the fixed-shape decode KV write (``paged.decode_rows`` /
  ``write_decode_rows``) against JAX ``write_decode_kv``: every pool byte
  outside the written rows unchanged, for inactive slots, -1 pages and
  slots that stopped mid-burst;
- a burst after a copy-on-write clone reads the clone.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.config.config import ConfigError as JConfigError
from deepspeed_tpu.config.config import ServeConfig as JServeConfig
from deepspeed_tpu.inference import paged as jpaged
from deepspeed_tpu.inference.engine_v2 import InferenceEngineV2 as JEngine
from deepspeed_tpu.inference.sampling import SamplingParams as JSampling
from deepspeed_tpu.models.presets import get_preset as j_preset
from deepspeed_tpu.models.transformer import init_params as j_init
from deepspeed_tpu_torch.config.config import ConfigError, ServeConfig
from deepspeed_tpu_torch.inference import paged as tpaged
from deepspeed_tpu_torch.inference.engine_v2 import InferenceEngineV2
from deepspeed_tpu_torch.inference.sampling import SamplingParams
from deepspeed_tpu_torch.models.presets import get_preset
from deepspeed_tpu_torch.models.transformer import params_from_numpy
from deepspeed_tpu_torch.parallel.topology import initialize_mesh

BURST_STATS = ("decode_bursts", "burst_ticks", "burst_emitted", "decode_ticks",
               "decode_emitted")
STEP_KW = dict(max_seqs=4, num_blocks=32, block_size=16, prefill_buckets=(16, 32, 64))
SCHED_KW = dict(max_seqs=4, num_blocks=64, block_size=8, prefill_buckets=(16, 32, 64),
                enable_prefix_caching=True)


@pytest.fixture(scope="module")
def models():
    """(jcfg, jparams, tcfg, tparams) per preset, fp32, built once."""
    cache = {}

    def get(name):
        if name not in cache:
            jcfg = j_preset(name, dtype=jnp.float32, max_seq_len=128)
            tcfg = get_preset(name, dtype=torch.float32, max_seq_len=128)
            jp = j_init(jax.random.PRNGKey(0), cfg=jcfg, dtype=jnp.float32)
            tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), tcfg,
                                   device="cpu")
            cache[name] = jcfg, jp, tcfg, tp
        return cache[name]

    return get


def _stats(eng):
    return {k: eng.stats[k] for k in BURST_STATS}


def _close(eng):
    audit = eng.close()
    assert audit["blocks_in_use"] == 0, audit
    return audit


def _prompts(vocab, n=4, seed=0, shared=12, sfx=4):
    rng = np.random.default_rng(seed)
    sys_prompt = rng.integers(1, vocab, shared).tolist()
    return {u: sys_prompt + rng.integers(1, vocab, sfx).tolist() for u in range(1, n + 1)}


def _serve(eng, prompts, samp):
    """Submit every prompt (one SamplingParams or {uid: SamplingParams}) to
    the engine's scheduler and run it dry; results, stats, leak-checked."""
    sched = eng.scheduler
    for u, p in prompts.items():
        assert sched.try_submit(u, p, samp[u] if isinstance(samp, dict) else samp).accepted
    sched.run()
    out = {u: sched.pop_result(u) for u in prompts}
    stats = _stats(eng)
    _close(eng)
    return out, stats


# ---------------------------------------------------------------------------
# step_n: token identity and stats (JAX test_inference.py:233-262)
# ---------------------------------------------------------------------------
STEP_PROMPTS = [[3, 4, 5, 6, 7], [9, 8, 7], list(range(10, 31))]


@pytest.mark.parametrize("name", ["tiny", "tiny_gpt2"])
def test_step_n_matches_per_tick_steps_and_jax(models, name):
    """Two bursts (6 ticks, then 5) against 11 per-tick steps of the port
    and JAX's two bursts: the same tokens, returns, burst stats, block
    lists, and the same close audit."""
    jcfg, jp, tcfg, tp = models(name)
    uids = [1, 2, 3]
    tick = InferenceEngineV2(tp, tcfg, device="cpu", **STEP_KW)
    tick.put(uids, STEP_PROMPTS)
    for _ in range(11):
        tick.step(SamplingParams())
    te = InferenceEngineV2(tp, tcfg, device="cpu", **STEP_KW)
    je = JEngine(jp, jcfg, **STEP_KW)
    assert te.put(uids, STEP_PROMPTS) == je.put(uids, STEP_PROMPTS)
    for n in (6, 5):
        assert te.step_n(n, SamplingParams()) == je.step_n(n, JSampling())
    for u in uids:
        assert te.mgr.seqs[u].tokens == je.mgr.seqs[u].tokens == tick.mgr.seqs[u].tokens
        assert te.mgr.seqs[u].blocks == je.mgr.seqs[u].blocks
    assert _stats(te) == {k: je.stats[k] for k in BURST_STATS}
    assert te.stats["decode_bursts"] == 2 and te.stats["burst_ticks"] == 11
    assert te.stats["burst_emitted"] == 33
    assert te.close() == je.close() == tick.close()
    assert te.close()["blocks_in_use"] == 0


# ---------------------------------------------------------------------------
# stop-exactness mid-burst (JAX test_megastep.py:150-232, test_inference.py:265)
# ---------------------------------------------------------------------------
def _stop_token_run(eng, sampling_cls, n, prompts, **samp):
    eng.put([1, 2], prompts, sampling_cls(**samp))
    out = eng.step_n(n, sampling_cls(**samp))
    return out, {u: (s.tokens, s.blocks, s.done) for u, s in eng.mgr.seqs.items()}


def _step_ticks(eng, n, samp):
    for _ in range(n):
        if not eng.step(samp):
            break


@pytest.mark.parametrize("limit", ["stop_token", "max_seq_len", "max_new_tokens"])
def test_bursts_stop_exactly_mid_burst(models, limit):
    """A row's stop token, the engine's ``max_seq_len`` and a request's
    ``max_new_tokens`` each land mid-burst: the row ends exactly there (the
    descriptors' tokens, block lists and done flags equal JAX's step_n /
    megastep and the port's per-tick run), its batchmates go on, and
    nothing leaks."""
    jcfg, jp, tcfg, tp = models("tiny")
    if limit == "max_new_tokens":
        prompts = _prompts(tcfg.vocab_size, n=3, seed=4)
        budgets = {1: 3, 2: 5, 3: 9}
        want, jstats = _serve(JEngine(jp, jcfg, serve=dict(decode_megastep=4), **SCHED_KW),
                              prompts, {u: JSampling(max_new_tokens=b) for u, b in budgets.items()})
        samp = {u: SamplingParams(max_new_tokens=b) for u, b in budgets.items()}
        got, stats = _serve(InferenceEngineV2(tp, tcfg, device="cpu", serve={"decode_megastep": 4},
                                              **SCHED_KW), prompts, samp)
        tick, _ = _serve(InferenceEngineV2(tp, tcfg, device="cpu", **SCHED_KW), prompts, samp)
        assert got == want == tick
        assert {u: len(t) for u, t in got.items()} == budgets
        assert stats == {k: jstats[k] for k in BURST_STATS} and stats["decode_bursts"] > 0
        return
    kw = dict(STEP_KW)
    samp = {}
    prompts = [[3, 4, 5], [9, 8, 7, 6]]
    if limit == "stop_token":
        free = InferenceEngineV2(tp, tcfg, device="cpu", **kw)
        _, seqs = _stop_token_run(free, SamplingParams, 8, prompts)
        samp = dict(stop_token=int(seqs[1][0][3 + 2]))  # uid 1's third generated token
        _close(free)
    else:
        # uid 2 (11 tokens after its prefill) reaches 16 at tick 5 of 10
        kw.update(max_seq_len=16, block_size=8)
        prompts[1] = list(range(20, 30))
    je = JEngine(jp, jcfg, **kw)
    te = InferenceEngineV2(tp, tcfg, device="cpu", **kw)
    tick = InferenceEngineV2(tp, tcfg, device="cpu", **kw)
    jout, jseqs = _stop_token_run(je, JSampling, 10, prompts, **samp)
    tout, tseqs = _stop_token_run(te, SamplingParams, 10, prompts, **samp)
    tick.put([1, 2], prompts, SamplingParams(**samp))
    _step_ticks(tick, 10, SamplingParams(**samp))
    assert tout == jout and tseqs == jseqs
    assert {u: s.tokens for u, s in tick.mgr.seqs.items()} == {u: v[0] for u, v in tseqs.items()}
    if limit == "stop_token":
        toks, _, done = tseqs[1]
        assert done and toks[-1] == samp["stop_token"] and len(toks) <= 3 + 3
        assert toks.index(samp["stop_token"]) == len(toks) - 1  # nothing past the stop
    else:
        assert len(tseqs[2][0]) == 16 and tseqs[2][2]
        assert len(tseqs[1][0]) == 14  # the least constrained row set the burst's length
    for s in te.mgr.seqs.values():  # the unused tail reservation came back
        assert len(s.blocks) == -(-s.cur_len // kw["block_size"])
    assert te.close() == je.close() == tick.close()
    assert te.close()["blocks_in_use"] == 0


# ---------------------------------------------------------------------------
# the scheduler's megastep (JAX test_megastep.py:82-123, bench.py:1302-1420)
# ---------------------------------------------------------------------------
def _arrival_run(make_engine, sampling, vocab, n_req=6, sys_len=48, sfx_len=8,
                 max_new=12):
    """``bench.py --serving --megastep``'s CPU branch: a shared-prefix
    arrival workload, Poisson(2) gaps in ticks, ``default_rng(0)``."""
    rng = np.random.default_rng(0)
    sys_prompt = rng.integers(1, vocab, sys_len).tolist()
    prompts = {u: sys_prompt + rng.integers(1, vocab, sfx_len).tolist()
               for u in range(1, n_req + 1)}
    arrivals = np.cumsum(rng.poisson(2.0, n_req))
    eng = make_engine()
    sched = eng.scheduler
    samp = sampling(temperature=0.0, max_new_tokens=max_new)
    submitted = 0
    while submitted < n_req or not sched.idle:
        while submitted < n_req and arrivals[submitted] <= sched.tick_no:
            submitted += 1
            sched.submit(submitted, prompts[submitted], samp)
        sched.tick()
    results = {u: sched.pop_result(u) for u in range(1, n_req + 1)}
    assert all(len(r) == max_new for r in results.values())
    stats = _stats(eng)
    _close(eng)
    return results, stats


MEGASTEP_KW = dict(max_seqs=4, num_blocks=48, block_size=8, max_seq_len=128,
                   prefill_buckets=(16, 32, 64), prefill_budget=64, prefill_chunk=32,
                   enable_prefix_caching=True)


def test_megastep_workload_matches_per_tick_and_jax(models):
    jcfg, jp, tcfg, tp = models("tiny")
    want, jstats = _arrival_run(
        lambda: JEngine(jp, jcfg, serve=dict(decode_megastep=4), **MEGASTEP_KW),
        JSampling, tcfg.vocab_size)
    got, stats = _arrival_run(
        lambda: InferenceEngineV2(tp, tcfg, device="cpu", serve=ServeConfig(decode_megastep=4),
                                  **MEGASTEP_KW), SamplingParams, tcfg.vocab_size)
    tick, tstats = _arrival_run(
        lambda: InferenceEngineV2(tp, tcfg, device="cpu", **MEGASTEP_KW), SamplingParams,
        tcfg.vocab_size)
    assert got == want == tick
    assert stats == {k: jstats[k] for k in BURST_STATS}
    assert stats["decode_bursts"] > 0 and stats["burst_ticks"] > stats["decode_bursts"]
    assert tstats["decode_bursts"] == 0
    # host syncs per emitted token (bench.py:1378-1381): fewer with bursts
    syncs = lambda s: (s["decode_ticks"] + s["decode_bursts"]) / (
        s["decode_emitted"] + s["burst_emitted"])
    assert syncs(stats) < syncs(tstats)


@pytest.mark.parametrize("variant", ["int8", "seq_shards_2"])
def test_megastep_quantized_and_seq_sharded_match_jax(models, variant):
    """int8 weights (JAX ``test_megastep_identity_quantized``) and a pool of
    two seq shards against the JAX single pool: megastep runs equal the
    port's per-tick run and JAX's megastep run."""
    jcfg, jp, tcfg, tp = models("tiny")
    prompts = _prompts(tcfg.vocab_size, n=3, seed=1)
    jkw, tkw = dict(SCHED_KW), dict(SCHED_KW)
    if variant == "int8":
        jkw["quantize_weights"] = tkw["quantize_weights"] = "int8"
    else:
        tkw.update(grid=initialize_mesh(devices=["cpu"] * 2, seq=2), seq_shards=2)
    want, jstats = _serve(JEngine(jp, jcfg, serve=dict(decode_megastep=4), **jkw), prompts,
                          JSampling(max_new_tokens=8))
    got, stats = _serve(InferenceEngineV2(tp, tcfg, device="cpu", serve={"decode_megastep": 4},
                                          **tkw), prompts, SamplingParams(max_new_tokens=8))
    tick, _ = _serve(InferenceEngineV2(tp, tcfg, device="cpu", **tkw), prompts,
                     SamplingParams(max_new_tokens=8))
    assert got == want == tick
    assert stats == {k: jstats[k] for k in BURST_STATS} and stats["decode_bursts"] > 0


def test_megastep_collapses_under_mixed_work(models):
    """While a running request is still mid-prefill the plan stays per-tick;
    once the tick is decode-only, fusing resumes (JAX ``test_megastep_
    collapses_under_mixed_work``), tick for tick as JAX plans it."""
    jcfg, jp, tcfg, tp = models("tiny")
    rng = np.random.default_rng(6)
    short = rng.integers(1, tcfg.vocab_size, 8).tolist()
    long = rng.integers(1, tcfg.vocab_size, 40).tolist()

    def run(eng, sampling):
        sched = eng.scheduler
        samp = sampling(temperature=0.0, max_new_tokens=6)
        assert sched.try_submit(1, short, samp).accepted
        sched.tick()  # prefill: no decode rows yet, nothing fused
        bursts = [eng.stats["decode_bursts"]]
        assert sched.try_submit(2, long, samp).accepted
        for _ in range(2):  # 40 tokens at chunk 16: mid-prefill for two ticks
            sched.tick()
            bursts.append(eng.stats["decode_bursts"])
        sched.run()
        out = {u: sched.pop_result(u) for u in (1, 2)}
        bursts.append(eng.stats["decode_bursts"])
        _close(eng)
        return out, bursts

    want, jbursts = run(JEngine(jp, jcfg, serve=dict(decode_megastep=8), prefill_chunk=16,
                                **SCHED_KW), JSampling)
    got, bursts = run(InferenceEngineV2(tp, tcfg, device="cpu", serve={"decode_megastep": 8},
                                        prefill_chunk=16, **SCHED_KW), SamplingParams)
    assert got == want and bursts == jbursts
    assert bursts[:3] == [0, 0, 0] and bursts[-1] > 0
    assert all(len(t) == 6 for t in got.values())


# ---------------------------------------------------------------------------
# ServeConfig
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("kw", [
    dict(decode_megastep=0), dict(decode_megastep=-1), dict(comm_tiles=0),
    dict(quant_comm="int4"), dict(deadline_ms=0), dict(ttft_deadline_ms=-5.0),
    dict(watchdog_tick_ms=-1.0), dict(max_retries=-1), dict(retry_backoff_ms=-1.0),
    dict(shed_queue_depth=0), dict(watchdog_grace_ticks=0),
])
def test_serve_config_checks_say_what_jax_says(kw):
    with pytest.raises(JConfigError) as jerr:
        JServeConfig(**kw)
    with pytest.raises(ConfigError) as terr:
        ServeConfig(**kw)
    assert str(terr.value) == str(jerr.value)


@pytest.mark.parametrize("kw,item", [
    pytest.param(dict(fused_serving=False), 7, id="kw10-7"),
])
def test_serve_config_refuses_unported_fields(models, kw, item):
    """A field of item 7 not ported yet, set away from its default, raises
    naming its item, from ``ServeConfig`` and from the engine's ``serve=``
    dict (the deadline, retry, shed and watchdog fields run:
    ``test_serve_config_runs_fault_tolerance_fields``; ``adaptation`` too:
    ``test_serve_config_takes_adaptation_as_jax_does``)."""
    _, _, tcfg, tp = models("tiny")
    with pytest.raises(NotImplementedError, match=f"item {item}"):
        ServeConfig(**kw)
    with pytest.raises(NotImplementedError, match=f"item {item}"):
        InferenceEngineV2(tp, tcfg, device="cpu", num_blocks=8, serve=kw)


@pytest.mark.parametrize("kw", [
    pytest.param(dict(quant_comm="int8"), id="kw8-7"),
    pytest.param(dict(comm_tiles=2), id="kw9-7"),
])
def test_serve_config_takes_the_tensor_parallel_transport_fields(models, kw):
    """``quant_comm`` / ``comm_tiles`` (the cases that the refusal test held
    until slice 23) parse with JAX's values; an engine without a model axis
    carries them and reads neither (``tests/test_torch_tp.py``
    serves through them over one)."""
    _, _, tcfg, tp = models("tiny")
    t, j = ServeConfig(**kw), JServeConfig(**kw)
    assert (t.quant_comm, t.comm_tiles) == (j.quant_comm, j.comm_tiles)
    eng = InferenceEngineV2(tp, tcfg, device="cpu", num_blocks=8, serve=kw)
    assert (eng.quant_comm, eng.comm_tiles) == (t.quant_comm, t.comm_tiles)
    assert eng.serving_ctx.tp is None
    eng.close()


def test_serve_config_takes_adaptation_as_jax_does(models):
    """``serve.adaptation`` (the online controller's block, ROADMAP item
    6's second half) is accepted: a dict coerces into ``AdaptationConfig``
    with JAX's values, and the engine carries it for ``attach_controller``."""
    import dataclasses

    _, _, tcfg, tp = models("tiny")
    kw = dict(adaptation={"enabled": True, "epoch_s": 0.05, "min_window": 2})
    t, j = ServeConfig(**kw), JServeConfig(**kw)
    assert dataclasses.asdict(t.adaptation) == dataclasses.asdict(j.adaptation)
    eng = InferenceEngineV2(tp, tcfg, device="cpu", num_blocks=8, serve=kw)
    assert eng.serve.adaptation.enabled and eng.serve.adaptation.min_window == 2
    eng.close()


@pytest.mark.parametrize("kw", [
    dict(deadline_ms=100.0), dict(ttft_deadline_ms=50.0), dict(max_retries=0),
    dict(retry_backoff_ms=0.0), dict(shed_queue_depth=4), dict(watchdog_tick_ms=10.0),
    dict(watchdog_grace_ticks=5),
])
def test_serve_config_runs_fault_tolerance_fields(models, kw):
    """The fault-tolerance fields (ROADMAP item 6's first half) are accepted
    with JAX's values and reach the engine's scheduler."""
    _, _, tcfg, tp = models("tiny")
    t, j = ServeConfig(**kw), JServeConfig(**kw)
    for f in kw:
        assert getattr(t, f) == getattr(j, f) == kw[f]
    eng = InferenceEngineV2(tp, tcfg, device="cpu", num_blocks=8, serve=kw)
    for f, v in kw.items():
        assert getattr(eng.scheduler.serve, f) == v
    _close(eng)


def test_serve_config_defaults_and_engine_block(models):
    _, _, tcfg, tp = models("tiny")
    assert ServeConfig().decode_megastep == JServeConfig().decode_megastep == 1
    assert ServeConfig(decode_megastep=8, adaptation={"enabled": False}).decode_megastep == 8
    eng = InferenceEngineV2(tp, tcfg, device="cpu", num_blocks=8,
                            serve={"decode_megastep": 3, "fused_serving": True})
    assert eng.serve == ServeConfig(decode_megastep=3, fused_serving=True)
    assert InferenceEngineV2(tp, tcfg, device="cpu", num_blocks=8).serve == ServeConfig()
    with pytest.raises(ConfigError, match="unknown config key 'megastep'"):
        InferenceEngineV2(tp, tcfg, device="cpu", num_blocks=8, serve={"megastep": 2})


# ---------------------------------------------------------------------------
# the device-side decode KV write
# ---------------------------------------------------------------------------
WRITE_CASES = {
    # (block table rows, positions, active)
    "inactive_slots": ([[5, 2, -1], [7, 1, -1], [1, 3, 9], [4, 0, 6]],
                       [6, 2, 11, 9], [True, False, True, False]),
    "minus_one_pages": ([[5, -1, -1], [-1, -1, -1], [1, 3, 9], [4, 0, -1]],
                        [6, 2, 11, 9], [True, True, True, True]),
    # slots 1 and 3 stopped mid-burst: their pages stay reserved, their
    # positions point into them, and they must write nothing
    "stopped_mid_burst": ([[5, 2, 8], [7, 1, 10], [3, 9, 11], [4, 0, 6]],
                          [6, 5, 11, 9], [True, False, True, False]),
}


@pytest.mark.parametrize("case", sorted(WRITE_CASES))
def test_device_decode_write_matches_jax(case):
    nb, bs, hkv, hd = 12, 4, 2, 8
    table, positions, active = (np.asarray(a) for a in WRITE_CASES[case])
    table = table.astype(np.int32)
    positions = positions.astype(np.int32)
    b = len(positions)
    rng = np.random.default_rng(20)
    pool0 = rng.normal(size=(nb, bs, hkv, hd)).astype(np.float32)
    new = rng.normal(size=(b, hkv, hd)).astype(np.float32)
    want = np.asarray(jpaged.write_decode_kv(jnp.asarray(pool0), jnp.asarray(new),
                                             jnp.asarray(table), jnp.asarray(positions),
                                             jnp.asarray(active)))
    k, _ = tpaged.init_paged_cache(1, nb, bs, hkv, hd, dtype=torch.float32, device="cpu",
                                   max_seqs=b)
    pool = k[0]
    pool.copy_(torch.from_numpy(pool0))
    rows = tpaged.decode_rows(torch.from_numpy(table), torch.from_numpy(positions),
                              torch.from_numpy(active), bs, nb)
    tpaged.write_decode_rows(pool, torch.from_numpy(new), rows)
    np.testing.assert_array_equal(pool.numpy(), want)
    # every row outside the active slots' targets kept its bytes
    written = {int(r) for r in rows if r < nb * bs}
    flat0, flat = pool0.reshape(nb * bs, hkv, hd), pool.reshape(nb * bs, hkv, hd).numpy()
    kept = [r for r in range(nb * bs) if r not in written]
    np.testing.assert_array_equal(flat[kept], flat0[kept])
    dropped = ~active | (table[np.arange(b), np.minimum(positions // bs, 2)] < 0)
    assert len(written) == int((~dropped).sum())
    assert sorted(int(r) for r in rows if r >= nb * bs) == \
        [nb * bs + i for i in np.nonzero(dropped)[0]]  # one drop row per dropped slot


def test_device_decode_write_refuses_a_pool_without_spare_rows():
    pool = torch.zeros(4, 2, 1, 4)
    rows = tpaged.decode_rows(torch.tensor([[0, 1]], dtype=torch.int32),
                              torch.tensor([0], dtype=torch.int32), torch.tensor([False]), 2, 4)
    with pytest.raises(ValueError, match="spare rows"):
        tpaged.write_decode_rows(pool, torch.zeros(1, 1, 4), rows)


# ---------------------------------------------------------------------------
# copy-on-write between bursts
# ---------------------------------------------------------------------------
def test_burst_after_copy_on_write_reads_the_clone(models):
    """A page shared when a burst starts is cloned in place in the same pool
    tensors (``cow_hook``) before the first tick; the burst writes and reads
    the clone: tokens equal an engine that never shared the page."""
    _, _, tcfg, tp = models("tiny")
    prompt = list(range(3, 14))  # 11 tokens: the 12th lands in page 1 (bs 8)
    kw = dict(STEP_KW, block_size=8)

    def run(share):
        eng = InferenceEngineV2(tp, tcfg, device="cpu", **kw)
        eng.put([1], [prompt])
        eng.step_n(2)  # the first burst (a graph captured on CUDA)
        seq = eng.mgr.seqs[1]
        page = seq.blocks[(seq.cur_len - 1) // 8]
        if share:
            eng.mgr.allocator.ref(page)  # another owner: the next write must clone
        eng.step_n(6)
        clones = eng.mgr.cow_copies
        if share:
            assert page not in seq.blocks
            eng.mgr.allocator.free([page])
        toks = list(seq.tokens)
        _close(eng)
        return toks, clones

    (shared, clones), (plain, none) = run(True), run(False)
    assert shared == plain and clones == 1 and none == 0

"""The port's serve front end (``deepspeed_tpu_torch/serving``) against the
JAX package's on the CPU, fp32, on ``tiny`` with the ``SEC`` of
``tests/test_serving_router.py``, weights from JAX
``init_params(PRNGKey(0))`` through ``params_from_numpy``.

- ``build_router``: routed tokens AND ``router.stats`` equal JAX's, with
  affinity on and off; the tokens equal a single engine's; every close
  audit is zero; the workers share the weight tensors;
- the paged-KV handoff: ``none`` tokens equal the unmigrated stream and JAX's
  routed run, wire bytes equal JAX's; ``int8`` tokens equal JAX's int8
  routed run (the wire is lossy: the unmigrated stream is not the
  reference); the payload codec's bytes and scales equal JAX's (int8 and
  fp8, fp32 and bf16 pages); the exact wire publishes the prefix on the
  target, the lossy one never; extract / inject round-trip in place;
- worker-kill replay and the replay budget equal JAX's; the front-door
  shed, the sampling-conflict re-route and ``adopt_prefilled`` validation;
- ``apply_knobs`` fans out to every live worker, isolating refusals;
- the configs' checks say what JAX's say; ``build_serve_engine`` builds the
  one-card seq grid and refuses tensor-parallel / replicated engines;
- a kernel or CUDA error in a worker's tick raises through
  ``Router.tick``: no FAILED request, no retry, no worker death.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.comm import qcomm as jqcomm
from deepspeed_tpu.config.config import ConfigError as JConfigError
from deepspeed_tpu.config.config import RouterConfig as JRouterConfig
from deepspeed_tpu.config.config import ServeEngineConfig as JServeEngineConfig
from deepspeed_tpu.inference.engine_v2 import build_serve_engine as j_build_engine
from deepspeed_tpu.inference.faults import FaultInjector as JInjector
from deepspeed_tpu.inference.sampling import SamplingParams as JSampling
from deepspeed_tpu.models.presets import get_preset as j_preset
from deepspeed_tpu.models.transformer import init_params as j_init
from deepspeed_tpu.serving import build_router as j_build_router
from deepspeed_tpu_torch.comm import qcomm
from deepspeed_tpu_torch.config.config import ConfigError, RouterConfig, ServeEngineConfig
from deepspeed_tpu_torch.inference import scheduler as S
from deepspeed_tpu_torch.inference.engine_v2 import build_serve_engine
from deepspeed_tpu_torch.inference.faults import FaultInjector
from deepspeed_tpu_torch.inference.sampling import SamplingParams
from deepspeed_tpu_torch.models.presets import get_preset
from deepspeed_tpu_torch.models.transformer import params_from_numpy
from deepspeed_tpu_torch.ops.kernels import KernelError
from deepspeed_tpu_torch.serving import build_router, extract_request
from torch_threads import one_torch_thread  # noqa: F401  (one intra-op thread)

SEC = dict(max_seqs=4, num_blocks=96, block_size=8, prefill_buckets=[16, 32, 64, 128],
           max_seq_len=256, enable_prefix_caching=True)


@pytest.fixture(scope="module")
def tiny():
    jcfg = j_preset("tiny", max_seq_len=256, dtype=jnp.float32)
    tcfg = get_preset("tiny", max_seq_len=256, dtype=torch.float32)
    jp = j_init(jax.random.PRNGKey(0), cfg=jcfg, dtype=jnp.float32)
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), tcfg, device="cpu")
    return jcfg, jp, tcfg, tp


def _routers(tiny, **kw):
    """A JAX router and a port router built alike (``faults`` /
    ``engine_faults``: a function of the injector class)."""
    jcfg, jp, tcfg, tp = tiny
    out = {}
    for pkg, build, Inj in (("jax", j_build_router, JInjector),
                            ("port", build_router, FaultInjector)):
        k = {n: (v(Inj) if callable(v) else v) for n, v in kw.items()}
        if pkg == "jax":
            out[pkg] = build(jp, jcfg, SEC, **k)
        else:
            out[pkg] = build(tp, tcfg, SEC, device="cpu", **k)
    return out


def _samp(pkg, **kw):
    return (JSampling if pkg == "jax" else SamplingParams)(temperature=0.0, **kw)


def _workload(vocab, n_req=16, seed=0):
    rng = np.random.default_rng(seed)
    sys_prompt = rng.integers(1, vocab, 24).tolist()
    out = {}
    for u in range(1, n_req + 1):
        sfx = rng.integers(1, vocab, 8).tolist()
        out[u] = (sys_prompt + sfx if u % 2 else rng.integers(1, vocab, 24).tolist() + sfx)
    return out


def _reference(tiny, prompts, max_new):
    _, _, tcfg, tp = tiny
    eng = build_serve_engine(tp, tcfg, SEC, device="cpu")
    sched = eng.scheduler
    for u, p in prompts.items():
        assert sched.try_submit(u, p, SamplingParams(temperature=0.0,
                                                     max_new_tokens=max_new)).accepted
    sched.run()
    want = {u: sched.pop_result(u) for u in prompts}
    assert eng.close()["blocks_in_use"] == 0
    return want


def _close(router):
    audits = router.close()
    assert all(a["blocks_in_use"] == 0 for a in audits), audits
    return audits


# ---------------------------------------------------------------------------
# routing
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("affinity", [True, False])
def test_router_storm_equals_jax(tiny, affinity):
    prompts = _workload(tiny[2].vocab_size)
    want = _reference(tiny, prompts, 6)
    res = {}
    for pkg, router in _routers(tiny, router=dict(n_workers=2, affinity=affinity)).items():
        samp = _samp(pkg, max_new_tokens=6)
        uids = list(prompts)
        for i in range(0, len(uids), 4):  # arrival-interleaved submission
            for u in uids[i:i + 4]:
                assert router.try_submit(u, prompts[u], samp).accepted
            router.tick()
        out = router.run()
        res[pkg] = (out, dict(router.stats), router.prefix_hit_rate(),
                    [w.engine.mgr.prompt_tokens_total for w in router.pool.workers],
                    [w.ns for w in router.pool.workers])
        _close(router)
    assert res["port"] == res["jax"]
    out, stats, hit, totals, namespaces = res["port"]
    assert all(out[u] == ("finished", want[u]) for u in prompts)
    assert (stats["routed_affinity"] > 0) == affinity and all(t > 0 for t in totals)
    assert namespaces == ["serve", "serve2"] and (hit > 0 or not affinity)


def test_workers_share_the_weights(tiny):
    _, _, tcfg, tp = tiny
    router = build_router(tp, tcfg, SEC, router=dict(n_workers=3), device="cpu")
    def leaves(tree):
        if isinstance(tree, dict):
            return [x for k in sorted(tree) for x in leaves(tree[k])]
        return [tree]

    engines = [w.engine for w in router.pool.workers]
    want = [t.data_ptr() for t in leaves(tp)]
    for eng in engines:
        assert [t.data_ptr() for t in leaves(eng.params)] == want
    ptrs = {eng.kv[0][0].data_ptr() for eng in engines}
    assert len(ptrs) == 3  # each worker its own pool
    _close(router)


# ---------------------------------------------------------------------------
# the paged-KV handoff
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("fmt", ["none", "int8", "fp8"])
def test_kv_handoff_equals_jax(tiny, fmt):
    jcfg, jp, tcfg, tp = tiny
    rng = np.random.default_rng(3)
    long_prompt = rng.integers(1, tcfg.vocab_size, 48).tolist()
    short = rng.integers(1, tcfg.vocab_size, 8).tolist()
    ref = build_serve_engine(tp, tcfg, SEC, device="cpu")
    want_long = ref.generate(long_prompt, SamplingParams(temperature=0.0, max_new_tokens=8))
    ref.close()
    res = {}
    for pkg, router in _routers(tiny, router=dict(n_workers=3, prefill_workers=1,
                                                  disagg_threshold=32,
                                                  handoff_fmt=fmt)).items():
        samp = _samp(pkg, max_new_tokens=8)
        router.submit(1, long_prompt, samp)
        router.submit(2, short, samp)
        out = router.run()
        ws = router.pool.workers
        res[pkg] = (out, dict(router.stats), dict(ws[0].scheduler.stats)["migrated"],
                    [dict(w.scheduler.stats)["adopted"] for w in ws[1:]])
        _close(router)
    assert res["port"] == res["jax"]  # tokens, stats, wire bytes: JAX's routed run
    out, stats, migrated, adopted = res["port"]
    assert stats["routed_prefill"] == stats["handoffs"] == migrated == sum(adopted) == 1
    els = 2 * tcfg.num_layers * 6 * 8 * tcfg.num_kv_heads * tcfg.hd
    if fmt == "none":
        assert stats["handoff_wire_bytes"] == els * 4
        assert out[1] == ("finished", want_long)  # exact wire: the unmigrated stream
    else:
        assert els <= stats["handoff_wire_bytes"] < 1.5 * els
        assert out[1][0] == "finished"


@pytest.mark.parametrize("fmt", ["int8", "fp8"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n", [256, 1000, 24576])
def test_payload_codec_bytes_equal_jax(fmt, dtype, n):
    import ml_dtypes  # the JAX side's fp8 / bf16 host types

    rng = np.random.default_rng(n)
    x = rng.standard_normal(n).astype(np.float32) * rng.uniform(1e-3, 50.0, n).astype(np.float32)
    x[: n // 7] = 0.0  # zero chunks: the 1e-12 amax floor
    t = torch.from_numpy(x).to(getattr(torch, dtype))
    host = t.float().numpy()
    if dtype == "bfloat16":
        host = host.astype(ml_dtypes.bfloat16)
    jq, js = jqcomm.quantize_payload(host, fmt)
    tq, ts = qcomm.quantize_payload(t, fmt)
    assert tq.dtype == (torch.int8 if fmt == "int8" else torch.uint8)
    assert np.array_equal(tq.numpy(), jq) and np.array_equal(ts.numpy(), js)
    back = qcomm.dequantize_payload(tq, ts, (n,), torch.float32, fmt)
    assert np.array_equal(back.numpy(), jqcomm.dequantize_payload(jq, js, (n,), np.float32, fmt))
    assert qcomm.payload_wire_bytes(n, fmt) == jqcomm.payload_wire_bytes(n, fmt)
    with pytest.raises(qcomm.QCommError):
        qcomm.quantize_payload(t, "int4")


def test_handoff_publishes_prefix_on_target(tiny):
    rng = np.random.default_rng(4)
    long_prompt = rng.integers(1, tiny[2].vocab_size, 48).tolist()
    res = {}
    for pkg, router in _routers(tiny, router=dict(n_workers=2, prefill_workers=1,
                                                  disagg_threshold=32)).items():
        samp = _samp(pkg, max_new_tokens=4)
        router.submit(1, long_prompt, samp)
        router.run(wait_for=[1])
        tgt = router.pool.workers[1]
        before = tgt.engine.mgr.cached_prompt_tokens
        router.submit(2, long_prompt[:24], samp)
        router.run(wait_for=[2])
        res[pkg] = (dict(router.stats), before, tgt.engine.mgr.cached_prompt_tokens,
                    router.pop_result(1), router.pop_result(2))
        _close(router)
    assert res["port"] == res["jax"]
    stats, before, after, _, _ = res["port"]
    assert stats["handoffs"] == stats["routed_affinity"] == 1 and after > before


def test_quantized_handoff_pages_stay_out_of_prefix_cache(tiny):
    rng = np.random.default_rng(6)
    long_prompt = rng.integers(1, tiny[2].vocab_size, 48).tolist()
    res = {}
    for pkg, router in _routers(tiny, router=dict(n_workers=2, prefill_workers=1,
                                                  disagg_threshold=32,
                                                  handoff_fmt="int8")).items():
        samp = _samp(pkg, max_new_tokens=4)
        router.submit(1, long_prompt, samp)
        router.run(wait_for=[1])
        tgt = router.pool.workers[1]
        regs = tgt.engine.mgr.allocator.registrations
        router.submit(2, long_prompt[:24], samp)
        router.run(wait_for=[2])
        res[pkg] = (dict(router.stats), regs, tgt.engine.mgr.cached_prompt_tokens)
        _close(router)
    assert res["port"] == res["jax"]
    stats, regs, cached = res["port"]
    assert stats["handoffs"] == 1 and regs == 0 and stats["routed_affinity"] == 0
    assert cached == 0


def test_extract_inject_round_trip_in_place(tiny):
    _, _, tcfg, tp = tiny
    src = build_serve_engine(tp, tcfg, SEC, device="cpu")
    dst = build_serve_engine(tp, tcfg, SEC, device="cpu")
    src.put([1], [list(range(1, 30))], SamplingParams(temperature=0.0))
    blocks = src.mgr.seqs[1].blocks[:4]
    pages = src.extract_kv_blocks(blocks)
    assert len(pages[0]) == len(pages[1]) == tcfg.num_layers
    assert pages[0][0].shape == (4, 8, tcfg.num_kv_heads, tcfg.hd)
    ptrs = [p.data_ptr() for p in (*dst.kv[0], *dst.kv[1])]
    dst.inject_kv_blocks([10, 3, 50, 7], pages)
    assert [p.data_ptr() for p in (*dst.kv[0], *dst.kv[1])] == ptrs  # written in place
    for a, b in zip((*src.kv[0], *src.kv[1]), (*dst.kv[0], *dst.kv[1])):
        assert torch.equal(b[[10, 3, 50, 7]], a[blocks])
    ho = extract_request(src, 1, fmt="none")
    assert ho.n_ctx == 29 and ho.n_pages == 4 and len(ho.payloads) == 2 * tcfg.num_layers
    with pytest.raises(ValueError, match="pool leaves"):
        dst.inject_kv_blocks([1], (pages[0], ()))
    src.close()
    dst.close()


# ---------------------------------------------------------------------------
# worker death, backpressure, adoption
# ---------------------------------------------------------------------------
def test_worker_kill_reroutes_and_replays_like_jax(tiny):
    prompts = _workload(tiny[2].vocab_size, n_req=8, seed=5)
    want = _reference(tiny, prompts, 8)
    res = {}
    for pkg, router in _routers(tiny, router=dict(n_workers=2), faults=lambda I: I(
            seed=0).arm("worker_kill", uids=[0], after=3, times=1)).items():
        samp = _samp(pkg, max_new_tokens=8)
        for u, p in prompts.items():
            assert router.try_submit(u, p, samp).accepted
        out = router.run()
        res[pkg] = (out, dict(router.stats), [w.alive for w in router.pool.workers],
                    router.faults.log)
        _close(router)
    assert res["port"] == res["jax"]
    out, stats, alive, _ = res["port"]
    assert stats["worker_deaths"] == 1 and stats["replays"] > 0 and alive == [False, True]
    assert all(out[u] == ("finished", want[u]) for u in prompts)


def test_replay_budget_exhaustion_fails_typed(tiny):
    res = {}
    for pkg, router in _routers(tiny, router=dict(n_workers=2, max_replays=0),
                                faults=lambda I: I(seed=0)
                                .arm("worker_kill", uids=[0], after=1, times=1)
                                .arm("worker_kill", uids=[1], after=1, times=1)).items():
        assert router.try_submit(1, [3, 1, 4, 1, 5], _samp(pkg, max_new_tokens=4)).accepted
        for _ in range(4):
            router.tick()
        res[pkg] = (router.pop_result(1), dict(router.stats),
                    router.try_submit(2, [1, 2], _samp(pkg, max_new_tokens=4)).reason)
        router.close()
    assert res["port"] == res["jax"]
    assert res["port"][0] == ("failed", []) and res["port"][2] == S.RETRY_LATER


def test_router_front_door_shed_like_jax(tiny):
    res = {}
    for pkg, router in _routers(tiny, router=dict(n_workers=1, shed_queue_depth=2),
                                serve=dict(shed_queue_depth=1)).items():
        samp = _samp(pkg, max_new_tokens=4)
        for uid in range(1, 7):
            assert router.try_submit(uid, [5] * 40, samp).accepted
        router.tick()
        seen = [router.pool.workers[0].shedding]
        for uid in range(7, 12):
            r = router.try_submit(uid, [5] * 40, samp)
            seen.append((r.reason, r.retry_after_ms is not None and r.retry_after_ms > 0))
        out = router.run()
        # worker_retry_later follows the worker's backoff hint, a multiple
        # of its measured tick time: wall-clock, not compared
        res[pkg] = (seen, out, {k: v for k, v in router.stats.items()
                                if k != "worker_retry_later"})
        router.close()
    assert res["port"] == res["jax"]
    seen, _, stats = res["port"]
    assert seen[0] and (S.RETRY_LATER, True) in seen[1:] and stats["shed_rejections"] >= 1


def test_sampling_conflict_reroutes_not_rejects(tiny):
    res = {}
    for pkg, router in _routers(tiny, router=dict(n_workers=2)).items():
        Samp = JSampling if pkg == "jax" else SamplingParams
        assert router.try_submit(1, [9] * 24 + [1, 2], Samp(temperature=0.7, top_k=5,
                                                             max_new_tokens=16)).accepted
        router.tick()
        r = router.try_submit(2, [9] * 24 + [3, 4], Samp(temperature=0.0, max_new_tokens=4))
        out = router.run()
        res[pkg] = (r.accepted, out[1][0], out[2], dict(router.stats)["rejected"])
        router.close()
    assert res["port"][0] and res["port"][3] == 0 and res["port"][1] == "finished"
    assert res["port"][2] == res["jax"][2]  # the greedy request's tokens


def test_adopt_prefilled_validation_like_jax(tiny):
    jcfg, jp, tcfg, tp = tiny
    res = {}
    for pkg, eng in (("jax", j_build_engine(jp, jcfg, SEC)),
                     ("port", build_serve_engine(tp, tcfg, SEC, device="cpu"))):
        sched = eng.scheduler
        samp = _samp(pkg, max_new_tokens=4)
        pt = (eng.mgr.prompt_tokens_total, eng.mgr.cached_prompt_tokens)
        seen = [sched.adopt_prefilled(1, [5] * 17, n_ctx=16, sampling=samp).reason,
                (eng.mgr.prompt_tokens_total, eng.mgr.cached_prompt_tokens) == pt,
                eng.mgr.seqs[1].seen_tokens, len(eng.mgr.seqs[1].blocks),
                sched.requests[1].state, list(sched.requests[1].generated),
                sched.adopt_prefilled(1, [5] * 17, 16, samp).reason,
                sched.adopt_prefilled(2, [5] * 17, 17, samp).reason]
        # a detach releases MIGRATED through the single release path
        sched.adopt_prefilled(3, [6] * 9, 8, samp)
        seen += [sched.detach(3), sched.requests[3].state, sched.detach(3)]
        sched.run(wait_for=[1])
        seen += [sched.requests[1].state, sched.pop_result(1), eng.close()]
        res[pkg] = seen
    assert res["port"] == res["jax"]
    assert res["port"][:6] == [S.QUEUED, True, 16, 3, S.DECODE, [5]]


def test_apply_knobs_fans_out_to_live_workers(tiny):
    _, _, tcfg, tp = tiny
    router = build_router(tp, tcfg, SEC, router=dict(n_workers=3), device="cpu",
                          faults=FaultInjector(seed=0).arm("worker_kill", uids=[2], times=1))
    router.tick()  # worker 2 dies
    out = router.apply_knobs({"prefill_chunk": 16, "shed_queue_depth": 5})
    assert sorted(out) == [0, 1] and out[0] == {"prefill_chunk": 16, "shed_queue_depth": 5}
    bad = router.apply_knobs({"bogus": 1})
    assert all(v.startswith("ValueError: unknown live knobs") for v in bad.values())
    router.tick()
    assert all(w.scheduler.knobs()["prefill_chunk"] == 16 for w in router.pool.alive)
    _close(router)


# ---------------------------------------------------------------------------
# configs and build_serve_engine
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("kw", [
    dict(n_workers=0), dict(n_workers=2, prefill_workers=2), dict(handoff_fmt="int4"),
    dict(disagg_threshold=0), dict(affinity_max_keys=0), dict(shed_queue_depth=0),
    dict(max_replays=-1), dict(retry_backoff_ms=-1.0), dict(heartbeat_interval_ms=0),
    dict(lease_ms=10.0), dict(rpc_max_attempts=0), dict(rpc_backoff_ms=300.0),
    dict(max_frame_bytes=100), dict(decode_megastep=0), dict(metrics_pull_interval_ms=0),
    dict(slo_objective=1.0), dict(slo_fast_window_s=0), dict(slo_slow_window_s=1.0),
])
def test_router_config_checks_say_what_jax_says(kw):
    with pytest.raises(JConfigError) as jerr:
        JRouterConfig(**kw)
    with pytest.raises(ConfigError) as terr:
        RouterConfig(**kw)
    assert str(terr.value) == str(jerr.value)


@pytest.mark.parametrize("kw", [
    dict(max_seqs=0), dict(kv_watermark=1.0), dict(quantize_weights="int4"),
    dict(quant_comm="int4"), dict(prefill_buckets=[]), dict(prefill_chunk=0),
])
def test_serve_engine_config_checks_say_what_jax_says(kw):
    with pytest.raises(JConfigError) as jerr:
        JServeEngineConfig(**kw)
    with pytest.raises(ConfigError) as terr:
        ServeEngineConfig(**kw)
    assert str(terr.value) == str(jerr.value)


def test_serve_engine_config_defaults_and_refusals(tiny):
    _, _, tcfg, tp = tiny
    t, j = ServeEngineConfig(), JServeEngineConfig()
    for f in t.__dataclass_fields__:
        assert getattr(t, f) == getattr(j, f), f
    kw = ServeEngineConfig(quantize_weights="int8", prefill_chunk=16).engine_kwargs()
    assert kw["quantize_weights"] == "int8" and kw["prefill_chunk"] == 16
    with pytest.raises(NotImplementedError, match="item 7"):
        ServeEngineConfig(serve_replicas=2)
    # tensor-parallel serving runs over a process world's model axis
    # (tests/test_torch_tp.py); its fields reach the engine
    kw = ServeEngineConfig(tp=2, quant_comm="int8", comm_tiles=2).engine_kwargs()
    assert (kw["quant_comm"], kw["comm_tiles"]) == ("int8", 2)
    eng = build_serve_engine(tp, tcfg, dict(SEC, seq_shards=2), device="cpu")
    assert eng.seq_shards == 2 and eng.mgr.allocator.stripes == 2
    assert eng.generate([1, 2, 3, 4, 5], SamplingParams(temperature=0.0, max_new_tokens=3))
    eng.close()


def test_parse_config_takes_the_serving_sections():
    from deepspeed_tpu_torch.config.config import parse_config

    cfg = parse_config({"serve": {"deadline_ms": 100.0, "shed_queue_depth": 4},
                        "serve_engine": {"max_seqs": 4, "enable_prefix_caching": True},
                        "router": {"n_workers": 3, "prefill_workers": 1}})
    assert cfg.serve.deadline_ms == 100.0 and cfg.serve_engine.max_seqs == 4
    assert cfg.router.prefill_workers == 1
    # the autotuner's section parses as JAX's does; a top-level
    # 'adaptation' is an unknown key in both (it lives under 'serve')
    from deepspeed_tpu.config.config import parse_config as j_parse_config

    got = parse_config({"autotune": {"enabled": True, "top_k": 4}}).autotune
    want = j_parse_config({"autotune": {"enabled": True, "top_k": 4}}).autotune
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    with pytest.raises(JConfigError) as jerr:
        j_parse_config({"adaptation": {"enabled": True}})
    with pytest.raises(ConfigError) as terr:
        parse_config({"adaptation": {"enabled": True}})
    assert str(terr.value) == str(jerr.value)
    with pytest.raises(ConfigError, match="unknown config key 'n_worker'"):
        parse_config({"router": {"n_worker": 2}})


# ---------------------------------------------------------------------------
# kernel and CUDA errors surface through the router
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("err", [
    KernelError("CUDA kernel paged_decode failed to launch: cudaError 700"),
    RuntimeError("CUDA error: an illegal memory access was encountered"),
])
def test_kernel_errors_raise_through_router_tick(tiny, monkeypatch, err):
    from deepspeed_tpu_torch.ops.kernels import paged_attention as PA

    _, _, tcfg, tp = tiny
    router = build_router(tp, tcfg, SEC, router=dict(n_workers=2), device="cpu",
                          serve=dict(max_retries=3, retry_backoff_ms=0.0))
    prompts = _workload(tcfg.vocab_size, n_req=4)
    for u, p in prompts.items():
        assert router.try_submit(u, p, SamplingParams(temperature=0.0,
                                                      max_new_tokens=6)).accepted
    router.tick()  # prefills land fault-free
    victim = router.pool.workers[1].engine.kv[0][0]
    real = PA.paged_attention_decode_plain

    def boom(q, cache_k, *a, **k):
        if cache_k.data_ptr() == victim.data_ptr():  # worker 1's decode only
            raise err
        return real(q, cache_k, *a, **k)

    monkeypatch.setattr(PA, "paged_attention_decode_plain", boom)
    with pytest.raises(type(err), match=str(err)[:20]):
        router.tick()
    assert all(w.alive for w in router.pool.workers)  # not a worker death
    for w in router.pool.workers:
        assert w.engine.stats["failed"] == w.engine.stats["retries"] == 0
        assert not w.scheduler.quarantined
    assert dict(router.stats)["worker_deaths"] == dict(router.stats)["failed"] == 0
    monkeypatch.undo()
    router.close()

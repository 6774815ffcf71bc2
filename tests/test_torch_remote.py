"""The port's subprocess workers (``deepspeed_tpu_torch/serving/remote.py``)
and stdio worker (``serving/pool.py serve_worker_main``) on the CPU.

- two tests spawn real children, each under its own ``wait_ready`` and
  ``reap`` limits: a CPU pool of 2 (telemetry on) whose first request's
  tokens equal the in-process port engine's and JAX's on the same weights,
  a fleet collector pulling both over their metrics channels with clock
  offsets, 0-block close audits, idempotent kill and reap; and a child
  asked for CUDA on a machine without a card, which raises (its stderr
  reaches ``wait_ready``) and never comes up on the CPU;
- the stdio hardening contract of ``tests/test_transport.py``'s stdio
  cases, through ``serve_worker_main`` on an in-memory duplex in a thread;
- the child entry's refusals (CUDA without a card, a multi-process
  bootstrap), the argv, and ``RouterConfig``'s transport checks against
  JAX's.
"""
import io
import json
import struct
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.config.config import ConfigError as JConfigError
from deepspeed_tpu.config.config import RouterConfig as JRouterConfig
from deepspeed_tpu.inference.engine_v2 import build_serve_engine as j_build_engine
from deepspeed_tpu.inference.sampling import SamplingParams as JSampling
from deepspeed_tpu.models.presets import get_preset as j_preset
from deepspeed_tpu_torch.config.config import ConfigError, RouterConfig
from deepspeed_tpu_torch.inference.engine_v2 import build_serve_engine
from deepspeed_tpu_torch.inference.sampling import SamplingParams
from deepspeed_tpu_torch.models.presets import get_preset
from deepspeed_tpu_torch.models.transformer import init_params
from deepspeed_tpu_torch.serving import remote, transport as T
from deepspeed_tpu_torch.serving.pool import serve_worker_main
from deepspeed_tpu_torch.telemetry import attach_fleet_collector

SEC = dict(max_seqs=4, num_blocks=96, block_size=8, prefill_buckets=[16, 32, 64, 128],
           max_seq_len=256, enable_prefix_caching=True)
SPEC = {"preset": "tiny", "seed": 0, "dtype": "float32", "max_seq_len": 256, "sec": SEC,
        "device": "cpu"}
SPAWN_S = 30.0  # each spawn test's wait_ready and reap limits
PROMPT = [3, 14, 15, 92, 65, 35, 89, 79]


def _to_jax(x):
    if isinstance(x, dict):
        return {k: _to_jax(v) for k, v in x.items()}
    return jnp.asarray(x.numpy())


# ---------------------------------------------------------------------------
# real children
# ---------------------------------------------------------------------------
def test_cpu_children_serve_pull_metrics_and_reap():
    """A pool of 2 CPU children (the spec's weights: port ``init_params``
    from seed 0): the routed tokens equal an in-process port engine's and
    JAX's engine's on the same weights; the fleet collector pulls both
    children over their metrics channels (merged TTFT count = requests,
    a clock offset with its error bound per worker); close audits show 0
    blocks; kill and reap are idempotent."""
    cfg = get_preset("tiny", max_seq_len=256, dtype=torch.float32)
    params = init_params(cfg, seed=0, device="cpu")
    samp = SamplingParams(temperature=0.0, max_new_tokens=6)
    ref = build_serve_engine(params, cfg, SEC, device="cpu")
    want = ref.generate(PROMPT, samp)
    ref.close()
    jeng = j_build_engine(_to_jax(params), j_preset("tiny", max_seq_len=256, dtype=jnp.float32),
                          SEC)
    assert jeng.generate(PROMPT, JSampling(temperature=0.0, max_new_tokens=6)) == want
    jeng.close()

    # one intra-op thread a child (the test may share its cores with other
    # test processes) and a lease no scheduling stall on a loaded box reaches
    pool = remote.RemotePool({**SPEC, "telemetry": True}, n_workers=2,
                             config=RouterConfig(n_workers=2, heartbeat_interval_ms=40.0,
                                                 lease_ms=10_000.0),
                             env={"OMP_NUM_THREADS": "1"}, ready_timeout_s=SPAWN_S)
    from deepspeed_tpu_torch.serving.router import Router

    router = Router(pool, pool.config)
    try:
        handles = [w.handle for w in pool.workers]
        assert all(h.proc.poll() is None and h.pid == h.proc.pid for h in handles)
        prompts = {1: PROMPT, 2: PROMPT[::-1], 3: PROMPT[2:], 4: PROMPT + [7]}
        for u, p in prompts.items():
            assert router.try_submit(u, p, samp).accepted
        out = router.run(max_ticks=2000)
        assert out[1] == ("finished", want)
        assert all(s == "finished" and len(t) == 6 for s, t in out.values())
        coll = attach_fleet_collector(router, start=False)
        assert coll.pull_once() == 2
        h = coll.fleet.merged_histogram("ttft_ms")
        assert h is not None and h.count == len(prompts)
        deadline = time.monotonic() + SPAWN_S  # at least one timestamped ack each
        while any(w.monitor.clock_offset(w.index) is None for w in pool.workers):
            assert time.monotonic() < deadline, "no heartbeat ack carried a clock reading"
            time.sleep(0.02)
        offsets = [w.monitor.clock_offset(w.index) for w in pool.workers]
        assert all(o[1] >= 0.0 for o in offsets)
        stats = [w.stats() for w in pool.workers]
        assert sum(s["sched"]["finished"] for s in stats) == len(prompts)
        assert all(s["memory_allocated"] is None and s["launches"]["paged_decode"] == 0
                   for s in stats)
        audits = router.close()
        assert audits and all(a is not None and a["blocks_in_use"] == 0 for a in audits)
        assert all(h.proc.poll() is not None for h in handles)
        for w in pool.workers:  # idempotent teardown after close
            w.kill()
            assert w.close() == w.close_audit
        assert all(h.reap(timeout_s=SPAWN_S) == h.proc.returncode for h in handles)
    finally:
        for w in pool.workers:
            w.kill()


def test_cuda_child_without_a_card_raises_at_wait_ready():
    """A child asked for ``device="cuda"`` on a machine with no card raises
    through ``resolve_device``; the parent's ``wait_ready`` reports its
    stderr — it never comes up quietly on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device: the child would come up on it")
    sw = remote.spawn_worker({**SPEC, "device": "cuda"}, env={"OMP_NUM_THREADS": "1"},
                             wait_ready=False)
    try:
        with pytest.raises(RuntimeError, match="died before ready") as ei:
            sw.wait_ready(SPAWN_S)
        assert "CUDA is not available" in str(ei.value)
    finally:
        rc = sw.reap(timeout_s=SPAWN_S)
    assert rc not in (None, 0) and sw.reap(timeout_s=SPAWN_S) == rc


# ---------------------------------------------------------------------------
# the child entry, in this process
# ---------------------------------------------------------------------------
def test_worker_main_refusals(monkeypatch):
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            remote._worker_main({**SPEC, "device": "cuda"})
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            serve_worker_main(stdin=io.BytesIO(), stdout=io.BytesIO(), params={},
                              cfg=None, sec=SEC, device="cuda")
    monkeypatch.setenv("DSTPU_NUM_PROCESSES", "2")
    for fn in (lambda: remote._worker_main(SPEC),
               lambda: serve_worker_main(stdin=io.BytesIO(), stdout=io.BytesIO())):
        with pytest.raises(NotImplementedError, match="item 7"):
            fn()


def test_worker_launch_cmd_and_transport_config_checks():
    argv = remote.worker_launch_cmd({"preset": "tiny", "seed": 0}, python="python3")
    assert argv[:3] == ["python3", "-m", "deepspeed_tpu_torch.serving.remote"]
    assert json.loads(argv[4]) == {"preset": "tiny", "seed": 0}
    for kw in (dict(lease_ms=10.0, heartbeat_interval_ms=20.0), dict(rpc_max_attempts=0),
               dict(rpc_backoff_ms=50.0, rpc_backoff_max_ms=10.0), dict(max_frame_bytes=16),
               dict(rpc_deadline_ms=0.0)):
        with pytest.raises(JConfigError) as jerr:
            JRouterConfig(**kw)
        with pytest.raises(ConfigError) as terr:
            RouterConfig(**kw)
        assert str(terr.value) == str(jerr.value)
    RouterConfig(heartbeat_interval_ms=25.0, lease_ms=250.0)


# ---------------------------------------------------------------------------
# stdio worker hardening (serve_worker_main over an in-memory duplex)
# ---------------------------------------------------------------------------
class _Duplex:
    """In-memory rfile / wfile pair for the stdio server."""

    def __init__(self, inbound: bytes):
        self._in = io.BytesIO(inbound)
        self.out = bytearray()

    def read(self, n):
        return self._in.read(n)

    def write(self, data):
        self.out.extend(data)
        return len(data)

    def flush(self):
        pass


def _frames(out: bytes):
    frames, off = [], 0
    while off + T.HEADER_BYTES <= len(out):
        _m, _v, ftype, _f, rid, length, _crc = struct.unpack(
            "!4sBBHQII", out[off:off + T.HEADER_BYTES])
        payload = out[off + T.HEADER_BYTES: off + T.HEADER_BYTES + length]
        frames.append(T.Frame(ftype, rid, bytes(payload)))
        off += T.HEADER_BYTES + length
    return frames


def _hello():
    return T.pack_frame(T.FT_HELLO, 0, b'{"version": %d, "channel": "rpc"}' % T.PROTO_VERSION)


def _serve(inbound: bytes, engines: list):
    """``serve_worker_main`` on a duplex, in a thread (it returns after the
    stream's clean shutdown); the engine it built is captured to check its
    close audit."""
    cfg = get_preset("tiny", max_seq_len=256, dtype=torch.float32)
    params = init_params(cfg, seed=0, device="cpu")
    duplex = _Duplex(inbound)
    real = T.WorkerServer.__init__

    def init(self, engine, *a, **k):
        engines.append(engine)
        real(self, engine, *a, **k)

    T.WorkerServer.__init__ = init
    try:
        t = threading.Thread(target=serve_worker_main, kwargs=dict(
            stdin=duplex, stdout=duplex, params=params, cfg=cfg, sec=SEC, device="cpu"))
        t.start()
        t.join(timeout=60.0)
        assert not t.is_alive(), "the stdio worker did not shut down"
    finally:
        T.WorkerServer.__init__ = real
    return _frames(bytes(duplex.out))


def _closed(engines):
    eng = engines[0]
    return eng.mgr.allocator.total_blocks - eng.mgr.allocator.available_blocks == 0


@pytest.mark.parametrize("case", ["junk", "torn", "version"])
def test_stdio_bad_traffic_typed_error_and_clean_shutdown(case):
    engines = []
    inbound = {
        "junk": _hello() + b"GARBAGE-NOT-A-FRAME-AT-ALL-########",
        "torn": _hello() + T.pack_frame(T.FT_REQUEST, 1, b'{"op":"tick"}')[:10],
        "version": T.pack_frame(T.FT_HELLO, 0, b'{"version": 42}'),
    }[case]
    frames = _serve(inbound, engines)
    kind = {"junk": "protocol_error", "torn": "connection_lost",
            "version": "version_mismatch"}[case]
    if case != "version":
        assert frames[0].ftype == T.FT_HELLO_ACK
    errors = [f.json()["kind"] for f in frames if f.ftype == T.FT_ERROR]
    assert errors and errors[0] == kind and frames[-1].ftype == T.FT_ERROR
    assert _closed(engines) and engines[0]._closed


def test_stdio_full_request_cycle_then_clean_eof():
    """One request served over the pipe, then EOF: a clean audited shutdown
    without a close op (the pipe's end is the worker's end)."""
    engines = []
    req = {"op": "submit", "uid": 1, "tokens": PROMPT, "sampling": {"max_new_tokens": 3}}
    inbound = _hello() + T.pack_frame(T.FT_REQUEST, 1, json.dumps(req).encode())
    for i in range(6):
        inbound += T.pack_frame(T.FT_REQUEST, 2 + i, b'{"op": "tick"}')
    inbound += T.pack_frame(T.FT_REQUEST, 9, b'{"op": "pop", "uid": 1}')
    frames = _serve(inbound, engines)
    replies = {f.rid: f.json() for f in frames if f.ftype == T.FT_RESPONSE}
    assert replies[1]["result"]["reason"] == "queued"
    assert replies[9]["result"]["state"] == "finished"
    cfg = get_preset("tiny", max_seq_len=256, dtype=torch.float32)
    ref = build_serve_engine(init_params(cfg, seed=0, device="cpu"), cfg, SEC, device="cpu")
    assert replies[9]["result"]["tokens"] == ref.generate(
        PROMPT, SamplingParams(temperature=0.0, max_new_tokens=3))
    ref.close()
    assert not any(f.ftype == T.FT_ERROR for f in frames)
    assert _closed(engines) and engines[0]._closed

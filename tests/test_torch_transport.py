"""The port's socket transport (``deepspeed_tpu_torch/serving/transport.py``)
against the JAX package's, on the CPU.

- the DSTP wire byte for byte: every frame type packs to JAX's bytes, a JAX
  ``FrameStream`` reads port frames over a socketpair and the reverse;
- each corruption class typed (torn, EOF, magic, version, checksum, frame
  type, oversize, junk JSON, timeouts, handshake skew);
- the handoff codec: meta and blobs equal JAX's for fp32 'none' / 'int8' /
  'fp8', a bf16 leaf written as ``"bfloat16"`` that JAX decodes to the same
  bits, the ambiguous ``'<V2'`` refused typed;
- a JAX ``RpcClient`` drives a port ``WorkerServer`` (tiny engine, JAX
  weights through ``params_from_numpy``) and a port ``RpcClient`` a JAX
  ``WorkerServer``: submit -> tick -> pop gives the same-package pairs'
  tokens;
- exactly-once retries, the reply cache's client scope, chaos retries,
  partitions, retry budgets, deadlines, abort hooks, fuzzing, heartbeat
  lease expiry, and the chaos points firing in JAX's order for one seed;
- the router over socket workers discovering a death: tokens and stats
  equal JAX's same scenario on the same weights (per tick and megastep);
- a kernel error raised in a server's tick comes out of ``Router.tick``
  as ``KernelError``: no FAILED request, no retry, no worker death.
"""
import socket
import struct
import threading
import time
import zlib

import jax
import jax.numpy as jnp
import ml_dtypes  # noqa: F401 — JAX's np.dtype("bfloat16") needs it loaded
import numpy as np
import pytest
import torch

from deepspeed_tpu.comm import qcomm as jqcomm
from deepspeed_tpu.inference.engine_v2 import build_serve_engine as j_build_engine
from deepspeed_tpu.inference.faults import FaultInjector as JInjector
from deepspeed_tpu.inference.sampling import SamplingParams as JSampling
from deepspeed_tpu.models.presets import get_preset as j_preset
from deepspeed_tpu.models.transformer import init_params as j_init
from deepspeed_tpu.serving import transport as JT
from deepspeed_tpu.serving.handoff import KVHandoff as JKVHandoff
from deepspeed_tpu.serving.remote import RemoteWorker as JRemoteWorker
from deepspeed_tpu.serving.router import Router as JRouter
from deepspeed_tpu.config.config import RouterConfig as JRouterConfig
from deepspeed_tpu.telemetry import Telemetry as JTelemetry
from deepspeed_tpu_torch.comm import qcomm
from deepspeed_tpu_torch.config.config import RouterConfig
from deepspeed_tpu_torch.inference.engine_v2 import build_serve_engine
from deepspeed_tpu_torch.inference.faults import FaultInjector
from deepspeed_tpu_torch.inference.sampling import SamplingParams
from deepspeed_tpu_torch.models.presets import get_preset
from deepspeed_tpu_torch.models.transformer import params_from_numpy
from deepspeed_tpu_torch.ops.kernels import KernelError
from deepspeed_tpu_torch.serving import transport as T
from deepspeed_tpu_torch.serving.handoff import KVHandoff
from deepspeed_tpu_torch.serving.remote import RemoteWorker
from deepspeed_tpu_torch.serving.router import Router
from deepspeed_tpu_torch.telemetry import Telemetry

SEC = dict(max_seqs=4, num_blocks=96, block_size=8, prefill_buckets=[16, 32, 64, 128],
           max_seq_len=256, enable_prefix_caching=True)
FRAME_TYPES = sorted(T._FRAME_NAMES)


@pytest.fixture(scope="module")
def tiny():
    jcfg = j_preset("tiny", max_seq_len=256, dtype=jnp.float32)
    tcfg = get_preset("tiny", max_seq_len=256, dtype=torch.float32)
    jp = j_init(jax.random.PRNGKey(0), cfg=jcfg, dtype=jnp.float32)
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), tcfg, device="cpu")
    return jcfg, jp, tcfg, tp


def _pair(mod_a=T, mod_b=T):
    a, b = socket.socketpair()
    return mod_a.FrameStream(a), mod_b.FrameStream(b)


# ---------------------------------------------------------------------------
# the wire, byte for byte
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("ftype", FRAME_TYPES)
def test_frames_byte_identical_to_jax(ftype):
    assert T._FRAME_NAMES == JT._FRAME_NAMES and T.MAGIC == JT.MAGIC
    assert T.PROTO_VERSION == JT.PROTO_VERSION and T.HEADER_BYTES == JT.HEADER_BYTES
    for rid, payload in ((0, b""), (7, b'{"op": "tick"}'), (2 ** 40 + 3, bytes(range(256)) * 9)):
        assert T.pack_frame(ftype, rid, payload) == JT.pack_frame(ftype, rid, payload)
    assert T._json_bytes({"op": "x", "n": [1, 2]}) == JT._json_bytes({"op": "x", "n": [1, 2]})


@pytest.mark.parametrize("direction", ["port_to_jax", "jax_to_port"])
def test_frames_cross_packages_over_a_socketpair(direction):
    src, dst = (T, JT) if direction == "port_to_jax" else (JT, T)
    a, b = _pair(src, dst)
    a.send_json(src.FT_REQUEST, 42, {"op": "submit", "uid": 1})
    a.send_frame(src.FT_BLOB, 42, b"\x00\x01\x02" * 70_000)
    f = b.recv_frame(timeout=2.0)
    assert (f.ftype, f.rid, f.json()) == (dst.FT_REQUEST, 42, {"op": "submit", "uid": 1})
    f2 = b.recv_frame(timeout=2.0)
    assert f2.ftype == dst.FT_BLOB and f2.payload == b"\x00\x01\x02" * 70_000
    out = {}
    t = threading.Thread(target=lambda: out.update(
        meta=dst.server_handshake(b, {"pid": 5, "nonce": 9}, timeout=2.0)))
    t.start()
    ident = src.client_handshake(a, "heartbeat", timeout=2.0, extra={"client_nonce": "n"})
    t.join(2.0)
    assert ident == {"pid": 5, "nonce": 9}
    assert out["meta"]["channel"] == "heartbeat" and out["meta"]["client_nonce"] == "n"
    a.close(), b.close()


# ---------------------------------------------------------------------------
# every corruption class, typed
# ---------------------------------------------------------------------------
def test_torn_frame_is_typed_connection_lost():
    a, b = _pair()
    raw = T.pack_frame(T.FT_REQUEST, 7, b"x" * 64)
    a._sock.sendall(raw[: len(raw) // 2])
    a.close()
    with pytest.raises(T.ConnectionLost) as ei:
        b.recv_frame(timeout=2.0)
    assert ei.value.torn and ei.value.transient
    b.close()


def test_clean_eof_is_not_torn():
    a, b = _pair()
    a.close()
    with pytest.raises(T.ConnectionLost) as ei:
        b.recv_frame(timeout=2.0)
    assert not ei.value.torn
    b.close()


@pytest.mark.parametrize("corruption", ["magic", "version", "crc", "ftype"])
def test_corrupt_frames_are_typed_protocol_errors(corruption):
    a, b = _pair()
    payload = b'{"op":"x"}'
    head = {
        "magic": struct.pack("!4sBBHQII", b"JUNK", T.PROTO_VERSION, T.FT_REQUEST, 0, 1,
                             len(payload), zlib.crc32(payload)),
        "version": struct.pack("!4sBBHQII", T.MAGIC, 99, T.FT_REQUEST, 0, 1, len(payload),
                               zlib.crc32(payload)),
        "crc": struct.pack("!4sBBHQII", T.MAGIC, T.PROTO_VERSION, T.FT_REQUEST, 0, 1,
                           len(payload), 0xDEAD),
        "ftype": struct.pack("!4sBBHQII", T.MAGIC, T.PROTO_VERSION, 200, 0, 1, len(payload),
                             zlib.crc32(payload)),
    }[corruption]
    a._sock.sendall(head + payload)
    with pytest.raises(T.ProtocolError):
        b.recv_frame(timeout=2.0)
    a.close(), b.close()


def test_oversized_frame_refused_both_sides():
    a, b = _pair()
    b.max_frame_bytes = 128
    with pytest.raises(T.ProtocolError):
        T.FrameStream(a._sock, max_frame_bytes=64).send_frame(T.FT_REQUEST, 1, b"x" * 65)
    a._sock.sendall(T.pack_frame(T.FT_REQUEST, 1, b"y" * 256))
    with pytest.raises(T.ProtocolError) as ei:
        b.recv_frame(timeout=2.0)
    assert "oversized" in str(ei.value)
    a.close(), b.close()


def test_junk_json_payload_typed():
    a, b = _pair()
    a.send_frame(T.FT_REQUEST, 1, b"\xff\xfenot json")
    f = b.recv_frame(timeout=2.0)
    with pytest.raises(T.ProtocolError):
        f.json()
    a.close(), b.close()


def test_recv_timeouts_are_typed_and_resume_mid_frame():
    a, b = _pair()
    with pytest.raises(T.RpcTimeout):
        b.recv_frame(timeout=0.1)
    raw = T.pack_frame(T.FT_REQUEST, 9, b"x" * 4096)
    a._sock.sendall(raw[:100])
    with pytest.raises(T.RpcTimeout):
        b.recv_frame(timeout=0.15)
    a._sock.sendall(raw[100:])
    f = b.recv_frame(timeout=2.0)
    assert (f.ftype, f.rid, f.payload) == (T.FT_REQUEST, 9, b"x" * 4096)
    a.send_frame(T.FT_REQUEST, 10, b"y")
    assert b.recv_frame(timeout=2.0).rid == 10
    a.close(), b.close()


def test_handshake_version_mismatch_typed():
    a, b = _pair()

    def server():
        try:
            T.server_handshake(b, {"pid": 1}, timeout=2.0)
        except T.ProtocolError:
            pass

    t = threading.Thread(target=server, daemon=True)
    t.start()
    a.send_json(T.FT_HELLO, 0, {"version": 99, "channel": "rpc"})
    f = a.recv_frame(timeout=2.0)
    assert f.ftype == T.FT_ERROR and f.json()["kind"] == "version_mismatch"
    t.join(timeout=2.0)
    a.close(), b.close()


# ---------------------------------------------------------------------------
# the handoff codec
# ---------------------------------------------------------------------------
def _leaves(rng, dtype=np.float32):
    return [rng.standard_normal((3, 8, 2, 4)).astype(dtype) for _ in range(4)]


def _handoffs(fmt, leaves):
    """The same pages through JAX's numpy codec and the port's torch codec."""
    jpay, tpay, jwire, twire = [], [], 0, 0
    for leaf in leaves:
        q, s = jqcomm.quantize_payload(leaf, fmt)
        jpay.append((q, s, leaf.shape, leaf.dtype))
        jwire += jqcomm.payload_wire_bytes(leaf.size, fmt, none_bytes_per_el=leaf.dtype.itemsize)
        t = torch.from_numpy(leaf)
        tq, ts = qcomm.quantize_payload(t, fmt)
        tpay.append((tq, ts, tuple(t.shape), t.dtype))
        twire += qcomm.payload_wire_bytes(t.numel(), fmt, none_bytes_per_el=t.element_size())
    kw = dict(uid=5, tokens=[1, 2, 3], n_ctx=2, n_pages=1, fmt=fmt)
    return JKVHandoff(payloads=jpay, wire_bytes=jwire, **kw), \
        KVHandoff(payloads=tpay, wire_bytes=twire, **kw)


@pytest.mark.parametrize("fmt", ["none", "int8", "fp8"])
def test_handoff_codec_equals_jax(fmt):
    jho, tho = _handoffs(fmt, _leaves(np.random.default_rng(0)))
    jmeta, jblobs = JT.encode_handoff(jho)
    tmeta, tblobs = T.encode_handoff(tho)
    assert tmeta == jmeta
    assert tblobs == jblobs
    # each side decodes the other's wire to the same pages
    back = T.decode_handoff(jmeta, jblobs)
    jback = JT.decode_handoff(tmeta, tblobs)
    for (q, s, sh, dt), (jq, js, jsh, jdt) in zip(back.payloads, jback.payloads):
        np.testing.assert_array_equal(q.numpy(), jq)
        assert (s is None) == (js is None) and tuple(sh) == tuple(jsh)
        if s is not None:
            np.testing.assert_array_equal(s.numpy(), js)
        got = qcomm.dequantize_payload(q, s, sh, dt, fmt)
        want = jqcomm.dequantize_payload(jq, js, jsh, jdt, fmt)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_handoff_codec_bf16_leaf_by_name():
    """A bf16 pool ships its pages in bf16: the port writes the leaf's dtype
    as ``"bfloat16"`` (numpy alone would write the ambiguous ``'<V2'``),
    and JAX's ``decode_handoff`` reads it back to the same bits."""
    rng = np.random.default_rng(1)
    pages = [torch.from_numpy(x).to(torch.bfloat16) for x in _leaves(rng)]
    for fmt in ("none", "int8"):
        pay = []
        for p in pages:
            q, s = qcomm.quantize_payload(p, fmt)
            pay.append((q, s, tuple(p.shape), p.dtype))
        ho = KVHandoff(uid=1, tokens=[1], n_ctx=2, n_pages=1, fmt=fmt, payloads=pay,
                       wire_bytes=1)
        meta, blobs = T.encode_handoff(ho)
        assert all(leaf["dtype"] == "bfloat16" for leaf in meta["leaves"])
        assert all(leaf["qdtype"] == ("bfloat16" if fmt == "none" else "|i1")
                   for leaf in meta["leaves"])
        jho = JT.decode_handoff(meta, blobs)
        back = T.decode_handoff(meta, blobs)
        for p, (jq, _, _, jdt), (q, _, _, dt) in zip(pay, jho.payloads, back.payloads):
            assert jdt == np.dtype(ml_dtypes.bfloat16) and dt == torch.bfloat16
            if fmt == "none":
                assert jq.dtype == np.dtype(ml_dtypes.bfloat16)
                np.testing.assert_array_equal(jq.view(np.int16), p[0].view(torch.int16).numpy())
                assert torch.equal(q.view(torch.int16), p[0].view(torch.int16))
            else:
                assert torch.equal(q, p[0])
        # the JAX package's own re-encode of the decoded leaf names the type too
        assert JT.encode_handoff(jho)[1] == blobs


def test_handoff_codec_refuses_void_and_malformed_typed():
    jho, tho = _handoffs("int8", _leaves(np.random.default_rng(2)))
    meta, blobs = T.encode_handoff(tho)
    for key in ("dtype", "qdtype"):
        bad = {**meta, "leaves": [dict(meta["leaves"][0], **{key: "<V2"})] + meta["leaves"][1:]}
        with pytest.raises(T.ProtocolError, match="ambiguous"):
            T.decode_handoff(bad, blobs)
    with pytest.raises(T.ProtocolError):
        T.decode_handoff(meta, blobs[:-1])  # missing scales blob
    with pytest.raises(T.ProtocolError):
        T.decode_handoff(meta, blobs + [b"extra"])  # trailing blob
    with pytest.raises(T.ProtocolError):
        T.decode_handoff(meta, [blobs[0][:-1]] + blobs[1:])  # short payload
    assert T.torch_dtype("float8_e4m3fn") == torch.float8_e4m3fn
    assert T.wire_dtype(torch.float32) == np.dtype(np.float32).str


# ---------------------------------------------------------------------------
# port servers over tiny engines
# ---------------------------------------------------------------------------
@pytest.fixture
def servers(tiny):
    """``make(pkg="port", **serve)``: a WorkerServer of either package over a
    tiny engine on JAX's weights, serving its socket on a thread."""
    jcfg, jp, tcfg, tp = tiny
    made = []

    def make(pkg="port", **serve):
        if pkg == "port":
            eng = build_serve_engine(tp, tcfg, SEC, device="cpu", serve=serve or None)
            srv = T.WorkerServer(eng, identity={"worker": len(made)})
        else:
            eng = j_build_engine(jp, jcfg, SEC, serve=serve or None)
            srv = JT.WorkerServer(eng, identity={"worker": len(made)})
        srv.bind()
        t = threading.Thread(target=srv.serve_socket, daemon=True)
        t.start()
        made.append((srv, t))
        return srv

    yield make
    for srv, t in made:
        srv.shutdown()
        t.join(timeout=5.0)


def _client(srv, mod=T, **kw):
    return mod.RpcClient(lambda: mod.dial("127.0.0.1", srv.port, "rpc"), **kw)


def _serve_one(c, uid=1, tokens=(3, 14, 15, 92, 65), max_new=5):
    reply, _ = c.call({"op": "submit", "uid": uid, "tokens": list(tokens),
                       "sampling": {"max_new_tokens": max_new}})
    assert reply["ok"] and reply["result"]["reason"] == "queued"
    for _ in range(32):
        reply, _ = c.call({"op": "tick"})
        if reply["requests"][str(uid)]["state"] == "finished":
            break
    reply, _ = c.call({"op": "pop", "uid": uid})
    assert reply["result"]["state"] == "finished"
    return reply["result"]["tokens"]


@pytest.mark.parametrize("client,server", [("jax", "port"), ("port", "jax"),
                                           ("port", "port"), ("jax", "jax")])
def test_cross_package_rpc_submit_tick_pop(tiny, servers, client, server):
    """A JAX client and a port server, and the reverse, complete submit ->
    tick -> pop with the tokens of the in-process port engine (which the
    same-package pairs also give)."""
    _, _, tcfg, tp = tiny
    ref = build_serve_engine(tp, tcfg, SEC, device="cpu")
    want = ref.generate([3, 14, 15, 92, 65], SamplingParams(temperature=0.0, max_new_tokens=5))
    ref.close()
    srv = servers(server)
    c = _client(srv, JT if client == "jax" else T)
    assert _serve_one(c) == want
    reply, _ = c.call({"op": "stats"})
    assert reply["ok"] and reply["sched"]["finished"] == 1
    if server == "port":  # the port's extra stats keys (a JAX client ignores them)
        assert reply["launches"]["paged_decode"] == 0 and reply["memory_allocated"] is None
    reply, _ = c.call({"op": "close"})
    assert reply["audit"]["blocks_in_use"] == 0
    c.close()


def test_worker_server_ops_and_load(servers):
    srv = servers()
    c = _client(srv)
    reply, _ = c.call({"op": "frobnicate"})
    assert not reply["ok"] and reply["error"]["kind"] == "bad_request"
    rids = [c.post({"op": "submit", "uid": 10 + i, "tokens": [1, 2],
                    "sampling": {"max_new_tokens": 1}}) for i in range(4)]
    for rid in reversed(rids):  # responses demux by rid
        reply, _ = c.wait(rid)
        assert reply["ok"] and reply["result"]["reason"] == "queued"
    reply, _ = c.call({"op": "tick"})
    assert sorted(int(u) for u in reply["requests"]) == [10, 11, 12, 13]
    assert {"queue_depth", "headroom_blocks", "total_blocks"} <= set(reply["load"])
    reply, _ = c.call({"op": "apply_knobs", "knobs": {"prefill_chunk": 16}})
    assert reply["ok"] and reply["staged"] == {"prefill_chunk": 16}
    reply, _ = c.call({"op": "apply_knobs", "knobs": {"prefill_chunk": 0}})
    assert not reply["ok"] and reply["error"]["kind"] == "internal"
    c.close()


def test_exactly_once_retry_after_lost_response(servers):
    srv = servers()
    c = _client(srv)
    rid = c.post({"op": "submit", "uid": 77, "tokens": [1, 2, 3],
                  "sampling": {"max_new_tokens": 1}})
    deadline = time.monotonic() + 5.0
    while rid not in srv._replies:
        assert time.monotonic() < deadline, "server never executed the op"
        time.sleep(0.01)
    c._drop_stream()
    reply, _ = c.wait(rid)
    assert reply["ok"] and reply["result"]["reason"] == "queued"
    assert srv.scheduler.stats["submitted"] == 1 and len(srv.scheduler.requests) == 1
    c.close()
    # a NEW client (fresh nonce, rid counter from 1) is never answered from
    # the previous client's cache
    c2 = _client(srv)
    reply2, _ = c2.call({"op": "tick"})
    assert "requests" in reply2 and "result" not in reply2
    c2.close()


def test_step_burst_op_fuses_ticks_exactly_once(servers):
    srv = servers(decode_megastep=4)
    c = _client(srv)
    reply, _ = c.call({"op": "submit", "uid": 1, "tokens": [1, 2, 3],
                       "sampling": {"max_new_tokens": 6}})
    reply, _ = c.call({"op": "step_burst", "n": 4})
    assert 1 <= reply["ticks"] <= 4 and reply["tick_no"] == srv.scheduler.tick_no
    rid = c.post({"op": "step_burst", "n": 4})
    deadline = time.monotonic() + 5.0
    while rid not in srv._replies:
        assert time.monotonic() < deadline
        time.sleep(0.01)
    tick_no = srv.scheduler.tick_no
    c._drop_stream()
    reply, _ = c.wait(rid)
    assert reply["tick_no"] == tick_no and srv.scheduler.tick_no == tick_no
    while srv.scheduler.requests[1].state != "finished":
        c.call({"op": "step_burst", "n": 4})
    reply, _ = c.call({"op": "pop", "uid": 1})
    assert len(reply["result"]["tokens"]) == 6
    c.close()


def test_conn_drop_and_partition_chaos_retry_and_succeed(servers):
    srv = servers()
    inj = FaultInjector(seed=0).arm("conn_drop", uids=[0], times=2)
    chaos = T.ChaosLink(inj, endpoint=0)
    c = T.RpcClient(lambda: T.dial("127.0.0.1", srv.port, "rpc", chaos=chaos),
                    backoff_ms=1.0, backoff_max_ms=5.0)
    reply, _ = c.call({"op": "submit", "uid": 5, "tokens": [1],
                       "sampling": {"max_new_tokens": 1}})
    assert reply["ok"] and inj.fired("conn_drop") == 2
    assert srv.scheduler.stats["submitted"] == 1
    c.close()
    inj = FaultInjector(seed=0).arm("partition", uids=[0], times=1, delay_s=0.3)
    chaos = T.ChaosLink(inj, endpoint=0)  # one partition window across redials
    c = T.RpcClient(lambda: T.dial("127.0.0.1", srv.port, "rpc", chaos=chaos),
                    backoff_ms=1.0, backoff_max_ms=5.0)
    t0 = time.monotonic()
    reply, _ = c.call({"op": "tick"}, deadline_ms=10_000)
    assert reply["ok"] and time.monotonic() - t0 >= 0.25
    c.close()


def test_retry_budget_deadline_and_abort_are_worker_dead(servers):
    def dead_dial():
        raise T.ConnectionLost("nobody home")

    c = T.RpcClient(dead_dial, max_attempts=3, backoff_ms=1.0, backoff_max_ms=2.0)
    t0 = time.monotonic()
    with pytest.raises(T.WorkerDead):
        c.call({"op": "tick"}, deadline_ms=5_000)
    assert time.monotonic() - t0 < 2.0
    srv = servers()
    c = _client(srv)
    with pytest.raises(T.WorkerDead):
        c.wait(999_999, deadline_ms=150)
    t0 = time.monotonic()
    with pytest.raises(T.WorkerDead, match="lease expired"):
        c.wait(999_999, deadline_ms=60_000, abort=lambda: "lease expired")
    assert time.monotonic() - t0 < 1.0
    c.close()


def test_fuzz_junk_bytes_never_kill_the_worker(servers):
    srv = servers()
    rng = np.random.default_rng(0)
    for _ in range(6):
        sock = socket.create_connection(("127.0.0.1", srv.port), timeout=5.0)
        stream = T.FrameStream(sock)
        try:
            T.client_handshake(stream, "rpc", timeout=5.0)
            sock.sendall(rng.integers(0, 256, rng.integers(8, 200), dtype=np.uint8).tobytes())
            try:
                assert stream.recv_frame(timeout=2.0).ftype == T.FT_ERROR
            except (T.ConnectionLost, T.RpcTimeout, T.ProtocolError):
                pass
        finally:
            stream.close()
    c = _client(srv)
    assert c.call({"op": "tick"})[0]["ok"]
    c.close()


def test_heartbeat_lease_expiry_on_freeze_and_on_loss(servers):
    srv = servers()
    # the healthy channel gets a lease no scheduling stall of a loaded box
    # reaches; the lossy one a short one
    mon = T.HeartbeatMonitor(interval_ms=20.0, lease_ms=1000.0)
    lossy_mon = T.HeartbeatMonitor(interval_ms=20.0, lease_ms=200.0)
    hb, _ = T.dial("127.0.0.1", srv.port, "heartbeat")
    inj = FaultInjector(seed=0).arm("heartbeat_loss", uids=[3])
    lossy, _ = T.dial("127.0.0.1", srv.port, "heartbeat", chaos=T.ChaosLink(inj, endpoint=3))
    mon.watch(0, hb)
    lossy_mon.watch(3, lossy)
    mon.start()
    lossy_mon.start()
    try:
        deadline = time.monotonic() + 5.0
        while not mon.snapshot() or mon.snapshot()[0]["age_s"] > 0.1 \
                or mon.clock_offset(0) is None:
            assert time.monotonic() < deadline, "no heartbeat ack"
            time.sleep(0.02)
        assert not mon.lease_expired(0)
        off, err = mon.clock_offset(0)
        assert err >= 0.0 and abs(off) < 1.0  # one process: one perf clock
        while not lossy_mon.lease_expired(3):  # acks swallowed: a live worker expires
            assert time.monotonic() < deadline, "heartbeat_loss never expired the lease"
            time.sleep(0.02)
        assert inj.fired("heartbeat_loss") > 0 and not mon.lease_expired(0)
        srv.shutdown()  # freeze: the acks stop
        deadline = time.monotonic() + 5.0
        while not mon.lease_expired(0):
            assert time.monotonic() < deadline, "lease never expired"
            time.sleep(0.02)
    finally:
        mon.stop()
        lossy_mon.stop()


def test_heartbeat_thread_survives_a_stream_closed_mid_ping():
    """A heartbeat stream closed while the monitor waits for its PONG (its
    socket's settimeout then raises EBADF) counts as a miss: the
    dstpu-heartbeat thread lives on and keeps charging misses."""
    a, b = socket.socketpair()
    stream = T.FrameStream(sock=a)
    mon = T.HeartbeatMonitor(interval_ms=20.0, lease_ms=60_000.0)
    mon.watch(0, stream)
    errors = []
    old_hook = threading.excepthook
    threading.excepthook = lambda args: errors.append(args.exc_value)
    mon.start()
    try:
        b.settimeout(5.0)
        assert b.recv(64)  # the PING is out: the monitor now waits in recv
        stream.close()  # closed under the ping, no PONG ever comes
        deadline = time.monotonic() + 5.0
        while mon.snapshot()[0]["misses"] < 3:
            assert time.monotonic() < deadline, "the monitor stopped counting misses"
            time.sleep(0.02)
        assert mon._thread is not None and mon._thread.is_alive()
        assert not errors, errors
    finally:
        mon.stop()
        threading.excepthook = old_hook
        b.close()


def _chaos_trace(tmod, Inj, seed):
    """The actions a seeded storm's ChaosLinks take over a fixed call order
    on a fake clock (no sockets): check() per frame, heartbeat_lost()."""
    now = [0.0]
    rpc = (Inj(seed).arm("conn_drop", p=0.2, times=6)
           .arm("conn_delay", p=0.3, delay_s=1e-4, times=12)
           .arm("partial_write", p=0.2, times=5))
    hb = (Inj(seed + 1).arm("heartbeat_loss", p=0.3, times=8)
          .arm("partition", uids=[1], after=5, times=1, delay_s=0.5))
    out = []
    links = [tmod.ChaosLink(rpc, endpoint=i, clock=lambda: now[0]) for i in range(3)]
    hbl = [lk.fork(hb) for lk in links]
    for step in range(60):
        now[0] = step * 0.1
        i = step % 3
        for lk, sending in ((links[i], step % 2 == 0), (hbl[i], True)):
            try:
                out.append(lk.check(sending=sending))
            except tmod.RpcTimeout:
                out.append("partition")
        out.append(hbl[i].heartbeat_lost())
    fired = {p: inj.fired(p) for inj in (rpc, hb) for p in
             ("conn_drop", "conn_delay", "partial_write", "heartbeat_loss", "partition")
             if inj.fired(p)}
    return out, fired


@pytest.mark.parametrize("seed", [0, 2])
def test_chaos_points_fire_in_jax_order(seed):
    got, fired = _chaos_trace(T, FaultInjector, seed)
    want, jfired = _chaos_trace(JT, JInjector, seed)
    assert got == want and fired == jfired
    assert {"drop", "partial", "partition", True} <= set(got)


# ---------------------------------------------------------------------------
# the router over socket workers
# ---------------------------------------------------------------------------
class _SocketPool:
    """Pool shim over directly-constructed RemoteWorkers of either package."""

    def __init__(self, workers, telemetry, monitor):
        self.workers = workers
        self.telemetry = telemetry
        self.monitor = monitor

    @property
    def alive(self):
        return [w for w in self.workers if w.alive]

    @property
    def decode_workers(self):
        return [w for w in self.alive if w.role == "mixed"]

    @property
    def prefill_workers(self):
        return [w for w in self.alive if w.role == "prefill"]

    def prefix_hit_rate(self):
        return 0.0

    def close(self):
        audits = [w.close() if w.alive else w.close_audit for w in self.workers]
        self.monitor.stop()
        return audits


def _socket_router(servers, pkg, megastep=1, n=2):
    mods = dict(port=(T, RouterConfig, RemoteWorker, Router, Telemetry),
                jax=(JT, JRouterConfig, JRemoteWorker, JRouter, JTelemetry))[pkg]
    tmod, Cfg, RW, R, Tel = mods
    srvs = [servers(pkg, **({"decode_megastep": megastep} if megastep > 1 else {}))
            for _ in range(n)]
    # a frozen server is found by the retry budget (its sockets close); the
    # lease is long so that no stall of a loaded box can expire a live one
    cfg = Cfg(n_workers=n, decode_megastep=megastep, heartbeat_interval_ms=20.0,
              lease_ms=5000.0, rpc_backoff_ms=1.0, rpc_backoff_max_ms=5.0, rpc_max_attempts=3)
    mon = tmod.HeartbeatMonitor(interval_ms=cfg.heartbeat_interval_ms, lease_ms=cfg.lease_ms)
    workers = [RW(i, "127.0.0.1", s.port, mon, config=cfg) for i, s in enumerate(srvs)]
    mon.start()
    return R(_SocketPool(workers, Tel(True), mon), cfg), srvs, workers


@pytest.mark.parametrize("megastep", [1, 4])
def test_router_over_sockets_discovers_death_like_jax(tiny, servers, megastep):
    """Two socket workers, worker 1 frozen mid-flight: the death is
    DISCOVERED (lease / retry budget), its requests replay on worker 0, and
    the tokens and router stats equal JAX's same scenario."""
    prompts = {u: [u, u + 1, u + 2, 7, 11] for u in range(1, 7)}
    # long enough that the freeze lands mid-flight (a megastep router tick
    # moves up to megastep^2 tokens: step_burst of fused bursts)
    max_new = 24 if megastep == 1 else 96
    res = {}
    for pkg in ("jax", "port"):
        router, srvs, workers = _socket_router(servers, pkg, megastep)
        Samp = JSampling if pkg == "jax" else SamplingParams
        samp = Samp(temperature=0.0, max_new_tokens=max_new)
        for u, p in prompts.items():
            assert router.try_submit(u, p, samp).accepted
        for _ in range(2):
            router.tick()
        srvs[1].shutdown()
        out = router.run(max_ticks=4096)
        stats = dict(router.stats)
        assert stats["worker_deaths"] == 1 and stats["discovered_deaths"] == 1
        assert not workers[1].alive
        audits = [a for a in router.close() if a is not None]
        assert audits and all(a["blocks_in_use"] == 0 for a in audits)
        stats.pop("worker_retry_later")  # follows wall-clock backoff hints
        res[pkg] = (out, stats)
    assert res["port"] == res["jax"]
    assert all(s == "finished" and len(t) == max_new for s, t in res["port"][0].values())


def test_kernel_error_in_a_server_tick_raises_through_router(servers):
    """A kernel fault in a worker's tick comes back typed (``kernel``) and
    ``Router.tick`` raises it as ``KernelError``: no request FAILED, no
    retry, no replay, no worker death."""
    router, srvs, workers = _socket_router(servers, "port")
    samp = SamplingParams(temperature=0.0, max_new_tokens=8)
    for u in range(1, 5):
        assert router.try_submit(u, [u, 5, 6, 7], samp).accepted
    router.tick()
    sched = srvs[1].scheduler
    real = sched.tick

    def tick():
        raise KernelError("CUDA kernel paged_decode failed to launch: cudaError 719")

    sched.tick = tick
    with pytest.raises(KernelError, match="worker 1: KernelError: CUDA kernel paged_decode"):
        router.tick()
    sched.tick = real
    stats = dict(router.stats)
    assert stats["worker_deaths"] == 0 and stats["replays"] == 0 and stats["failed"] == 0
    assert all(w.healthy() for w in workers)
    assert not any(q.state == "failed" for s in srvs for q in s.scheduler.requests.values())
    assert srvs[1].engine.stats["retries"] == 0
    out = router.run(max_ticks=512)  # the router carries on after the caller's handling
    assert all(s == "finished" for s, _ in out.values())
    assert all(a["blocks_in_use"] == 0 for a in router.close())


# ---------------------------------------------------------------------------
# the reply cache's byte cap
# ---------------------------------------------------------------------------
def test_reply_cache_byte_cap_evicts_oldest_first(tiny):
    """Count cap and byte cap both hold after every store; the oldest
    replies go first; the reply just stored stays even when it alone is
    over the byte cap."""
    _, _, tcfg, tp = tiny
    eng = build_serve_engine(tp, tcfg, SEC, device="cpu")
    srv = T.WorkerServer(eng, reply_cache_size=4, reply_cache_bytes=100)
    for rid in (1, 2, 3):
        srv._cache_reply(rid, {"ok": True}, [b"x" * 40])
    assert list(srv._replies) == [2, 3] and srv.reply_cache_bytes() == 80
    for rid in (4, 5, 6, 7, 8):
        srv._cache_reply(rid, {"ok": True}, [])
    assert list(srv._replies) == [5, 6, 7, 8] and srv.reply_cache_bytes() == 0
    srv._cache_reply(9, {"ok": True}, [b"y" * 30, b"z" * 30])
    assert list(srv._replies) == [6, 7, 8, 9] and srv.reply_cache_bytes() == 60
    srv._cache_reply(10, {"ok": True}, [b"w" * 500])
    assert list(srv._replies) == [10] and srv.reply_cache_bytes() == 500
    srv._note_client("another client")
    assert not srv._replies and srv.reply_cache_bytes() == 0
    eng.close()


def _request_bytes(srv, mod, rid, op):
    """Serve one REQUEST frame (``rid``, ``op``) through ``srv`` over a
    socketpair and return every byte the server wrote back."""
    a, b = socket.socketpair()
    mod.FrameStream(a).send_json(mod.FT_REQUEST, rid, op)
    server_side = (T if isinstance(srv, T.WorkerServer) else JT).FrameStream(b)
    srv._serve_request(server_side, server_side.recv_frame(timeout=5.0))
    a.settimeout(0.5)
    out = b""
    try:
        while True:
            chunk = a.recv(1 << 16)
            if not chunk:
                break
            out += chunk
    except socket.timeout:
        pass
    a.close()
    b.close()
    return out


def _jax_reads(raw):
    """A JAX ``FrameStream`` reads a reply's bytes: (response frame, blobs)."""
    a, b = socket.socketpair()
    a.sendall(raw)
    fs = JT.FrameStream(b)
    head = fs.recv_frame(timeout=5.0)
    blobs = [fs.recv_frame(timeout=5.0).payload for _ in range(head.json().get("blobs", 0))]
    a.close()
    b.close()
    return head, blobs


def test_byte_capped_cache_replays_jax_frames_and_reexecutes_evicted(tiny):
    """Under a byte cap that holds one ``extract`` reply, a retry of the
    newest extract replays its frames byte for byte (a JAX ``FrameStream``
    reads them: the wire is unchanged); the older extract, evicted by
    bytes, executes again on its retry, as an id evicted by count does;
    and a ``submit`` reply's frames are byte-equal to a JAX server's."""
    jcfg, jp, tcfg, tp = tiny
    eng = build_serve_engine(tp, tcfg, SEC, device="cpu")
    jeng = j_build_engine(jp, jcfg, SEC)
    srv = T.WorkerServer(eng, identity={"worker": 0})
    jsrv = JT.WorkerServer(jeng, identity={"worker": 0})
    sub = {"op": "submit", "uid": 1, "tokens": [3, 14, 15, 92, 65],
           "sampling": {"max_new_tokens": 8}, "_cn": "c"}
    assert _request_bytes(srv, JT, 1, dict(sub)) == _request_bytes(jsrv, JT, 1, dict(sub))
    srv.scheduler.submit(2, [7, 8, 9, 10, 11, 12], SamplingParams(max_new_tokens=8))
    srv.scheduler.tick()
    ext = lambda uid: {"op": "extract", "uid": uid, "fmt": "none", "_cn": "c"}  # noqa: E731
    first = _request_bytes(srv, JT, 2, ext(1))
    one = srv.reply_cache_bytes()
    assert one > 0
    srv._reply_cache_cap_bytes = one + one // 2  # holds one extract, not two
    second = _request_bytes(srv, JT, 3, ext(2))
    assert 2 not in srv._replies and 3 in srv._replies
    assert srv.reply_cache_bytes() <= srv._reply_cache_cap_bytes
    assert _request_bytes(srv, JT, 3, ext(2)) == second  # cached: the same bytes
    head, _ = _jax_reads(second)
    assert head.ftype == JT.FT_RESPONSE and head.rid == 3 and head.json()["ok"]
    calls = []
    real = srv._op_extract
    srv._op_extract = lambda op, blobs: calls.append(op["uid"]) or real(op, blobs)
    again = _request_bytes(srv, JT, 2, ext(1))  # evicted by bytes: runs again
    assert calls == [1]
    (h1, b1), (h2, b2) = _jax_reads(first), _jax_reads(again)
    assert h1.json()["handoff"] == h2.json()["handoff"] and b1 == b2  # the same pages
    assert srv.reply_cache_bytes() <= srv._reply_cache_cap_bytes
    eng.close()
    jeng.close()

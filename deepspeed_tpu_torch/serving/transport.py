"""Fault-tolerant socket transport: the out-of-process serving wire — the
port of ``deepspeed_tpu/serving/transport.py``, byte for byte on the wire
(a JAX client talks to a port server, and the reverse).

The router tier (``serving/router.py``) was built in-process; this module is
the seam that moves workers behind a real network boundary while keeping the
router's availability and token-identity guarantees.  Four layers:

* **Framing** — every message is a length-prefixed, versioned, checksummed
  frame: ``magic | version | type | flags | request-id | length | crc32``
  followed by the payload.  JSON payloads carry control ops; ``BLOB`` frames
  carry binary KV-handoff pages (the qcomm payload-codec wire format), so a
  migration ships bytes, not host-memory references.  A torn frame (EOF
  mid-header/payload) is a typed :class:`ConnectionLost`; a corrupt frame
  (bad magic, version skew, checksum mismatch, oversized length) is a typed
  :class:`ProtocolError` — never an unhandled exception.
* **RPC** — :class:`RpcClient` gives every call a request id and a deadline.
  Responses match by id (so calls may be pipelined and responses
  interleave), transient failures (connection drops, partitions) retry with
  bounded exponential backoff + deterministic jitter, reconnecting and
  re-sending the SAME request id.  :class:`WorkerServer` keeps an
  exactly-once reply cache keyed by request id, so an op whose response was
  lost on the wire is answered from cache on retry instead of re-executing
  (a re-sent ``submit`` cannot double-admit, a re-sent ``pop`` still returns
  the tokens).
* **Health** — :class:`HeartbeatMonitor` runs one background thread pinging
  every worker on a DEDICATED heartbeat channel (never the RPC channel, so
  liveness is observable while the worker computes, and no socket I/O ever
  happens under a lock).  A worker whose acks stop for longer than
  ``lease_ms`` has its lease expire; the router *discovers* the death and
  replays the worker's in-flight requests elsewhere.
* **Chaos** — :class:`ChaosLink` wires the network-scoped fault points
  (``conn_drop``, ``conn_delay``, ``partial_write``, ``partition``,
  ``heartbeat_loss`` — ``inference/faults.py``) into every send/recv, keyed
  by worker index, so a seeded storm can run against real worker
  subprocesses.

What the port adds to the reference, all invisible to a JAX peer:

* A kernel or CUDA error in an op (``ops.kernels.surfaces``) is replied as
  a typed ``{"kind": "kernel"}`` error, never as ``internal``; the client
  side (``serving/remote.py``) raises it as ``KernelError`` from the op
  that met it, so it is never retried, replayed or turned into a FAILED
  request.
* The ``stats`` reply also carries the worker process's kernel launch
  counts (``launches``), its CUDA ``memory_allocated`` and the bytes its
  reply cache holds (``reply_cache_bytes``, bounded by the server's byte
  cap beside its count cap).
* The handoff codec writes a bf16 or fp8 leaf's dtype by its name
  (``"bfloat16"``, ``"float8_e4m3fn"``), which numpy reads back whenever
  ``ml_dtypes`` is loaded; the ambiguous void string (``'<V2'``) numpy
  alone gives those types is refused, typed.

Concurrency model: the RPC channel is single-owner (the router thread); the
heartbeat thread owns only the heartbeat channels and the monitor's state
map.  The one lock in each class guards pure state — every blocking socket
call happens with no lock held.
"""
from __future__ import annotations

import json
import os
import queue
import random
import select
import socket
import struct
import threading
import time
import zlib
from collections import OrderedDict
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..inference.faults import (
    CONN_DELAY,
    CONN_DROP,
    HEARTBEAT_LOSS,
    PARTIAL_WRITE,
    PARTITION,
    InjectedFault,
)
from ..ops import kernels
from ..ops.kernels import surfaces

# -- wire format --------------------------------------------------------------
MAGIC = b"DSTP"
PROTO_VERSION = 1
# magic | version | frame type | flags (reserved) | request id | payload
# length | payload crc32
_HEADER = struct.Struct("!4sBBHQII")
HEADER_BYTES = _HEADER.size

FT_HELLO = 1
FT_HELLO_ACK = 2
FT_REQUEST = 3
FT_RESPONSE = 4
FT_BLOB = 5
FT_PING = 6
FT_PONG = 7
FT_ERROR = 8

_FRAME_NAMES = {
    FT_HELLO: "HELLO", FT_HELLO_ACK: "HELLO_ACK", FT_REQUEST: "REQUEST",
    FT_RESPONSE: "RESPONSE", FT_BLOB: "BLOB", FT_PING: "PING",
    FT_PONG: "PONG", FT_ERROR: "ERROR",
}

DEFAULT_MAX_FRAME_BYTES = 64 * 1024 * 1024
# recv poll quantum: the grain at which waits re-check deadlines/abort hooks
_POLL_S = 0.05


class TransportError(RuntimeError):
    """Base of every typed transport failure.  ``transient`` marks the
    retry-with-backoff class (the connection or link failed; the worker may
    be fine); non-transient errors mean the peer is unusable as-is."""

    transient = False


class ProtocolError(TransportError):
    """Corrupt or incompatible traffic on a live connection: bad magic,
    version skew, checksum mismatch, oversized frame, junk payload.
    Non-transient — resending the same bytes cannot help."""


class ConnectionLost(TransportError):
    """The connection dropped (EOF, reset, torn frame mid-read).  Transient:
    reconnect and re-send the same request id."""

    transient = True

    def __init__(self, msg: str, torn: bool = False):
        super().__init__(msg)
        self.torn = torn  # EOF landed MID-frame (peer died mid-write)


class RpcTimeout(TransportError):
    """No traffic within the wait window (slow worker or a partition).  The
    caller keeps waiting until its deadline/abort hook says otherwise."""

    transient = True


class WorkerDead(TransportError):
    """The retry budget, deadline, or abort hook (lease expiry) gave up on
    the worker.  Non-transient: the router replays the worker's requests."""


# -- chaos wiring -------------------------------------------------------------
class ChaosLink:
    """Per-worker network-fault state shared by every channel to that
    worker: a ``partition`` fired on any channel black-holes all of them
    for its window.  All methods are lock-free (the partition clock is a
    single float; a benign race between the router and heartbeat threads
    only jitters the window edge by one check)."""

    def __init__(self, faults=None, endpoint: int = 0,
                 clock: Callable[[], float] = time.monotonic,
                 partition_cell: Optional[List[float]] = None):
        self.faults = faults
        self.endpoint = int(endpoint)
        self.clock = clock
        # shared across every channel to this worker (fork()), so a
        # partition fired on one channel black-holes them all
        self._partition = partition_cell if partition_cell is not None \
            else [0.0]

    @property
    def partition_until(self) -> float:
        return self._partition[0]

    def fork(self, faults=None) -> "ChaosLink":
        """A per-channel link sharing this worker's partition window.  Give
        each THREAD its own (seeded) injector — the heartbeat thread and
        the router thread must never race one RNG — while partitions stay
        worker-wide."""
        return ChaosLink(faults if faults is not None else self.faults,
                         self.endpoint, self.clock,
                         partition_cell=self._partition)

    def _fires(self, point: str) -> bool:
        if self.faults is None:
            return False
        try:
            self.faults.maybe_raise(point, uids=(self.endpoint,))
        except InjectedFault:
            return True
        return False

    def check(self, sending: bool) -> Optional[str]:
        """Consult the armed chaos points for one I/O op.  Returns None to
        proceed, ``'drop'``/``'partial'`` to sever the connection, or
        raises :class:`RpcTimeout` while a partition window is open.  May
        sleep (``conn_delay``) — callers never hold a lock here."""
        if self.faults is None:
            return None
        d = self.faults.delay(CONN_DELAY, uids=(self.endpoint,))
        if d:
            time.sleep(d)
        d = self.faults.delay(PARTITION, uids=(self.endpoint,))
        if d:
            self._partition[0] = max(self._partition[0], self.clock() + d)
        if self.clock() < self._partition[0]:
            raise RpcTimeout(
                f"network partition to worker {self.endpoint} "
                "(injected): traffic black-holed")
        if self._fires(CONN_DROP):
            return "drop"
        if sending and self._fires(PARTIAL_WRITE):
            return "partial"
        return None

    def heartbeat_lost(self) -> bool:
        """``heartbeat_loss``: swallow one received ack."""
        return self._fires(HEARTBEAT_LOSS)


# -- frames -------------------------------------------------------------------
@dataclass
class Frame:
    ftype: int
    rid: int
    payload: bytes

    @property
    def name(self) -> str:
        return _FRAME_NAMES.get(self.ftype, f"?{self.ftype}")

    def json(self) -> Dict[str, Any]:
        try:
            out = json.loads(self.payload.decode("utf-8"))
        except (UnicodeDecodeError, json.JSONDecodeError) as e:
            raise ProtocolError(f"junk {self.name} payload: {e}")
        if not isinstance(out, dict):
            raise ProtocolError(
                f"{self.name} payload must be a JSON object, got "
                f"{type(out).__name__}")
        return out


def pack_frame(ftype: int, rid: int, payload: bytes) -> bytes:
    return _HEADER.pack(MAGIC, PROTO_VERSION, ftype, 0, rid, len(payload),
                        zlib.crc32(payload)) + payload


def _json_bytes(obj: Dict[str, Any]) -> bytes:
    return json.dumps(obj).encode("utf-8")


class FrameStream:
    """One framed, checksummed byte channel over a socket or a binary file
    pair (the stdio worker).  Owns torn/corrupt-frame detection and the
    chaos hooks; thread-safety is by convention (each stream has exactly
    one owner thread), so there is nothing to lock."""

    def __init__(self, sock: Optional[socket.socket] = None,
                 rfile=None, wfile=None,
                 max_frame_bytes: int = DEFAULT_MAX_FRAME_BYTES,
                 chaos: Optional[ChaosLink] = None):
        if sock is None and (rfile is None or wfile is None):
            raise ValueError("FrameStream needs a socket or an rfile/wfile pair")
        self._sock = sock
        self._rfile = rfile
        self._wfile = wfile
        # real-fd file streams (pipes, stdio) read via os.read + select so
        # timeouts work there too; buffered .read() is the fallback for
        # in-memory streams.  NEVER mix: once we own the fd, the buffered
        # layer must stay untouched or bytes strand in its buffer.
        self._rfd: Optional[int] = None
        if rfile is not None:
            try:
                self._rfd = rfile.fileno()
            except Exception:
                self._rfd = None
        self.max_frame_bytes = int(max_frame_bytes)
        self.chaos = chaos
        self.closed = False
        # partial-frame accumulator: a recv_frame that times out MID-frame
        # keeps what it read, so the next call resumes at the same byte —
        # losing the partial would desynchronize the stream and turn every
        # later frame into checksum garbage.  bytearray: appends amortize
        # O(1), so a 64 MiB BLOB arriving in TCP-sized chunks costs O(n),
        # not O(n^2) re-copies.
        self._rbuf = bytearray()

    # -- raw I/O -------------------------------------------------------------
    def _raw_send(self, data: bytes) -> None:
        try:
            if self._sock is not None:
                self._sock.sendall(data)
            else:
                self._wfile.write(data)
                self._wfile.flush()
        except (BrokenPipeError, ConnectionError, ValueError, OSError) as e:
            self.close()
            raise ConnectionLost(f"send failed: {e}")

    def _fill_rbuf(self, n: int, deadline: Optional[float]) -> None:
        """Grow the accumulator to at least ``n`` bytes, or raise a typed
        error.  A timeout PRESERVES what arrived (``self._rbuf``) — the
        next call resumes the same frame.  ``deadline`` is an absolute
        ``time.monotonic`` instant (None = block)."""
        while len(self._rbuf) < n:
            want = n - len(self._rbuf)
            if self._sock is not None:
                if deadline is not None:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        raise RpcTimeout(
                            f"recv timed out mid-frame "
                            f"({len(self._rbuf)}/{n} B)"
                            if self._rbuf else "recv timed out")
                    self._sock.settimeout(min(remaining, _POLL_S * 4))
                else:
                    self._sock.settimeout(_POLL_S * 4)
                try:
                    chunk = self._sock.recv(max(want, 65536))
                except socket.timeout:
                    continue  # loop re-checks the deadline at the top
                except (ConnectionError, OSError) as e:
                    self.close()
                    raise ConnectionLost(f"recv failed: {e}",
                                         torn=bool(self._rbuf))
            elif self._rfd is not None:
                if deadline is not None:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        raise RpcTimeout(
                            f"recv timed out mid-frame "
                            f"({len(self._rbuf)}/{n} B)"
                            if self._rbuf else "recv timed out")
                    ready, _, _ = select.select(
                        [self._rfd], [], [], min(remaining, _POLL_S * 4))
                    if not ready:
                        continue
                try:
                    chunk = os.read(self._rfd, max(want, 65536))
                except OSError as e:
                    self.close()
                    raise ConnectionLost(f"read failed: {e}",
                                         torn=bool(self._rbuf))
            else:
                try:
                    chunk = self._rfile.read(want)
                except (ValueError, OSError) as e:
                    self.close()
                    raise ConnectionLost(f"read failed: {e}",
                                         torn=bool(self._rbuf))
            if not chunk:
                self.close()
                raise ConnectionLost(
                    f"torn frame: EOF after {len(self._rbuf)}/{n} B"
                    if self._rbuf else "connection closed",
                    torn=bool(self._rbuf))
            self._rbuf += chunk

    def _take(self, n: int) -> bytes:
        out = bytes(self._rbuf[:n])
        del self._rbuf[:n]
        return out

    # -- frames --------------------------------------------------------------
    def send_frame(self, ftype: int, rid: int, payload: bytes) -> None:
        if len(payload) > self.max_frame_bytes:
            raise ProtocolError(
                f"refusing to send oversized frame: {len(payload)} B > "
                f"max_frame_bytes {self.max_frame_bytes}")
        data = pack_frame(ftype, rid, payload)
        if self.chaos is not None:
            action = self.chaos.check(sending=True)
            if action == "drop":
                self.close()
                raise ConnectionLost("connection dropped (injected)")
            if action == "partial":
                # ship a frame prefix so the PEER sees a torn frame, then die
                self._raw_send(data[:max(1, len(data) // 2)])
                self.close()
                raise ConnectionLost("partial write (injected)")
        self._raw_send(data)

    def send_json(self, ftype: int, rid: int, obj: Dict[str, Any]) -> None:
        self.send_frame(ftype, rid, _json_bytes(obj))

    def recv_frame(self, timeout: Optional[float] = None) -> Frame:
        """One complete frame, validated.  Raises :class:`RpcTimeout` when
        nothing arrives in ``timeout`` seconds, :class:`ConnectionLost` on
        EOF/torn frames, :class:`ProtocolError` on corrupt ones."""
        if self.chaos is not None:
            action = self.chaos.check(sending=False)
            if action == "drop":
                self.close()
                raise ConnectionLost("connection dropped (injected)")
        deadline = None if timeout is None else time.monotonic() + timeout
        self._fill_rbuf(HEADER_BYTES, deadline)
        magic, version, ftype, _flags, rid, length, crc = _HEADER.unpack(
            self._rbuf[:HEADER_BYTES])
        # header validation BEFORE consuming/buffering the payload: corrupt
        # or oversized lengths must never drive the accumulator
        if magic != MAGIC:
            raise ProtocolError(f"bad magic {magic!r} (want {MAGIC!r})")
        if version != PROTO_VERSION:
            raise ProtocolError(
                f"protocol version mismatch: peer speaks v{version}, "
                f"this side v{PROTO_VERSION}")
        if ftype not in _FRAME_NAMES:
            raise ProtocolError(f"unknown frame type {ftype}")
        if length > self.max_frame_bytes:
            raise ProtocolError(
                f"oversized frame: {length} B > max_frame_bytes "
                f"{self.max_frame_bytes}")
        self._fill_rbuf(HEADER_BYTES + length, deadline)
        self._take(HEADER_BYTES)
        payload = self._take(length)
        if zlib.crc32(payload) != crc:
            raise ProtocolError(
                f"checksum mismatch on {_FRAME_NAMES[ftype]} frame "
                f"rid={rid}")
        return Frame(ftype, rid, payload)

    def close(self) -> None:
        if self.closed:
            return
        self.closed = True
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass


# -- handshake ----------------------------------------------------------------
RPC_CHANNEL = "rpc"
HEARTBEAT_CHANNEL = "heartbeat"
METRICS_CHANNEL = "metrics"


def client_handshake(stream: FrameStream, channel: str,
                     timeout: float = 10.0,
                     extra: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    """HELLO -> HELLO_ACK.  ``extra`` rides the HELLO payload (the RPC
    client's ``client_nonce`` — the server scopes its exactly-once reply
    cache to it, so a RESTARTED client whose request-id counter starts
    over is never answered from a previous client's stale replies).
    Returns the worker's identity dict (pid, worker index, start nonce) —
    the router checks the nonce to notice a restarted process wearing an
    old address."""
    stream.send_json(FT_HELLO, 0, {**(extra or {}), "version": PROTO_VERSION,
                                   "channel": channel})
    f = stream.recv_frame(timeout)
    if f.ftype == FT_ERROR:
        err = f.json()
        raise ProtocolError(
            f"handshake refused: {err.get('kind')}: {err.get('detail')}")
    if f.ftype != FT_HELLO_ACK:
        raise ProtocolError(f"expected HELLO_ACK, got {f.name}")
    meta = f.json()
    if meta.get("version") != PROTO_VERSION:
        raise ProtocolError(
            f"protocol version mismatch: worker speaks "
            f"v{meta.get('version')}, this side v{PROTO_VERSION}")
    return meta.get("identity", {})


def server_handshake(stream: FrameStream, identity: Dict[str, Any],
                     timeout: float = 10.0) -> Dict[str, Any]:
    """Recv HELLO, reply HELLO_ACK (or a typed ERROR on version skew).
    Returns the client's HELLO meta (``channel`` guaranteed present)."""
    f = stream.recv_frame(timeout)
    if f.ftype != FT_HELLO:
        stream.send_json(FT_ERROR, f.rid, {
            "kind": "protocol_error",
            "detail": f"expected HELLO, got {f.name}"})
        raise ProtocolError(f"expected HELLO, got {f.name}")
    meta = f.json()
    if meta.get("version") != PROTO_VERSION:
        stream.send_json(FT_ERROR, f.rid, {
            "kind": "version_mismatch",
            "detail": f"worker speaks v{PROTO_VERSION}, client sent "
                      f"v{meta.get('version')}"})
        raise ProtocolError(
            f"client protocol version {meta.get('version')} != "
            f"{PROTO_VERSION}")
    meta.setdefault("channel", RPC_CHANNEL)
    stream.send_json(FT_HELLO_ACK, f.rid,
                     {"version": PROTO_VERSION, "identity": identity})
    return meta


def dial(host: str, port: int, channel: str,
         connect_timeout: float = 10.0,
         max_frame_bytes: int = DEFAULT_MAX_FRAME_BYTES,
         chaos: Optional[ChaosLink] = None,
         hello_extra: Optional[Dict[str, Any]] = None
         ) -> Tuple[FrameStream, Dict]:
    """Connect + handshake one channel to a worker.  Returns
    ``(stream, identity)``."""
    try:
        sock = socket.create_connection((host, port), timeout=connect_timeout)
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
    except OSError as e:
        raise ConnectionLost(f"connect to {host}:{port} failed: {e}")
    stream = FrameStream(sock, max_frame_bytes=max_frame_bytes, chaos=chaos)
    try:
        identity = client_handshake(stream, channel, timeout=connect_timeout,
                                    extra=hello_extra)
    except TransportError:
        stream.close()
        raise
    return stream, identity


# -- KV-handoff payload codec -------------------------------------------------
# the handoff's leaves: pool pages (fp32 / fp16 / bf16 / fp8), int8 codes,
# fp8 codes as bytes, fp32 scales.  bf16 and fp8 are numpy's ambiguous void
# types without ml_dtypes ('<V2', '|V1'): they go by name, which JAX's
# ``np.dtype(name)`` resolves whenever ml_dtypes is loaded
_NAMED_DTYPES = {"bfloat16": torch.bfloat16, "float8_e4m3fn": torch.float8_e4m3fn}
# the others: numpy's ``.str``, as JAX writes it
_NUMPY_DTYPES = {
    np.dtype(np.float32): torch.float32, np.dtype(np.float16): torch.float16,
    np.dtype(np.int8): torch.int8, np.dtype(np.uint8): torch.uint8,
}
_WIRE_NAMES = {**{t: d.str for d, t in _NUMPY_DTYPES.items()},
               **{t: n for n, t in _NAMED_DTYPES.items()}}


def wire_dtype(dtype: torch.dtype) -> str:
    """The handoff's wire string of a torch dtype: numpy's ``.str`` where
    numpy knows the type (``'<f4'``, ``'|i1'``), the name otherwise
    (``'bfloat16'``, ``'float8_e4m3fn'``)."""
    try:
        return _WIRE_NAMES[dtype]
    except KeyError:
        raise ProtocolError(f"dtype {dtype} has no handoff wire form")


def torch_dtype(name: str) -> torch.dtype:
    """Inverse of :func:`wire_dtype`.  A void type (``'<V2'``: what numpy
    without ml_dtypes writes for bf16 or fp8) is ambiguous and refused,
    typed — never guessed as fp16."""
    if name in _NAMED_DTYPES:
        return _NAMED_DTYPES[name]
    try:
        d = np.dtype(name)
    except TypeError as e:
        raise ProtocolError(f"unknown handoff dtype {name!r}: {e}")
    if d.kind == "V":
        raise ProtocolError(
            f"ambiguous handoff dtype {name!r}: a void type (numpy's form of "
            "bf16 / fp8 without ml_dtypes); the wire names such leaves "
            "('bfloat16', 'float8_e4m3fn')")
    if d not in _NUMPY_DTYPES:
        raise ProtocolError(f"unsupported handoff dtype {name!r}")
    return _NUMPY_DTYPES[d]


def tensor_bytes(t: torch.Tensor) -> bytes:
    """A tensor's bytes in C order (a bf16 or fp8 tensor through a byte
    view: ``.numpy()`` cannot take those types)."""
    flat = t.detach().cpu().contiguous().reshape(-1)
    return flat.view(torch.uint8).numpy().tobytes()


def tensor_from_bytes(blob: bytes, dtype: torch.dtype, shape) -> torch.Tensor:
    """Inverse of :func:`tensor_bytes`: a writable CPU tensor of ``shape``."""
    n = 1
    for d in shape:
        n *= int(d)
    size = torch.empty((), dtype=dtype).element_size()
    if len(blob) != n * size:
        raise ValueError(f"{len(blob)} B for {n} x {dtype} ({n * size} B)")
    if n == 0:
        return torch.empty(tuple(shape), dtype=dtype)
    return torch.frombuffer(bytearray(blob), dtype=dtype).reshape(tuple(shape))


def encode_handoff(ho) -> Tuple[Dict[str, Any], List[bytes]]:
    """Serialize a :class:`serving.handoff.KVHandoff` into a JSON-able meta
    dict + binary blobs (one or two per pool leaf: quantized payload, then
    scales when the format carries them).  ``wire_bytes`` stays the qcomm
    payload accounting — byte-exact with the in-process handoff counter.
    The meta and blobs equal JAX's for every dtype numpy knows."""
    meta: Dict[str, Any] = {
        "uid": ho.uid, "tokens": list(ho.tokens), "n_ctx": ho.n_ctx,
        "n_pages": ho.n_pages, "fmt": ho.fmt, "wire_bytes": ho.wire_bytes,
        "leaves": [],
    }
    blobs: List[bytes] = []
    for q, s, shape, dtype in ho.payloads:
        leaf = {
            "shape": [int(d) for d in shape], "dtype": wire_dtype(dtype),
            "qshape": list(q.shape), "qdtype": wire_dtype(q.dtype),
            "scales": s is not None,
        }
        blobs.append(tensor_bytes(q))
        if s is not None:
            leaf["sshape"] = list(s.shape)
            leaf["sdtype"] = wire_dtype(s.dtype)
            blobs.append(tensor_bytes(s))
        meta["leaves"].append(leaf)
    return meta, blobs


def decode_handoff(meta: Dict[str, Any], blobs: Sequence[bytes]):
    """Inverse of :func:`encode_handoff` — rebuilds the ``KVHandoff`` (CPU
    tensors) from wire bytes.  Raises :class:`ProtocolError` on any
    shape/count/dtype skew (a half-shipped handoff must never scatter into
    a pool)."""
    from .handoff import KVHandoff

    payloads = []
    it = iter(blobs)
    try:
        for leaf in meta["leaves"]:
            q = tensor_from_bytes(next(it), torch_dtype(leaf["qdtype"]),
                                  leaf["qshape"])
            s = None
            if leaf["scales"]:
                s = tensor_from_bytes(next(it), torch_dtype(leaf["sdtype"]),
                                      leaf["sshape"])
            payloads.append((q, s, tuple(leaf["shape"]),
                             torch_dtype(leaf["dtype"])))
    except (StopIteration, KeyError, ValueError, TypeError, RuntimeError) as e:
        raise ProtocolError(f"malformed handoff payload: {e}")
    if next(it, None) is not None:
        raise ProtocolError("trailing handoff blobs (count mismatch)")
    return KVHandoff(
        uid=int(meta["uid"]), tokens=[int(t) for t in meta["tokens"]],
        n_ctx=int(meta["n_ctx"]), n_pages=int(meta["n_pages"]),
        fmt=str(meta["fmt"]), payloads=payloads,
        wire_bytes=int(meta["wire_bytes"]),
    )


# -- RPC client ---------------------------------------------------------------
class RpcClient:
    """Single-owner (router-thread) RPC endpoint for one worker.

    Every call carries a fresh request id and an absolute deadline.  On a
    dropped connection the client reconnects with bounded exponential
    backoff + deterministic jitter and RE-SENDS the same request id — the
    server's exactly-once reply cache makes the retry safe for mutating
    ops.  ``post``/``wait`` expose the pipelined half: several requests may
    be outstanding and responses interleave in any order (matched by id).
    ``abort`` hooks (the heartbeat lease) turn a wait into a typed
    :class:`WorkerDead` without burning the whole deadline."""

    def __init__(self, dial_fn: Callable[[], Tuple[FrameStream, Dict]],
                 deadline_ms: float = 120_000.0, max_attempts: int = 5,
                 backoff_ms: float = 10.0, backoff_max_ms: float = 250.0,
                 jitter_seed: int = 0,
                 max_frame_bytes: int = DEFAULT_MAX_FRAME_BYTES):
        self._dial = dial_fn
        self.max_frame_bytes = int(max_frame_bytes)
        self.deadline_ms = float(deadline_ms)
        self.max_attempts = int(max_attempts)
        self.backoff_ms = float(backoff_ms)
        self.backoff_max_ms = float(backoff_max_ms)
        self._rng = random.Random(jitter_seed)
        # the exactly-once scope: the server keys its reply cache to this
        # nonce, so a NEW client whose rid counter restarts at 1 can never
        # be answered from a previous client's cached replies.  (Reconnects
        # of THIS client re-present the same nonce and keep the cache.)
        self.nonce = f"{os.getpid():x}-{random.getrandbits(48):x}"
        self._stream: Optional[FrameStream] = None
        self.identity: Optional[Dict[str, Any]] = None
        self._rid = 0
        # rid -> (op json, blobs, needs_send) for every un-answered request
        self._inflight: Dict[int, Tuple[Dict, Tuple[bytes, ...], bool]] = {}
        self._replies: Dict[int, Tuple[Dict, List[bytes]]] = {}
        self.dead = False

    # -- connection ----------------------------------------------------------
    def connect(self) -> Dict[str, Any]:
        if self._stream is None:
            self._stream, self.identity = self._dial()
            # a reconnect must re-send every outstanding request
            for rid, (op, blobs, _need) in list(self._inflight.items()):
                self._inflight[rid] = (op, blobs, True)
        return self.identity or {}

    def _drop_stream(self) -> None:
        s, self._stream = self._stream, None
        if s is not None:
            s.close()

    def close(self) -> None:
        self.dead = True
        self._drop_stream()
        self._inflight.clear()
        self._replies.clear()

    # -- requests ------------------------------------------------------------
    def post(self, op: Dict[str, Any],
             blobs: Sequence[bytes] = ()) -> int:
        """Send one request, non-blocking beyond the write itself.  Returns
        the request id for :meth:`wait`.  A failed send is remembered and
        retried by ``wait`` — posting never raises on transient errors.
        Oversized payloads are refused HERE, typed, before any byte is
        sent: a locally-impossible request must neither condemn a healthy
        worker nor desynchronize the stream by announcing blobs it can
        never deliver."""
        for blob in blobs:
            if len(blob) > self.max_frame_bytes:
                raise ProtocolError(
                    f"request blob of {len(blob)} B exceeds max_frame_bytes "
                    f"{self.max_frame_bytes}; not sending")
        if len(_json_bytes(op)) + 64 > self.max_frame_bytes:
            raise ProtocolError(
                "request body exceeds max_frame_bytes; not sending")
        self._rid += 1
        rid = self._rid
        self._inflight[rid] = (op, tuple(blobs), True)
        try:
            self._send_one(rid)
        except TransportError:
            pass  # wait() owns the retry loop
        return rid

    def _send_one(self, rid: int) -> None:
        op, blobs, _need = self._inflight[rid]
        self.connect()
        try:
            self._stream.send_json(
                FT_REQUEST, rid,
                {**op, "blobs": len(blobs), "_cn": self.nonce})
            for blob in blobs:
                self._stream.send_frame(FT_BLOB, rid, blob)
        except TransportError as e:
            if isinstance(e, ConnectionLost):
                self._drop_stream()
            raise
        self._inflight[rid] = (op, blobs, False)

    def _recv_into_replies(self, timeout: float,
                           deadline: Optional[float] = None) -> None:
        """Read one response (+ its blobs) into the reply map."""
        f = self._stream.recv_frame(timeout)
        if f.ftype == FT_ERROR:
            err = f.json()
            raise ProtocolError(
                f"worker protocol error: {err.get('kind')}: "
                f"{err.get('detail')}")
        if f.ftype != FT_RESPONSE:
            raise ProtocolError(f"expected RESPONSE, got {f.name}")
        reply = f.json()
        blobs: List[bytes] = []
        for _ in range(int(reply.get("blobs", 0))):
            # continuation blobs follow the response immediately; give them
            # a generous window (MBs of KV pages) still clamped to the
            # caller's deadline so a stalled worker can't pin the wait
            budget = 10.0
            if deadline is not None:
                budget = min(budget, max(deadline - time.monotonic(), 0.05))
            try:
                bf = self._stream.recv_frame(timeout=budget)
            except RpcTimeout:
                # mid-REPLY timeout: the response is consumed but its blobs
                # are not — a plain retry would read the leftover blobs as
                # the NEXT reply.  Drop the stream so the retry reconnects
                # and the server's reply cache re-sends the whole thing.
                self._drop_stream()
                raise ConnectionLost(
                    f"timed out mid-reply for rid {f.rid}; reconnecting")
            if bf.ftype != FT_BLOB or bf.rid != f.rid:
                raise ProtocolError(
                    f"expected BLOB for rid {f.rid}, got {bf.name} "
                    f"rid={bf.rid}")
            blobs.append(bf.payload)
        if f.rid in self._inflight:  # stale/duplicate replies are dropped
            del self._inflight[f.rid]
            self._replies[f.rid] = (reply, blobs)

    def wait(self, rid: int, deadline_ms: Optional[float] = None,
             abort: Optional[Callable[[], Any]] = None
             ) -> Tuple[Dict[str, Any], List[bytes]]:
        """Block until ``rid``'s response arrives.  Transient transport
        failures reconnect + re-send under the backoff policy; the deadline
        and ``abort`` hook bound the total wait.  Raises
        :class:`WorkerDead` when the worker is given up on."""
        if self.dead:
            raise WorkerDead("rpc client already closed")
        deadline = time.monotonic() + (
            (deadline_ms if deadline_ms is not None else self.deadline_ms)
            / 1e3)
        attempts = 0
        while True:
            if rid in self._replies:
                return self._replies.pop(rid)
            if abort is not None and abort():
                raise WorkerDead(f"aborted wait for rid {rid}: {abort()}")
            now = time.monotonic()
            if now >= deadline:
                raise WorkerDead(
                    f"rpc deadline exceeded waiting for rid {rid}")
            try:
                self.connect()
                _op, _blobs, need = self._inflight.get(rid, (None, (), False))
                if need:
                    self._send_one(rid)
                self._recv_into_replies(min(_POLL_S, deadline - now),
                                        deadline=deadline)
            except RpcTimeout:
                continue  # slow worker or partition: the deadline decides
            except ConnectionLost:
                attempts += 1
                if attempts >= self.max_attempts:
                    raise WorkerDead(
                        f"connection lost {attempts} times waiting for "
                        f"rid {rid}; retry budget exhausted")
                self._drop_stream()
                if rid in self._inflight:
                    op, blobs, _need = self._inflight[rid]
                    self._inflight[rid] = (op, blobs, True)
                self._backoff(attempts, deadline)
            except ProtocolError as e:
                raise WorkerDead(f"protocol failure: {e}")

    def _backoff(self, attempt: int, deadline: float) -> None:
        """Bounded exponential backoff with deterministic jitter, clamped
        to the remaining deadline."""
        base = min(self.backoff_ms * (2 ** (attempt - 1)),
                   self.backoff_max_ms) / 1e3
        pause = base * (0.5 + 0.5 * self._rng.random())
        pause = min(pause, max(deadline - time.monotonic(), 0.0))
        if pause > 0:
            time.sleep(pause)

    def call(self, op: Dict[str, Any], blobs: Sequence[bytes] = (),
             deadline_ms: Optional[float] = None,
             abort: Optional[Callable[[], Any]] = None
             ) -> Tuple[Dict[str, Any], List[bytes]]:
        return self.wait(self.post(op, blobs), deadline_ms=deadline_ms,
                         abort=abort)


# -- heartbeat monitor --------------------------------------------------------
class _HbTarget:
    __slots__ = ("stream", "redial", "last_ack", "expired", "seq", "misses",
                 "next_redial", "offset_s", "offset_err_s", "rtt_s")

    def __init__(self, stream, now: float, redial=None):
        self.stream = stream
        self.redial = redial  # () -> FrameStream: reconnect a dropped channel
        self.last_ack = now
        self.expired = False
        self.seq = 0
        self.misses = 0
        self.next_redial = 0.0  # throttle: a dead peer's redial blocks ~the
        # connect timeout, and the single monitor thread must not spend
        # every cycle inside it
        # clock-offset estimate from PONG timestamps (None until one ack
        # carried a remote ts); the minimum-RTT sample wins — its midpoint
        # has the tightest error bound (<= RTT/2)
        self.offset_s: Optional[float] = None
        self.offset_err_s: Optional[float] = None
        self.rtt_s: Optional[float] = None


class HeartbeatMonitor:
    """One background thread pinging every watched worker on its dedicated
    heartbeat channel.  The lease state (``last_ack`` per worker) lives
    under ``self._lock``; every socket ping happens with NO lock held —
    the monitor snapshots its targets under the lock, does I/O outside it,
    then folds the results back in (no blocking call under a lock).  ``lease_expired(i)`` is the router's death oracle."""

    def __init__(self, interval_ms: float = 50.0, lease_ms: float = 1000.0,
                 clock: Callable[[], float] = time.monotonic):
        self.interval_s = float(interval_ms) / 1e3
        self.lease_s = float(lease_ms) / 1e3
        self.clock = clock
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._targets: Dict[int, _HbTarget] = {}
        self._thread: Optional[threading.Thread] = None

    # -- state surface (usable without the thread: tests drive these) -------
    def watch(self, endpoint: int, stream: Optional[FrameStream] = None,
              redial=None) -> None:
        """Track ``endpoint``.  ``redial`` (optional) reconnects a dropped
        heartbeat channel — without it one transient connection drop would
        silence a healthy worker into lease expiry."""
        tgt = _HbTarget(stream, self.clock(), redial=redial)
        with self._lock:
            self._targets[int(endpoint)] = tgt

    def unwatch(self, endpoint: int) -> None:
        with self._lock:
            tgt = self._targets.pop(int(endpoint), None)
        if tgt is not None and tgt.stream is not None:
            tgt.stream.close()

    def note_ack(self, endpoint: int) -> None:
        now = self.clock()
        with self._lock:
            tgt = self._targets.get(int(endpoint))
            if tgt is not None and not tgt.expired:
                tgt.last_ack = now
                tgt.misses = 0

    def note_miss(self, endpoint: int) -> None:
        """A ping went unanswered; expire the lease once the silence
        outlives it AND at least two attempts actually failed — pure
        monitor-side scheduling delay (one slow peer's redial starving the
        shared ping loop) must never expire a worker that was simply not
        asked.  Expiry LATCHES — a zombie ack after expiry must not
        resurrect a worker the router already replayed."""
        now = self.clock()
        with self._lock:
            tgt = self._targets.get(int(endpoint))
            if tgt is None:
                return
            tgt.misses += 1
            if tgt.misses >= 2 and now - tgt.last_ack > self.lease_s:
                tgt.expired = True

    def note_clock(self, endpoint: int, t_send: float, t_recv: float,
                   remote_ts: float) -> None:
        """Fold one timestamped PONG into the worker's clock-offset
        estimate: ``offset = remote_ts - (t_send + t_recv) / 2`` — the
        remote stamped its reply somewhere inside the local round trip, so
        the RTT midpoint is the unbiased estimate and the error is bounded
        by RTT/2.  The minimum-RTT sample wins (tightest bound).  Pure
        state under the lock; drivable with fake timestamps in tests."""
        rtt = max(float(t_recv) - float(t_send), 0.0)
        offset = float(remote_ts) - (float(t_send) + float(t_recv)) / 2.0
        with self._lock:
            tgt = self._targets.get(int(endpoint))
            if tgt is None:
                return
            if tgt.rtt_s is None or rtt <= tgt.rtt_s:
                tgt.rtt_s = rtt
                tgt.offset_s = offset
                tgt.offset_err_s = rtt / 2.0

    def clock_offset(self, endpoint: int) -> Optional[Tuple[float, float]]:
        """``(offset_s, error_bound_s)`` mapping the worker's clock onto
        the local one (``local_ts ~= remote_ts - offset_s``), or None
        before any timestamped ack arrived.  The fleet trace stitcher
        shifts a worker's span timestamps by this."""
        with self._lock:
            tgt = self._targets.get(int(endpoint))
            if tgt is None or tgt.offset_s is None:
                return None
            return (tgt.offset_s, tgt.offset_err_s)

    def lease_expired(self, endpoint: int) -> bool:
        now = self.clock()
        with self._lock:
            tgt = self._targets.get(int(endpoint))
            if tgt is None:
                return False
            if not tgt.expired and tgt.misses >= 2 \
                    and now - tgt.last_ack > self.lease_s:
                tgt.expired = True
            return tgt.expired

    def snapshot(self) -> Dict[int, Dict[str, Any]]:
        now = self.clock()
        with self._lock:
            return {
                ep: {"age_s": now - t.last_ack, "expired": t.expired,
                     "misses": t.misses, "offset_s": t.offset_s,
                     "rtt_s": t.rtt_s}
                for ep, t in self._targets.items()
            }

    # -- the thread ----------------------------------------------------------
    def start(self) -> None:
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._run, name="dstpu-heartbeat", daemon=True)
            self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=5.0)
            self._thread = None
        with self._lock:
            targets = list(self._targets.values())
            self._targets.clear()
        for tgt in targets:
            if tgt.stream is not None:
                tgt.stream.close()

    def _ping_targets(self) -> List[Tuple[int, Any, int, Any, float]]:
        with self._lock:
            return [(ep, t.stream, t.seq, t.redial, t.next_redial)
                    for ep, t in self._targets.items()
                    if not t.expired and (t.stream is not None
                                          or t.redial is not None)]

    def _bump_seq(self, endpoint: int) -> None:
        with self._lock:
            tgt = self._targets.get(endpoint)
            if tgt is not None:
                tgt.seq += 1

    def _set_stream(self, endpoint: int, stream) -> None:
        now = self.clock()
        with self._lock:
            tgt = self._targets.get(endpoint)
            if tgt is not None:
                tgt.stream = stream
                # throttle the next redial: a genuinely-partitioned peer's
                # connect attempt blocks for the dial timeout, and the ONE
                # monitor thread must keep pinging everyone else (a starved
                # ping must never read as a dead worker)
                tgt.next_redial = now + max(self.interval_s * 4, 0.2)

    def _run(self) -> None:
        while not self._stop.wait(self.interval_s):
            for ep, stream, seq, redial, next_redial in self._ping_targets():
                if stream is None or stream.closed:
                    if redial is None or self.clock() < next_redial:
                        self._bump_seq(ep)
                        self.note_miss(ep)
                        continue
                    # a dropped heartbeat CHANNEL is not a dead worker:
                    # reconnect (outside any lock) before charging a miss
                    try:
                        stream = redial()
                    except TransportError:
                        stream = None
                    self._set_stream(ep, stream)
                if stream is None:
                    self._bump_seq(ep)
                    self.note_miss(ep)
                    continue
                pong = self._ping(stream, seq)
                self._bump_seq(ep)
                if pong is not None:
                    self.note_ack(ep)
                    if pong.get("ts") is not None:
                        self.note_clock(ep, pong["_t_send"], pong["_t_recv"],
                                        float(pong["ts"]))
                else:
                    self.note_miss(ep)

    def _ping(self, stream: FrameStream, seq: int) -> Optional[Dict[str, Any]]:
        """One ping/ack exchange on the heartbeat channel.  Returns the
        PONG payload (with local ``_t_send``/``_t_recv`` perf-clock stamps
        bracketing the round trip, for the clock-offset estimate) or None
        on a miss.  NO locks held here — socket I/O and the lease state
        never share a critical section."""
        try:
            t_send = time.perf_counter()
            stream.send_json(FT_PING, seq, {"seq": seq})
            deadline = time.monotonic() + max(self.interval_s * 2, 0.05)
            while True:
                f = stream.recv_frame(max(deadline - time.monotonic(), 0.01))
                if f.ftype == FT_PONG and f.rid >= seq:
                    t_recv = time.perf_counter()
                    break
                if time.monotonic() >= deadline:
                    return None
        except (TransportError, OSError):
            # OSError: the stream was closed under the ping (its socket's
            # settimeout raises EBADF): a miss, never the thread's end
            return None
        chaos = stream.chaos
        if chaos is not None and chaos.heartbeat_lost():
            return None  # the ack was "lost on the wire"
        try:
            payload = f.json()
        except ProtocolError:
            payload = {}
        payload["_t_send"] = t_send
        payload["_t_recv"] = t_recv
        return payload


# -- worker-side server -------------------------------------------------------
class MetricsChannel:
    """Collector-owned pull channel to one worker — the third channel kind
    (rpc = router thread, heartbeat = monitor thread, metrics = collector
    thread), so a fleet poll never contends with the engine-owner RPC loop
    and channel ownership stays one-thread-one-socket.  Failures degrade
    to ``None`` — the heartbeat lease owns death discovery; a missed pull
    is just a sparser sample — and the next pull redials."""

    def __init__(self, dial_fn: Callable[[], FrameStream]):
        self._dial = dial_fn
        self._stream: Optional[FrameStream] = None
        self._rid = 0

    def pull(self, spans: bool = False,
             timeout: float = 5.0) -> Optional[Dict[str, Any]]:
        """One ``metrics_pull`` round trip: the worker's mergeable registry
        state (+ drained span events when ``spans``), or None on any
        transport failure.  Idempotent read — no retry machinery, no
        exactly-once cache (a fresher snapshot is strictly better than a
        replayed stale one)."""
        self._rid += 1
        try:
            if self._stream is None or self._stream.closed:
                self._stream = self._dial()
            self._stream.send_json(FT_REQUEST, self._rid,
                                   {"op": "metrics_pull",
                                    "spans": bool(spans)})
            while True:
                f = self._stream.recv_frame(timeout=timeout)
                if f.ftype == FT_ERROR:
                    return None
                if f.ftype == FT_RESPONSE and f.rid == self._rid:
                    reply = f.json()
                    return reply if reply.get("ok") else None
                # stale reply from an earlier abandoned pull: skip it
        except (TransportError, ProtocolError):
            stream, self._stream = self._stream, None
            if stream is not None:
                stream.close()
            return None

    def close(self) -> None:
        stream, self._stream = self._stream, None
        if stream is not None:
            stream.close()


class WorkerServer:
    """The worker process half: serves the framed RPC protocol over a
    listening socket (``serve_socket``) or a single binary stream pair —
    the hardened ``serve_worker_main`` stdio mode (``serve_stream``).

    The engine is single-owner: every op that touches it runs on the one
    RPC-serving thread.  Heartbeat channels are answered by tiny dedicated
    threads that read only ``self._load`` (a snapshot the RPC thread
    refreshes under ``self._lock``) — never the engine.  Metrics channels
    likewise get their own threads reading only the lock-guarded telemetry
    state, so a fleet pull can never block (or be blocked by) a tick.  An
    exactly-once reply cache keyed by request id makes client retries
    after lost responses safe for mutating ops.

    The cache holds at most ``reply_cache_size`` replies and
    ``reply_cache_bytes`` bytes of their blobs; the oldest replies go first
    until both caps hold, and the reply just stored always stays (a retry
    of it must find it).  The byte cap is what bounds host memory: a
    cached ``extract`` keeps its handoff pages, and one 512-token bf16
    handoff of the 24-layer 410M model (2 kv heads, head_dim 128) is
    12,582,912 B, so the default 256 MiB keeps about 21 of them where the
    count cap alone would let 4,096 take about 50 GB.  A retried id whose
    reply was evicted, by either cap, executes again, as one evicted by
    count always did."""

    def __init__(self, engine, max_frame_bytes: int = DEFAULT_MAX_FRAME_BYTES,
                 reply_cache_size: int = 4096,
                 identity: Optional[Dict[str, Any]] = None,
                 reply_cache_bytes: int = 256 << 20):
        self.engine = engine
        self.scheduler = engine.scheduler
        # stashed for the metrics-channel threads: telemetry state is
        # internally lock-guarded (safe cross-thread), and going through
        # this alias keeps the single-owner engine object itself out of
        # thread-target bodies
        self._telemetry = getattr(engine, "telemetry", None)
        self.max_frame_bytes = int(max_frame_bytes)
        self._lock = threading.Lock()
        self._load: Dict[str, Any] = {}
        self._replies: "OrderedDict[int, Tuple[Dict, List[bytes]]]" = \
            OrderedDict()
        self._reply_cache_size = int(reply_cache_size)
        self._reply_cache_cap_bytes = int(reply_cache_bytes)
        self._reply_bytes = 0  # blob bytes the cache holds
        self._running = True
        self.identity = dict(identity or {})
        self.identity.setdefault("pid", os.getpid())
        self.identity.setdefault("nonce", random.getrandbits(32))
        # engine geometry the router needs for placement decisions (block
        # hashing, disaggregation threshold default) rides the handshake
        self.identity.setdefault("block_size", int(engine.block_size))
        self.identity.setdefault(
            "disagg_default",
            int(getattr(engine, "prefill_chunk", None)
                or engine.prefill_budget))
        # the reply cache's owner: a handshake presenting a DIFFERENT
        # client nonce clears the cache (request ids are only unique per
        # client; a fresh client must never hit a stale cached reply)
        self._client_nonce: Optional[str] = None
        self._listener: Optional[socket.socket] = None
        # (stream, hello meta) per handshaken rpc connection
        self._rpc_queue: "queue.Queue[Tuple[FrameStream, Dict]]" = \
            queue.Queue()
        self._acceptor_thread: Optional[threading.Thread] = None
        self.port: Optional[int] = None
        self.close_audit: Optional[Dict[str, int]] = None
        self._refresh_load()

    # -- load snapshot (RPC thread writes, heartbeat threads read) -----------
    def _refresh_load(self) -> None:
        eng, sched = self.engine, self.scheduler
        try:
            ttft = float(
                eng.telemetry.request_hists(eng._ns)["ttft"].percentile(50))
        except Exception:
            ttft = 0.0
        load = {
            "queue_depth": len(sched.waiting),
            "running": len(sched._running),
            "headroom_blocks": eng.mgr.allocator.available_blocks,
            "total_blocks": eng.mgr.allocator.total_blocks,
            "shedding": bool(sched.shedding),
            "retry_after_ms": float(sched.retry_after_ms()),
            "prompt_tokens_total": int(eng.mgr.prompt_tokens_total),
            "cached_prompt_tokens": int(eng.mgr.cached_prompt_tokens),
            "ttft_p50_ms": ttft,
        }
        with self._lock:
            self._load = load

    def _load_snapshot(self) -> Dict[str, Any]:
        with self._lock:
            return dict(self._load)

    # -- socket mode ---------------------------------------------------------
    def bind(self, host: str = "127.0.0.1", port: int = 0) -> int:
        self._listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._listener.bind((host, port))
        self._listener.listen(16)
        self._listener.settimeout(0.2)
        self.port = self._listener.getsockname()[1]
        return self.port

    def serve_socket(self) -> None:
        """Accept + serve until a ``close`` op arrives.  RPC connections are
        served one at a time on THIS thread (the engine owner); a dropped
        connection simply waits for the client's reconnect.  Heartbeat
        connections get their own echo threads."""
        if self._listener is None:
            self.bind()
        self._acceptor_thread = threading.Thread(
            target=self._acceptor, name="dstpu-worker-accept", daemon=True)
        self._acceptor_thread.start()
        try:
            while self._running:
                try:
                    stream, _meta = self._rpc_queue.get(timeout=0.2)
                except queue.Empty:
                    continue
                self._serve_rpc(stream, shutdown_on_protocol_error=False)
        finally:
            self.shutdown()

    def _note_client(self, nonce) -> None:
        """Scope the exactly-once reply cache to the requesting client
        (every ``RpcClient`` request carries its ``_cn`` nonce): a NEW
        client — whose request-id counter restarts at 1 — gets a fresh
        cache instead of the previous client's stale replies, while
        reconnects of the same client keep theirs (that is the whole point
        of the cache)."""
        if nonce != self._client_nonce:
            self._replies.clear()
            self._reply_bytes = 0
            self._client_nonce = nonce

    def _acceptor(self) -> None:
        """Accept loop (its own thread): handshake each connection and route
        it by channel.  Touches no engine state."""
        while self._running:
            try:
                sock, _addr = self._listener.accept()
            except socket.timeout:
                continue
            except OSError:
                return  # listener closed: shutting down
            stream = FrameStream(sock, max_frame_bytes=self.max_frame_bytes)
            try:
                meta = server_handshake(stream, self.identity, timeout=10.0)
            except TransportError:
                stream.close()
                continue
            if meta["channel"] == HEARTBEAT_CHANNEL:
                threading.Thread(
                    target=self._serve_heartbeat, args=(stream,),
                    name="dstpu-worker-hb", daemon=True).start()
            elif meta["channel"] == METRICS_CHANNEL:
                threading.Thread(
                    target=self._serve_metrics, args=(stream,),
                    name="dstpu-worker-metrics", daemon=True).start()
            else:
                self._rpc_queue.put((stream, meta))

    def _serve_heartbeat(self, stream: FrameStream) -> None:
        """Echo PING -> PONG with the load snapshot.  Runs on its own
        thread; reads only ``self._load`` (under the lock, no I/O inside),
        so liveness stays observable while the RPC thread computes."""
        while self._running:
            try:
                f = stream.recv_frame(timeout=1.0)
            except RpcTimeout:
                continue
            except TransportError:
                break
            if f.ftype != FT_PING:
                break
            try:
                stream.send_json(FT_PONG, f.rid, {
                    "seq": f.rid, "nonce": self.identity.get("nonce"),
                    "load": self._load_snapshot(),
                    # worker perf-clock reading: the monitor midpoints its
                    # send/recv around this to estimate the clock offset
                    # that stitches this worker's trace events onto the
                    # router's timeline (error <= RTT/2)
                    "ts": time.perf_counter()})
            except TransportError:
                break
        stream.close()

    def _serve_metrics(self, stream: FrameStream) -> None:
        """Serve ``metrics_pull`` on a dedicated thread (one per collector
        connection) so fleet observability never queues behind — or stalls
        — the engine-owner RPC loop.  Touches ONLY thread-safe telemetry
        state: ``export_state`` and the span drain take their own internal
        locks around pure dict building (never the engine, never
        ``self._lock``), so a pull racing a tick sees each metric's
        consistent point-in-time state — exactly the mergeable-export
        contract."""
        tel = self._telemetry
        while self._running:
            try:
                f = stream.recv_frame(timeout=1.0)
            except RpcTimeout:
                continue
            except TransportError:
                break
            if f.ftype != FT_REQUEST:
                break
            try:
                op = f.json()
            except ProtocolError:
                break
            if op.get("op") != "metrics_pull" or tel is None:
                try:
                    stream.send_json(FT_ERROR, f.rid, {
                        "kind": "bad_request",
                        "detail": "metrics channel serves metrics_pull only"})
                except TransportError:
                    break
                continue
            out: Dict[str, Any] = {
                "ok": True, "blobs": 0,
                "metrics": tel.registry.export_state(),
                "ts": time.perf_counter(),
            }
            if op.get("spans"):
                out["events"] = tel.drain_chrome_events()
            try:
                stream.send_json(FT_RESPONSE, f.rid, out)
            except TransportError:
                break
        stream.close()

    # -- stdio mode (the hardened serve_worker_main wire) --------------------
    def serve_stream(self, stream: FrameStream) -> None:
        """Serve ONE framed stream (stdio / pipe worker).  Any protocol
        violation — torn, oversized, junk frame, version skew — answers
        with a typed ERROR frame where the pipe still works, then shuts the
        worker down CLEANLY (audited ``engine.close()``), never an
        unhandled exception."""
        try:
            meta = server_handshake(stream, self.identity)
        except ConnectionLost as e:
            self._stdio_fail(stream, "connection_lost", str(e), e.torn)
            return
        except ProtocolError as e:
            self._stdio_fail(stream, "protocol_error", str(e), True)
            return
        if meta["channel"] != RPC_CHANNEL:
            self._stdio_fail(
                stream, "protocol_error",
                f"stdio worker serves rpc only, got {meta['channel']!r}",
                True)
            return
        self._serve_rpc(stream, shutdown_on_protocol_error=True)
        self.shutdown()

    def _stdio_fail(self, stream: FrameStream, kind: str, detail: str,
                    respond: bool) -> None:
        if respond:
            try:
                stream.send_json(FT_ERROR, 0, {"kind": kind,
                                               "detail": detail})
            except TransportError:
                pass
        self.shutdown()

    # -- the RPC loop --------------------------------------------------------
    def _serve_rpc(self, stream: FrameStream,
                   shutdown_on_protocol_error: bool) -> None:
        while self._running:
            try:
                f = stream.recv_frame(timeout=0.25)
            except RpcTimeout:
                continue
            except ConnectionLost as e:
                if shutdown_on_protocol_error:
                    # stdio peer is gone for good: torn frames get the typed
                    # error (best effort), clean EOF just shuts down
                    self._stdio_fail(stream, "connection_lost", str(e),
                                     respond=e.torn)
                break  # socket mode: await the client's reconnect
            except ProtocolError as e:
                try:
                    stream.send_json(FT_ERROR, 0, {
                        "kind": "protocol_error", "detail": str(e)})
                except TransportError:
                    pass
                if shutdown_on_protocol_error:
                    self.shutdown()
                break
            if f.ftype == FT_PING:  # stdio mode: heartbeats ride the pipe
                try:
                    stream.send_json(FT_PONG, f.rid,
                                     {"seq": f.rid,
                                      "load": self._load_snapshot(),
                                      "ts": time.perf_counter()})
                except TransportError:
                    break
                continue
            if f.ftype != FT_REQUEST:
                try:
                    stream.send_json(FT_ERROR, f.rid, {
                        "kind": "protocol_error",
                        "detail": f"expected REQUEST, got {f.name}"})
                except TransportError:
                    break
                if shutdown_on_protocol_error:
                    self.shutdown()
                    break
                continue
            try:
                ok = self._serve_request(stream, f)
            except TransportError:
                break
            if not ok and shutdown_on_protocol_error:
                self.shutdown()
                break
        stream.close()

    def _serve_request(self, stream: FrameStream, f: Frame) -> bool:
        """Parse, dedupe, dispatch, reply.  Returns False on a payload-level
        protocol violation (junk JSON) after sending the typed error."""
        try:
            op = f.json()
        except ProtocolError as e:
            stream.send_json(FT_ERROR, f.rid,
                            {"kind": "protocol_error", "detail": str(e)})
            return False
        self._note_client(op.pop("_cn", None))
        blobs: List[bytes] = []
        for _ in range(int(op.get("blobs", 0) or 0)):
            bf = stream.recv_frame(timeout=10.0)
            if bf.ftype != FT_BLOB or bf.rid != f.rid:
                stream.send_json(FT_ERROR, f.rid, {
                    "kind": "protocol_error",
                    "detail": f"expected BLOB rid={f.rid}, got {bf.name} "
                              f"rid={bf.rid}"})
                return False
            blobs.append(bf.payload)
        # metrics_pull is EXEMPT from the exactly-once reply cache: a pull
        # is an idempotent read (re-executing a retried pull returns a
        # FRESHER snapshot, which is strictly better than a cached stale
        # one), and caching would pin multi-KB registry payloads in a cache
        # sized for control replies
        no_cache = op.get("op") == "metrics_pull"
        cached = None if no_cache else self._replies.get(f.rid)
        if cached is None:
            reply, rblobs = self._dispatch(op, blobs)
            if not no_cache:
                self._cache_reply(f.rid, reply, rblobs)
        else:
            reply, rblobs = cached
        stream.send_json(FT_RESPONSE, f.rid, {**reply, "blobs": len(rblobs)})
        for blob in rblobs:
            stream.send_frame(FT_BLOB, f.rid, blob)
        return True

    # -- op dispatch (engine owner thread) -----------------------------------
    @staticmethod
    def _submit_result(res) -> Dict[str, Any]:
        return {"uid": res.uid, "reason": res.reason, "detail": res.detail,
                "retry_after_ms": res.retry_after_ms}

    @staticmethod
    def _sampling(op: Dict[str, Any]):
        from ..inference.sampling import SamplingParams

        samp = op.get("sampling") or {}
        return SamplingParams(
            temperature=float(samp.get("temperature", 0.0)),
            top_k=int(samp.get("top_k", 0)),
            top_p=float(samp.get("top_p", 1.0)),
            max_new_tokens=int(samp.get("max_new_tokens", 128)),
            stop_token=(None if samp.get("stop_token") is None
                        else int(samp["stop_token"])),
        )

    def _dispatch(self, op: Dict[str, Any],
                  blobs: List[bytes]) -> Tuple[Dict[str, Any], List[bytes]]:
        """Execute one op.  The worker NEVER dies from a bad op: unknown
        ops and internal failures come back as typed error replies.  A
        kernel or CUDA error (``ops.kernels.surfaces``) comes back as the
        ``kernel`` kind with its text — the client raises it, it is never a
        retryable ``internal`` failure."""
        kind = op.get("op")
        handler = getattr(self, f"_op_{kind}", None) if isinstance(
            kind, str) and not kind.startswith("_") else None
        if handler is None:
            return ({"ok": False, "error": {
                "kind": "bad_request", "detail": f"unknown op {kind!r}"}}, [])
        try:
            out = handler(op, blobs)
        except Exception as e:  # noqa: BLE001 — one bad op must not kill the worker
            kind = "kernel" if surfaces(e) else "internal"
            return ({"ok": False, "error": {
                "kind": kind, "detail": f"{type(e).__name__}: {e}"}}, [])
        finally:
            self._refresh_load()
        if isinstance(out, tuple):
            reply, rblobs = out
        else:
            reply, rblobs = out, []
        return ({"ok": True, **reply, "load": self._load_snapshot()}, rblobs)

    def _op_submit(self, op, blobs):
        res = self.scheduler.try_submit(
            int(op["uid"]), [int(t) for t in op["tokens"]],
            self._sampling(op),
            deadline_ms=op.get("deadline_ms"),
            ttft_deadline_ms=op.get("ttft_deadline_ms"),
        )
        return {"result": self._submit_result(res)}

    def _request_views(self) -> Dict[str, Any]:
        from ..inference.scheduler import DECODE

        reqs = {}
        for uid, req in self.scheduler.requests.items():
            reqs[str(uid)] = {
                "state": req.state, "error": req.error,
                "generated": len(req.generated),
                "cancel_requested": bool(req.cancel_requested),
                "decoding": req.state == DECODE,
            }
        return reqs

    def _op_tick(self, op, blobs):
        self.scheduler.tick()
        return {"requests": self._request_views(),
                "tick_no": self.scheduler.tick_no}

    def _op_step_burst(self, op, blobs):
        """Up to ``n`` scheduler ticks in ONE exactly-once RPC — the wire
        half of megastep decode (the in-engine half fuses each tick's
        decode phase into a device burst).  Ticks run back to back on the
        engine owner thread, stopping early once the scheduler goes idle;
        the reply carries the FINAL request views plus the tick count run,
        and the router demuxes per-token progress off the cumulative
        ``generated`` counts.  Exactly-once replay is unchanged: the whole
        burst is one rid in the reply cache, so a replayed request frame
        returns the cached reply instead of running the ticks again."""
        n = max(1, int(op.get("n", 1)))
        ticks = 0
        for _ in range(n):
            self.scheduler.tick()
            ticks += 1
            if self.scheduler.idle:
                break
        return {"requests": self._request_views(),
                "tick_no": self.scheduler.tick_no, "ticks": ticks}

    def _op_pop(self, op, blobs):
        uid = int(op["uid"])
        req = self.scheduler.requests.get(uid)
        if req is None:
            return {"result": None,
                    "error": {"kind": "not_found", "detail": f"uid {uid}"}}
        state, error = req.state, req.error
        tokens = self.scheduler.pop_result(uid)
        return {"result": {"state": state, "error": error, "tokens": tokens}}

    def _op_cancel(self, op, blobs):
        return {"cancelled": bool(self.scheduler.cancel(int(op["uid"])))}

    def _op_detach(self, op, blobs):
        uid = int(op["uid"])
        migrated = self.scheduler.detach(uid)
        if migrated:
            self.scheduler.pop_result(uid)
        return {"migrated": bool(migrated)}

    def _op_extract(self, op, blobs):
        from . import handoff as handoff_mod

        t0 = time.perf_counter()
        ho = handoff_mod.extract_request(
            self.engine, int(op["uid"]), fmt=str(op.get("fmt", "none")))
        t1 = time.perf_counter()
        meta, hblobs = encode_handoff(ho)
        # this side's share of a migration's time (a JAX client ignores it)
        ms = {"extract": 1e3 * (t1 - t0), "encode": 1e3 * (time.perf_counter() - t1)}
        return {"handoff": meta, "ms": ms}, hblobs

    def _op_adopt(self, op, blobs):
        from . import handoff as handoff_mod

        t0 = time.perf_counter()
        ho = decode_handoff(op["handoff"], blobs)
        ms = {"decode": 1e3 * (time.perf_counter() - t0)}
        res = self.scheduler.adopt_prefilled(
            ho.uid, ho.tokens, n_ctx=ho.n_ctx, sampling=self._sampling(op),
            deadline_ms=op.get("deadline_ms"),
            ttft_deadline_ms=op.get("ttft_deadline_ms"),
        )
        if res.accepted:
            t1 = time.perf_counter()
            try:
                handoff_mod.inject_request(self.engine, ho)
            except Exception:
                # a failed injection must not leave a half-adopted sequence
                self.scheduler.cancel(ho.uid)
                self.scheduler.pop_result(ho.uid)
                raise
            ms["inject"] = 1e3 * (time.perf_counter() - t1)
        return {"result": self._submit_result(res), "ms": ms}

    def _op_stats(self, op, blobs):
        """The engine's and scheduler's counters, plus what only this
        process can see: its kernel launch counts (``ops.kernels.LAUNCHES``
        lives per process), its CUDA ``memory_allocated`` (None on the
        CPU) and the bytes of handoff blobs its reply cache holds."""
        dev = getattr(self.engine, "device", None)
        mem = (torch.cuda.memory_allocated(dev)
               if dev is not None and torch.device(dev).type == "cuda" else None)
        return {"serve": dict(self.engine.stats),
                "sched": dict(self.scheduler.stats),
                "launches": dict(kernels.LAUNCHES),
                "memory_allocated": mem,
                "reply_cache_bytes": self.reply_cache_bytes()}

    def _cache_reply(self, rid: int, reply: Dict, rblobs: List[bytes]) -> None:
        """Store a reply, then evict the oldest until the count and byte
        caps hold; the reply just stored is never evicted."""
        self._replies[rid] = (reply, rblobs)
        self._reply_bytes += sum(len(b) for b in rblobs)
        while len(self._replies) > 1 and (
                len(self._replies) > self._reply_cache_size
                or self._reply_bytes > self._reply_cache_cap_bytes):
            _, (_, old) = self._replies.popitem(last=False)
            self._reply_bytes -= sum(len(b) for b in old)

    def reply_cache_bytes(self) -> int:
        """Blob bytes the exactly-once reply cache holds (a cached
        ``extract`` keeps its handoff pages until the cache evicts it)."""
        return self._reply_bytes

    def _op_apply_knobs(self, op, blobs):
        """Stage a live-retune batch on this worker's scheduler (the wire
        leg of the controller's per-worker knob push).  Validation errors
        surface as the typed error reply like any other bad op; the staged
        values land at the worker's next tick boundary."""
        staged = self.scheduler.apply_knobs(**dict(op.get("knobs") or {}))
        return {"staged": staged, "knobs": self.scheduler.knobs()}

    def _op_metrics_pull(self, op, blobs):
        """Fleet-observability pull: the worker's full MERGEABLE registry
        state (``MetricsRegistry.export_state`` — counters, gauges,
        histogram bucket/sample states) plus, when ``spans`` is set, the
        chrome trace events recorded since the last pull (watermarked
        drain — each batch ships once).  ``ts`` is this process's
        ``perf_counter`` reading so the collector can sanity-check its
        heartbeat-derived clock offset.  Served on the engine owner thread
        here (the stdio/RPC path; socket collectors use the dedicated
        metrics channel instead) — pure host state, no device sync."""
        tel = self._telemetry
        out: Dict[str, Any] = {
            "metrics": tel.registry.export_state(),
            "ts": time.perf_counter(),
        }
        if op.get("spans"):
            out["events"] = tel.drain_chrome_events()
        return out

    def _op_close(self, op, blobs):
        self.close_audit = self.engine.close()
        self._running = False
        return {"audit": self.close_audit}

    # -- teardown ------------------------------------------------------------
    def shutdown(self) -> Dict[str, int]:
        """Idempotent clean shutdown: audited ``engine.close()`` + listener
        teardown.  Returns the zero-leak audit."""
        self._running = False
        listener, self._listener = self._listener, None
        if listener is not None:
            try:
                listener.close()
            except OSError:
                pass
        if self.close_audit is None:
            self.close_audit = self.engine.close()
        return self.close_audit


__all__ = [
    "ChaosLink", "ConnectionLost", "DEFAULT_MAX_FRAME_BYTES", "Frame", "FrameStream",
    "HEARTBEAT_CHANNEL", "HeartbeatMonitor", "METRICS_CHANNEL",
    "MetricsChannel", "PROTO_VERSION",
    "ProtocolError", "RPC_CHANNEL", "RpcClient", "RpcTimeout",
    "TransportError", "WorkerDead", "WorkerServer", "client_handshake",
    "decode_handoff", "dial", "encode_handoff", "pack_frame",
    "server_handshake", "tensor_bytes", "tensor_from_bytes", "torch_dtype",
    "wire_dtype",
]

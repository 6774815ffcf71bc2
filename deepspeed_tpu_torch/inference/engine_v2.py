"""Continuous-batching inference engine — counterpart of
``deepspeed_tpu/inference/engine_v2.py`` (single device).

``put(uids, tokens)`` admits and prefills sequences in packed dispatches
under ``prefill_budget`` tokens (cold packs on the flash kernel, packs that
start past a cached prefix on the packed-context kernel); ``step()`` runs
one batched decode tick over the fixed slot array (paged decode kernel).
With ``enable_speculation`` a tick drafts tokens by prompt lookup
(``speculative.propose``) and verifies every slot's [last token | drafts]
in one forward (``model_runner.verify_packed_ctx``: the packed-context
kernel over mid-page context), then accepts on the device
(``sampling.spec_verify_sample``) with one host read per tick.
Host-side block bookkeeping (``ragged.StateManager``) drives the dispatches
and copy-on-write clones pages in place.  ``scheduler`` builds the
queueing ``ServeScheduler`` on top.

``quantize_weights`` ('int8' | 'fp8' | 'fp6') compresses the big matmul
kernels on the engine's device, one layer slice at a time
(``ops.quantizer.quantize_serving_params``), and every serving matmul then
reads the compressed bytes through the dequant-matmul kernels.

``grid=initialize_mesh(devices=[dev] * S, seq=S), seq_shards=S`` serves
long contexts: the KV pool splits into ``S`` seq-shard slices, a
sequence's pages stripe across them, every pool-reading attention runs per
shard through the kernels' partial modes and merges by log-sum-exp
(``paged.py``), so a prompt bigger than one slice fits as long as the whole
pool does.  The ``S`` shards run in one process on the engine's device.

``step_n(n)`` and the scheduler's megastep (``serve={"decode_megastep":
n}``) run device-resident decode bursts (``_decode_burst``): every page a
burst can touch is reserved first, the decode tick (forward, sampling,
non-finite guard, on-device termination by stop token and emission cap)
runs n times on persistent device tensors with no host read between
ticks, and one fetch at the end returns every row's run.  On CUDA the tick
is captured once as a CUDA graph (``ops.kernels.CapturedGraph``) per
sampling triple and replayed n times; on the CPU the same tick body runs
eagerly n times.  ``step()`` stays an eager tick over the same body.

Telemetry (``telemetry=``: a ``TelemetryConfig``, a bool or a shared
``telemetry.Telemetry``): ``stats`` is a read-through ``StatsView`` over
the engine's claimed ``serve*/`` counters (they count with telemetry off
too); prefill packs, decode and verify ticks and bursts are spans with
histograms (``prefill_pack_ms``, ``decode_tick_ms``, ``spec_tick_ms``,
``burst_tick_ms``, the drafter's ``spec_draft_len`` /
``spec_match_distance``); a prefill pack that samples nothing ends with a
CUDA event the recorder resolves later.  Engines sharing one ``Telemetry``
claim ``serve``, ``serve2``, ... (with paired ``sched*`` / ``comm*``), and
``close()`` releases them.  ``faults=`` takes a seeded
``faults.FaultInjector``: its points fire before every dispatch (a burst
checks once, before its graph replays) and poison rows after the fetch.
``extract_kv_blocks`` / ``inject_kv_blocks`` are the paged-KV handoff's
device halves (``serving/handoff.py``): inject writes the existing pool
tensors in place, so a captured burst graph keeps reading the live pool.
``build_serve_engine`` builds an engine from a ``ServeEngineConfig``.

``grid=`` a ``ProcessGrid`` with a ``model`` axis (``initialize_mesh(
model=tp)`` in each rank of a ``torch.distributed`` world; JAX's
``engine_v2.py:95-130``, ``:186-215``) serves one model split over the
ranks: each keeps its shard of the tree (``TensorParallel.
shard_serving_tree``: the AutoTP layout at head granularity, a GQA model
whose kv heads do not divide the axis keeping the kv head its q heads
read; a quantized tree is quantized whole first, the FP6 row kernels
packed per K-chunk), its pool holds its kv heads, and the runner reduces
the row-parallel partial sums over ``model`` (``quant_comm`` /
``comm_tiles``: the transport, ``comm/qcomm.py``) and gathers the
logits' vocab shards.  The host side (scheduler, allocator, prefix cache)
runs the same on every rank, and every rank samples the same logits with
the same generator, so the ranks draw the same tokens and schedule the
same work.  Refused over a model axis, naming item 7: the batch axis and
``serve_replicas``, seq shards, speculation, decode bursts (``step_n`` /
``decode_megastep`` > 1: a CUDA graph over the collectives), MoE, and the
``serve`` knobs that read a rank's own clock (deadlines, the watchdog:
the ranks' schedulers would decide apart).

Not ported yet, and refused loudly rather than ignored: weight offload,
replica meshes and seq shards on distinct devices
(ROADMAP queue 1 item 7), ``fused_serving=False`` (the JAX jnp-body lever:
on the card that body is a kernel's plain version), and the ``serve``
fields of items 6 and 7 (``config.ServeConfig``).  Every dispatch raises
through to the caller: a kernel that fails to build or launch, or a graph
that fails to capture or replay, is an error, never a failed request or an
eager fallback (the scheduler's guards re-raise it, ``ops.kernels.
surfaces``).
"""
from __future__ import annotations

import logging
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..config.config import ServeConfig, _coerce
from ..models.transformer import TransformerConfig
from ..ops.kernels import CapturedGraph, resolve_device
from ..ops.quantizer import (
    QUANT_TYPES,
    ServingContext,
    map_quant,
    quantize_serving_params,
    tree_nbytes,
)
from ..parallel.topology import BATCH_AXES, Grid, ProcessGrid, normalize_device
from ..telemetry import StatsView, Telemetry, device_ready
from . import model_runner, speculative
from .paged import init_paged_cache
from .ragged import StateManager
from .sampling import SamplingParams, finite_guard, sample, spec_verify_sample

logger = logging.getLogger("deepspeed_tpu_torch")

# counter names of the JAX engine's stats view that this engine moves
# (JAX's table / sampling upload counters have no counterpart here: the
# port hands its host tables to each dispatch)
STAT_NAMES = (
    "prefill_tokens_dispatched",  # real prompt tokens run (not pad)
    "prefill_dispatches",
    "decode_ticks",
    "decode_emitted",  # tokens emitted by plain decode dispatches
    "decode_bursts",  # device-resident bursts (ONE host sync each)
    "burst_ticks",  # decode ticks run inside bursts
    "burst_emitted",  # tokens committed out of burst fetches
    "spec_ticks",  # verify dispatches (each scores k+1 positions)
    "spec_seq_forwards",  # sequence-participations in verify ticks
    "spec_drafted",  # draft tokens proposed
    "spec_accepted",  # draft tokens accepted
    "spec_emitted",  # tokens emitted by verify ticks (accepted + 1 each)
    "spec_drafts_shed",  # draft sets dropped by _spec_tick's capacity pre-pass
    # fault-tolerance transitions, counted by the paired ServeScheduler
    # (registry counters are memoized by name: its handles are these)
    "failed",  # requests reaching FAILED (isolation / NaN sentinel)
    "timed_out",  # deadline expirations (TTFT or e2e)
    "cancelled",  # cancel(uid) calls that landed
    "retries",  # transient-dispatch retries (bounded backoff loop)
    "nan_failures",  # FAILED through the -1 logits sentinel
    "isolation_probes",  # solo re-dispatches after a batch failure
    "shed_transitions",  # shed-mode flips (both directions)
    "shed_rejections",  # try_submit calls rejected RETRY_LATER
    "watchdog_trips",  # tick-duration watchdog firings
)
# the engine's histograms (``{ns}/<name>``)
HIST_NAMES = ("prefill_pack_ms", "decode_tick_ms", "spec_tick_ms", "burst_tick_ms",
              "spec_draft_len", "spec_match_distance")


# burst-accumulator pad written by rows already deactivated on the device:
# distinct from the -1 finite_guard poison sentinel (a real emission, always
# a row's LAST, that the host must see to quarantine)
_BURST_PAD = -2


def _bucket(n: int, buckets: Sequence[int]) -> int:
    for b in buckets:
        if n <= b:
            return b
    raise ValueError(f"prompt length {n} exceeds max bucket {buckets[-1]}")


class InferenceEngineV2:
    """Paged-KV continuous-batching engine for one model replica on one
    device.  ``params``: the port's parameter dict (``models.transformer.
    init_params`` / ``params_from_numpy``), moved to ``device``."""

    def __init__(
        self,
        params,
        cfg: TransformerConfig,
        max_seqs: int = 64,
        num_blocks: int = 2048,
        block_size: int = 32,
        max_seq_len: Optional[int] = None,
        prefill_buckets: Sequence[int] = (64, 128, 256, 512, 1024, 2048, 4096),
        prefill_budget: Optional[int] = None,
        seed: int = 0,
        offload_weights: bool = False,
        grid=None,
        quantize_weights: Optional[str] = None,
        enable_prefix_caching: bool = False,
        prefill_chunk: Optional[int] = None,
        kv_watermark: float = 0.0625,
        enable_speculation: bool = False,
        spec_max_draft: int = 4,
        spec_min_match: int = 2,
        spec_lookup_window: int = 1024,
        fused_serving: Optional[bool] = None,
        serve_replicas: int = 1,
        seq_shards: int = 1,
        serve=None,
        telemetry=None,
        faults=None,
        device=None,
        quant_comm: Optional[str] = None,
        comm_tiles: Optional[int] = None,
    ):
        # the serving config block (a ServeConfig or a dict); the fields the
        # port does not run yet raise in ServeConfig itself
        self.serve = serve if isinstance(serve, ServeConfig) else _coerce(ServeConfig, serve)
        unsupported = {
            "offload_weights": offload_weights,
            "fused_serving=False": fused_serving is False,
            "serve_replicas>1": serve_replicas != 1,
        }
        refused = [k for k, on in unsupported.items() if on]
        if refused:
            raise NotImplementedError(f"not ported yet: {', '.join(refused)}")
        sq = int(seq_shards)
        self.tp = None  # the model axis of a tensor-parallel engine
        if isinstance(grid, ProcessGrid):
            self.tp = self._tp_checks(grid, cfg, sq, enable_speculation, self.serve)
            if device is None:
                device = grid.device
        elif grid is not None:
            if not isinstance(grid, Grid):
                raise TypeError("grid must be a deepspeed_tpu_torch.parallel.topology.Grid "
                                "(initialize_mesh)")
            if grid.spec.model > 1 or grid.spec.data > 1:
                raise NotImplementedError(
                    f"a one-process grid with model {grid.spec.model} / batch "
                    f"{grid.spec.data} is not ported yet (ROADMAP queue 1 item 7); a model "
                    "axis serves over a ProcessGrid, one rank a device")
            if device is None:
                device = grid.devices[0]
        # seq-sharded pool: ``seq_shards`` > 1 slices the block pool over the
        # grid's seq axis; a sequence's pages round-robin across the slices,
        # each shard attends over its own pages and the partials merge by
        # log-sum-exp, so a context bigger than one slice serves as long as
        # the AGGREGATE pool fits it
        if sq > 1:
            if grid is None or grid.spec.seq != sq:
                raise ValueError(
                    f"seq_shards={sq} needs a grid whose seq axis is exactly {sq} -- "
                    f"build it with initialize_mesh(devices=[dev] * {sq}, seq={sq})")
            if num_blocks % sq:
                raise ValueError(f"num_blocks ({num_blocks}) must divide into 1 replicas x "
                                 f"{sq} seq shards")
        if quantize_weights not in (None, "int8", "fp8", "fp6"):
            raise ValueError(f"quantize_weights format {quantize_weights!r} (int8|fp8|fp6)")
        if enable_speculation and spec_max_draft < 1:
            raise ValueError("spec_max_draft must be >= 1 when speculating")
        if enable_speculation and spec_min_match < 1:
            raise ValueError("spec_min_match must be >= 1 when speculating")
        model_runner._check_family(cfg)
        self.device = resolve_device(device)
        if self.tp is not None and self.device != grid.device:
            raise ValueError(f"the grid's device {grid.device} is not the engine's device "
                             f"{self.device}")
        if isinstance(grid, Grid) and any(d != normalize_device(self.device)
                                          for d in grid.devices):
            raise ValueError(f"the grid's devices {[str(d) for d in grid.devices]} are not "
                             f"the engine's device {self.device}")
        self.seq_shards = sq
        self._mesh = grid if sq > 1 else None
        self.cfg = cfg
        # the runner's config: a tensor-parallel rank's local heads
        self._run_cfg = cfg if self.tp is None else self.tp.local_cfg
        self.quantize_weights = quantize_weights
        tp_size = self.tp.size if self.tp is not None else 1
        if quantize_weights is None:
            if self.tp is not None:
                params = self.tp.shard_serving_tree(params)
            self.params = _to_device(params, self.device)
        else:
            # on the device, one layer slice at a time; only the quantized
            # tree is kept (a tensor-parallel rank then cuts its shard)
            before = tree_nbytes(params)
            self.params = quantize_serving_params(params, quantize_weights,
                                                  row_parallel_shards=tp_size,
                                                  device=self.device)
            if self.tp is not None:
                self.params = self.tp.shard_serving_tree(self.params)
            logger.info("quantized-weight serving (%s): params %.1f MiB -> %.1f MiB",
                        quantize_weights, before / 2**20, tree_nbytes(self.params) / 2**20)
        self.block_size = block_size
        self.max_seq_len = max_seq_len or cfg.max_seq_len
        self.max_pages = -(-self.max_seq_len // block_size)
        self.enable_prefix_caching = enable_prefix_caching
        self.prefill_chunk = prefill_chunk
        self.kv_watermark = kv_watermark
        # speculation: up to spec_max_draft drafts per sequence verify in ONE
        # forward; spec_min_match is the n-gram that must recur to draft
        self.enable_speculation = enable_speculation
        self.spec_max_draft = spec_max_draft
        self.spec_min_match = spec_min_match
        self.spec_lookup_window = spec_lookup_window
        # the row-parallel transport (comm/qcomm.py): the argument, else the
        # serve block; at a model axis of one there is no partial sum to
        # move, so the sums stay exact (JAX ``engine_v2.py:292``)
        from ..comm.qcomm import _check_fmt

        self.quant_comm = _check_fmt(quant_comm if quant_comm is not None
                                     else self.serve.quant_comm)
        self.comm_tiles = max(int(comm_tiles if comm_tiles is not None
                                  else self.serve.comm_tiles), 1)
        self.serving_ctx = ServingContext(
            tp=self.tp, comm_fmt=self.quant_comm if tp_size > 1 else "none",
            comm_tiles=self.comm_tiles)
        # chaos harness (inference/faults.py): a seeded FaultInjector whose
        # points fire at this engine's dispatch sites and in the allocator's
        # growth path; None = every check is a no-op
        self.faults = faults
        self.mgr = StateManager(num_blocks, block_size, max_seqs,
                                enable_prefix_caching=enable_prefix_caching,
                                seq_shards=sq)
        self.mgr.faults = faults
        # speculation totals [drafted, accepted] of the one replica (the
        # spec half of ``replica_stats``)
        self._spec_by_replica = [[0, 0]]
        self._scheduler = None
        self.telemetry = Telemetry.ensure(telemetry)
        if self.telemetry.enabled:
            # a configured chrome_trace_path / jsonl_path is written at exit
            self.telemetry.register_exit_close()
        # the engine's namespace group, claimed atomically: a second engine
        # on a shared Telemetry gets serve2 / sched2 / comm2
        self._ns, self._sched_ns, self._comm_ns = \
            self.telemetry.claim_prefixes(("serve", "sched", "comm"))
        self._c = self.telemetry.counters(self._ns, STAT_NAMES)
        self.stats = StatsView(self._c)
        reg = self.telemetry.registry
        self._h = {k: reg.histogram(f"{self._ns}/{k}") for k in HIST_NAMES}
        # the namespace's request-latency histograms exist before any request
        self.telemetry.request_hists(self._ns)
        self.prefill_buckets = [b for b in prefill_buckets if b <= self.max_seq_len] \
            or [self.max_seq_len]
        # SplitFuse-style token budget, clamped to the largest bucket
        self.prefill_budget = min(prefill_budget or self.prefill_buckets[-1],
                                  self.prefill_buckets[-1])
        self.kv = init_paged_cache(cfg.num_layers, num_blocks, block_size,
                                   self._run_cfg.num_kv_heads, cfg.hd, dtype=cfg.dtype,
                                   device=self.device, max_seqs=max_seqs)
        self._gen = torch.Generator(device=self.device).manual_seed(seed)
        self._burst_cap = 64  # step_n accumulator rows (doubles on demand)
        self._burst: Optional[_BurstState] = None  # the bursts' device tensors and graphs
        # host block-table mirror, handed to every decode dispatch
        self._tables_np = np.full((max_seqs, self.max_pages), -1, np.int32)
        self.mgr.cow_hook = self._cow

    @staticmethod
    def _tp_checks(grid, cfg: TransformerConfig, seq_shards: int, speculation: bool, serve):
        """A process grid serves over its ``model`` axis alone; what does not
        compose with it yet raises naming item 7.  The ranks' schedulers must
        decide alike, so knobs that read each rank's own clock (deadlines,
        the watchdog) are refused too."""
        from ..parallel.tensor_parallel import TensorParallel

        others = {a: grid.axis_size(a) for a in BATCH_AXES if grid.axis_size(a) > 1}
        clocked = [k for k in ("deadline_ms", "ttft_deadline_ms", "watchdog_tick_ms")
                   if getattr(serve, k) is not None]
        refused = [what for what, on in (
            (f"a batch / replica axis ({others})", bool(others)),
            ("seq shards", seq_shards > 1),
            (f"an expert / seq axis ({grid.axis_size('expert')} / {grid.axis_size('seq')})",
             grid.axis_size("expert") > 1 or grid.axis_size("seq") > 1),
            ("MoE layers", cfg.moe_num_experts > 0),
            ("speculation", speculation),
            ("decode bursts (serve.decode_megastep > 1)", serve.decode_megastep > 1),
            (f"serve.{'/'.join(clocked)} (each rank's own clock)", bool(clocked)),
        ) if on]
        if refused:
            raise NotImplementedError(f"{', '.join(refused)} with a model axis is not ported "
                                      "yet (ROADMAP queue 1 item 7)")
        return TensorParallel(grid, cfg)

    def _cow(self, src: int, dst: int) -> None:
        """Copy-on-write page clone, in place in every layer pool."""
        for pool in (*self.kv[0], *self.kv[1]):
            pool[dst].copy_(pool[src])

    # -- scheduling queries --------------------------------------------------
    def query(self, uid: int) -> Tuple[int, int]:
        """(max admissible new tokens, allocatable blocks): admission info,
        evictable prefix-cache blocks included (JAX ``query``; one
        replica)."""
        free = max(a.available_blocks for a in self.mgr.allocators)
        return free * self.block_size, free

    def can_schedule(self, prompt_lens: Sequence[int], token_lists=None) -> bool:
        return self.mgr.can_admit_all(prompt_lens, token_lists=token_lists)

    # -- serving API ---------------------------------------------------------
    def put(self, uids: Sequence[int], token_lists: Sequence[Sequence[int]],
            sampling: SamplingParams = SamplingParams()) -> Dict[int, int]:
        """Admit new sequences and prefill them, returning {uid: first_token}
        (-1 for a row whose logits were non-finite).  All or nothing: raises
        ``RuntimeError`` when KV blocks or slots run out (load that may
        exceed capacity belongs on ``self.scheduler``)."""
        token_lists = [list(map(int, toks)) for toks in token_lists]
        for toks in token_lists:
            if len(toks) > self.prefill_buckets[-1]:
                raise ValueError(f"prompt length {len(toks)} exceeds max bucket "
                                 f"{self.prefill_buckets[-1]}")
        if not self.can_schedule([len(t) for t in token_lists], token_lists=token_lists):
            raise RuntimeError(
                f"cannot admit {len(token_lists)} sequences "
                f"({sum(len(t) for t in token_lists)} tokens): out of KV blocks/slots")
        entries = []
        admitted: List[int] = []
        snap = self.mgr.hit_stats_snapshot()
        try:
            for uid, toks in zip(uids, token_lists):
                seq = self.mgr.admit(uid, toks)
                admitted.append(uid)
                self.mgr.ensure_capacity(seq, 0)
                entries.append((seq, seq.seen_tokens, len(seq.tokens)))
        except RuntimeError:
            for u in admitted:
                self.mgr.release(u)
            self.mgr.hit_stats_restore(snap)
            raise
        return self.prefill_entries(entries, sampling)

    def prefill_entries(self, entries, sampling: SamplingParams) -> Dict[int, int]:
        """Prefill ``entries`` = [(seq, start, end)] token ranges in packs
        under ``prefill_budget``; returns {uid: first_token} for every entry
        that completes its prompt.  ``start`` must be page-aligned."""
        out: Dict[int, int] = {}
        bs = self.block_size
        for _seq, start, _end in entries:
            if start % bs:
                raise ValueError(f"prefill start {start} not page-aligned (bs {bs})")
        pending = list(entries)
        while pending:
            pack, deferred, pack_len = [], [], 0
            for entry in pending:
                _seq, start, end = entry
                n = -(-(end - start) // bs) * bs
                # an oversized single entry rides an empty pack (bucketed up)
                if pack_len and pack_len + n > self.prefill_budget:
                    deferred.append(entry)
                    continue
                pack.append(entry)
                pack_len += n
            self._run_packed_prefill(pack, sampling, out)
            pending = deferred
        return out

    def _run_packed_prefill(self, entries, sampling, out: Dict[int, int]) -> None:
        """One packed-prefill dispatch.  Each suffix starts at a PAGE
        boundary of the pack (segment-0 gap padding between prompts) so KV
        lands as page-granular writes.  Cold packs (all starts 0) take the
        flash kernel; any non-zero start takes the packed-context kernel."""
        self._maybe_fault("runner_exception", [s.uid for s, _, _ in entries])
        bs = self.block_size
        t_pad = _bucket(max(sum(-(-(e - s) // bs) * bs for _, s, e in entries), bs),
                        self.prefill_buckets)
        if t_pad % bs:
            raise ValueError(f"prefill bucket {t_pad} must be a multiple of block_size {bs}")
        use_ctx = any(start > 0 for _, start, _ in entries)
        B = self.mgr.max_seqs
        tokens = np.zeros(t_pad, np.int32)
        seg = np.zeros(t_pad, np.int32)
        pos = np.zeros(t_pad, np.int32)
        pack_pages = np.full(t_pad // bs, -1, np.int32)
        last_idx = np.full(B, -1, np.int32)
        ctx_tables = np.full((B, self.max_pages), -1, np.int32)
        ctx_lens = np.zeros(B, np.int32)
        cur = 0
        for s, start, end in entries:
            n = end - start
            tokens[cur:cur + n] = s.tokens[start:end]
            seg[cur:cur + n] = s.slot + 1
            pos[cur:cur + n] = np.arange(start, end)
            n_pages = -(-n // bs)
            first_page = start // bs
            pack_pages[cur // bs: cur // bs + n_pages] = s.blocks[first_page:first_page + n_pages]
            if end == len(s.tokens):  # completes the prompt -> sample
                last_idx[s.slot] = cur + n - 1
            ctx_tables[s.slot, :len(s.blocks)] = s.blocks
            ctx_lens[s.slot] = start
            cur += n_pages * bs  # next prompt starts page-aligned
        n_real = sum(e - s for _, s, e in entries)
        sp = self.telemetry.recorder.start(
            "prefill_pack", track=self._ns, hist=self._h["prefill_pack_ms"],
            tokens=n_real, pad=t_pad, entries=len(entries), ctx=use_ctx)
        with self.telemetry.step_annotation("prefill_pack",
                                            self._c["prefill_dispatches"].value + 1):
            if use_ctx:
                logits, self.kv = model_runner.prefill_packed_ctx(
                    self.params, self._run_cfg, tokens, seg, pos, pack_pages, last_idx,
                    ctx_tables, ctx_lens, self.kv, ctx=self.serving_ctx, mesh=self._mesh,
                    seq_shards=self.seq_shards)
            else:
                logits, self.kv = model_runner.prefill_packed(
                    self.params, self._run_cfg, tokens, seg, pos, pack_pages, last_idx,
                    self.kv, ctx=self.serving_ctx)
        sp.dispatched()
        self._c["prefill_tokens_dispatched"].inc(n_real)
        self._c["prefill_dispatches"].inc()
        poison = self._poisoned([s.uid for s, _, end in entries if end == len(s.tokens)])
        next_tokens = None
        for s, _start, end in entries:
            s.seen_tokens = end
            if end == len(s.tokens):
                if next_tokens is None:
                    next_tokens = self._sample(logits, sampling)
                tok = int(next_tokens[s.slot])
                if s.uid in poison:
                    tok = -1
                if tok < 0:
                    # finite_guard sentinel: commit nothing, retract the keys
                    # this sequence published, report -1 for this uid only
                    s.error = "non-finite logits in prefill"
                    self.mgr.quarantine_written(s)
                    out[s.uid] = -1
                    continue
                s.tokens.append(tok)
                self._set_block_table(s)
                out[s.uid] = tok
            self.mgr.update_hashes(s)
        if next_tokens is not None:
            sp.end()  # host-complete: the sampled fetch synced the pack
        else:
            # intermediate chunks only: nothing was read back, so the pack
            # may still run on the device.  Its reading is deferred to a
            # CUDA event on the dispatch's stream (the next host-synced span
            # on this track, or a flush, resolves it); on the CPU the logits
            # are ready at once.
            sp.end(sync_obj=device_ready(logits))

    # -- fault hooks -----------------------------------------------------------
    def _maybe_fault(self, point: str, uids) -> None:
        """Chaos-harness check before a dispatch site: raised BEFORE any
        device work, so a retry or an isolation probe re-dispatches against
        an intact pool (a burst checks once, before its graph replays —
        never inside a capture)."""
        if self.faults is not None:
            self.faults.maybe_raise(point, uids=uids)

    def _poisoned(self, uids) -> frozenset:
        """Uids whose rows the chaos harness poisons this dispatch: the same
        ``-1`` sentinel ``finite_guard`` produces, so the whole quarantine
        path runs."""
        if self.faults is None:
            return frozenset()
        return frozenset(self.faults.select("nan_logits", uids))

    def _sample(self, logits: torch.Tensor, sampling: SamplingParams) -> np.ndarray:
        """Sample + non-finite guard on the device, one fetch to the host."""
        sampled = finite_guard(logits, sample(logits, sampling, self._gen))
        return sampled.cpu().numpy()

    def _set_block_table(self, seq) -> None:
        row = self._tables_np[seq.slot]
        row[:] = -1
        row[:len(seq.blocks)] = seq.blocks

    # -- speculative decoding ------------------------------------------------
    def plan_speculation(self, active_seqs, max_total_draft_tokens: Optional[int] = None,
                         max_emit: Optional[Dict[int, int]] = None) -> Dict[int, List[int]]:
        """Prompt-lookup drafts for one verify tick: {uid: drafts}.

        A sequence's draft length follows its accept-rate EMA (one that
        rejects everything falls to 0 = plain decode and re-probes with one
        token after a cooldown), is clamped so the sequence cannot outgrow
        ``max_seq_len``, and all drafts together stay under
        ``max_total_draft_tokens`` (the scheduler passes its leftover
        prefill-chunk budget: drafted tokens share the tick's headroom).
        ``max_emit`` caps the tokens a sequence may still emit: a tick emits
        at most drafts + 1, so drafts clamp to max_emit - 1 before they
        debit the budget.  Sequences with no proposal are absent."""
        out: Dict[int, List[int]] = {}
        if not self.enable_speculation:
            return out
        budget = (max_total_draft_tokens if max_total_draft_tokens is not None
                  else self.mgr.max_seqs * self.spec_max_draft)
        for s in active_seqs:
            cap = s.spec_draft_len if s.spec_draft_len >= 0 else self.spec_max_draft
            if cap == 0:
                # throttled: re-probe with one draft every few ticks, so a
                # sequence that becomes compressible recovers
                s.spec_cooldown -= 1
                if s.spec_cooldown > 0:
                    continue
                cap = 1
            cap = min(cap, self.spec_max_draft, budget, self.max_seq_len - s.cur_len - 1)
            if max_emit is not None and s.uid in max_emit:
                cap = min(cap, max_emit[s.uid] - 1)
            if cap <= 0:
                continue
            drafts, match_start = speculative.propose_detail(
                s.tokens, self.spec_min_match, cap, self.spec_lookup_window)
            if drafts:
                out[s.uid] = drafts
                budget -= len(drafts)
                self._h["spec_draft_len"].observe(len(drafts))
                # tail -> matched n-gram distance: ~0 in a repetition loop,
                # large on a prompt-copy workload
                self._h["spec_match_distance"].observe(
                    len(s.tokens) - self.spec_min_match - match_start)
        return out

    def _spec_tick(self, active_seqs, sampling: SamplingParams,
                   proposals: Optional[Dict[int, List[int]]] = None) -> Dict[int, List[int]]:
        """One speculative tick: draft -> verify k + 1 positions per
        sequence in one forward -> accept -> roll back.  Returns {uid:
        emitted tokens}, between 1 (every draft rejected, or none) and
        k + 1, appended to each descriptor ([-1] for a row whose verify
        logits were non-finite).  With no draft at all it is a plain decode
        tick."""
        if proposals is None:
            proposals = self.plan_speculation(active_seqs)
        # reserve the pages of every row a pack writes (L-1 .. L-1+n); under
        # pool pressure a sequence sheds its drafts and reserves only the
        # plain-decode token, so speculation never raises where plain
        # decode fits (the scheduler sheds first; this guards step())
        bs = self.block_size
        for s in active_seqs:
            n = len(proposals.get(s.uid, []))
            L = s.cur_len
            try:
                self.mgr.ensure_capacity(s, n + 1)
                # the copy-on-write guard belongs to the same reservation:
                # it may allocate, and may swap a page of the block list
                for pg in range((L - 1) // bs, (L - 1 + n) // bs + 1):
                    self.mgr.ensure_writable(s, pg * bs)
            except RuntimeError:
                if not n:
                    raise
                proposals.pop(s.uid, None)
                self._c["spec_drafts_shed"].inc()
                # the draft tail's pages may be what the clone needs
                self.mgr.truncate_to_length(s)
                self.mgr.ensure_capacity(s, 1)
                self.mgr.ensure_writable(s, L - 1)
        if not proposals:
            return {u: [t] for u, t in self._decode_tick(active_seqs, sampling).items()}
        self._maybe_fault("runner_exception", [s.uid for s in active_seqs])
        B, K = self.mgr.max_seqs, self.spec_max_draft
        K1 = K + 1
        tokens = np.zeros(B * K1, np.int32)
        seg = np.zeros(B * K1, np.int32)
        pos = np.zeros(B * K1, np.int32)
        dst_pages = np.full(B * K1, -1, np.int32)
        dst_offs = np.zeros(B * K1, np.int32)
        draft = np.zeros((B, K), np.int32)
        n_draft = np.zeros(B, np.int32)
        ctx_lens = np.zeros(B, np.int32)
        for s in active_seqs:
            drafts = proposals.get(s.uid, [])
            n = len(drafts)
            L = s.cur_len
            self._set_block_table(s)
            draft[s.slot, :n] = drafts
            n_draft[s.slot] = n
            ctx_lens[s.slot] = s.seen_tokens
            for i in range(n + 1):
                p_tok = L - 1 + i
                row = s.slot * K1 + i
                tokens[row] = s.tokens[-1] if i == 0 else drafts[i - 1]
                seg[row] = s.slot + 1
                pos[row] = p_tok
                dst_pages[row] = s.blocks[p_tok // bs]
                dst_offs[row] = p_tok % bs
        sp = self.telemetry.recorder.start(
            "spec_tick", track=self._ns, hist=self._h["spec_tick_ms"],
            batch=len(active_seqs), drafted=int(n_draft.sum()))
        with self.telemetry.step_annotation("spec_tick", self._c["spec_ticks"].value + 1):
            out_np, n_out = self._verify(tokens, seg, pos, dst_pages, dst_offs, ctx_lens,
                                         draft, n_draft, sampling)
        sp.dispatched()
        self._c["spec_ticks"].inc()
        self._c["spec_seq_forwards"].inc(len(active_seqs))
        sp.end()  # the verify's host read is the tick's sync
        poison = self._poisoned([s.uid for s in active_seqs])
        out: Dict[int, List[int]] = {}
        for s in active_seqs:
            n_emit = int(n_out[s.slot])
            emitted = [int(t) for t in out_np[s.slot, :n_emit]]
            if s.uid in poison or any(t < 0 for t in emitted):
                # finite_guard poisoned the row: commit nothing, return the
                # draft pages, retract its published keys
                s.error = "non-finite logits in verify"
                self.mgr.quarantine_written(s)
                if self.mgr.truncate_to_length(s):
                    self._set_block_table(s)
                out[s.uid] = [-1]
                continue
            n = int(n_draft[s.slot])
            n_acc = n_emit - 1
            s.tokens.extend(emitted)
            s.seen_tokens = s.cur_len - 1
            # rollback: free the tail pages rejected drafts reserved (their
            # rows inside kept pages are masked by length and overwritten)
            if self.mgr.truncate_to_length(s):
                self._set_block_table(s)
            self.mgr.update_hashes(s)
            self._c["spec_drafted"].inc(n)
            self._c["spec_accepted"].inc(n_acc)
            self._c["spec_emitted"].inc(n_emit)
            s.spec_drafted += n
            s.spec_accepted += n_acc
            self._spec_by_replica[0][0] += n
            self._spec_by_replica[0][1] += n_acc
            if n > 0:
                self._spec_update_throttle(s, n, n_acc)
            out[s.uid] = emitted
        return out

    def _verify(self, tokens, seg, pos, dst_pages, dst_offs, ctx_lens, draft, n_draft,
                sampling: SamplingParams):
        """The verify dispatch (JAX ``spec_impl``): the forward over the
        pack, acceptance on the device, and ONE host read of
        (out [B, k+1], n_out [B]).  The host arrays go up before the
        forward: a copy from pageable memory waits for the stream.  The
        tick's one ``SamplingParams`` reaches the acceptance as scalars."""
        draft_dev = torch.from_numpy(draft).to(self.device)
        n_draft_dev = torch.from_numpy(n_draft).to(self.device)
        logits, self.kv = model_runner.verify_packed_ctx(
            self.params, self._run_cfg, tokens, seg, pos, dst_pages, dst_offs,
            self._tables_np, ctx_lens, self.kv, ctx=self.serving_ctx, mesh=self._mesh,
            seq_shards=self.seq_shards)
        B, K = draft.shape
        logits = logits.reshape(B, K + 1, -1)
        out, n_out = spec_verify_sample(
            logits, draft_dev, n_draft_dev, sampling.temperature, sampling.top_p,
            sampling.top_k, self._gen)
        # one non-finite logit in a row's k + 1 positions poisons the row
        host = torch.cat([finite_guard(logits, out), n_out[:, None]], dim=1).cpu().numpy()
        return host[:, :-1], host[:, -1]

    def _spec_update_throttle(self, s, n: int, n_acc: int) -> None:
        """Fold one verify tick's (drafted, accepted) into the sequence's
        accept-rate EMA and recompute its draft cap: full rejections decay
        it to 0 in about 3 ticks (then a cooldown of 8 ticks before a
        1-token probe); acceptance grows it back to ``spec_max_draft``."""
        s.spec_ema = 0.5 * s.spec_ema + 0.5 * (n_acc / n)
        s.spec_draft_len = int(round(s.spec_ema * self.spec_max_draft))
        if s.spec_draft_len == 0:
            s.spec_cooldown = 8

    def _decode_tick(self, active_seqs, sampling: SamplingParams) -> Dict[int, int]:
        """One batched decode dispatch over ``active_seqs`` only; appends the
        sampled token per sequence (stop/length handling is the caller's)."""
        B = self.mgr.max_seqs
        tokens = np.zeros(B, np.int32)
        seq_lens = np.zeros(B, np.int32)
        active = np.zeros(B, bool)
        for s in active_seqs:
            # grow pages for the token written this tick; clone a shared page
            self.mgr.ensure_capacity(s, 1)
            self.mgr.ensure_writable(s, s.cur_len - 1)
            self._set_block_table(s)
            tokens[s.slot] = s.tokens[-1]
            seq_lens[s.slot] = s.cur_len - 1  # KV position of the new token
            active[s.slot] = True
        self._maybe_fault("runner_exception", [s.uid for s in active_seqs])
        sp = self.telemetry.recorder.start(
            "decode_tick", track=self._ns, hist=self._h["decode_tick_ms"],
            batch=len(active_seqs))
        with self.telemetry.step_annotation("decode_tick", self._c["decode_ticks"].value + 1):
            logits, self.kv = model_runner.decode_step(
                self.params, self._run_cfg, tokens, seq_lens, self._tables_np, active,
                self.kv, ctx=self.serving_ctx, mesh=self._mesh, seq_shards=self.seq_shards)
        sp.dispatched()
        self._c["decode_ticks"].inc()
        self._c["decode_emitted"].inc(len(active_seqs))
        next_tokens = self._sample(logits, sampling)
        sp.end()  # the fetch above is the tick's host sync
        poison = self._poisoned([s.uid for s in active_seqs])
        out = {}
        for s in active_seqs:
            tok = int(next_tokens[s.slot])
            if s.uid in poison:
                tok = -1
            if tok < 0:
                s.error = "non-finite logits in decode"
                self.mgr.quarantine_written(s)
                if self.mgr.truncate_to_length(s):
                    self._set_block_table(s)
                out[s.uid] = -1
                continue
            s.tokens.append(tok)
            s.seen_tokens = s.cur_len - 1
            self.mgr.update_hashes(s)
            out[s.uid] = tok
        return out

    def step(self, sampling: SamplingParams = SamplingParams()) -> Dict[int, int]:
        """One batched decode tick over all active sequences; returns the
        newest token per uid (-1 for a row with non-finite logits).  With
        ``enable_speculation`` a tick may emit several tokens per sequence,
        all appended to its descriptor; a stop token inside the run cuts the
        sequence there."""
        active_seqs = [s for s in self.mgr.active if not s.done]
        if not active_seqs:
            return {}
        if self.enable_speculation:
            runs = self._spec_tick(active_seqs, sampling)
        else:
            runs = {u: [t] for u, t in self._decode_tick(active_seqs, sampling).items()}
        out = {}
        for s in active_seqs:
            run = runs[s.uid]
            if run[-1] < 0:
                s.done = True
                out[s.uid] = -1
                continue
            run = self.cut_at_stop(s, run, sampling.stop_token)
            if run[-1] == sampling.stop_token:
                s.done = True
            if s.cur_len >= self.max_seq_len:
                s.done = True
            out[s.uid] = run[-1]
        return out

    @staticmethod
    def cut_at_stop(seq, run: List[int], stop_token: Optional[int]) -> List[int]:
        """``run`` (tokens a tick just appended to ``seq``) up to and
        including the first ``stop_token``; the tokens speculated past it
        are dropped from the descriptor too."""
        if stop_token is None or stop_token not in run:
            return run
        cut = len(run) - run.index(stop_token) - 1
        if cut:
            del seq.tokens[-cut:]
            seq.seen_tokens = min(seq.seen_tokens, seq.cur_len - 1)
        return run[:len(run) - cut]

    # -- device-resident decode bursts -----------------------------------
    def _burst_tick(self, st: "_BurstState", sampling: SamplingParams) -> None:
        """One decode tick of a burst on ``st``'s device tensors, in place
        (JAX ``decode_burst_impl``): forward, sampling, the non-finite
        guard; the row emitted into ``st.buf[tick + 1]`` (``_BURST_PAD``
        where the row was already inactive) and the counts into row 0; a
        row deactivates on the poison sentinel, its stop token or its
        emission cap, AFTER this tick's emission; lengths advance only for
        rows that emitted; the next token is clamped to >= 0.  Reads
        nothing back to the host: a CUDA graph holds it."""
        logits, _ = model_runner.decode_body(
            self.params, self._run_cfg, st.tokens, st.lens, st.tables, st.active, self.kv,
            ctx=self.serving_ctx, mesh=self._mesh, seq_shards=self.seq_shards)
        sampled = finite_guard(logits, sample(logits, sampling, self._gen))
        act_i = st.active.int()
        st.buf.index_copy_(0, st.tick + 1, torch.where(st.active, sampled, _BURST_PAD)[None])
        st.emitted += act_i
        st.buf[0].copy_(st.emitted)
        hit_stop = (st.stop >= 0) & (sampled == st.stop)
        st.active &= (sampled >= 0) & ~hit_stop & (st.emitted < st.max_emit)
        st.lens += act_i
        st.tokens.copy_(torch.where(st.active, sampled.clamp(min=0), st.tokens))
        st.tick += 1

    def _run_burst(self, st: "_BurstState", sampling: SamplingParams, n: int) -> None:
        """``n`` ticks of ``_burst_tick``.  On the CPU they run eagerly.  On
        CUDA the tick is a captured graph per sampling triple, replayed:
        a triple's first burst runs its first tick eagerly on the capture
        stream (the warm-up that builds and configures every kernel before
        any capture), then captures the tick and replays it for the rest.
        A capture or replay error raises; nothing falls back to eager
        ticks."""
        if self.device.type != "cuda":
            for _ in range(n):
                self._burst_tick(st, sampling)
            return
        key = (sampling.temperature, sampling.top_k, sampling.top_p)
        graph = st.graphs.get(key)
        if graph is None:
            stream = st.stream
            stream.wait_stream(torch.cuda.current_stream(self.device))
            with torch.cuda.stream(stream):
                self._burst_tick(st, sampling)
            torch.cuda.current_stream(self.device).wait_stream(stream)
            n -= 1
            graph = CapturedGraph()
            graph.capture(lambda: self._burst_tick(st, sampling), stream=stream,
                          generators=(self._gen,) if sampling.temperature > 0 else ())
            st.graphs[key] = graph
        for _ in range(n):
            graph.replay()

    def _decode_burst(self, active_seqs, sampling: SamplingParams, n: int,
                      max_emit: Optional[Dict[int, int]] = None,
                      stop_tokens: Optional[Dict[int, Optional[int]]] = None
                      ) -> Dict[int, List[int]]:
        """Device-resident multi-tick decode (JAX ``_decode_burst``): up to
        ``n`` decode ticks over ``active_seqs`` with on-device termination
        and ONE end-of-burst fetch; ``step_n`` and the scheduler's megastep
        both ride this.

        Per-slot stop tokens (``stop_tokens`` {uid: id}, default
        ``sampling.stop_token``) and emission caps (``max_emit`` {uid: n},
        clamped by the ``max_seq_len`` headroom) ride device tensors; each
        row deactivates the tick it stops, so later ticks neither sample it
        nor write its KV and the runs are token-identical to per-tick
        ``step()``.  Every page a row's burst can touch is reserved before
        the first tick, so the block tables go up once.

        Returns {uid: emitted run}.  A poisoned row's run ends with the -1
        sentinel: the healthy prefix before it is committed and its
        published cache keys are retracted.  Rows given no emission
        headroom return an empty run untouched."""
        B = self.mgr.max_seqs
        uids = [s.uid for s in active_seqs]
        P = self.max_pages
        host = np.zeros(4 * B + B * P, np.int32)
        tokens0, base_lens, stop_rows, emit_cap = host[:4 * B].reshape(4, B)
        stop_rows[:] = -1
        for s in active_seqs:
            cap_i = min(n, self.max_seq_len - s.cur_len)
            if max_emit is not None and s.uid in max_emit:
                cap_i = min(cap_i, int(max_emit[s.uid]))
            if cap_i < 1:
                continue  # no headroom: empty run, the row never enters the batch
            # reserve every page this row's burst can touch: the block table
            # is then static for all its ticks (one upload); rows that stop
            # early hand the unused tail back after the fetch
            self.mgr.ensure_capacity(s, cap_i)
            self.mgr.ensure_writable(s, s.cur_len - 1)
            self._set_block_table(s)
            base_lens[s.slot] = s.cur_len - 1
            tokens0[s.slot] = s.tokens[-1]
            emit_cap[s.slot] = cap_i
            stop = sampling.stop_token if stop_tokens is None \
                else stop_tokens.get(s.uid, sampling.stop_token)
            stop_rows[s.slot] = -1 if stop is None else int(stop)
        active = emit_cap > 0
        if not active.any():
            return {u: [] for u in uids}
        # no tick can emit once every row is past its cap: clamp the burst
        n = min(n, int(emit_cap.max()))
        # the burst's one fault check, before any replay (never in a capture)
        self._maybe_fault("runner_exception", uids)
        host[4 * B:] = self._tables_np.reshape(-1)
        cap = self._burst_cap
        while cap < n:
            cap *= 2
        self._burst_cap = cap
        if self._burst is None or self._burst.buf.shape[0] < cap + 1:
            self._burst = None  # drop the old buffer's graphs before the new ones
            self._burst = _BurstState(B, P, cap, self.device)
        st = self._burst
        st.inputs.copy_(torch.from_numpy(host))  # the burst's one upload
        st.active.copy_(st.max_emit > 0)
        st.emitted.zero_()
        st.tick.zero_()
        st.buf.fill_(_BURST_PAD)
        st.buf[0].zero_()
        base = SamplingParams(sampling.temperature, sampling.top_k, sampling.top_p)
        # ONE span for the whole burst; the per-tick figure is the burst
        # average, observed once per tick
        sp = self.telemetry.recorder.start(
            "decode_burst", track=self._ns, ticks=n, batch=len(active_seqs))
        with self.telemetry.step_annotation("decode_burst", n):
            self._run_burst(st, base, n)
        sp.dispatched()
        self._c["decode_bursts"].inc()
        self._c["burst_ticks"].inc(n)
        burst = st.buf[:n + 1].cpu().numpy()  # the ONE host sync
        sp = sp.end()
        if sp.duration_ms is not None:
            per_tick = sp.duration_ms / n
            for _ in range(n):
                self._h["burst_tick_ms"].observe(per_tick)
        poison_inj = self._poisoned(uids)
        out: Dict[int, List[int]] = {}
        total = 0
        for s in active_seqs:
            if not active[s.slot]:
                out[s.uid] = []
                continue
            m = int(burst[0, s.slot])
            run = [int(t) for t in burst[1:1 + m, s.slot]]
            if s.uid in poison_inj:
                # injected poison: nothing committed, the row quarantined
                run = [-1]
            committed = run[:-1] if run and run[-1] == -1 else run
            s.tokens.extend(committed)
            s.seen_tokens = s.cur_len - 1
            if run and run[-1] < 0:
                # the row deactivated at its first bad tick on the device; its
                # published keys are retracted (its written KV is suspect)
                s.error = "non-finite logits in decode burst"
                self.mgr.quarantine_written(s)
            else:
                self.mgr.update_hashes(s)
            # hand back the unused tail reservation in one truncate
            if self.mgr.truncate_to_length(s):
                self._set_block_table(s)
            total += len(committed)
            out[s.uid] = run
        self._c["burst_emitted"].inc(total)
        return out

    def step_n(self, n: int, sampling: SamplingParams = SamplingParams()) -> Dict[int, int]:
        """``n`` decode ticks as one device-resident burst: the sampled
        tokens stay on the device between ticks and the host reads once,
        at the end.  Stop-exact: each row's stop token and length cap are
        checked on the device, so the tokens equal those of ``n`` per-tick
        ``step()`` calls.  Returns {uid: last kept token} (-1 for a
        poisoned row, as ``step()``)."""
        if self.tp is not None:
            raise NotImplementedError("decode bursts with a model axis (a CUDA graph over "
                                      "the collectives) are not ported yet (ROADMAP queue 1 "
                                      "item 7): serve it per tick (decode_megastep 1)")
        active_seqs = [s for s in self.mgr.active if not s.done]
        if not active_seqs or n <= 0:
            return {}
        # sequences already at the length cap finish; the rest keep decoding
        for s in active_seqs:
            if s.cur_len >= self.max_seq_len:
                s.done = True
        active_seqs = [s for s in active_seqs if not s.done]
        if not active_seqs:
            return {}
        # rows stop at their own length caps on the device, so the burst
        # length follows the least constrained row
        n = min(n, self.max_seq_len - min(s.cur_len for s in active_seqs))
        runs = self._decode_burst(active_seqs, sampling, n)
        out: Dict[int, int] = {}
        for s in active_seqs:
            run = runs[s.uid]
            if not run:
                continue
            if run[-1] < 0:
                s.done = True
                out[s.uid] = -1
                continue
            if sampling.stop_token is not None and run[-1] == sampling.stop_token:
                s.done = True
            if s.cur_len >= self.max_seq_len:
                s.done = True
            out[s.uid] = run[-1]
        return out

    def flush(self, uids: Sequence[int]) -> None:
        for uid in uids:
            self.mgr.release(uid)

    # -- paged-KV handoff (serving/handoff.py rides these) -------------------
    def _pool_leaves(self) -> List[torch.Tensor]:
        """The pool tensors in JAX's ``tree_leaves`` order over
        ``(k_layers, v_layers)``: every layer's K, then every layer's V."""
        return [*self.kv[0], *self.kv[1]]

    def extract_kv_blocks(self, blocks: Sequence[int]):
        """Device -> host copy of a block range: per-layer ``(k, v)`` page
        tensors ``[n_blocks, bs, hkv, hd]`` on the CPU for ``blocks`` (any
        order), in the pool's structure.  One gather per leaf on the device
        and ONE host copy for the whole tree (never one per page)."""
        idx = torch.as_tensor([int(b) for b in blocks], dtype=torch.long, device=self.device)
        leaves = self._pool_leaves()
        host = torch.stack([pool.index_select(0, idx) for pool in leaves]).cpu()
        L = len(self.kv[0])
        pages = list(host.unbind(0))
        return tuple(pages[:L]), tuple(pages[L:])

    def inject_kv_blocks(self, blocks: Sequence[int], pages) -> None:
        """Scatter extracted pages into THIS engine's pool at ``blocks``
        (the decode half of the handoff), in place: each layer's pool
        tensor keeps its storage, so a captured burst graph that reads the
        pool stays valid.  ``pages`` is the :meth:`extract_kv_blocks`
        structure (any device and float dtype; one host-to-device copy for
        the whole tree).  The caller owns ``blocks`` (freshly allocated,
        refcount 1): this never consults the allocator."""
        idx = torch.as_tensor([int(b) for b in blocks], dtype=torch.long, device=self.device)
        leaves = self._pool_leaves()
        flat = [*pages[0], *pages[1]]
        if len(flat) != len(leaves):
            raise ValueError(f"handoff carries {len(flat)} pool leaves, this engine has "
                             f"{len(leaves)}")
        dev = torch.stack([torch.as_tensor(p) for p in flat]).to(
            device=self.device, dtype=leaves[0].dtype)
        for pool, page in zip(leaves, dev.unbind(0)):
            pool.index_copy_(0, idx, page)

    # -- per-replica telemetry ------------------------------------------------
    def replica_stats(self) -> List[Dict[str, float]]:
        """Host-side per-replica serving stats (one row: the pool is one
        replica): the allocator / hit-rate row of the state manager plus
        this engine's speculation totals."""
        rows = self.mgr.replica_stats()
        for r, row in enumerate(rows):
            drafted, accepted = self._spec_by_replica[r]
            row["spec_drafted"] = drafted
            row["spec_accepted"] = accepted
            row["spec_accept_rate"] = accepted / drafted if drafted else 0.0
        return rows

    def update_replica_gauges(self) -> None:
        """Refresh the ``serve/replicaN/*`` gauges (prefix-hit rate, pool
        headroom, spec accept rate) from ``replica_stats``; the names ride
        this engine's claimed namespace, so ``close`` sweeps them."""
        if not self.telemetry.enabled:
            return
        reg = self.telemetry.registry
        for r, row in enumerate(self.replica_stats()):
            pre = f"{self._ns}/replica{r}"
            reg.gauge(f"{pre}/prefix_hit_rate").set(row["prefix_hit_rate"])
            reg.gauge(f"{pre}/pool_headroom").set(row["headroom"])
            reg.gauge(f"{pre}/spec_accept_rate").set(row["spec_accept_rate"])

    # -- live retune surface --------------------------------------------------
    def apply_knobs(self, *, enable_speculation: Optional[bool] = None,
                    spec_max_draft: Optional[int] = None,
                    kv_watermark: Optional[float] = None,
                    prefill_chunk: Optional[int] = None) -> Dict[str, Any]:
        """Retune the engine-owned live knobs (plain attributes read each
        tick), validated as at construction; raises ``ValueError`` before
        applying anything (all or nothing).  Returns the applied
        ``{knob: value}``.  Call from the engine's owner thread (the
        scheduler applies staged knobs at its tick boundary)."""
        spec_on = (self.enable_speculation if enable_speculation is None
                   else bool(enable_speculation))
        draft = self.spec_max_draft if spec_max_draft is None else int(spec_max_draft)
        if spec_on and draft < 1:
            raise ValueError("spec_max_draft must be >= 1 when speculating")
        if spec_on and not self.enable_speculation \
                and self._scheduler is not None and not self._scheduler.idle:
            # live sequences carry no drafter state: turning it on needs a drain
            raise ValueError(
                "enable_speculation can only turn on while the scheduler "
                "is drained (live sequences carry no drafter state)")
        if kv_watermark is not None and not 0.0 <= float(kv_watermark) < 1.0:
            raise ValueError(f"kv_watermark must be in [0, 1), got {kv_watermark}")
        if prefill_chunk is not None and int(prefill_chunk) < 1:
            raise ValueError(f"prefill_chunk must be >= 1, got {prefill_chunk}")
        applied: Dict[str, Any] = {}
        if enable_speculation is not None:
            self.enable_speculation = spec_on
            applied["enable_speculation"] = spec_on
        if spec_max_draft is not None:
            self.spec_max_draft = draft
            applied["spec_max_draft"] = draft
        if kv_watermark is not None:
            self.kv_watermark = float(kv_watermark)
            applied["kv_watermark"] = self.kv_watermark
        if prefill_chunk is not None:
            self.prefill_chunk = int(prefill_chunk)
            applied["prefill_chunk"] = self.prefill_chunk
        return applied

    def close(self) -> Dict[str, int]:
        """Cancel every scheduler request, release every sequence, audit the
        allocator (raises on a broken invariant), settle the telemetry and
        release the engine's claimed namespaces (the next engine on a
        shared ``Telemetry`` gets ``serve`` back), and drop the device
        tensors.  Idempotent.  Returns ``{"blocks_in_use",
        "cached_blocks"}`` after release — the zero-leak audit."""
        if getattr(self, "_closed", False):
            return dict(self._close_audit)
        if self._scheduler is not None:
            self._scheduler.close()
        for uid in list(self.mgr.seqs):
            self.mgr.release(uid)
        a = self.mgr.allocator
        a.audit()
        self._close_audit = {
            "blocks_in_use": a.total_blocks - a.free_blocks - a.cached_blocks,
            "cached_blocks": a.cached_blocks,
        }
        self.telemetry.flush()
        for ns in (self._ns, self._sched_ns, self._comm_ns):
            self.telemetry.release_prefix(ns)
        self._burst = None  # the graphs first, then the tensors they read
        self.params = None
        self.kv = None
        self.mgr.cow_hook = None
        self._closed = True
        return dict(self._close_audit)

    @property
    def scheduler(self):
        """Lazily built ``ServeScheduler`` bound to this engine."""
        if self._scheduler is None:
            from .scheduler import ServeScheduler

            self._scheduler = ServeScheduler(
                self, prefill_chunk=self.prefill_chunk, kv_watermark=self.kv_watermark,
                serve=self.serve, faults=self.faults)
        return self._scheduler

    def generate(self, prompt_tokens: Sequence[int],
                 sampling: SamplingParams = SamplingParams()) -> List[int]:
        """Single-prompt convenience through the scheduler."""
        sched = self.scheduler
        uid = sched.next_uid()
        sched.submit(uid, prompt_tokens, sampling)
        sched.run(wait_for=[uid])
        req = sched.requests[uid]
        if req.state != "finished":
            state, err = req.state, req.error
            sched.pop_result(uid)
            raise RuntimeError(f"generate() request {state}: {err or state}")
        return sched.pop_result(uid)


def build_serve_engine(params, cfg, sec, *, telemetry=None, serve=None, faults=None,
                       device=None) -> InferenceEngineV2:
    """The config -> engine seam (JAX ``build_serve_engine``): an
    ``InferenceEngineV2`` from a ``config.ServeEngineConfig`` (or a dict
    coerced into one).  ``seq_shards`` > 1 brings up the one-card seq grid
    (``initialize_mesh(devices=[dev] * S, seq=S)``); ``tp`` > 1 the
    ``model`` axis of the ``torch.distributed`` world this process is a
    rank of (every rank calls it); ``serve_replicas`` > 1 is refused by the
    config (ROADMAP queue 1 item 7).  ``device``: CUDA unless the caller
    names another."""
    from ..config.config import ServeEngineConfig
    from ..parallel.topology import initialize_mesh

    sec = sec if isinstance(sec, ServeEngineConfig) else _coerce(ServeEngineConfig, dict(sec))
    dev = resolve_device(device)
    grid = None
    if sec.tp > 1:
        grid = initialize_mesh(model=sec.tp, device=dev)
    elif sec.seq_shards > 1:
        grid = initialize_mesh(devices=[dev] * sec.seq_shards, seq=sec.seq_shards)
    return InferenceEngineV2(params, cfg, grid=grid, telemetry=telemetry, serve=serve,
                             faults=faults, device=dev, **sec.engine_kwargs())


class _BurstState:
    """The device tensors the decode bursts read and advance in place, and
    the graphs captured over them.  One per engine, reused by every burst
    until the accumulator must grow, so a captured tick's pointers stay
    valid across its replays.  ``inputs`` holds the per-burst upload:
    tokens, lengths, stop tokens, emission caps ([B] each) and the block
    tables [B, P], int32; ``buf`` [cap + 1, B] the accumulator (row 0 the
    emission counts, row 1 + t tick t's emissions)."""

    def __init__(self, B: int, P: int, cap: int, device: torch.device):
        self.inputs = torch.zeros(4 * B + B * P, dtype=torch.int32, device=device)
        self.tokens, self.lens, self.stop, self.max_emit = self.inputs[:4 * B].view(4, B)
        self.tables = self.inputs[4 * B:].view(B, P)
        self.active = torch.zeros(B, dtype=torch.bool, device=device)
        self.emitted = torch.zeros(B, dtype=torch.int32, device=device)
        self.tick = torch.zeros(1, dtype=torch.long, device=device)
        self.buf = torch.full((cap + 1, B), _BURST_PAD, dtype=torch.int32, device=device)
        self.graphs: Dict[tuple, CapturedGraph] = {}  # sampling triple -> its tick
        self.stream = torch.cuda.Stream(device) if device.type == "cuda" else None


def _to_device(params, device):
    if isinstance(params, dict):
        return {k: _to_device(v, device) for k, v in params.items()}
    if isinstance(params, QUANT_TYPES):
        return map_quant(params, lambda t: t.to(device))
    return params.to(device)

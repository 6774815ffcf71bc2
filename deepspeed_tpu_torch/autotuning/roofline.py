"""Roofline cost model: the static half of the autotuner — the port of
``deepspeed_tpu/autotuning/roofline.py`` with H100 constants.

Predicts, per candidate, the dominant resource terms of one training step
or one serving decode tick from first principles — HBM weight-stream
bytes, wire bytes per collective (``comm/budget.py``'s plans over
``comm/qcomm.wire_bytes``), and model FLOPs — and checks memory /
structural feasibility so the search never builds a candidate the card
cannot run.  The prediction is a *ranking and pruning* signal: knobs with
no roofline coordinate (``kv_watermark``, ``prefill_chunk``) rank flat
here and are told apart by the measured trials.  ``serving_feasible``,
``predict_serve_cost``, ``train_memory_bytes`` and ``predict_train_cost``
do JAX's arithmetic: given the same constants they return JAX's numbers.

Constants come from one of two places, in preference order:

1. **Calibration** (:meth:`RooflineConstants.calibrate`) from records that
   name an NVIDIA card: ``chip_smoke.py``'s JSON lines carry a ``gpu``
   field (``"NVIDIA H100 80GB HBM3, 700.00 W"``).  A ``train`` record's
   tokens/s x FLOPs per token gives the achieved compute rate; every
   timed kernel whose bound is bytes (``bound_by: "bytes"``) gives an
   achieved HBM rate (its ``bound_ms / ms`` of the card's 3.35 TB/s).
   The best observed record wins.  Every record that names no NVIDIA card
   — the repo's TPU artifacts ``BENCH_r0*.json`` / ``MULTICHIP_r0*.json``
   among them — is skipped.
2. **H100 defaults** (below), each with its origin, when no record parses.
"""
from __future__ import annotations

import glob
import json
import os
from dataclasses import dataclass, replace
from typing import Any, Dict, Iterator, Optional, Sequence, Tuple

# bytes one weight element costs on the wire/HBM per serving quant format
_WEIGHT_BYTES = {None: 2.0, "none": 2.0, "bf16": 2.0,
                 "int8": 1.0, "fp8": 1.0, "fp6": 0.75}
# recompute overhead multipliers on the backward pass (coarse: full remat
# re-runs the forward, selective re-runs the MLP intermediates)
_REMAT_FLOPS = {"none": 1.0, "selective": 1.15, "full": 4.0 / 3.0}
# the H100 SXM's peak HBM3 rate (datasheet), against which a kernel's
# ``bound_ms`` was computed in chip_smoke.py
PEAK_HBM_BYTES_S = 3.35e12


@dataclass(frozen=True)
class RooflineConstants:
    """Achievable (not peak) rates the cost terms divide by.  Defaults: one
    NVIDIA H100 80GB HBM3 at a 700.00 W power limit, from the port's own
    chip runs recorded in PERF.md (written by ``chip_smoke.py``)."""

    # sustained bf16 FLOP/s: the 410M train flagship's MFU 0.25420 of the
    # 989 TFLOP/s dense bf16 peak (H100 80GB HBM3, 700.00 W; PERF.md
    # section 5, train cell)
    compute_flops: float = 251.4e12
    # sustained HBM stream: K8 (fused AdamW) and K6a (row quantizer) reach
    # 85-86 % of the 3.35 TB/s peak (H100 80GB HBM3, 700.00 W; PERF.md
    # section 6 table)
    hbm_gbps: float = 2850.0
    # NVLink 4: 900 GB/s per card both ways, 450 each way (the H100 SXM
    # data sheet at 700 W; read only by tp > 1 rows, which the engine
    # refuses until ROADMAP item 7)
    ici_gbps: float = 450.0
    # device memory: 80 GB (H100 80GB HBM3)
    hbm_bytes: float = 80e9
    # host time of one eager 410M decode tick at batch 64: 18.380 ms wall
    # less 3.1489 ms device (H100 80GB HBM3, 700.00 W; PERF.md section 5,
    # serving cells)
    host_tick_s: float = 15.2e-3
    # seq shards on one card merge their partials in the card's memory:
    # no link hop to wait for
    ici_hop_s: float = 0.0
    sources: Tuple[str, ...] = ()     # record files that informed a rate

    @classmethod
    def calibrate(cls, artifact_dir: Optional[str],
                  patterns: Sequence[str] = ("*.jsonl", "*.log", "*.json"),
                  ) -> "RooflineConstants":
        """Fit the rate constants from records that name an NVIDIA card;
        every constant no record informs keeps its H100 default.  A file
        is read as one JSON document or, failing that, as JSON lines;
        unreadable files, non-JSON lines and records without an NVIDIA
        ``gpu`` field are skipped — absence of records is the normal
        fresh-checkout case, not an error."""
        base = cls()
        if not artifact_dir or not os.path.isdir(artifact_dir):
            return base
        compute, hbm, used = [], [], []
        seen = set()
        for pat in patterns:
            for path in sorted(glob.glob(os.path.join(artifact_dir, pat))):
                if path in seen:
                    continue
                seen.add(path)
                hit = False
                for rec in _card_records(path):
                    c = _compute_rate(rec)
                    if c:
                        compute.append(c)
                        hit = True
                    rates = list(_hbm_rates(rec))
                    if rates:
                        hbm.extend(rates)
                        hit = True
                if hit:
                    used.append(os.path.basename(path))
        out = base
        if compute:  # best observed run = achievable on this card
            out = replace(out, compute_flops=max(compute))
        if hbm:
            out = replace(out, hbm_gbps=max(hbm))
        if used:
            out = replace(out, sources=tuple(used))
        return out


def _card_records(path: str) -> Iterator[Dict[str, Any]]:
    """The records of one file whose ``gpu`` field names an NVIDIA card."""
    try:
        with open(path, errors="replace") as fh:
            text = fh.read()
    except OSError:
        return
    try:
        docs = [json.loads(text)]
    except ValueError:
        docs = []
        for line in text.splitlines():
            line = line.strip()
            if line.startswith("{"):
                try:
                    docs.append(json.loads(line))
                except ValueError:
                    continue
    for doc in docs:
        if isinstance(doc, dict) and "NVIDIA" in str(doc.get("gpu", "")):
            yield doc


def _compute_rate(rec: Dict[str, Any]) -> Optional[float]:
    """Achieved FLOP/s of a ``train`` record: tokens/s x FLOPs per token
    (6 N when the record carries no ``flops_per_token``)."""
    if rec.get("phase") != "train":
        return None
    tps = rec.get("tokens_per_s")
    if not isinstance(tps, (int, float)) or tps <= 0:
        return None
    per_tok = rec.get("flops_per_token")
    if not isinstance(per_tok, (int, float)) or per_tok <= 0:
        params = rec.get("params")
        if not isinstance(params, (int, float)) or params <= 0:
            return None
        per_tok = 6.0 * float(params)
    return float(tps) * float(per_tok)


def _hbm_rates(obj) -> Iterator[float]:
    """Achieved GB/s of every bytes-bound timed kernel in a record:
    ``bound_ms / ms`` of the card's peak HBM rate."""
    if isinstance(obj, dict):
        ms, bound = obj.get("ms"), obj.get("bound_ms")
        if (obj.get("bound_by") == "bytes" and isinstance(ms, (int, float))
                and isinstance(bound, (int, float)) and ms > 0 and bound > 0):
            yield PEAK_HBM_BYTES_S * float(bound) / float(ms) / 1e9
        for v in obj.values():
            yield from _hbm_rates(v)
    elif isinstance(obj, list):
        for v in obj:
            yield from _hbm_rates(v)


# ---------------------------------------------------------------------------
# model-shape helpers
# ---------------------------------------------------------------------------
def _flops_per_token(model_cfg) -> float:
    n = float(model_cfg.param_count)
    # 6N forward+backward for training callers; serving callers use 2N
    return 6.0 * n


def weight_stream_bytes(model_cfg, quant) -> float:
    """HBM bytes one full forward must stream for the weights (the decode
    roofline term — decode matmuls are weight-bound)."""
    per = _WEIGHT_BYTES.get(quant, 2.0)
    scale_overhead = 0.0 if quant in (None, "none", "bf16") else 0.02
    return float(model_cfg.param_count) * (per + scale_overhead * 4)


def kv_pool_bytes(model_cfg, num_blocks: int, block_size: int) -> float:
    import torch

    el = torch.empty((), dtype=model_cfg.dtype).element_size()
    return (2.0 * model_cfg.num_layers * num_blocks * block_size
            * model_cfg.num_kv_heads * model_cfg.hd * el)


# ---------------------------------------------------------------------------
# serving: feasibility + predicted tick cost
# ---------------------------------------------------------------------------
def serving_feasible(cand: Dict[str, Any], model_cfg, base: Dict[str, Any],
                     n_devices: int,
                     consts: Optional[RooflineConstants] = None,
                     ) -> Tuple[bool, str]:
    """Mirror of the engine's own constructor rejections + the memory
    model, evaluated WITHOUT building anything.  ``base`` carries the
    non-searched engine shape (max_seqs, num_blocks, block_size, ...).
    Returns ``(ok, reason)`` — reasons become leaderboard verdicts."""
    tp = int(cand.get("tp", 1))
    dp = int(cand.get("serve_replicas", 1))
    sq = int(cand.get("seq_shards", 1) or 1)
    if tp < 1 or dp < 1 or sq < 1:
        return False, "structural: tp/serve_replicas/seq_shards must be >= 1"
    if tp * dp * sq > n_devices:
        return False, (f"structural: tp*replicas*seq_shards {tp * dp * sq} "
                       f"exceeds {n_devices} devices")
    if model_cfg.num_heads % tp:
        return False, (f"structural: num_heads {model_cfg.num_heads} "
                       f"not divisible by tp {tp}")
    if dp > 1:
        # prefix caching / chunked prefill / speculation are replica-affine
        # now (per-replica cache namespaces + replica-local ctx packs) —
        # the old engine gate is gone, so the serve_replicas x
        # {prefix_caching, prefill_chunk, spec} region of the grid is
        # feasible and searchable; only the structural pool split remains
        if base.get("max_seqs", 0) % dp or base.get("num_blocks", 0) % dp:
            return False, "structural: max_seqs/num_blocks must divide replicas"
    if sq > 1 and base.get("num_blocks", 0) % (dp * sq):
        # the engine's own bring-up gate: each replica's pool must split
        # into sq equal contiguous stripes (seq-axis device slices)
        return False, ("structural: num_blocks must divide "
                       "replicas x seq_shards")
    if cand.get("quant_comm", "none") != "none" and tp <= 1:
        return False, "structural: quant_comm needs a TP mesh"
    megastep = cand.get("decode_megastep", 1)
    if megastep is not None and int(megastep) < 1:
        return False, "structural: decode_megastep must be >= 1"
    consts = consts or RooflineConstants()
    need = (weight_stream_bytes(model_cfg, cand.get("quant")) / tp
            + kv_pool_bytes(model_cfg, base.get("num_blocks", 0),
                            base.get("block_size", 32)) / max(dp * sq, 1)
            + 0.05 * consts.hbm_bytes)  # activation / workspace slack
    if need > consts.hbm_bytes:
        return False, (f"memory: est {need / 1e9:.2f} GB per device > "
                       f"HBM {consts.hbm_bytes / 1e9:.1f} GB")
    return True, "ok"


def predict_serve_cost(cand: Dict[str, Any], model_cfg,
                       base: Dict[str, Any],
                       consts: Optional[RooflineConstants] = None) -> float:
    """Predicted seconds per *emitted token* of one decode tick (lower is
    better): weight-stream HBM time + collective wire time (the
    ``comm/budget`` tick plan — row-parallel transports at the candidate's
    format plus the format-independent overhead) + host dispatch, divided
    by the tick's emitted tokens (batch x speculative amortization).  The
    same arithmetic as JAX's: equal constants give equal costs."""
    from ..comm.budget import plan_bytes, serving_tick_plan

    consts = consts or RooflineConstants()
    tp = max(int(cand.get("tp", 1)), 1)
    dp = max(int(cand.get("serve_replicas", 1)), 1)
    sq = max(int(cand.get("seq_shards", 1) or 1), 1)
    B = max(int(base.get("max_seqs", 1)), 1)
    t = weight_stream_bytes(model_cfg, cand.get("quant")) / tp \
        / (consts.hbm_gbps * 1e9)
    # KV-read roofline (the term seq sharding actually moves): a decode
    # tick streams the live context KV, bounded by one device's pool slice
    # — splitting the pool over dp x sq slices multiplies the effective
    # KV-streaming bandwidth per token by the slice count.  Callers that
    # pass no ``num_blocks`` in ``base`` (format-ordering comparisons)
    # charge nothing here, as before.
    kv_read = kv_pool_bytes(model_cfg, base.get("num_blocks", 0),
                            base.get("block_size", 32)) / (dp * sq) \
        / (consts.hbm_gbps * 1e9)
    t += kv_read
    # prefill/verify attention KV traffic (the packed-ctx kernel's own
    # roofline: pages touched x bytes/page at the pool's element format,
    # which is what kv_pool_bytes already encodes).  A spec-verify tick
    # re-streams each live sequence's cached context pages through the
    # ctx-attention kernel ON TOP of the decode read above, and chunked
    # prefill co-scheduled with decode touches roughly half the live pool
    # per tick — without these terms long-context spec/chunked candidates
    # rank as if verify attention were free.
    if cand.get("spec"):
        t += kv_read
    if cand.get("prefill_chunk"):
        t += 0.5 * kv_read
    if tp > 1 or sq > 1:
        plan = serving_tick_plan(
            model_cfg, B, tp, cand.get("quant_comm", "none"),
            sample_rows=B, compute_itemsize=2, seq_shards=sq, replicas=dp,
        )
        t += plan_bytes(plan) / (consts.ici_gbps * 1e9)
        # the ring's cost at decode widths is hop LATENCY, not bytes: S-1
        # nearest-neighbour permutes per layer sit on the critical path
        t += (sq - 1) * model_cfg.num_layers * consts.ici_hop_s
    # megastep fuses n decode ticks into ONE device burst (one graph
    # replay, one host sync), amortizing the host dispatch across the
    # fused ticks; the device time
    # per tick is unchanged.  _canon_serving pins megastep to 1 under spec
    # (the scheduler collapses it there), so no interaction term is needed.
    t += consts.host_tick_s / max(int(cand.get("decode_megastep", 1) or 1), 1)
    emitted = float(B)
    if cand.get("spec"):
        # prompt-lookup acceptance on mixed workloads lands ~0.3; each
        # verify tick emits accepted + 1 per sequence
        emitted *= 1.0 + 0.3 * float(cand.get("spec_max_draft", 0) or 0)
    return t / emitted


# ---------------------------------------------------------------------------
# training: feasibility + predicted step cost
# ---------------------------------------------------------------------------
def train_memory_bytes(cand: Dict[str, Any], model_cfg, seq_len: int) -> int:
    """Per-device state + activation estimate (the model-info pruning
    pass)."""
    n_params = float(model_cfg.param_count)
    mesh = cand.get("mesh") or {}
    shard = max(int(mesh.get("fsdp", 1)), 1)
    stage = int(cand.get("zero_stage", 0))
    micro = int(cand.get("micro_batch", 1))
    remat = cand.get("remat", "none")
    state = n_params * 4 * 3 / (shard if stage >= 1 else 1)
    compute = n_params * 2 / (shard if stage >= 3 else 1)
    d = model_cfg.hidden_size
    L = model_cfg.num_layers
    f = model_cfg.intermediate_size
    v = model_cfg.vocab_size
    tok = micro * seq_len
    act_per_layer = {
        "none": tok * (2 * f + 6 * d) * 2,
        "selective": tok * 5 * d * 2,
        "full": tok * d * 2,
    }.get(remat, tok * 5 * d * 2)
    acts = L * act_per_layer + tok * v * 6  # + fp32 logits fwd/bwd
    return int(state + compute + acts)


def training_feasible(cand: Dict[str, Any], model_cfg, seq_len: int,
                      n_devices: int,
                      consts: Optional[RooflineConstants] = None,
                      hbm_bytes: Optional[float] = None,
                      ) -> Tuple[bool, str]:
    mesh = cand.get("mesh") or {}
    extent = 1
    for v in mesh.values():
        extent *= max(int(v), 1)
    if extent > n_devices or (extent and n_devices % extent):
        return False, (f"structural: mesh extent {extent} does not divide "
                       f"{n_devices} devices")
    cap = hbm_bytes if hbm_bytes is not None \
        else (consts.hbm_bytes if consts else None)
    if cap:
        est = train_memory_bytes(cand, model_cfg, seq_len)
        if est > cap:
            return False, (f"memory: est {est / 1e9:.2f} GB > "
                           f"HBM {cap / 1e9:.1f} GB")
    return True, "ok"


def predict_train_cost(cand: Dict[str, Any], model_cfg, seq_len: int,
                       consts: Optional[RooflineConstants] = None) -> float:
    """Predicted seconds per trained token (lower is better): compute with
    the remat recompute factor + the ZeRO-3 gather/reduce wire time at the
    candidate's fsdp extent (the shared ``comm/budget.zero3_step_plan``;
    int8 when ZeRO++ qwZ/qgZ is on)."""
    from ..comm.budget import plan_bytes, zero3_step_plan

    consts = consts or RooflineConstants()
    mesh = cand.get("mesh") or {}
    fsdp = max(int(mesh.get("fsdp", 1)), 1)
    micro = max(int(cand.get("micro_batch", 1)), 1)
    tokens = micro * seq_len
    t = tokens * _flops_per_token(model_cfg) \
        * _REMAT_FLOPS.get(cand.get("remat", "none"), 1.0) \
        / consts.compute_flops
    if int(cand.get("zero_stage", 0)) >= 3 and fsdp > 1:
        fmt = "int8" if cand.get("zero_quant") else "none"
        wire = plan_bytes(zero3_step_plan(
            int(model_cfg.param_count), fsdp, fmt))
        t += wire / (consts.ici_gbps * 1e9)
    t += consts.host_tick_s
    # the host term is per step: under equal rates smaller dispatch counts
    # (bigger micro) rank first
    return t / tokens

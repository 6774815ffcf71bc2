"""Trial harness: run one candidate as a short in-process measurement — the
port of ``deepspeed_tpu/autotuning/trial.py``.

The measured half of the autotuner (roofline.py is the static half).  A
trial builds an engine in this process, drives a short workload and tears
it down; a candidate the port refuses (a training mesh of more than one
rank, which needs a process world and not this one process; ``tp`` > 1,
``serve_replicas`` > 1: ROADMAP queue 1 item 7) raises at construction,
and the search records the refusal's text as the candidate's verdict and
goes on.  A mesh of one rank runs on the one device, as JAX's one-device
mesh does; the ZeRO++ keys run as on JAX's (a no-op over one rank).

Two runners share the ``(candidate, budget) -> (score, metrics)``
protocol the search engine calls (``budget`` is the successive-halving
fraction in (0, 1]; ``score`` is higher-is-better in the bench's own
units):

- :class:`TrainTrialRunner` — a few train steps through
  ``deepspeed_tpu_torch.initialize``; score = ``tokens_per_sec``.
- :class:`ServeTrialRunner` — a shared-prefix arrival workload through
  ``ServeScheduler`` on an engine built via ``build_serve_engine``; score =
  ``serve_effective_tokens_per_sec`` (prompt + generated tokens per wall
  second), metrics carry the telemetry TTFT/TBT percentiles.  Every trial
  runs a shape REHEARSAL first (first-use work — kernel loading, a burst
  graph's capture — must not decide a search), resets the telemetry
  window, then measures; teardown goes through ``engine.close()`` and the
  zero-leak allocator audit — a trial that leaks blocks or telemetry
  namespaces would poison every trial after it.

Both run on ``device`` (CUDA unless the caller names another).
"""
from __future__ import annotations

import math

import gc
import time
from dataclasses import dataclass, replace
from typing import Any, Dict, Optional, Tuple

import numpy as np

from ..utils.logging import log_dist


@dataclass(frozen=True)
class ServeWorkload:
    """Shared-prefix arrival workload (the ``bench.py --serving`` shape):
    ``n_req`` requests sharing a ``sys_len``-token system prompt with
    ``sfx_len``-token unique suffixes, Poisson-ish arrivals, greedy
    ``max_new`` continuations."""

    n_req: int = 8
    sys_len: int = 64
    sfx_len: int = 16
    max_new: int = 8
    seed: int = 0
    arrival_mean: float = 2.0

    def scaled(self, frac: float) -> "ServeWorkload":
        """Successive-halving budget: lower rungs serve fewer requests of
        the same shape (same prompt structure -> the same packs and bursts)."""
        if frac >= 1.0:
            return self
        return replace(self, n_req=max(2, int(round(self.n_req * frac))))


class ServeTrialRunner:
    """Serve one :class:`ServeWorkload` under a candidate's engine config;
    teardown must leave the process as clean as before the trial."""

    def __init__(self, params, model_cfg, workload: ServeWorkload,
                 base: Optional[Dict[str, Any]] = None, device=None,
                 telemetry_factory=None):
        self.params = params
        self.model_cfg = model_cfg
        self.workload = workload
        self.base = dict(base or {})
        self.device = device
        self.telemetry_factory = telemetry_factory
        self.trials_run = 0

    # candidate knob -> ServeEngineConfig field
    _CAND_FIELDS = {
        "tp": "tp", "serve_replicas": "serve_replicas",
        "quant": "quantize_weights", "prefill_chunk": "prefill_chunk",
        "kv_watermark": "kv_watermark", "spec": "enable_speculation",
        "spec_max_draft": "spec_max_draft", "quant_comm": "quant_comm",
        "comm_tiles": "comm_tiles", "prefix_caching": "enable_prefix_caching",
    }

    def engine_config(self, cand: Dict[str, Any]):
        """Merge the fixed engine shape (``base``) with the candidate's
        searched knobs into a validated ``ServeEngineConfig``."""
        from ..config.config import ServeEngineConfig, _coerce

        kw = dict(self.base)
        for k, f in self._CAND_FIELDS.items():
            if k in cand:
                kw[f] = cand[k]
        if not kw.get("enable_speculation"):
            kw.pop("spec_max_draft", None)
        # decode_megastep is a ServeConfig (scheduler-tier) knob, not an
        # engine-shape field — it routes via the serve= block at build time
        kw.pop("decode_megastep", None)
        return _coerce(ServeEngineConfig, kw)

    def serve_config(self, cand: Dict[str, Any]) -> Optional[Dict[str, Any]]:
        """ServeConfig overrides carried by the candidate (the scheduler-
        tier knobs the engine shape does not own)."""
        n = int(cand.get("decode_megastep", 1) or 1)
        return {"decode_megastep": n} if n > 1 else None

    def _drive(self, sched, prompts, samp, uid_off: int, arrivals):
        steps = sched.tick_no + np.cumsum(arrivals)
        submitted = 0
        n = len(prompts)
        while submitted < n or not sched.idle:
            while submitted < n and steps[submitted] <= sched.tick_no:
                submitted += 1
                sched.submit(uid_off + submitted, prompts[submitted], samp)
            sched.tick()
        return {u: sched.pop_result(uid_off + u) for u in range(1, n + 1)}

    def __call__(self, cand: Dict[str, Any], budget: float = 1.0,
                 ) -> Tuple[float, Dict[str, Any]]:
        from ..inference.engine_v2 import build_serve_engine
        from ..inference.sampling import SamplingParams
        from ..telemetry import Telemetry, percentile_summary

        wl = self.workload.scaled(budget)
        cfg = self.model_cfg
        sec = self.engine_config(cand)
        tel = (self.telemetry_factory() if self.telemetry_factory is not None
               else Telemetry(True))
        eng = build_serve_engine(self.params, cfg, sec, telemetry=tel,
                                 serve=self.serve_config(cand),
                                 device=self.device)
        try:
            sched = eng.scheduler
            samp = SamplingParams(temperature=0.0, max_new_tokens=wl.max_new)
            rng = np.random.default_rng(wl.seed)
            sys_prompt = rng.integers(1, cfg.vocab_size, wl.sys_len).tolist()
            prompts = {
                u: sys_prompt
                + rng.integers(1, cfg.vocab_size, wl.sfx_len).tolist()
                for u in range(1, wl.n_req + 1)
            }
            arrivals = rng.poisson(wl.arrival_mean, wl.n_req)
            # shape rehearsal: replay the workload's exact arrival
            # structure with prefix-disjoint tokens, so every first-use
            # cost (kernel loading, burst-graph capture) lands OUTSIDE the
            # timed window (it must not pick the winner)
            r_sys = rng.integers(1, cfg.vocab_size, wl.sys_len).tolist()
            r_prompts = {
                u: r_sys + rng.integers(1, cfg.vocab_size, wl.sfx_len).tolist()
                for u in range(1, wl.n_req + 1)
            }
            self._drive(sched, r_prompts, samp, 20_000, arrivals)
            tel.reset_window()
            stats0 = dict(eng.stats)
            sched0 = dict(sched.stats)
            t0 = time.perf_counter()
            results = self._drive(sched, prompts, samp, 0, arrivals)
            dt = time.perf_counter() - t0
            total = sum(len(p) for p in prompts.values()) + sum(
                len(r) for r in results.values()
            )
            tel.flush()
            pct = percentile_summary(tel.registry, (
                f"{eng._ns}/ttft_ms", f"{eng._ns}/tbt_ms",
                f"{eng._ns}/queue_wait_ms", f"{eng._ns}/e2e_ms",
            ), qs=(50, 90))
            score = total / dt
            metrics = {
                "serve_effective_tokens_per_sec": round(score, 2),
                "requests": wl.n_req,
                "total_tokens": int(total),
                "wall_s": round(dt, 4),
                "finished": sched.stats["finished"] - sched0.get("finished", 0),
                "preemptions": sched.stats["preemptions"]
                - sched0.get("preemptions", 0),
                "decode_ticks": eng.stats["decode_ticks"]
                - stats0.get("decode_ticks", 0),
                "spec_accept_rate": round(
                    (eng.stats["spec_accepted"] - stats0.get("spec_accepted", 0))
                    / max(1, eng.stats["spec_drafted"]
                          - stats0.get("spec_drafted", 0)), 3),
                "latency_percentiles": pct,
            }
        finally:
            audit = eng.close()
            del eng
            gc.collect()
        if audit["blocks_in_use"]:
            raise RuntimeError(
                f"serve trial leaked {audit['blocks_in_use']} KV blocks "
                f"(candidate {cand})"
            )
        self.trials_run += 1
        return score, metrics


class TrainTrialRunner:
    """A few train steps under a candidate's config; score = tokens/sec
    (the flagship training metric).  ``model_factory(remat)`` builds a
    fresh model shell per trial."""

    def __init__(self, model_factory, base_config: Dict[str, Any],
                 seq_len: int, steps: int = 3, device=None):
        self.device = device
        self.model_factory = model_factory
        self.base_config = dict(base_config)
        self.seq_len = seq_len
        self.steps = steps
        self.trials_run = 0

    def config_for(self, cand: Dict[str, Any]) -> Dict[str, Any]:
        config = dict(self.base_config)
        config["train_micro_batch_size_per_gpu"] = int(cand["micro_batch"])
        config.setdefault("steps_per_print", 1_000_000)
        zo = dict(config.get("zero_optimization", {}))
        zo["stage"] = int(cand.get("zero_stage", zo.get("stage", 0)))
        if cand.get("zero_quant"):
            zo["zero_quantized_weights"] = True
            zo["zero_quantized_gradients"] = True
        config["zero_optimization"] = zo
        return config

    def __call__(self, cand: Dict[str, Any], budget: float = 1.0,
                 ) -> Tuple[float, Dict[str, Any]]:
        from .. import initialize

        steps = max(1, int(round(self.steps * budget)))
        config = self.config_for(cand)
        engine = None
        try:
            model = self.model_factory(cand.get("remat", "none"))
            axes = dict(cand.get("mesh") or {})
            if math.prod(axes.values()) > 1:
                raise NotImplementedError(
                    f"mesh {axes}: a trial runs in this one process; a mesh of more than "
                    "one rank needs a process world (ROADMAP queue 1 item 7)")
            engine, _, _, _ = initialize(model=model, config=config, device=self.device)
            vocab = getattr(getattr(model, "cfg", None), "vocab_size", 1000)
            rng = np.random.default_rng(0)
            dp = engine.dp_world_size
            micro = int(cand["micro_batch"])
            batch = {
                "input_ids": rng.integers(
                    0, vocab, (1, micro * dp, self.seq_len + 1)
                ).astype(np.int32)
            }
            loss = engine.train_batch(batch)  # warm-up
            float(loss)
            t0 = time.perf_counter()
            for _ in range(steps):
                loss = engine.train_batch(batch)
            float(loss)
            dt = (time.perf_counter() - t0) / steps
            score = micro * dp * self.seq_len / dt
            metrics = {
                "tokens_per_sec": round(score, 1),
                "step_time_s": round(dt, 5),
                "steps": steps,
                "loss": float(loss),
            }
        finally:
            del engine
            gc.collect()
        self.trials_run += 1
        log_dist(f"autotune trial {cand} -> {metrics['tokens_per_sec']} tok/s")
        return score, metrics

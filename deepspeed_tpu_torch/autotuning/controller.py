"""Online adaptation: a telemetry-driven controller that retunes the live
serving engine under traffic drift — the port of
``deepspeed_tpu/autotuning/controller.py`` (pure Python over the port's
``telemetry.RateView`` and ``ServeScheduler.apply_knobs`` / ``signals`` /
``knobs``; the same signals give the same decision log).

The offline autotuner (``space.py``/``roofline.py``/``trial.py``) picks ONE
static config per workload; production traffic is nonstationary — prefix-hit
rate, prompt-length mix, and speculative accept rate drift by the minute.
:class:`OnlineController` closes that loop: a background thread samples the
live telemetry registry each *epoch* (windowed TTFT/TBT percentiles, accept
EMA, prefix-hit rate, wire-byte rate, pool headroom, queue depth) and
retunes the knobs that need no rebuild through the scheduler's locked
intake surface — ``scheduler.apply_knobs`` stages a validated batch that the
single-owner tick applies at its own boundary, so no dispatch phase ever
observes a knob change mid-burst.

Knob tiers
    *live* (this controller, no rebuild): ``prefill_chunk``,
    ``kv_watermark``, ``spec_max_draft`` / ``enable_speculation``, shed /
    watchdog / deadline thresholds, ``decode_megastep``.
    *rebuild* (frozen into the engine's weights, pool or captured graphs):
    ``tp``, ``serve_replicas``, ``quantize_weights``, ``quant_comm``,
    ``comm_tiles`` (the port's engine refuses ``tp``, ``serve_replicas``,
    ``quant_comm`` and ``comm_tiles`` until ROADMAP queue 1 item 7).  For
    these the controller only PROPOSES: a
    roofline-scored candidate whose predicted win clears
    ``adaptation.rebuild_hysteresis`` is parked on
    ``take_rebuild_proposal()`` for the engine's OWNER thread to act on
    (``engine.close()`` + ``build_serve_engine`` — teardown is
    leak-audited, and close() must never run on the controller thread:
    it is a blocking drain).

Guarded A/B epochs
    Every applied retune opens a *guard*: the triggering metric's value is
    the baseline, and after ``guard_epochs`` epochs the fresh value is
    compared against it.  A regression beyond ``regress_tolerance`` rolls
    the knobs back to their previous values and starts a
    ``cooldown_epochs`` quiet period — a controller that thrashes is worse
    than no controller.  Every decision (applied / kept / rolled_back /
    rejected / proposed) is appended to ``decisions`` with the full signal
    snapshot that triggered it.

Concurrency: the epoch loop paces on a ``Condition.wait(timeout)`` and steps OUTSIDE it;
``stop()`` flips the flag under the condition and joins outside every lock;
the controller thread never holds its own lock while calling into the
scheduler (no cross-component lock-order edge) and never touches the engine
object at all — construction-time wiring (``attach_controller``) captures
the scheduler handle, telemetry namespaces, and static shape facts on the
owner thread, so the thread-reachable methods stay free of ``engine``/
``kv`` attribute loads and of tick/step dispatch calls.
"""
from __future__ import annotations

import threading
from typing import Any, Callable, Dict, List, Optional

from ..config.config import AdaptationConfig, _coerce
from ..telemetry import RateView, Telemetry

_MIN_WATERMARK = 1.0 / 64.0
# guard epochs where the guarded metric saw zero new samples don't count
# toward the verdict — the guard is held open up to this many extra epochs
# waiting for post-retune traffic, then gives up as inconclusive ("kept")
_GUARD_MAX_EXTENDS = 16


def _lifetime_key(metric: Optional[str]) -> Optional[str]:
    """Map a guarded quantile metric (``ttft_ms_p90``) to the lifetime
    sample-count signal of its histogram (``ttft_ms_lifetime_n``); None for
    metrics with no per-sample count (EMAs, rates)."""
    if metric:
        for fam in ("ttft_ms", "tbt_ms"):
            if metric.startswith(fam + "_p"):
                return fam + "_lifetime_n"
    return None


class _SumSource:
    """``RateView`` source summing several counters (e.g. emitted tokens =
    plain decode + burst + verify emissions)."""

    __slots__ = ("_counters",)

    def __init__(self, counters):
        self._counters = tuple(counters)

    @property
    def value(self) -> float:
        return sum(c.value for c in self._counters)


class OnlineController:
    """Telemetry-driven live retuner for one serve engine's scheduler.

    Construct via :func:`attach_controller` (it does the owner-thread
    wiring); drive either with ``start()``/``stop()`` (wall-clock epochs)
    or by calling ``step_epoch()`` directly (deterministic tests and
    drivers that pace epochs by ticks)."""

    def __init__(
        self,
        scheduler,
        *,
        config: Optional[AdaptationConfig] = None,
        telemetry: Optional[Telemetry] = None,
        serve_ns: str = "serve",
        comm_ns: Optional[str] = None,
        prefill_budget: Optional[int] = None,
        clock: Optional[Callable[[], float]] = None,
        rebuild_scorer: Optional[Callable[[Dict[str, Any]],
                                          Optional[Dict[str, Any]]]] = None,
    ):
        self._sched = scheduler
        self.cfg: AdaptationConfig = config if isinstance(
            config, AdaptationConfig) else _coerce(AdaptationConfig, config)
        tel = telemetry or getattr(scheduler, "telemetry", None) \
            or Telemetry.ensure(None)
        self._tel = tel
        self._clock = clock or tel.clock
        # signal sources: the engine's request-latency histograms (windowed
        # views) and serve/comm counters — registry objects are memoized by
        # name, so these are the very handles the engine increments
        self._hists = tel.request_hists(serve_ns)
        self._c = tel.counters(serve_ns, (
            "decode_emitted", "burst_emitted", "spec_emitted",
            "spec_drafted", "spec_accepted", "timed_out", "shed_rejections",
        ))
        self._emit_rate = RateView(_SumSource((
            self._c["decode_emitted"], self._c["burst_emitted"],
            self._c["spec_emitted"],
        )))
        self._wire_rate = RateView(
            tel.counters(comm_ns, ("bytes_on_wire",))["bytes_on_wire"]
        ) if comm_ns else None
        self._prefill_budget = prefill_budget
        self._rebuild_scorer = rebuild_scorer
        # epoch pacing + shutdown flag; the flag is only ever written under
        # this condition, the epoch work runs outside it
        self._cv = threading.Condition()
        self._stop = False
        self._thread: Optional[threading.Thread] = None
        self.epoch = 0
        self.decisions: List[Dict[str, Any]] = []
        self.last_error: Optional[str] = None
        self._accept_ema: Optional[float] = None
        self._prev: Dict[str, float] = {}  # counter values at last epoch
        self._guard: Optional[Dict[str, Any]] = None
        self._cooldown = 0
        self._injected: Optional[Dict[str, Any]] = None
        self._rebuild_proposal: Optional[Dict[str, Any]] = None

    # -- lifecycle ----------------------------------------------------------
    def start(self) -> None:
        """Spawn the epoch thread (idempotent while running)."""
        if self._thread is not None:
            return
        with self._cv:
            self._stop = False
        t = threading.Thread(target=self._run, name="adapt-controller",
                             daemon=True)
        self._thread = t
        t.start()

    def stop(self, timeout: float = 10.0) -> None:
        """Idempotent shutdown: flag + wake under the condition, join
        OUTSIDE every lock (a blocking join under a lock is a deadlock
        waiting to happen)."""
        t = self._thread
        with self._cv:
            self._stop = True
            self._cv.notify_all()
        if t is not None:
            t.join(timeout)
        self._thread = None

    def _run(self) -> None:
        errors = 0
        while True:
            with self._cv:
                if self._stop:
                    return
                self._cv.wait(self.cfg.epoch_s)
                if self._stop:
                    return
            try:
                self.step_epoch()
                errors = 0
            except Exception as e:  # a controller crash must not take
                # the serve loop's observability down with it — record,
                # back off, and give up only on a persistent fault
                self.last_error = f"{type(e).__name__}: {e}"
                errors += 1
                if errors >= 3:
                    return

    # -- the epoch state machine --------------------------------------------
    def step_epoch(self, now: Optional[float] = None) -> Dict[str, Any]:
        """One controller epoch: snapshot signals, then either settle an
        open guard (possibly rolling back), sit out a cooldown, or propose
        at most ONE retune (single-knob changes keep the A/B attribution
        clean).  Returns the signal snapshot (tests assert on it)."""
        now = float(self._clock()) if now is None else float(now)
        self.epoch += 1
        sig = self._snapshot(now)
        if self._guard is not None:
            self._check_guard(sig)
        elif self._cooldown > 0:
            self._cooldown -= 1
        elif not self._retune(sig):
            self._consider_rebuild(sig)
        return sig

    def _snapshot(self, now: float) -> Dict[str, Any]:
        sig = dict(self._sched.signals())
        sig["epoch"] = self.epoch
        sig["now"] = now
        sig["emitted_tokens_per_s"] = self._emit_rate.sample(now)
        if self._wire_rate is not None:
            sig["wire_bytes_per_s"] = self._wire_rate.sample(now)
        for key, h in (("ttft_ms", self._hists["ttft"]),
                       ("tbt_ms", self._hists["tbt"])):
            q = h.window_quantiles((50, 90))
            sig[f"{key}_p50"] = q["p50"]
            sig[f"{key}_p90"] = q["p90"]
            sig[f"{key}_n"] = h.window_count
            sig[f"{key}_lifetime_n"] = h.count
        for name in ("spec_drafted", "spec_accepted", "timed_out",
                     "shed_rejections"):
            v = self._c[name].value
            sig[f"{name}_delta"] = v - self._prev.get(name, 0)
            self._prev[name] = v
        pre = sig.get("preemptions", 0)
        sig["preemptions_delta"] = pre - self._prev.get("preemptions", 0)
        self._prev["preemptions"] = pre
        if sig["spec_drafted_delta"] > 0:
            r = sig["spec_accepted_delta"] / sig["spec_drafted_delta"]
            self._accept_ema = r if self._accept_ema is None \
                else 0.5 * self._accept_ema + 0.5 * r
        sig["spec_accept_ema"] = self._accept_ema
        sig["knobs"] = self._sched.knobs()
        return sig

    def _retune(self, sig: Dict[str, Any]) -> bool:
        prop = self._propose(sig)
        if prop is None:
            return False
        action, knobs, reason, metric, better = prop
        prev = {k: sig["knobs"].get(k) for k in knobs}
        try:
            self._sched.apply_knobs(**knobs)
        except ValueError as e:
            self._log(dict(epoch=self.epoch, action=action, knobs=knobs,
                           reason=reason, outcome="rejected", error=str(e),
                           signals=sig))
            return False
        baseline = sig.get(metric)
        self._guard = dict(action=action, knobs=knobs, prev=prev,
                           metric=metric, better=better, baseline=baseline,
                           epochs_left=self.cfg.guard_epochs,
                           n0=sig.get(_lifetime_key(metric)),
                           extends_left=_GUARD_MAX_EXTENDS)
        self._log(dict(epoch=self.epoch, action=action, knobs=knobs,
                       prev=prev, reason=reason, metric=metric,
                       baseline=baseline, outcome="applied", signals=sig))
        return True

    def _check_guard(self, sig: Dict[str, Any]) -> None:
        g = self._guard
        g["epochs_left"] -= 1
        if g["epochs_left"] > 0:
            return
        # with a free-running thread, guard_epochs can elapse before a
        # single post-retune request lands in the guarded metric's window
        # — the comparison would read back the pre-retune samples and
        # always "keep".  Hold the guard open (bounded) until the metric's
        # lifetime count moves; give up as inconclusive at the cap.
        nkey = _lifetime_key(g["metric"])
        n_now = sig.get(nkey) if nkey else None
        if (n_now is not None and g.get("n0") is not None
                and n_now <= g["n0"] and g["extends_left"] > 0):
            g["extends_left"] -= 1
            g["epochs_left"] = 1
            return
        self._guard = None
        current = sig.get(g["metric"])
        base = g["baseline"]
        tol = self.cfg.regress_tolerance
        # a zero/absent baseline is inconclusive (the window had no
        # samples when the change landed) — keep rather than thrash
        regressed = False
        if current is not None and base:
            regressed = (current * tol < base) if g["better"] == "higher" \
                else (current > base * tol)
        if not regressed:
            self._log(dict(epoch=self.epoch, action=g["action"],
                           knobs=g["knobs"], metric=g["metric"],
                           baseline=base, current=current, outcome="kept",
                           signals=sig))
            return
        outcome = "rolled_back"
        try:
            self._sched.apply_knobs(**g["prev"])
        except ValueError as e:  # previous values can no longer apply
            # (e.g. spec re-enable while live) — record, cooldown anyway
            outcome = f"rollback_failed: {e}"
        self._cooldown = self.cfg.cooldown_epochs
        self._log(dict(
            epoch=self.epoch, action="rollback", knobs=g["prev"],
            metric=g["metric"], baseline=base, current=current,
            reason=(f"{g['metric']} regressed past tolerance "
                    f"{tol:g} after {g['action']}"),
            outcome=outcome, signals=sig))

    def _propose(self, sig: Dict[str, Any]):
        """Rule chain, first match wins: (action, knobs, reason, guard
        metric, 'higher'|'lower')."""
        cfg = self.cfg
        if self._injected is not None:
            (knobs, metric, better), self._injected = self._injected, None
            return ("injected", knobs, "injected retune (test hook)",
                    metric, better)
        k = sig["knobs"]
        ema = sig.get("spec_accept_ema")
        # 1. speculative quality: a draft costs a verify position whether
        # or not it is accepted — low acceptance is pure overhead
        if k["enable_speculation"] and ema is not None:
            if ema < 0.35:
                if k["spec_max_draft"] > 1:
                    return ("spec_draft_down",
                            {"spec_max_draft": max(1, k["spec_max_draft"] // 2)},
                            f"accept EMA {ema:.2f} < 0.35",
                            "emitted_tokens_per_s", "higher")
                return ("spec_off", {"enable_speculation": False},
                        f"accept EMA {ema:.2f} < 0.35 at draft width 1",
                        "emitted_tokens_per_s", "higher")
            if ema > 0.85 and k["spec_max_draft"] < cfg.max_spec_draft:
                return ("spec_draft_up",
                        {"spec_max_draft": k["spec_max_draft"] + 1},
                        f"accept EMA {ema:.2f} > 0.85",
                        "emitted_tokens_per_s", "higher")
        # 2. TTFT SLO pressure trumps throughput: un-fuse the megastep so
        # admissions react per tick again
        if (cfg.ttft_slo_ms is not None and k["decode_megastep"] > 1
                and sig.get("ttft_ms_n", 0) >= cfg.min_window
                and sig["ttft_ms_p90"] > cfg.ttft_slo_ms):
            return ("megastep_down",
                    {"decode_megastep": max(1, k["decode_megastep"] // 2)},
                    (f"ttft p90 {sig['ttft_ms_p90']:.1f}ms over SLO "
                     f"{cfg.ttft_slo_ms:g}ms"),
                    "ttft_ms_p90", "lower")
        # 3. decode-bound stretch (live batch, empty queue, no spec):
        # raise the megastep ceiling to amortize host syncs.  The
        # scheduler's plan still self-collapses to per-tick whenever
        # admissions or prefill chunks appear, so a backlog forming later
        # does not need this rule to reverse itself.
        if (not k["enable_speculation"] and sig["queue_depth"] == 0
                and sig["running"] > 0
                and sig.get("tbt_ms_n", 0) >= cfg.min_window
                and k["decode_megastep"] < cfg.max_decode_megastep):
            return ("megastep_up",
                    {"decode_megastep": min(cfg.max_decode_megastep,
                                            max(2, k["decode_megastep"] * 2))},
                    "decode-bound: fuse device ticks, one host sync per burst",
                    "tbt_ms_p90", "lower")
        # 4. admission backlog behind long prefills: widen the chunk
        if (self._prefill_budget
                and sig["queue_depth"] > max(2, sig["running"])
                and k["prefill_chunk"] < self._prefill_budget):
            return ("prefill_chunk_up",
                    {"prefill_chunk": min(self._prefill_budget,
                                          k["prefill_chunk"] * 2)},
                    f"queue depth {sig['queue_depth']} backed up on prefill",
                    "ttft_ms_p90", "lower")
        # 5. KV watermark: preemption churn <-> admission starvation
        if sig.get("preemptions_delta", 0) > 0 and k["kv_watermark"] < 0.5:
            return ("watermark_up",
                    {"kv_watermark": min(0.5, max(k["kv_watermark"] * 2,
                                                  _MIN_WATERMARK))},
                    "preemption churn: reserve more decode headroom",
                    "emitted_tokens_per_s", "higher")
        if (sig["queue_depth"] > 0
                and sig.get("preemptions_delta", 0) == 0
                and sig["headroom_fraction"] > 0.5
                and k["kv_watermark"] > _MIN_WATERMARK):
            return ("watermark_down",
                    {"kv_watermark": max(_MIN_WATERMARK,
                                         k["kv_watermark"] / 2)},
                    "idle pool with a waiting queue: admit deeper",
                    "emitted_tokens_per_s", "higher")
        # 6. shed gate too tight: rejecting while every admitted request
        # still meets its deadline
        if (sig["shedding"] and sig.get("timed_out_delta", 0) == 0
                and sig.get("shed_rejections_delta", 0) > 0
                and k["shed_queue_depth"] is not None):
            return ("shed_relax",
                    {"shed_queue_depth": k["shed_queue_depth"] * 2},
                    "shedding with zero deadline misses",
                    "emitted_tokens_per_s", "higher")
        return None

    # -- rebuild escalation -------------------------------------------------
    def _consider_rebuild(self, sig: Dict[str, Any]) -> None:
        if (not self.cfg.allow_rebuild or self._rebuild_scorer is None
                or self._rebuild_proposal is not None):
            return
        out = self._rebuild_scorer(sig)
        if not out:
            return
        ratio = float(out.get("predicted_ratio", 0.0))
        if ratio < self.cfg.rebuild_hysteresis:
            return
        self._rebuild_proposal = dict(out, epoch=self.epoch, signals=sig)
        self._log(dict(
            epoch=self.epoch, action="propose_rebuild",
            knobs=out.get("candidate"),
            reason=(f"predicted {ratio:.2f}x win >= hysteresis "
                    f"{self.cfg.rebuild_hysteresis:g}"),
            outcome="proposed", signals=sig))

    def take_rebuild_proposal(self) -> Optional[Dict[str, Any]]:
        """Pop the pending rebuild proposal (owner thread).  The OWNER
        performs the actual ``engine.close()`` + ``build_serve_engine`` —
        a blocking teardown must never run on the controller thread."""
        prop, self._rebuild_proposal = self._rebuild_proposal, None
        return prop

    # -- test hooks ---------------------------------------------------------
    def inject_retune(self, _metric: str = "emitted_tokens_per_s",
                      _better: str = "higher", **knobs: Any) -> None:
        """Force the NEXT proposing epoch to apply ``knobs``, guarded on
        ``_metric`` like any organic retune — the bench's
        rollback-fires-on-a-bad-retune proof uses this."""
        self._injected = (dict(knobs), _metric, _better)

    def _log(self, decision: Dict[str, Any]) -> None:
        self.decisions.append(decision)


def attach_controller(engine, config=None, *, clock=None,
                      rebuild_scorer=None) -> OnlineController:
    """Owner-thread wiring: capture the scheduler handle, telemetry
    namespaces, and static shape facts HERE so the controller thread never
    loads an engine attribute.  ``config`` defaults to the engine's
    ``serve.adaptation`` block."""
    cfg = config if config is not None else engine.serve.adaptation
    sched = engine.scheduler  # materializes the lazy scheduler
    return OnlineController(
        sched, config=cfg, telemetry=engine.telemetry,
        serve_ns=engine._ns, comm_ns=engine._comm_ns,
        prefill_budget=engine.prefill_budget,
        clock=clock, rebuild_scorer=rebuild_scorer)


def roofline_rebuild_scorer(model_cfg, base: Dict[str, Any],
                            current: Dict[str, Any], n_devices: int, *,
                            consts=None, candidates=None):
    """Build a rebuild scorer over the SHARED offline knob registry: the
    current config and every feasible ``serving_space`` candidate are
    scored with ``predict_serve_cost`` (sec per emitted token, lower is
    better) and the best strictly-better candidate is returned with its
    predicted win ratio.  The controller applies the hysteresis gate and
    only proposes: the owner thread decides whether to rebuild."""
    from .roofline import predict_serve_cost, serving_feasible
    from .space import serving_space

    cands = list(candidates) if candidates is not None \
        else serving_space().grid()

    def scorer(sig: Dict[str, Any]) -> Optional[Dict[str, Any]]:
        cur = dict(current)
        live = sig.get("knobs") or {}
        if "decode_megastep" in live:  # live drift rides into the baseline
            cur["decode_megastep"] = live["decode_megastep"]
        cur_cost = predict_serve_cost(cur, model_cfg, base, consts)
        best, best_cost = None, cur_cost
        for c in cands:
            ok, _ = serving_feasible(c, model_cfg, base, n_devices, consts)
            if not ok:
                continue
            cost = predict_serve_cost(c, model_cfg, base, consts)
            if cost < best_cost:
                best, best_cost = c, cost
        if best is None:
            return None
        return {"candidate": dict(best), "predicted_cost": best_cost,
                "current_cost": cur_cost,
                "predicted_ratio": cur_cost / best_cost if best_cost else 0.0}

    return scorer

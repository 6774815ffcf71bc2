"""Roofline-seeded configuration search with successive halving — the port
of ``deepspeed_tpu/autotuning/autotuner.py`` (the search itself is pure
Python: the same space, feasibility, costs and runner scores give JAX's
trial order, winner and leaderboard).

The unified rewrite of the original micro-batch x remat x ZeRO grid
search (which predated the serving stack entirely): one search engine
covering both workloads —

- **training**: mesh shape x ZeRO stage / ZeRO++ qwZ-qgZ x remat x
  micro-batch (:func:`autotune_model`);
- **serving**: TP width x serve replicas x weight quant format x
  prefill_chunk x kv_watermark x speculation x quantized TP collectives
  (:func:`autotune_serving`).

The pipeline:

1. enumerate the :class:`~.space.SearchSpace` grid (deterministic order);
2. **prune** structurally/memory-infeasible candidates with the roofline
   feasibility model — no engine is ever built for them;
3. **rank** survivors by predicted cost (roofline.py) and take the top
   ``top_k`` as the rung-0 cohort;
4. **successive halving**: run the cohort as short in-process trials at
   the first budget fraction, promote the best ``1/eta`` to the next
   rung's larger budget, repeat to the full-budget final rung.  An
   ``incumbent`` candidate (the current hand-tuned config) is always
   carried to the final rung, so the search can never return something it
   measured worse than the config you already have;
5. the **winner** is the measured-score argmax of the final rung, scored
   by the same metrics the bench emits (``tokens_per_sec`` /
   ``serve_effective_tokens_per_sec``) so tuner numbers and bench numbers
   are directly comparable.

Every candidate — pruned, errored, skipped or measured — lands in the
per-trial leaderboard (:func:`leaderboard` / :func:`write_leaderboard`)
with its predicted cost, feasibility verdict and measured score.

Failures (an out-of-memory, the port's refusal of a knob it does not run
yet — ``error:NotImplementedError: <its text>``) mark a candidate
``error:*`` and the search continues; a kernel or CUDA fault
(``ops.kernels.surfaces``, out-of-memory excepted) is no verdict and
raises out of the search.  Determinism is a tested contract (same seed +
same space -> same trial order and same winner).
"""
from __future__ import annotations

import json
import math
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..ops.kernels import surfaces
from ..utils.logging import log_dist
from .space import SearchSpace, candidate_key

TUNING_METRICS = ("throughput", "latency")

# verdicts
PENDING = "pending"        # enumerated, not yet considered
NOT_RUN = "not_run"        # feasible but below the rung-0 cut / budget cap
OK = "ok"                  # measured at least once


@dataclass
class Trial:
    """One candidate's full search record (one leaderboard row)."""

    index: int                       # enumeration order in the grid
    candidate: Dict[str, Any]
    predicted_cost: Optional[float] = None   # roofline s/token (lower=better)
    verdict: str = PENDING           # ok | pruned:* | error:* | not_run
    score: Optional[float] = None    # bench-metric units (higher=better)
    metrics: Dict[str, Any] = field(default_factory=dict)
    rung: int = -1                   # highest rung measured at
    run_order: List[int] = field(default_factory=list)  # global launch seq

    @property
    def feasible(self) -> bool:
        return not self.verdict.startswith("pruned")

    @property
    def measured(self) -> bool:
        return self.score is not None

    def row(self) -> Dict[str, Any]:
        return {
            "index": self.index,
            "candidate": self.candidate,
            "predicted_cost": self.predicted_cost,
            "verdict": self.verdict,
            "score": self.score,
            "metrics": self.metrics,
            "rung": self.rung,
            "run_order": self.run_order,
        }


class Autotuner:
    """The search engine.  ``runner(candidate, budget) -> (score, metrics)``
    measures one candidate; ``feasibility(cand) -> (ok, reason)`` and
    ``cost_model(cand) -> float`` are the roofline hooks (both optional —
    without them every candidate is feasible with flat predicted cost and
    the search degrades to plain successive halving over the grid order).

    ``metric`` sets the score's direction: ``"throughput"`` treats the
    runner's score as higher-is-better (tokens/s), ``"latency"`` as
    lower-is-better (return step time / TTFT as the score) — promotion
    and winner selection honor it.  ``seed`` is provenance: the search
    itself is deterministic (stable sorts, grid-order tie-breaks); the
    seed names the measurement-noise realization a stochastic runner
    should derive its own rngs from."""

    def __init__(
        self,
        space: SearchSpace,
        runner: Callable[[Dict[str, Any], float], Tuple[float, Dict[str, Any]]],
        *,
        cost_model: Optional[Callable[[Dict[str, Any]], float]] = None,
        feasibility: Optional[Callable[[Dict[str, Any]], Tuple[bool, str]]] = None,
        metric: str = "throughput",
        rungs: Sequence[float] = (0.25, 1.0),
        eta: int = 2,
        top_k: int = 8,
        max_trials: Optional[int] = None,
        seed: int = 0,
        incumbent: Optional[Dict[str, Any]] = None,
    ):
        if metric not in TUNING_METRICS:
            raise ValueError(f"metric must be one of {TUNING_METRICS}")
        if list(rungs) != sorted(rungs) or not rungs or rungs[-1] != 1.0:
            raise ValueError(f"rungs must ascend and end at 1.0, got {rungs}")
        if eta < 2:
            raise ValueError(f"eta must be >= 2, got {eta}")
        self.space = space
        self.runner = runner
        self.cost_model = cost_model
        self.feasibility = feasibility
        self.metric = metric
        self.rungs = tuple(rungs)
        self.eta = eta
        self.top_k = top_k
        self.max_trials = max_trials
        self.seed = seed
        self.incumbent = dict(incumbent) if incumbent is not None else None
        self.trials: List[Trial] = []
        self.pruned_fraction: float = 0.0
        self._launches = 0
        # score direction: throughput = higher wins, latency = lower wins
        self._sign = -1.0 if metric == "throughput" else 1.0

    def _score_key(self, t: Trial):
        """Sort key under the metric's direction; grid order breaks ties
        so same-seed re-runs replay identical promotions."""
        return (self._sign * t.score, t.index)

    # -- phases --------------------------------------------------------------
    def _enumerate(self) -> List[Trial]:
        self.trials = [Trial(index=i, candidate=c)
                       for i, c in enumerate(self.space.grid())]
        return self.trials

    def _prune_and_predict(self) -> List[Trial]:
        """Static pass over EVERY candidate: feasibility verdict + predicted
        cost (predicted even for pruned ones — the leaderboard shows what
        the model thought of the whole grid).  Returns the survivors."""
        survivors: List[Trial] = []
        for t in self.trials:
            if self.cost_model is not None:
                try:
                    t.predicted_cost = float(self.cost_model(t.candidate))
                except Exception as e:  # cost model must never kill a search
                    t.predicted_cost = None
                    log_dist(f"autotune: cost model failed on "
                             f"{t.candidate}: {e}")
            ok, reason = (True, "ok") if self.feasibility is None \
                else self.feasibility(t.candidate)
            if not ok:
                t.verdict = reason if reason.startswith("pruned") \
                    else f"pruned:{reason}"
            else:
                t.verdict = NOT_RUN  # upgraded to ok when measured
                survivors.append(t)
        n = len(self.trials)
        self.pruned_fraction = (n - len(survivors)) / n if n else 0.0
        return survivors

    def _rank(self, trials: List[Trial]) -> List[Trial]:
        """Roofline seeding: predicted cost ascending, grid order breaking
        ties (and standing in entirely when there is no cost model)."""
        return sorted(
            trials,
            key=lambda t: (t.predicted_cost if t.predicted_cost is not None
                           else math.inf, t.index),
        )

    def _is_incumbent(self, t: Trial) -> bool:
        return (self.incumbent is not None
                and candidate_key(t.candidate) == candidate_key(self.incumbent))

    def _launch(self, t: Trial, rung: int) -> None:
        budget = self.rungs[rung]
        self._launches += 1
        t.run_order.append(self._launches)
        try:
            score, metrics = self.runner(t.candidate, budget)
            t.score = float(score)
            t.metrics = dict(metrics)
            t.rung = rung
            t.verdict = OK
            log_dist(
                f"autotune[r{rung} b={budget:g}] #{t.index} {t.candidate} "
                f"-> {t.score:,.1f}"
            )
        except Exception as e:  # infeasible in practice: record, continue
            if surfaces(e) and not isinstance(e, torch.cuda.OutOfMemoryError):
                raise  # a kernel or CUDA fault is the port's, not the candidate's
            err = f"error:{type(e).__name__}: {str(e)[:200]}"
            if t.measured:
                # a higher-rung failure must not erase the measurement a
                # lower rung already paid for (transient OOM / flaky
                # first use): keep score+rung, note the failure in metrics
                t.metrics[f"error_at_rung_{rung}"] = err
            else:
                t.verdict = err
                t.rung = rung
            log_dist(f"autotune[r{rung}] #{t.index} FAILED ({err})")

    # -- the search ----------------------------------------------------------
    def search(self) -> Tuple[Optional[Trial], List[Trial]]:
        """Returns ``(winner trial or None, every trial)``."""
        self._enumerate()
        survivors = self._prune_and_predict()
        log_dist(
            f"autotune: {len(self.trials)} candidates, "
            f"{len(survivors)} survive the roofline prune "
            f"({100 * self.pruned_fraction:.0f}% pruned)"
        )
        if not survivors:
            return None, self.trials
        ranked = self._rank(survivors)
        cohort = ranked[: self.top_k]
        # the incumbent always gets measured (and, below, always reaches
        # the final rung): the search cannot return worse-than-hand-tuned.
        # Prepended, not appended — under a tight max_trials budget the
        # cohort's TAIL is what gets cut, and cutting the incumbent would
        # silently void that guarantee
        inc = next((t for t in survivors if self._is_incumbent(t)), None)
        if inc is not None and inc not in cohort:
            cohort.insert(0, inc)

        budget_left = (self.max_trials if self.max_trials is not None
                       else len(cohort) * len(self.rungs))
        for rung in range(len(self.rungs)):
            runnable = []
            for t in cohort:
                if budget_left <= 0:
                    break
                budget_left -= 1
                self._launch(t, rung)
                if t.measured and t.rung == rung:
                    runnable.append(t)
            if not runnable:
                break
            if rung == len(self.rungs) - 1:
                cohort = runnable
                break
            keep = max(1, math.ceil(len(runnable) / self.eta))
            promoted = sorted(runnable, key=self._score_key)[:keep]
            if inc is not None and inc.measured and inc not in promoted:
                promoted.insert(0, inc)  # budget cuts the tail, never inc
            cohort = promoted

        final = [t for t in self.trials
                 if t.measured and t.rung == len(self.rungs) - 1]
        pool = final or [t for t in self.trials if t.measured]
        if not pool:
            return None, self.trials
        winner = min(pool, key=self._score_key)
        log_dist(
            f"autotune: WINNER #{winner.index} {winner.candidate} "
            f"@ {winner.score:,.1f}"
        )
        return winner, self.trials


# ---------------------------------------------------------------------------
# leaderboard
# ---------------------------------------------------------------------------
def leaderboard(trials: Sequence[Trial],
                meta: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    """Every candidate's row (measured first, best score on top; then
    errored, not-run, pruned — all present, nothing silently dropped)."""
    def order(t: Trial):
        bucket = (0 if t.measured else
                  1 if t.verdict.startswith("error") else
                  2 if t.verdict == NOT_RUN else 3)
        return (bucket, -(t.score or 0.0), t.index)

    return {
        "meta": dict(meta or {}),
        "candidates": len(trials),
        "measured": sum(1 for t in trials if t.measured),
        "pruned": sum(1 for t in trials if t.verdict.startswith("pruned")),
        "trials": [t.row() for t in sorted(trials, key=order)],
    }


def write_leaderboard(path: str, trials: Sequence[Trial],
                      meta: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    board = leaderboard(trials, meta)
    with open(path, "w") as fh:
        json.dump(board, fh, indent=1, default=str)
    return board


# ---------------------------------------------------------------------------
# workload entrypoints
# ---------------------------------------------------------------------------
def autotune_model(
    preset: str,
    seq_len: int,
    base_config: Optional[Dict[str, Any]] = None,
    *,
    micro_batches: Sequence[int] = (1, 2, 4, 8),
    remat_policies: Sequence[str] = ("none", "selective", "full"),
    zero_stages: Sequence[int] = (1, 2, 3),
    mesh_candidates: Sequence[Dict[str, int]] = ({},),
    zero_quant: Sequence[bool] = (False,),
    steps: int = 3,
    metric: str = "throughput",
    rungs: Sequence[float] = (1.0,),
    top_k: int = 8,
    eta: int = 2,
    max_trials: Optional[int] = None,
    seed: int = 0,
    device_memory_bytes: Optional[float] = None,
    artifacts_dir: Optional[str] = None,
    device=None,
) -> Tuple[Optional[Dict[str, Any]], List[Trial]]:
    """Training entry: tune a named preset (models/presets.py); returns
    ``(winner config dict or None, trials)``.  The winner dict is a valid
    engine config — it round-trips through ``config.parse_config`` — with
    the tuner's provenance under the ``"autotuning"`` key (a reference
    passthrough key the parser accepts and strips).  Trials run on
    ``device`` (CUDA unless the caller names another)."""
    import torch

    from ..models.presets import get_preset
    from ..models.transformer import CausalLM
    from ..ops.kernels import resolve_device
    from . import roofline
    from .space import training_space
    from .trial import TrainTrialRunner

    def factory(remat: str):
        return CausalLM(get_preset(preset, remat=remat, max_seq_len=seq_len))

    base = base_config or {
        "optimizer": {"type": "adamw", "params": {"lr": 1e-4}},
        "bf16": {"enabled": True},
    }
    model_cfg = get_preset(preset, max_seq_len=seq_len)
    sp = training_space(
        micro_batches=micro_batches, remat_policies=remat_policies,
        zero_stages=zero_stages, mesh_candidates=mesh_candidates,
        zero_quant=zero_quant,
    )
    consts = roofline.RooflineConstants.calibrate(artifacts_dir)
    dev = resolve_device(device)
    hbm = device_memory_bytes
    if hbm is None and dev.type == "cuda":
        hbm = torch.cuda.get_device_properties(dev).total_memory
    n_dev = 1  # the port trains on one device (a mesh is ROADMAP item 7)
    runner = TrainTrialRunner(factory, base, seq_len, steps=steps, device=dev)
    tuner = Autotuner(
        sp, runner,
        cost_model=lambda c: roofline.predict_train_cost(
            c, model_cfg, seq_len, consts),
        feasibility=lambda c: roofline.training_feasible(
            c, model_cfg, seq_len, n_dev, consts, hbm_bytes=hbm),
        metric=metric, rungs=rungs, eta=eta, top_k=top_k,
        max_trials=max_trials, seed=seed,
    )
    winner, trials = tuner.search()
    if winner is None:
        return None, trials
    cfg = runner.config_for(winner.candidate)
    cfg["autotuning"] = {  # passthrough key: parse_config strips it
        "winner": winner.candidate,
        "tokens_per_sec": winner.score,
        "metric": metric,
        "pruned_fraction": tuner.pruned_fraction,
        "calibration_sources": list(consts.sources),
    }
    return cfg, trials


def autotune_serving(
    params,
    model_cfg,
    *,
    workload=None,
    base: Optional[Dict[str, Any]] = None,
    space: Optional[SearchSpace] = None,
    incumbent: Optional[Dict[str, Any]] = None,
    rungs: Sequence[float] = (0.5, 1.0),
    top_k: int = 6,
    eta: int = 2,
    max_trials: Optional[int] = None,
    seed: int = 0,
    metric: str = "throughput",
    artifacts_dir: Optional[str] = None,
    device=None,
    n_devices: Optional[int] = None,
) -> Tuple[Optional[Trial], List[Trial], "Autotuner"]:
    """Serving entry: search engine/scheduler knobs over a shared-prefix
    workload; returns ``(winner trial, trials, tuner)``.  ``base`` is the
    fixed engine shape (``ServeEngineConfig`` fields the search does not
    touch); ``incumbent`` the current hand-tuned candidate (always carried
    to the final rung).  Trials run on ``device`` (CUDA unless the caller
    names another); ``n_devices`` is what the feasibility model may spread
    a candidate over (default: one device, as the engine runs on one) —
    a row it lets through and the engine refuses records the refusal."""
    from ..ops.kernels import resolve_device
    from . import roofline
    from .space import serving_space
    from .trial import ServeTrialRunner, ServeWorkload

    wl = workload or ServeWorkload()
    sp = space or serving_space()
    base = dict(base or {})
    consts = roofline.RooflineConstants.calibrate(artifacts_dir)
    dev = resolve_device(device)
    n_dev = int(n_devices) if n_devices is not None else 1
    runner = ServeTrialRunner(params, model_cfg, wl, base=base, device=dev)
    feas_base = {
        "max_seqs": base.get("max_seqs", 8),
        "num_blocks": base.get("num_blocks", 96),
        "block_size": base.get("block_size", 32),
        "enable_prefix_caching": base.get("enable_prefix_caching", False),
    }
    tuner = Autotuner(
        sp, runner,
        cost_model=lambda c: roofline.predict_serve_cost(
            c, model_cfg, feas_base, consts),
        feasibility=lambda c: roofline.serving_feasible(
            c, model_cfg, feas_base, n_dev, consts),
        metric=metric, rungs=rungs, eta=eta, top_k=top_k,
        max_trials=max_trials, seed=seed, incumbent=incumbent,
    )
    tuner.consts = consts  # calibration provenance for the leaderboard
    winner, trials = tuner.search()
    return winner, trials, tuner

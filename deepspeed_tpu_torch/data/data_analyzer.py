"""Offline DataAnalyzer — counterpart of ``deepspeed_tpu/data/
data_analyzer.py`` (the reference's ``runtime/data_pipeline/data_sampling/
data_analyzer.py:22 DataAnalyzer`` and ``:455 DistributedDataAnalyzer``):
a map-reduce over a dataset that writes the difficulty index files the
curriculum reads.

The metrics are host numpy over tokenized samples, so no device takes
part: the map phase is a ``ProcessPoolExecutor`` fan-out over contiguous
shards (spawned processes, each re-opening an ``MMapIndexedDataset`` by
its prefix; in this process for any other dataset) and the reduce phase a
numpy merge.  Multi-node runs shard by ``worker_id`` / ``num_workers`` the
same way.

Outputs per metric (``.npy``, memory-mappable; byte-equal to JAX's for the
same corpus), read by ``CurriculumDataSampler`` and
``curriculum_index_filter``:

- ``{save}/{metric}/sample_to_metric.npy``: the value of each sample id;
- ``{save}/{metric}/index_to_sample.npy``: the sample ids sorted by value;
- ``{save}/{metric}/index_to_metric.npy``: the values in that order;
- ``{save}/{metric}/value.npy``: the total (accumulate metrics).

Metric types as the reference's schema: ``single_value_per_sample`` and
``accumulate_value_over_samples``.
"""
from __future__ import annotations

import multiprocessing
import os
from concurrent.futures import ProcessPoolExecutor
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np

SINGLE_VALUE = "single_value_per_sample"
ACCUMULATE = "accumulate_value_over_samples"


def seqlen_metric(sample) -> int:
    """The canonical difficulty metric: token count of the sample (reference
    curriculum 'seqlen')."""
    if isinstance(sample, dict):
        sample = sample.get("input_ids", next(iter(sample.values())))
    return int(np.asarray(sample).reshape(-1).shape[0])


def _worker_paths(save_path: str, metric: str, worker_id: int):
    d = os.path.join(save_path, metric)
    return (
        os.path.join(d, f"worker{worker_id}_values.npy"),
        os.path.join(d, f"worker{worker_id}_ids.npy"),
    )


def _map_shard(args):
    """Top-level (picklable) map worker: compute metrics over one contiguous
    shard.  ``dataset_ref`` is either the dataset object itself (in-process
    path) or an MMapIndexedDataset prefix string (re-opened per process)."""
    (dataset_ref, worker_id, num_workers, save_path, metric_names,
     metric_functions, metric_types) = args
    if isinstance(dataset_ref, str):
        from .indexed_dataset import MMapIndexedDataset

        dataset = MMapIndexedDataset(dataset_ref)
    else:
        dataset = dataset_ref
    n = len(dataset)
    start = (n * worker_id) // num_workers
    end = (n * (worker_id + 1)) // num_workers
    for name, fn, mtype in zip(metric_names, metric_functions, metric_types):
        os.makedirs(os.path.join(save_path, name), exist_ok=True)
        vpath, ipath = _worker_paths(save_path, name, worker_id)
        if mtype == SINGLE_VALUE:
            vals = np.empty((end - start,), np.int64)
            for i in range(start, end):
                vals[i - start] = fn(dataset[i])
            np.save(vpath, vals)
            np.save(ipath, np.arange(start, end, dtype=np.int64))
        elif mtype == ACCUMULATE:
            total = None
            for i in range(start, end):
                v = np.asarray(fn(dataset[i]))
                total = v if total is None else total + v
            np.save(vpath, np.zeros((0,), np.int64) if total is None else total)
            np.save(ipath, np.asarray([start, end], np.int64))
        else:
            raise ValueError(f"unknown metric type {mtype!r}")
    return worker_id


class DataAnalyzer:
    """Map-reduce metric analysis (reference data_analyzer.py:22).

    ``run_map()`` computes this worker's shard; ``run_reduce()`` merges all
    workers' outputs into the index files; ``run_map_reduce(processes=k)``
    fans the map out over k local processes and reduces — the single-host
    equivalent of the reference's DistributedDataAnalyzer run.
    """

    def __init__(
        self,
        dataset,
        num_workers: int = 1,
        worker_id: int = 0,
        batch_size: int = 1,  # accepted for API parity; metrics are per-sample
        metric_names: Sequence[str] = ("seqlen",),
        metric_functions: Optional[Sequence[Callable]] = None,
        metric_types: Optional[Sequence[str]] = None,
        save_path: str = "./data_analysis",
        collate_fn=None,  # API parity; unused (samples analyzed raw)
    ):
        self.dataset = dataset
        self.num_workers = num_workers
        self.worker_id = worker_id
        self.metric_names = list(metric_names)
        self.metric_functions = list(metric_functions or [seqlen_metric])
        self.metric_types = list(metric_types or [SINGLE_VALUE] * len(self.metric_names))
        if not (
            len(self.metric_names)
            == len(self.metric_functions)
            == len(self.metric_types)
        ):
            raise ValueError("metric_names/functions/types must align")
        self.save_path = save_path

    def _dataset_ref(self):
        from .indexed_dataset import MMapIndexedDataset

        if isinstance(self.dataset, MMapIndexedDataset):
            # re-openable by prefix -> picklable map jobs
            prefix = self.dataset.prefix if hasattr(self.dataset, "prefix") else None
            if prefix:
                return prefix
        return self.dataset

    def run_map(self) -> None:
        _map_shard((
            self._dataset_ref(), self.worker_id, self.num_workers,
            self.save_path, self.metric_names, self.metric_functions,
            self.metric_types,
        ))

    def run_reduce(self) -> Dict[str, Dict[str, Any]]:
        out: Dict[str, Dict[str, Any]] = {}
        n_total = len(self.dataset)
        for name, mtype in zip(self.metric_names, self.metric_types):
            d = os.path.join(self.save_path, name)
            if mtype == SINGLE_VALUE:
                sample_to_metric = np.empty((n_total,), np.int64)
                seen = np.zeros((n_total,), bool)
                for w in range(self.num_workers):
                    vpath, ipath = _worker_paths(self.save_path, name, w)
                    try:
                        vals, ids = np.load(vpath), np.load(ipath)
                    except FileNotFoundError as e:
                        raise RuntimeError(
                            f"reduce: worker {w} produced no mapped metric "
                            f"'{name}' ({e.filename}) — did every worker "
                            "run_map()?"
                        ) from e
                    sample_to_metric[ids] = vals
                    seen[ids] = True
                if not seen.all():
                    missing = int((~seen).sum())
                    raise RuntimeError(
                        f"reduce: {missing} samples have no mapped metric "
                        f"'{name}' — did every worker run_map()?"
                    )
                order = np.argsort(sample_to_metric, kind="stable").astype(np.int64)
                np.save(os.path.join(d, "sample_to_metric.npy"), sample_to_metric)
                np.save(os.path.join(d, "index_to_sample.npy"), order)
                np.save(os.path.join(d, "index_to_metric.npy"), sample_to_metric[order])
                out[name] = {"sample_to_metric": sample_to_metric, "order": order}
            else:
                total = None
                for w in range(self.num_workers):
                    vpath, _ = _worker_paths(self.save_path, name, w)
                    v = np.load(vpath)
                    if v.size:
                        total = v if total is None else total + v
                np.save(os.path.join(d, "value.npy"), total)
                out[name] = {"value": total}
        return out

    def run_map_reduce(self, processes: Optional[int] = None):
        """Fan the map over local processes (the multi-process 'distributed'
        map the reference runs via torch.dist), then reduce."""
        processes = processes or self.num_workers
        ref = self._dataset_ref()
        jobs = [
            (ref, w, self.num_workers, self.save_path, self.metric_names,
             self.metric_functions, self.metric_types)
            for w in range(self.num_workers)
        ]
        if processes > 1 and isinstance(ref, str):
            with ProcessPoolExecutor(max_workers=processes,
                                     mp_context=multiprocessing.get_context("spawn")) as ex:
                list(ex.map(_map_shard, jobs))
        else:
            # non-picklable dataset or explicit single process: in-process map
            for j in jobs:
                _map_shard(j)
        return self.run_reduce()


# ---------------------------------------------------------------------------
# curriculum consumption
# ---------------------------------------------------------------------------
class CurriculumIndex:
    """Reader over the analyzer's output for one metric."""

    def __init__(self, save_path: str, metric_name: str):
        d = os.path.join(save_path, metric_name)
        self.sample_to_metric = np.load(
            os.path.join(d, "sample_to_metric.npy"), mmap_mode="r"
        )
        self.index_to_sample = np.load(
            os.path.join(d, "index_to_sample.npy"), mmap_mode="r"
        )
        self.index_to_metric = np.load(
            os.path.join(d, "index_to_metric.npy"), mmap_mode="r"
        )

    def sample_ids_up_to(self, difficulty: int) -> np.ndarray:
        """All sample ids whose metric <= difficulty (sorted ascending by
        metric) — the eligible pool for the current curriculum step."""
        k = int(np.searchsorted(self.index_to_metric, difficulty, side="right"))
        return np.asarray(self.index_to_sample[:k])


def curriculum_index_filter(save_path: str, metric_name: str, scheduler):
    """An ``index_filter`` for ``DeepSpeedDataSampler``: keep the samples
    whose analyzed metric is within the scheduler's CURRENT difficulty."""
    index = CurriculumIndex(save_path, metric_name)

    def filt(order: np.ndarray, epoch: int) -> np.ndarray:
        eligible = index.sample_ids_up_to(scheduler.get_current_difficulty())
        mask = np.zeros(int(np.max(order)) + 1 if len(order) else 0, bool)
        mask[eligible[eligible < len(mask)]] = True
        return order[mask[order]]

    return filt


class CurriculumDataSampler:
    """Difficulty-aware sampler: per global batch, draw from the eligible
    pool (metric <= current difficulty) — per-STEP granularity like the
    reference's DeepSpeedDataSampler difficulty clusters
    (data_sampler.py:36), not per-epoch.  State is ``consumed_samples``
    plus the RNG-deterministic pool order per (difficulty, epoch)."""

    def __init__(
        self,
        index: CurriculumIndex,
        scheduler,
        global_batch_size: int,
        seed: int = 0,
    ):
        self.index = index
        self.scheduler = scheduler
        self.global_batch_size = global_batch_size
        self.seed = seed
        self.consumed_samples = 0
        self._pool_key = None
        self._pool = None
        self._pos = 0

    def next_batch(self, global_step: int) -> np.ndarray:
        difficulty = self.scheduler.update_difficulty(global_step)
        key = difficulty
        if self._pool_key != key:
            pool = self.index.sample_ids_up_to(difficulty)
            if len(pool) < self.global_batch_size:
                raise ValueError(
                    f"curriculum difficulty {difficulty} admits only "
                    f"{len(pool)} samples < global batch "
                    f"{self.global_batch_size}; raise min_difficulty"
                )
            rng = np.random.default_rng(self.seed + difficulty)
            pool = rng.permutation(pool)
            self._pool_key, self._pool, self._pos = key, pool, 0
        if self._pos + self.global_batch_size > len(self._pool):
            self._pos = 0  # new pass over the eligible pool
        batch = self._pool[self._pos : self._pos + self.global_batch_size]
        self._pos += self.global_batch_size
        self.consumed_samples += self.global_batch_size
        return np.asarray(batch, np.int64)

    def state_dict(self):
        return {
            "consumed_samples": self.consumed_samples,
            # the full pool position: exact restore regardless of the step
            # numbering the caller fed next_batch (the replay fallback below
            # must assume contiguous 1-based steps)
            "pool_key": None if self._pool_key is None else int(self._pool_key),
            "pos": int(self._pos),
        }

    def load_state_dict(self, state):
        """Restore the pool position exactly.

        ``consumed_samples`` alone used to be restored, leaving
        ``_pos``/``_pool_key`` at their fresh-start values — a resumed run
        re-drew the current difficulty pool from index 0, repeating samples
        it had already trained on.  New checkpoints carry the position
        directly; old ones fall back to a deterministic replay of the
        difficulty trajectory (valid for the contiguous 1-based step
        numbering ``next_batch`` documents)."""
        from .curriculum_scheduler import CURRENT_DIFFICULTY, MIN_DIFFICULTY

        self.consumed_samples = int(state["consumed_samples"])
        self._pool_key, self._pool, self._pos = None, None, 0
        if "pool_key" in state:
            key = state["pool_key"]
            self._pos = int(state.get("pos", 0))
            if key is not None:
                self._pool_key = key
                rng = np.random.default_rng(self.seed + key)
                self._pool = rng.permutation(self.index.sample_ids_up_to(key))
                # a warm scheduler that ratcheted past the checkpoint must
                # rewind with us: update_difficulty skips recomputation at
                # max difficulty, so a stale high value would stick
                self.scheduler.set_current_difficulty(key)
            else:
                self.scheduler.state[CURRENT_DIFFICULTY] = self.scheduler.state[
                    MIN_DIFFICULTY
                ]
            return
        # legacy state: replay the trajectory from the beginning (a live
        # scheduler that already advanced past the checkpointed step would
        # otherwise replay at its ratcheted difficulty).  After the replay
        # the scheduler lands at the checkpointed step's difficulty.
        steps = self.consumed_samples // self.global_batch_size
        self.scheduler.state[CURRENT_DIFFICULTY] = self.scheduler.state[
            MIN_DIFFICULTY
        ]
        pool_len = 0
        for step in range(1, steps + 1):
            difficulty = self.scheduler.update_difficulty(step)
            if self._pool_key != difficulty:
                self._pool_key = difficulty
                # length only — the permuted pool itself is materialized
                # once below, not per replayed step
                pool_len = int(
                    np.searchsorted(
                        self.index.index_to_metric, difficulty, side="right"
                    )
                )
                self._pos = 0
            if self._pos + self.global_batch_size > pool_len:
                self._pos = 0
            self._pos += self.global_batch_size
        if self._pool_key is not None:
            rng = np.random.default_rng(self.seed + self._pool_key)
            self._pool = rng.permutation(
                self.index.sample_ids_up_to(self._pool_key)
            )


def main(argv: Optional[List[str]] = None) -> int:
    """CLI: analyze an on-disk MMapIndexedDataset by sequence length.

    ``python -m deepspeed_tpu_torch.data.data_analyzer --data-prefix P --save S``
    """
    import argparse

    from .indexed_dataset import MMapIndexedDataset

    ap = argparse.ArgumentParser(description="offline dataset difficulty analyzer")
    ap.add_argument("--data-prefix", required=True, help="MMapIndexedDataset prefix")
    ap.add_argument("--save", required=True, help="output directory")
    ap.add_argument("--metric", default="seqlen", choices=["seqlen"])
    ap.add_argument("--workers", type=int, default=os.cpu_count() or 1)
    args = ap.parse_args(argv)
    ds = MMapIndexedDataset(args.data_prefix)
    analyzer = DataAnalyzer(
        ds, num_workers=args.workers, metric_names=[args.metric],
        metric_functions=[seqlen_metric], metric_types=[SINGLE_VALUE],
        save_path=args.save,
    )
    analyzer.run_map_reduce(processes=args.workers)
    print(f"analyzed {len(ds)} samples -> {args.save}/{args.metric}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

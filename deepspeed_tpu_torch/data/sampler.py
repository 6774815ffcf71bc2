"""Deterministic, resumable data sampler — counterpart of
``deepspeed_tpu/data/sampler.py`` (the reference's ``DeepSpeedDataSampler``,
``runtime/data_pipeline/data_sampling/data_sampler.py:36``).

The sampler owns the global sample order (a seeded numpy shuffle per epoch)
and yields per-step index batches; its whole position is one integer,
``consumed_samples``, which ``state_dict`` captures and ``load_state_dict``
restores.  The order is a pure function of (seed, epoch), so resuming
recomputes the epoch's permutation and skips: for one seed the index stream
and the state dicts are JAX's.
"""
from __future__ import annotations

from typing import Dict, Iterator, List, Optional

import numpy as np

from ..utils.logging import warning_once


def find_fit_int_dtype(min_value: int, max_value: int):
    """Smallest numpy unsigned int type covering ``[min_value, max_value]``
    (int64 when ``min_value`` is negative)."""
    for dt in (np.uint8, np.uint16, np.uint32, np.uint64):
        if max_value <= np.iinfo(dt).max and min_value >= 0:
            return dt
    return np.int64


class DeepSpeedDataSampler:
    """Yields global index batches of ``micro_batch * dp_size * gas``
    samples.  ``index_filter(order, epoch)`` restricts an epoch's eligible
    samples (the curriculum hook)."""

    def __init__(self, one_epoch_total_samples: int, micro_batch_size: int,
                 data_parallel_rank: int = 0, data_parallel_size: int = 1,
                 gradient_accumulation_steps: int = 1, num_epochs: int = 1, seed: int = 0,
                 shuffle: bool = True, drop_last: bool = True, index_filter=None):
        if one_epoch_total_samples <= 0:
            raise ValueError(f"no sample to consume: {one_epoch_total_samples}")
        if data_parallel_rank >= data_parallel_size:
            raise ValueError(
                f"data_parallel_rank {data_parallel_rank} >= size {data_parallel_size}")
        self.one_epoch_total_samples = one_epoch_total_samples
        self.index_dtype = find_fit_int_dtype(0, one_epoch_total_samples)
        self.total_samples = one_epoch_total_samples * num_epochs
        self.micro_batch_size = micro_batch_size
        self.data_parallel_rank = data_parallel_rank
        self.data_parallel_size = data_parallel_size
        self.gradient_accumulation_steps = gradient_accumulation_steps
        self.micro_batch_times_data_parallel_size = micro_batch_size * data_parallel_size
        self.global_batch_size = (self.micro_batch_times_data_parallel_size
                                  * gradient_accumulation_steps)
        self.seed = seed
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.index_filter = index_filter
        self.consumed_samples = 0
        self._order_cache: Optional[tuple] = None  # (epoch, order)

    def __len__(self) -> int:
        return self.total_samples

    def _epoch_order(self, epoch: int) -> np.ndarray:
        order = np.arange(self.one_epoch_total_samples, dtype=self.index_dtype)
        if self.index_filter is not None:
            order = np.asarray(self.index_filter(order, epoch), dtype=self.index_dtype)
        if self.shuffle:
            np.random.default_rng(self.seed + epoch).shuffle(order)
        return order

    def get_start_end_idx(self, batch_len: Optional[int] = None):
        """This DP rank's slice of a global micro batch (reference
        ``data_sampler.py:122``)."""
        batch_len = batch_len or self.micro_batch_times_data_parallel_size
        start = round(self.data_parallel_rank * batch_len / self.data_parallel_size)
        end = round((self.data_parallel_rank + 1) * batch_len / self.data_parallel_size)
        return start, end

    def __iter__(self) -> Iterator[np.ndarray]:
        """Yield ``[global_batch_size]`` int64 index arrays from
        ``consumed_samples`` on; an epoch's trailing partial batch is
        dropped and charged to the position."""
        while self.consumed_samples < self.total_samples:
            epoch_len = self.one_epoch_total_samples
            epoch = self.consumed_samples // epoch_len
            within = self.consumed_samples % epoch_len
            if self._order_cache is None or self._order_cache[0] != epoch:
                self._order_cache = (epoch, self._epoch_order(epoch))
            order = self._order_cache[1]
            usable = (len(order) // self.global_batch_size) * self.global_batch_size
            if usable == 0:
                return  # fewer eligible samples than one global batch
            if within >= usable:
                self.consumed_samples = (epoch + 1) * epoch_len
                continue
            batch = order[within:within + self.global_batch_size]
            self.consumed_samples += self.global_batch_size
            if within + self.global_batch_size >= usable:
                self.consumed_samples = (epoch + 1) * epoch_len
            yield batch.astype(np.int64)

    def local_slice(self, global_batch: np.ndarray) -> np.ndarray:
        """``[gas, local_micro]`` indices of this rank in a global batch."""
        per_micro = self.micro_batch_times_data_parallel_size
        out: List[np.ndarray] = []
        for g in range(self.gradient_accumulation_steps):
            micro = global_batch[g * per_micro:(g + 1) * per_micro]
            start, end = self.get_start_end_idx(len(micro))
            out.append(micro[start:end])
        return np.stack(out)

    def state_dict(self) -> Dict[str, int]:
        return {"consumed_samples": self.consumed_samples, "seed": self.seed}

    def load_state_dict(self, state: Dict[str, int]) -> None:
        if state.get("seed", self.seed) != self.seed:
            warning_once("data sampler restored with a different seed; the resumed "
                         "sample order will not match the original run")
        self.consumed_samples = int(state["consumed_samples"])

"""Data loading: deterministic sharding and ``RepeatingLoader`` —
counterpart of ``deepspeed_tpu/runtime/dataloader.py`` (the reference's
``DeepSpeedDataLoader`` :41 and ``RepeatingLoader`` :17).

``DeepSpeedTpuDataLoader`` yields global batches folded ``[gas,
global_micro_batch, ...]`` as CPU tensors; the engine's ``_place_batch``
copies them to the card (on the prefetch worker under
``train_on_loader``).  Its position is the sampler's (``data/sampler.py``):
``state_dict()`` read between ``__next__`` calls is the position of the
next batch, so restoring it and iterating again replays the same stream.
That is what makes a checkpoint taken with prefetched batches in flight
exact (``runtime/prefetch.py`` ``resume_state``).
"""
from __future__ import annotations

from typing import Any, Callable, Iterator, Optional, Sequence

import numpy as np
import torch

from ..data.sampler import DeepSpeedDataSampler
from ..utils.logging import warning_once


def unwrap_loader_chain(loader):
    """Yield ``loader`` and each ``.loader``-wrapped inner loader
    (cycle-safe): the one traversal the engine's prefetch state capture
    and the checkpoint's drain check share."""
    seen = set()
    while loader is not None and id(loader) not in seen:
        yield loader
        seen.add(id(loader))
        loader = getattr(loader, "loader", None)


class RepeatingLoader:
    """Wrap an iterable so that it restarts on ``StopIteration`` (reference
    ``runtime/dataloader.py:17``); the inner loader's position contract is
    delegated."""

    def __init__(self, loader):
        self.loader = loader
        self.data_iter = iter(self.loader)

    def __iter__(self):
        return self

    def __next__(self):
        try:
            return next(self.data_iter)
        except StopIteration:
            self.data_iter = iter(self.loader)
            return next(self.data_iter)

    def state_dict(self):
        inner = getattr(self.loader, "state_dict", None)
        return inner() if callable(inner) else None

    def load_state_dict(self, state) -> None:
        inner = getattr(self.loader, "load_state_dict", None)
        if callable(inner) and state is not None:
            inner(state)
            # the wrapped epoch iterator ran past the restored position
            self.data_iter = iter(self.loader)


def _tree_map(fn, *trees):
    """``fn`` over the leaves of equally shaped dict / list / tuple trees."""
    head = trees[0]
    if isinstance(head, dict):
        return {k: _tree_map(fn, *[t[k] for t in trees]) for k in head}
    if isinstance(head, (list, tuple)):
        return type(head)(_tree_map(fn, *xs) for xs in zip(*trees))
    return fn(*trees)


def _default_collate(samples: Sequence[Any]):
    """Stack the samples leaf by leaf (``np.stack``, as JAX) into CPU
    tensors."""
    return _tree_map(lambda *xs: torch.from_numpy(np.stack([np.asarray(x) for x in xs])),
                     *samples)


class DeepSpeedTpuDataLoader:
    """Shards an indexable dataset (``__len__`` / ``__getitem__`` returning an
    array, tuple or dict of arrays) deterministically and emits ``[gas,
    micro, ...]`` batches; ``collate_fn`` stacks samples (default: stacked
    CPU tensors per leaf).  Trailing partial batches are always dropped, as
    in JAX."""

    def __init__(self, dataset, micro_batch_size: int, dp_world_size: int = 1,
                 gradient_accumulation_steps: int = 1, dp_rank: int = 0, shuffle: bool = True,
                 seed: int = 0, drop_last: bool = True, collate_fn: Optional[Callable] = None,
                 global_batches: bool = True, num_epochs: Optional[int] = None,
                 index_filter: Optional[Callable] = None):
        self.dataset = dataset
        self.micro_batch_size = micro_batch_size
        self.gas = gradient_accumulation_steps
        self.dp_world_size = dp_world_size
        self.dp_rank = dp_rank
        self.collate_fn = collate_fn or _default_collate
        self.global_batches = global_batches
        self.data_sampler = DeepSpeedDataSampler(
            one_epoch_total_samples=len(dataset), micro_batch_size=micro_batch_size,
            data_parallel_rank=dp_rank, data_parallel_size=dp_world_size,
            gradient_accumulation_steps=gradient_accumulation_steps,
            # None: unbounded epochs, each __iter__ one epoch with a fresh shuffle
            num_epochs=num_epochs if num_epochs is not None else 2**31,
            seed=seed, shuffle=shuffle, index_filter=index_filter)
        self.batches_per_epoch = len(dataset) // (micro_batch_size * dp_world_size * self.gas)
        if not drop_last:
            warning_once("drop_last=False is not supported (static shapes); the trailing "
                         "partial batch is dropped")

    def set_epoch(self, epoch: int):
        """Jump the sampler to the start of ``epoch``."""
        self.data_sampler.consumed_samples = epoch * self.data_sampler.one_epoch_total_samples

    @property
    def epoch(self) -> int:
        return self.data_sampler.consumed_samples // self.data_sampler.one_epoch_total_samples

    def __len__(self):
        return self.batches_per_epoch

    def state_dict(self):
        return self.data_sampler.state_dict()

    def load_state_dict(self, state) -> None:
        self.data_sampler.load_state_dict(state)

    def __iter__(self) -> Iterator[Any]:
        """One epoch of batches (resuming mid-epoch after a restore)."""
        s = self.data_sampler
        if s.consumed_samples >= s.total_samples:
            s.consumed_samples = 0
        epoch0 = self.epoch
        for idx in s:
            if not self.global_batches:
                idx = s.local_slice(idx).reshape(-1)
            batch = self.collate_fn([self.dataset[int(i)] for i in idx])
            yield _tree_map(
                lambda x: x.reshape((self.gas, x.shape[0] // self.gas) + tuple(x.shape[1:])),
                batch)
            if self.epoch != epoch0:
                break

"""The port's data loader and prefetch position
(``deepspeed_tpu_torch/runtime/dataloader.py``, ``data/sampler.py``,
``runtime/prefetch.py``) against the JAX package's, on the CPU.

- the sampler's index streams and ``state_dict``s equal JAX's for the same
  seed (shuffled, rank slices, epochs, a filter), and a mid-epoch resume
  replays the rest exactly (JAX ``tests/test_data.py:24``);
- the loader's batches equal JAX's (collated ``[gas, micro, ...]``, CPU
  tensors here, numpy there) and its position rides ``state_dict``;
- ``DevicePrefetcher.resume_state`` tracks the batches drawn and not yet
  consumed, through ``RepeatingLoader`` too (JAX ``tests/test_prefetch.py:
  113, 314``), and ``train_on_loader`` hands the unconsumed ones back to
  the loader when it closes;
- ``initialize(training_data=...)`` builds the loader as JAX's does.
"""
import time

import jax
import numpy as np
import pytest
import torch

from deepspeed_tpu.data.sampler import DeepSpeedDataSampler as JSampler
from deepspeed_tpu.runtime import dataloader as jdl
from deepspeed_tpu.runtime.prefetch import DevicePrefetcher as JPrefetcher

import deepspeed_tpu_torch as tds
from deepspeed_tpu_torch.data.sampler import DeepSpeedDataSampler
from deepspeed_tpu_torch.models import transformer as tt
from deepspeed_tpu_torch.models.presets import get_preset
from deepspeed_tpu_torch.runtime import dataloader as tdl
from deepspeed_tpu_torch.runtime.prefetch import DevicePrefetcher

SAMPLER_CASES = {
    "shuffled": dict(one_epoch_total_samples=100, micro_batch_size=2, data_parallel_size=2,
                     gradient_accumulation_steps=2, num_epochs=3, seed=7),
    "ordered": dict(one_epoch_total_samples=37, micro_batch_size=3, num_epochs=2,
                    shuffle=False),
    "rank1": dict(one_epoch_total_samples=64, micro_batch_size=2, data_parallel_rank=1,
                  data_parallel_size=4, gradient_accumulation_steps=2, num_epochs=2, seed=3),
    "filtered": dict(one_epoch_total_samples=80, micro_batch_size=4, num_epochs=2, seed=11,
                     index_filter=lambda order, epoch: order[order % (epoch + 2) != 0]),
}


class TokDataset:
    """Indexable rows of token ids (and a per-row weight), numpy."""

    def __init__(self, n=48, seq=17, vocab=256, seed=0):
        rng = np.random.default_rng(seed)
        self.x = rng.integers(0, vocab, (n, seq)).astype(np.int64)
        self.w = rng.standard_normal(n).astype(np.float32)

    def __len__(self):
        return len(self.x)

    def __getitem__(self, i):
        return {"input_ids": self.x[i], "w": self.w[i]}


@pytest.mark.parametrize("case", sorted(SAMPLER_CASES))
def test_sampler_stream_and_states_equal_jax(case):
    kw = SAMPLER_CASES[case]
    j, t = JSampler(**kw), DeepSpeedDataSampler(**kw)
    assert t.index_dtype == j.index_dtype and len(t) == len(j)
    for a, b in zip(iter(t), iter(j)):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype
        assert t.state_dict() == j.state_dict()
        np.testing.assert_array_equal(t.local_slice(a), j.local_slice(b))
    assert t.state_dict() == j.state_dict()
    assert t.get_start_end_idx() == j.get_start_end_idx()


@pytest.mark.parametrize("case", sorted(SAMPLER_CASES))
def test_sampler_resume_mid_epoch_is_exact(case):
    """JAX ``test_data.py:24``: a fresh sampler loaded with a mid-epoch
    state yields exactly the rest of the uninterrupted stream."""
    kw = SAMPLER_CASES[case]
    full = list(DeepSpeedDataSampler(**kw))
    run = DeepSpeedDataSampler(**kw)
    it = iter(run)
    first = [next(it) for _ in range(3)]
    resumed = DeepSpeedDataSampler(**kw)
    resumed.load_state_dict(run.state_dict())
    got = first + list(resumed)
    assert len(got) == len(full)
    for a, b in zip(got, full):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("gas,micro,global_batches", [(2, 2, True), (1, 4, True),
                                                      (2, 1, False)])
def test_loader_batches_equal_jax(gas, micro, global_batches):
    ds = TokDataset()
    kw = dict(micro_batch_size=micro, gradient_accumulation_steps=gas, seed=5,
              dp_world_size=2 if not global_batches else 1, dp_rank=1 if not global_batches else 0,
              global_batches=global_batches)
    jl, tl = jdl.DeepSpeedTpuDataLoader(ds, **kw), tdl.DeepSpeedTpuDataLoader(ds, **kw)
    assert len(tl) == len(jl)
    n = 0
    for epoch in range(2):
        for jb, tb in zip(jl, tl):
            assert set(tb) == set(jb)
            for k in jb:
                assert isinstance(tb[k], torch.Tensor) and tb[k].device.type == "cpu"
                np.testing.assert_array_equal(tb[k].numpy(), np.asarray(jb[k]))
            assert tl.state_dict() == jl.state_dict() and tl.epoch == jl.epoch
            n += 1
    assert n == 2 * len(tl)


def test_loader_tuple_samples_and_custom_collate():
    class Pairs:
        def __len__(self):
            return 12

        def __getitem__(self, i):
            return np.full(3, i, np.float32), np.int64(i)

    tl = tdl.DeepSpeedTpuDataLoader(Pairs(), micro_batch_size=2, gradient_accumulation_steps=2,
                                    shuffle=False)
    x, y = next(iter(tl))
    assert tuple(x.shape) == (2, 2, 3) and y.tolist() == [[0, 1], [2, 3]]
    jl = jdl.DeepSpeedTpuDataLoader(Pairs(), micro_batch_size=2, gradient_accumulation_steps=2,
                                    shuffle=False)
    jx, jy = next(iter(jl))
    np.testing.assert_array_equal(x.numpy(), jx)
    custom = tdl.DeepSpeedTpuDataLoader(
        Pairs(), micro_batch_size=2, shuffle=False,
        collate_fn=lambda s: {"x": torch.stack([torch.from_numpy(a) for a, _ in s])})
    assert tuple(next(iter(custom))["x"].shape) == (1, 2, 3)


def test_loader_position_resumes_the_same_batches():
    ds = TokDataset()
    a = tdl.DeepSpeedTpuDataLoader(ds, micro_batch_size=2, gradient_accumulation_steps=2, seed=1)
    it = iter(a)
    for _ in range(3):
        next(it)
    state = a.state_dict()
    want = [b["input_ids"] for b in it]
    b = tdl.DeepSpeedTpuDataLoader(ds, micro_batch_size=2, gradient_accumulation_steps=2, seed=1)
    b.load_state_dict(state)
    got = [x["input_ids"] for x in b]
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def _counter_source():
    state = {"pos": 0}

    def gen():
        while state["pos"] < 20:
            state["pos"] += 1
            yield state["pos"]

    return state, gen()


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_resume_state_tracks_unconsumed_batches(pkg):
    """JAX ``test_prefetch.py:113``, in both packages: nothing consumed
    rewinds to the start; after one batch the position is just past it,
    whatever the read-ahead."""
    cls = DevicePrefetcher if pkg == "port" else JPrefetcher
    state, gen = _counter_source()
    pf = cls(gen, lambda x: x, depth=2, state_fn=lambda: dict(state))
    deadline = time.monotonic() + 2.0
    while pf.qsize() < 2 and time.monotonic() < deadline:
        time.sleep(0.01)
    assert pf.qsize() == 2 and state["pos"] >= 2
    assert pf.resume_state()["pos"] == 0
    assert next(pf) == 1
    assert pf.resume_state()["pos"] == 1
    assert next(pf) == 2
    assert pf.resume_state()["pos"] == 2
    pf.close()
    assert DevicePrefetcher(iter([]), lambda x: x).resume_state() is None


def test_prefetcher_end_and_error_keep_the_position():
    state, gen = _counter_source()
    pf = DevicePrefetcher(gen, lambda x: x, depth=3, state_fn=lambda: dict(state))
    assert list(pf) == list(range(1, 21))
    assert pf.resume_state() == {"pos": 20}  # drained: the live position

    def boom(x):
        if x == 3:
            raise ValueError("bad batch")
        return x

    state2, gen2 = _counter_source()
    pf2 = DevicePrefetcher(gen2, boom, depth=2, state_fn=lambda: dict(state2))
    assert [next(pf2), next(pf2)] == [1, 2]
    with pytest.raises(ValueError, match="bad batch"):
        next(pf2)
    assert pf2.resume_state() == {"pos": 2}  # resuming replays the batch that failed
    pf2.close()


def test_repeating_loader_delegates_resume_state_like_jax():
    """JAX ``test_prefetch.py:314`` in both packages, and the wrapper chain."""
    ds = TokDataset(n=64)
    out = {}
    for name, mod in (("port", tdl), ("jax", jdl)):
        inner = mod.DeepSpeedTpuDataLoader(ds, micro_batch_size=4, shuffle=False)
        rl = mod.RepeatingLoader(inner)
        for _ in range(3):
            next(rl)
        st = rl.state_dict()
        first_after = next(rl)
        rl.load_state_dict(st)
        replay = next(rl)
        np.testing.assert_array_equal(np.asarray(replay["input_ids"]),
                                      np.asarray(first_after["input_ids"]))
        assert [link is inner for link in mod.unwrap_loader_chain(rl)] == [False, True]
        out[name] = (st, [np.asarray(next(rl)["input_ids"]) for _ in range(20)])
    assert out["port"][0] == out["jax"][0] == {"consumed_samples": 12, "seed": 0}
    for a, b in zip(out["port"][1], out["jax"][1]):  # wraps past the epoch alike
        np.testing.assert_array_equal(a, b)


def _engine(**over):
    cfg = get_preset("tiny", dtype=torch.float32, max_seq_len=32)
    conf = {"train_micro_batch_size_per_gpu": 2, "gradient_accumulation_steps": 2,
            "bf16": {"enabled": False}, "optimizer": {"type": "adamw", "params": {"lr": 1e-2}},
            "steps_per_print": 1000, "seed": 4, **over}
    engine, _, loader, _ = tds.initialize(model=tt.CausalLM(cfg), config=conf, device="cpu",
                                          training_data=TokDataset(vocab=cfg.vocab_size))
    return engine, loader


def test_initialize_training_data_builds_jax_loader():
    engine, loader = _engine()
    assert engine.training_dataloader is loader
    want = jdl.DeepSpeedTpuDataLoader(TokDataset(vocab=256), micro_batch_size=2,
                                      gradient_accumulation_steps=2, seed=4)
    assert len(loader) == len(want) == 12
    for tb, jb in zip(loader, want):
        np.testing.assert_array_equal(tb["input_ids"].numpy(), jb["input_ids"])


@pytest.mark.parametrize("depth", [0, 2])
def test_train_on_loader_hands_unconsumed_batches_back(depth):
    """After ``train_on_loader`` closes, the loader's position is that of
    the batches the steps consumed: read-ahead goes back (depth 2), and the
    synchronous loop (depth 0) never read ahead."""
    engine, loader = _engine(train_data={"prefetch_depth": depth})
    losses = list(engine.train_on_loader(loader, num_steps=3))
    assert len(losses) == 3
    assert loader.state_dict()["consumed_samples"] == 3 * 4
    ref, ref_loader = _engine(train_data={"prefetch_depth": depth})
    it = iter(ref_loader)
    for _ in range(3):
        next(it)
    assert next(iter(loader))["input_ids"].equal(next(it)["input_ids"])


def test_curriculum_filter_runs_without_prefetch():
    """A sampler with an ``index_filter`` draws at the consuming step's
    difficulty: ``train_on_loader`` runs it synchronously, as JAX does."""
    engine, loader = _engine()
    loader.data_sampler.index_filter = lambda order, epoch: order
    gen = engine.train_on_loader(loader)
    next(gen)
    assert engine._active_prefetcher is None
    gen.close()

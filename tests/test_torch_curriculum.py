"""The port's curriculum learning, indexed dataset and data analyzer against
the JAX package, on the CPU.

- The schedules (``fixed_linear``, ``fixed_root``, ``fixed_discrete``,
  custom), ``get_state`` / ``set_state`` and the config errors equal JAX's;
  ``truncate_to_seqlen`` cuts tensors and numpy arrays as JAX cuts numpy.
- Over a seqlen ramp the engine's per-step losses agree with the JAX
  engine's within 1e-5 (fp32 on ``tiny``: the trajectory tolerance of
  ``test_torch_training.py``), and each step's batch is the scheduler's
  length.  The checkpoint's ``curriculum`` meta equals JAX's and loads
  across the two packages.
- Indexed datasets round-trip in both directions with byte-equal files;
  the analyzer's outputs are byte-equal to JAX's (in this process, over
  spawned workers, and through the CLI); a worker that never mapped is
  found, with JAX's text.
- ``CurriculumDataSampler`` and ``curriculum_index_filter`` give JAX's
  index streams and resume exactly; ``initialize`` with a
  ``data_analysis_path`` samples only within the current difficulty and
  runs ``train_on_loader`` without prefetch.
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu as jds
from deepspeed_tpu.config.config import ConfigError as JConfigError
from deepspeed_tpu.data import curriculum_scheduler as jcs
from deepspeed_tpu.data import data_analyzer as jda
from deepspeed_tpu.data import indexed_dataset as jid
from deepspeed_tpu.data.sampler import DeepSpeedDataSampler as JSampler
from deepspeed_tpu.models import transformer as jt
from deepspeed_tpu.models.presets import get_preset as j_preset
from deepspeed_tpu.parallel.topology import initialize_mesh

import deepspeed_tpu_torch as tds
from deepspeed_tpu_torch.config.config import ConfigError
from deepspeed_tpu_torch.data import curriculum_scheduler as tcs
from deepspeed_tpu_torch.data import data_analyzer as tda
from deepspeed_tpu_torch.data import indexed_dataset as tid
from deepspeed_tpu_torch.data.sampler import DeepSpeedDataSampler
from deepspeed_tpu_torch.models import transformer as tt
from deepspeed_tpu_torch.models.presets import get_preset
from torch_threads import one_torch_thread  # noqa: F401  (one intra-op thread)

ENGINE_TOL = dict(atol=1e-5, rtol=1e-5)

SCHEDULES = {
    "fixed_linear": {"min_difficulty": 8, "max_difficulty": 64, "schedule_type": "fixed_linear",
                     "schedule_config": {"total_curriculum_step": 7, "difficulty_step": 8}},
    "fixed_root": {"min_difficulty": 520, "max_difficulty": 4096, "schedule_type": "fixed_root",
                   "schedule_config": {"total_curriculum_step": 13, "difficulty_step": 8,
                                       "root_degree": 3}},
    "fixed_discrete": {"min_difficulty": 1, "max_difficulty": 3,
                       "schedule_type": "fixed_discrete",
                       "schedule_config": {"difficulty": [1, 2, 3], "max_step": [4, 9]}},
    "custom": {"min_difficulty": 2, "max_difficulty": 40, "schedule_type": "custom"},
}


@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_schedules_equal_jax(name):
    j, t = jcs.CurriculumScheduler(SCHEDULES[name]), tcs.CurriculumScheduler(SCHEDULES[name])
    if name == "custom":
        for s in (j, t):
            s.set_custom_get_difficulty(lambda step: 2 + 3 * step)
    got = [(t.update_difficulty(k), t.get_difficulty(k)) for k in range(20)]
    want = [(j.update_difficulty(k), j.get_difficulty(k)) for k in range(20)]
    assert got == want and len({d for d, _ in got}) > 2
    assert t.get_state() == j.get_state()
    fresh = tcs.CurriculumScheduler(SCHEDULES[name])
    fresh.set_state(json.loads(json.dumps(j.get_state())))
    assert fresh.get_current_difficulty() == j.get_current_difficulty()


@pytest.mark.parametrize("cfg", [
    {"max_difficulty": 8, "schedule_type": "fixed_linear"},
    {"min_difficulty": 1, "max_difficulty": 8, "schedule_type": "fixed_root",
     "schedule_config": {"total_curriculum_step": 3, "difficulty_step": 8}},
    {"min_difficulty": 1, "max_difficulty": 8, "schedule_type": "fixed_discrete",
     "schedule_config": {"difficulty": [1, 2], "max_step": [1, 2]}},
    {"min_difficulty": 1, "max_difficulty": 8, "schedule_type": "zigzag"},
])
def test_schedule_errors_read_as_jax(cfg):
    with pytest.raises(JConfigError) as jerr:
        jcs.CurriculumScheduler(cfg)
    with pytest.raises(ConfigError) as terr:
        tcs.CurriculumScheduler(cfg)
    assert str(terr.value) == str(jerr.value)


def test_truncate_cuts_token_leaves_as_jax():
    rng = np.random.default_rng(0)
    batch = {"input_ids": rng.integers(0, 9, (2, 3, 40)).astype(np.int32),
             "weights": rng.random((2, 3, 40)).astype(np.float32),
             "flags": np.ones((2, 40), bool), "ids1d": np.arange(40)}
    want = jcs.truncate_to_seqlen(batch, 20)
    got_np = tcs.truncate_to_seqlen(batch, 20)
    got_t = tcs.truncate_to_seqlen({k: torch.as_tensor(v) for k, v in batch.items()}, 20)
    for k in batch:
        assert got_np[k].shape == np.asarray(want[k]).shape
        np.testing.assert_array_equal(got_t[k].numpy(), np.asarray(want[k]), err_msg=k)
    assert got_t["input_ids"].shape[-1] == 21
    assert tcs.truncate_to_seqlen([torch.zeros(2, 5, dtype=torch.long)], 9)[0].shape == (2, 5)


RAMP = {"enabled": True, "curriculum_type": "seqlen", "min_difficulty": 8,
        "max_difficulty": 32, "schedule_type": "fixed_linear",
        "schedule_config": {"total_curriculum_step": 3, "difficulty_step": 8}}


def _engine_config(**over):
    return {"train_micro_batch_size_per_gpu": 2, "gradient_accumulation_steps": 2,
            "optimizer": {"type": "adamw", "params": {"lr": 3e-3, "weight_decay": 0.1}},
            "bf16": {"enabled": False}, "steps_per_print": 1000,
            "data_efficiency": {"enabled": True, "curriculum_learning": dict(RAMP)}, **over}


def _pair():
    jcfg = j_preset("tiny", dtype=jnp.float32)
    jp = jax.tree_util.tree_map(np.asarray, jt.init_params(jax.random.PRNGKey(0), jcfg))
    jeng, _, _, _ = jds.initialize(model=jt.CausalLM(jcfg),
                                   params=jax.tree_util.tree_map(jnp.asarray, jp),
                                   config=_engine_config(),
                                   mesh=initialize_mesh(devices=jax.devices()[:1], data=1))
    tcfg = get_preset("tiny", dtype=torch.float32, attn_impl="flash", remat="selective")
    teng, _, _, _ = tds.initialize(model=tt.CausalLM(tcfg),
                                   params=tt.params_from_numpy(jp, tcfg, device="cpu"),
                                   config=_engine_config(), device="cpu")
    return jeng, teng


def test_seqlen_ramp_losses_match_jax_engine_and_checkpoint_meta(tmp_path):
    jeng, teng = _pair()
    rng = np.random.default_rng(5)
    batches = [{"input_ids": rng.integers(0, 256, (2, 2, 33)).astype(np.int32)}
               for _ in range(3)]
    seen = []
    orig = teng.loss_fn

    def spy(params, micro, rng_):
        seen.append(micro["input_ids"].shape[-1] - 1)
        return orig(params, micro, rng_)

    teng.loss_fn = spy
    j_losses = [float(jeng.train_batch(b)) for b in batches]
    t_losses = [float(teng.train_batch(b)) for b in batches]
    np.testing.assert_allclose(t_losses, j_losses, **ENGINE_TOL)
    assert seen == [16, 16, 24, 24, 32, 32]  # two micro-batches a step
    assert teng.curriculum_scheduler.get_state() == jeng.curriculum_scheduler.get_state()
    # the checkpoint's meta: JAX's save writes the scheduler's get_state()
    # (its saving.py:245-246); the port's equals it, and each package's
    # loads into the other
    teng.save_checkpoint(str(tmp_path / "port"), tag="t")
    metas = {"port": json.load(open(tmp_path / "port" / "t" / "meta.json")),
             "jax": {"curriculum": json.loads(json.dumps(
                 jeng.curriculum_scheduler.get_state()))}}
    assert metas["port"]["curriculum"] == metas["jax"]["curriculum"]
    assert metas["port"]["curriculum"]["current_difficulty"] == 32
    tcfg = get_preset("tiny", dtype=torch.float32)
    fresh_t, _, _, _ = tds.initialize(model=tt.CausalLM(tcfg), config=_engine_config(),
                                      device="cpu")
    meta_path = tmp_path / "port" / "t" / "meta.json"
    meta = dict(metas["port"], curriculum=metas["jax"]["curriculum"])
    meta_path.write_text(json.dumps(meta))
    fresh_t.load_checkpoint(str(tmp_path / "port"), tag="t")
    fresh_j = jcs.CurriculumScheduler(RAMP)
    fresh_j.set_state(metas["port"]["curriculum"])
    assert fresh_t.curriculum_scheduler.get_state() == metas["jax"]["curriculum"]
    assert fresh_j.get_current_difficulty() == 32 and fresh_j.update_difficulty(9) == 32


# ---------------------------------------------------------------------------
# the indexed dataset and the analyzer
# ---------------------------------------------------------------------------
def _docs(n=37, seed=3, lo=1, hi=60):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 30000, int(rng.integers(lo, hi))) for _ in range(n)]


def _files(prefix):
    return {ext: open(prefix + ext, "rb").read() for ext in (".bin", ".idx")}


@pytest.mark.parametrize("dtype", [np.int32, np.uint16, np.int64])
def test_indexed_dataset_files_round_trip_byte_equal(tmp_path, dtype):
    docs = _docs()
    for mod, name in ((jid, "jax"), (tid, "port")):
        b = mod.MMapIndexedDatasetBuilder(str(tmp_path / name), dtype=dtype)
        for d in docs:
            b.add_item(d)
        b.finalize()
    assert _files(str(tmp_path / "port")) == _files(str(tmp_path / "jax"))
    for reader, name in ((tid, "jax"), (jid, "port")):  # each reads the other's
        ds = reader.MMapIndexedDataset(str(tmp_path / name))
        assert len(ds) == len(docs) and ds.dtype == np.dtype(dtype)
        for i in (0, 5, len(docs) - 1, -1):
            np.testing.assert_array_equal(ds[i], np.asarray(docs[i], dtype))
        np.testing.assert_array_equal(ds.sizes, [len(d) for d in docs])
        np.testing.assert_array_equal(ds.get(3, 1, 2), np.asarray(docs[3][1:3], dtype))
        assert len(ds[2:5]) == 3
    with pytest.raises(IndexError):
        tid.MMapIndexedDataset(str(tmp_path / "jax"))[len(docs)]


def _analysis_files(root):
    out = {}
    for dirpath, _, names in os.walk(root):
        for n in names:
            out[os.path.relpath(os.path.join(dirpath, n), root)] = open(
                os.path.join(dirpath, n), "rb").read()
    return out


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("corpus")
    b = tid.MMapIndexedDatasetBuilder(str(root / "docs"))
    for d in _docs(n=64, seed=9, lo=4, hi=33):
        b.add_item(d)
    b.finalize()
    return str(root / "docs")


def _analyze(mod, ds, save, workers=3, processes=1, accumulate=False):
    names, fns, types = ["seqlen"], [mod.seqlen_metric], [mod.SINGLE_VALUE]
    if accumulate:
        names.append("tokens")
        fns.append(lambda s: np.asarray(s).size)
        types.append(mod.ACCUMULATE)
    a = mod.DataAnalyzer(ds, num_workers=workers, metric_names=names, metric_functions=fns,
                         metric_types=types, save_path=save)
    return a.run_map_reduce(processes=processes)


def test_analyzer_outputs_are_byte_equal_to_jax(corpus, tmp_path):
    ds = jid.MMapIndexedDataset(corpus)
    _analyze(jda, [ds[i] for i in range(len(ds))], str(tmp_path / "jax"), accumulate=True)
    _analyze(tda, [ds[i] for i in range(len(ds))], str(tmp_path / "port"), accumulate=True)
    want = _analysis_files(tmp_path / "jax")
    assert _analysis_files(tmp_path / "port") == want
    assert "seqlen/index_to_metric.npy" in want and "tokens/value.npy" in want
    # spawned map workers over the re-opened dataset, then the CLI
    _analyze(tda, tid.MMapIndexedDataset(corpus), str(tmp_path / "spawned"), workers=2,
             processes=2)
    assert tda.main(["--data-prefix", corpus, "--save", str(tmp_path / "cli"),
                     "--workers", "1"]) == 0
    for d in ("spawned", "cli"):
        got = {k: v for k, v in _analysis_files(tmp_path / d).items() if "worker" not in k}
        assert got == {k: v for k, v in want.items()
                       if k.startswith("seqlen/") and "worker" not in k}


def test_analyzer_finds_a_worker_that_never_mapped(corpus, tmp_path):
    msgs = []
    for mod in (jda, tda):
        a = mod.DataAnalyzer(tid.MMapIndexedDataset(corpus), num_workers=2,
                             save_path=str(tmp_path / mod.__name__))
        a.run_map()  # worker 0 only
        with pytest.raises(RuntimeError, match="worker 1") as err:
            a.run_reduce()
        msgs.append(str(err.value).replace(mod.__name__, ""))
    assert msgs[0] == msgs[1]


def test_curriculum_sampler_streams_equal_jax_and_resume(corpus, tmp_path):
    _analyze(tda, tid.MMapIndexedDataset(corpus), str(tmp_path))
    sched_cfg = {"min_difficulty": 8, "max_difficulty": 32, "schedule_type": "fixed_linear",
                 "schedule_config": {"total_curriculum_step": 6, "difficulty_step": 8}}

    def samplers(mod, cs):
        idx = mod.CurriculumIndex(str(tmp_path), "seqlen")
        return mod.CurriculumDataSampler(idx, cs.CurriculumScheduler(sched_cfg), 4, seed=2)

    js, ts = samplers(jda, jcs), samplers(tda, tcs)
    lens = tid.MMapIndexedDataset(corpus).sizes
    for step in range(1, 6):
        got, want = ts.next_batch(step), js.next_batch(step)
        np.testing.assert_array_equal(got, want)
        assert (lens[got] <= ts.scheduler.get_current_difficulty()).all()
    state = ts.state_dict()
    assert state == js.state_dict()
    resumed = samplers(tda, tcs)
    resumed.load_state_dict(state)
    legacy = samplers(tda, tcs)
    legacy.load_state_dict({"consumed_samples": state["consumed_samples"]})
    for step in range(6, 10):
        want = ts.next_batch(step)
        np.testing.assert_array_equal(resumed.next_batch(step), want)
        np.testing.assert_array_equal(legacy.next_batch(step), want)


def test_index_filter_streams_equal_jax(corpus, tmp_path):
    _analyze(tda, tid.MMapIndexedDataset(corpus), str(tmp_path))
    scheds = [m.CurriculumScheduler(SCHEDULES["fixed_linear"]) for m in (jcs, tcs)]
    for s in scheds:
        s.update_difficulty(2)
    streams = []
    for mod, sampler_cls, s in ((jda, JSampler, scheds[0]), (tda, DeepSpeedDataSampler,
                                                             scheds[1])):
        filt = mod.curriculum_index_filter(str(tmp_path), "seqlen", s)
        sampler = sampler_cls(64, micro_batch_size=2, gradient_accumulation_steps=2, seed=1,
                              index_filter=filt)
        streams.append([b.tolist() for b, _ in zip(sampler, range(5))])
    assert streams[0] == streams[1] and len(streams[0]) > 1


def test_initialize_samples_within_the_analyzed_difficulty(corpus, tmp_path):
    ds = tid.MMapIndexedDataset(corpus)
    _analyze(tda, ds, str(tmp_path))
    cl = dict(RAMP, data_analysis_path=str(tmp_path), min_difficulty=16,
              schedule_config={"total_curriculum_step": 4, "difficulty_step": 8})

    def pad(samples):
        out = np.zeros((len(samples), 33), np.int64)
        for i, s in enumerate(samples):
            out[i, :len(s)] = s % 256
        return {"input_ids": torch.as_tensor(out)}

    cfg = get_preset("tiny", dtype=torch.float32, max_seq_len=64)
    eng, _, loader, _ = tds.initialize(
        model=tt.CausalLM(cfg), device="cpu", training_data=ds, collate_fn=pad,
        config=_engine_config(data_efficiency={"enabled": True, "curriculum_learning": cl}))
    assert loader.data_sampler.index_filter is not None
    drawn = []
    order = loader.data_sampler._epoch_order
    loader.data_sampler._epoch_order = lambda e: drawn.append(order(e)) or drawn[-1]
    losses = list(eng.train_on_loader(loader, num_steps=3))
    assert len(losses) == 3 and eng._active_prefetcher is None
    assert all(np.isfinite(float(x)) for x in losses)
    eligible = ds.sizes[drawn[0]]
    assert len(eligible) < len(ds) and (eligible <= 16).all()  # the difficulty at the draw

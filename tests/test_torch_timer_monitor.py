"""The port's timers, memory report, monitors, accelerator and the config
sections of the instrumented step, against the JAX package on the CPU.

- Timers: ``_Timer``, ``SynchronizedWallClockTimer`` and
  ``ThroughputTimer`` driven by one fake clock in both packages give equal
  readings (exact: the same float operations); ``_block`` counts a fence
  and waits for nothing on a CPU tensor.  The engine fences the step timer
  every step only under ``wall_clock_breakdown``, else only at
  ``steps_per_print`` boundaries (the async-metrics contract).
- Monitors: the same events give byte-equal CSV files; WandB and Comet,
  through fake modules, receive the same calls; a missing package disables
  its writer with a warning in both.  The engine's monitor events over 3
  fp32 steps on ``tiny`` match the JAX engine's: the same labels and steps,
  values within 1e-5 (the trajectory tolerance of
  ``test_torch_training.py``).
- ``see_memory_usage`` and ``get_accelerator``'s method names and device
  rule.
- Config: the sections this slice runs parse into JAX's values, and so do
  ``elasticity`` and ``compile``, which slice 21 runs.
"""
import dataclasses
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu as jds
from deepspeed_tpu.config.config import parse_config as j_parse_config
from deepspeed_tpu.models import transformer as jt
from deepspeed_tpu.models.presets import get_preset as j_preset
from deepspeed_tpu.monitor import monitor as jmon
from deepspeed_tpu.parallel.topology import initialize_mesh
from deepspeed_tpu.utils import memory as jmem
from deepspeed_tpu.utils import timer as jtimer

import deepspeed_tpu_torch as tds
from deepspeed_tpu_torch.accelerator import CudaAccelerator, get_accelerator
from deepspeed_tpu_torch.config.config import parse_config
from deepspeed_tpu_torch.models import transformer as tt
from deepspeed_tpu_torch.models.presets import get_preset
from deepspeed_tpu_torch.monitor import monitor as tmon
from deepspeed_tpu_torch.utils import memory as tmem
from deepspeed_tpu_torch.utils import timer as ttimer
from torch_threads import one_torch_thread  # noqa: F401  (one intra-op thread)

ENGINE_TOL = dict(atol=1e-5, rtol=1e-5)


class FakeClock:
    """``time.perf_counter`` for both packages: each read advances by the
    next of ``steps`` seconds."""

    def __init__(self, steps):
        self.t, self.steps, self.i = 100.0, steps, 0

    def __call__(self):
        self.t += self.steps[self.i % len(self.steps)]
        self.i += 1
        return self.t


def _drive_timers(timer_mod, clock, monkeypatch):
    monkeypatch.setattr(timer_mod.time, "perf_counter", clock)
    reg = timer_mod.SynchronizedWallClockTimer()
    out = []
    for _ in range(3):
        reg("fwd").start()
        reg("fwd").stop()
        reg("bwd").start()
        reg("bwd").stop(record=False)
        out.append((reg("fwd").last(), reg("fwd").mean(), reg("fwd").elapsed(reset=False)))
    out.append(reg.get_mean(["fwd", "bwd", "none"]))
    out.append((reg.has("fwd"), reg.has("step")))
    tput = timer_mod.ThroughputTimer(batch_size=16, steps_per_output=2)
    for i in range(5):
        tput.start()
        tput.stop(global_step=i != 2)
        out.append((tput.global_steps, tput.total_elapsed, tput.avg_samples_per_sec()))
    out.append(list(tput.history))
    reg("fwd").reset()
    out.append((reg("fwd").last(), reg("fwd").elapsed()))
    return out


def test_timers_read_as_jax_under_one_fake_clock(monkeypatch):
    steps = [0.25, 0.5, 0.125, 1.0, 0.0625]
    want = _drive_timers(jtimer, FakeClock(steps), monkeypatch)
    got = _drive_timers(ttimer, FakeClock(steps), monkeypatch)
    assert got == want
    assert got[-3][2] > 0  # samples/s counted from start_step on


def test_timer_names_are_jax_names():
    for name in ("FORWARD_MICRO_TIMER", "FORWARD_GLOBAL_TIMER", "BACKWARD_MICRO_TIMER",
                 "BACKWARD_GLOBAL_TIMER", "STEP_MICRO_TIMER", "STEP_GLOBAL_TIMER",
                 "TRAIN_BATCH_TIMER"):
        assert getattr(ttimer, name) == getattr(jtimer, name)


def test_block_counts_a_fence_and_waits_for_nothing_on_the_cpu():
    before = ttimer.TIMER_SYNCS["count"]
    ttimer._block(torch.ones(3))
    ttimer._block(None)
    assert ttimer.TIMER_SYNCS["count"] == before + 2


def test_see_memory_usage_is_off_unless_forced():
    assert tmem.see_memory_usage("x") is None and jmem.see_memory_usage("x") is None
    got = tmem.see_memory_usage("x", force=True, collect=True, device="cpu")
    want = jmem.see_memory_usage("x", force=True)
    assert set(got) == set(want)
    assert got["device_bytes_in_use"] == 0 and got["host_rss_gb"] > 0


# ---------------------------------------------------------------------------
# monitors
# ---------------------------------------------------------------------------
EVENTS = [("Train/Samples/train_loss", 2.3456789, 1), ("Train/Samples/lr", 1e-3, 1),
          ("Train/Samples/train_loss", np.float32(1.5).item(), 2), ("Train/Samples/lr", 0.5, 2),
          ("train/step_ms/p50", 12.0, 2)]


def _csv_files(root):
    return {p.name: p.read_bytes() for p in sorted(root.iterdir())}


def test_csv_files_are_byte_equal_to_jax(tmp_path):
    for mod, name in ((jmon, "jax"), (tmon, "port")):
        cfg = types.SimpleNamespace(enabled=True, output_path=str(tmp_path / name),
                                    job_name="job")
        mon = mod.CsvMonitor(cfg)
        mon.write_events(EVENTS)
        mon.write_events(EVENTS[:2])  # a second flush appends under the header
    want = _csv_files(tmp_path / "jax" / "job")
    assert _csv_files(tmp_path / "port" / "job") == want
    assert len(want) == 3


def _fake_wandb(calls):
    stub = types.ModuleType("wandb")
    stub.init = lambda **kw: calls.append(("init", kw))
    stub.log = lambda row, step=None: calls.append((step, dict(row)))
    return stub


def _fake_comet(calls):
    class _Exp:
        def log_metric(self, label, value, step=None):
            calls.append((label, value, step))

        def set_name(self, name):
            calls.append(("name", name))

    stub = types.ModuleType("comet_ml")
    stub.start = lambda **kw: calls.append(("start", kw)) or _Exp()
    return stub


def test_wandb_and_comet_receive_jax_calls(monkeypatch):
    wcfg = types.SimpleNamespace(enabled=True, project="p", group="g", team="t")
    ccfg = types.SimpleNamespace(enabled=True, samples_log_interval=2, api_key="k",
                                 project="p", workspace=None, experiment_key=None,
                                 online=None, mode=None, experiment_name="run")
    calls = {}
    for mod, name in ((jmon, "jax"), (tmon, "port")):
        calls[name] = []
        monkeypatch.setitem(sys.modules, "wandb", _fake_wandb(calls[name]))
        monkeypatch.setitem(sys.modules, "comet_ml", _fake_comet(calls[name]))
        w, c = mod.WandbMonitor(wcfg), mod.CometMonitor(ccfg)
        assert w.enabled and c.enabled and c.experiment is not None
        w.write_events(EVENTS)
        c.write_events(EVENTS)
    assert calls["port"] == calls["jax"]
    assert ("start", {"api_key": "k", "project_name": "p"}) in calls["port"]


def test_missing_writer_packages_disable_as_in_jax(monkeypatch):
    monkeypatch.setitem(sys.modules, "wandb", None)
    monkeypatch.setitem(sys.modules, "comet_ml", None)
    cfg = types.SimpleNamespace(enabled=True, project=None, group=None, team=None)
    for mod in (jmon, tmon):
        assert not mod.WandbMonitor(cfg).enabled
        assert not mod.CometMonitor(cfg).enabled
    conf = parse_config({"wandb": {"enabled": True}, "comet": {"enabled": True}})
    master = tmon.MonitorMaster(conf)
    assert master.rank0 and not master.enabled and master.writers == []


def test_tensorboard_writer_enables_as_in_jax(tmp_path):
    cfg = types.SimpleNamespace(enabled=True, output_path=str(tmp_path), job_name="tb")
    assert tmon.TensorBoardMonitor(cfg).enabled == jmon.TensorBoardMonitor(cfg).enabled


def _engine_config(out_dir, **over):
    return {"train_micro_batch_size_per_gpu": 2, "gradient_accumulation_steps": 2,
            "optimizer": {"type": "adamw", "params": {"weight_decay": 0.1}},
            "scheduler": {"type": "WarmupLR",
                          "params": {"warmup_num_steps": 3, "warmup_max_lr": 3e-3}},
            "bf16": {"enabled": False}, "steps_per_print": 2,
            "csv_monitor": {"enabled": True, "output_path": str(out_dir), "job_name": "run"},
            **over}


def _csv_events(root):
    out = {}
    for p in sorted(root.iterdir()):
        lines = p.read_text().splitlines()
        label = lines[0].split(",", 1)[1]
        out[label] = [(int(a), float(b)) for a, b in (ln.split(",") for ln in lines[1:])]
    return out


def test_engine_monitor_events_match_jax_engine(tmp_path):
    jcfg = j_preset("tiny", dtype=jnp.float32)
    jp = jax.tree_util.tree_map(np.asarray, jt.init_params(jax.random.PRNGKey(0), jcfg))
    rng = np.random.default_rng(3)
    batches = [{"input_ids": rng.integers(0, 256, (2, 2, 17)).astype(np.int32)}
               for _ in range(3)]
    jeng, _, _, _ = jds.initialize(
        model=jt.CausalLM(jcfg), params=jax.tree_util.tree_map(jnp.asarray, jp),
        config=_engine_config(tmp_path / "jax"),
        mesh=initialize_mesh(devices=jax.devices()[:1], data=1))
    tcfg = get_preset("tiny", dtype=torch.float32, attn_impl="flash", remat="selective")
    teng, _, _, _ = tds.initialize(model=tt.CausalLM(tcfg),
                                   params=tt.params_from_numpy(jp, tcfg, device="cpu"),
                                   config=_engine_config(tmp_path / "port"), device="cpu")
    assert teng.monitor.enabled and len(teng.monitor.writers) == 1
    for eng in (jeng, teng):
        for b in batches:
            eng.train_batch(b)
        eng.get_last_loss()  # flushes the third step (not a print boundary)
    want, got = _csv_events(tmp_path / "jax" / "run"), _csv_events(tmp_path / "port" / "run")
    assert sorted(got) == sorted(want) == ["Train/Samples/loss_scale", "Train/Samples/lr",
                                           "Train/Samples/train_loss"]
    for label in want:
        assert [s for s, _ in got[label]] == [s for s, _ in want[label]] == [1, 2, 3]
        np.testing.assert_allclose([v for _, v in got[label]], [v for _, v in want[label]],
                                   err_msg=label, **ENGINE_TOL)


def test_engine_monitor_rows_hold_get_last_loss(tmp_path):
    """The CSV's loss row of each step is the float ``get_last_loss``
    reads, to the last digit; the registry's aggregates ride along under
    telemetry."""
    tcfg = get_preset("tiny", dtype=torch.float32, max_seq_len=32)
    eng, _, _, _ = tds.initialize(model=tt.CausalLM(tcfg), config=_engine_config(
        tmp_path, telemetry={"enabled": True}, steps_per_print=1), device="cpu")
    losses = []
    for b in range(3):
        eng.train_batch({"input_ids": np.full((2, 2, 9), b + 1, np.int64)})
        losses.append(eng.get_last_loss())
    rows = _csv_events(tmp_path / "run")
    assert [v for _, v in rows["Train/Samples/train_loss"]] == losses
    assert rows["train/step_ms/count"][-1] == (3, 3.0)


@pytest.mark.parametrize("wall_clock", [False, True])
def test_step_timer_fences_only_when_asked(wall_clock):
    """Without ``wall_clock_breakdown`` the loop fences only at the
    ``steps_per_print`` boundary (the throughput timer); with it, the step
    timer fences every step and ``timers.log`` resets it at the boundary."""
    tcfg = get_preset("tiny", dtype=torch.float32, max_seq_len=32)
    conf = {"train_micro_batch_size_per_gpu": 1, "bf16": {"enabled": False},
            "steps_per_print": 4, "wall_clock_breakdown": wall_clock}
    eng, _, _, _ = tds.initialize(model=tt.CausalLM(tcfg), config=conf, device="cpu")
    batch = {"input_ids": np.ones((1, 1, 9), np.int64)}
    before = ttimer.TIMER_SYNCS["count"]
    for _ in range(3):
        eng.train_batch(batch)
    assert ttimer.TIMER_SYNCS["count"] - before == (3 if wall_clock else 0)
    assert eng.timers("step").elapsed(reset=False) > 0
    eng.train_batch(batch)
    assert ttimer.TIMER_SYNCS["count"] - before == (5 if wall_clock else 1)
    assert (eng.timers("step").elapsed(reset=False) == 0) == wall_clock
    assert eng.tput_timer.global_steps == 4


def test_forward_and_backward_are_timed():
    tcfg = get_preset("tiny", dtype=torch.float32, max_seq_len=32)
    eng, _, _, _ = tds.initialize(model=tt.CausalLM(tcfg), config={
        "train_micro_batch_size_per_gpu": 1, "bf16": {"enabled": False}}, device="cpu")
    loss = eng.forward({"input_ids": np.ones((1, 9), np.int64)})
    eng.backward(loss)
    assert eng.timers("fwd").last() > 0 and eng.timers("bwd").last() > 0


# ---------------------------------------------------------------------------
# the accelerator
# ---------------------------------------------------------------------------
def test_accelerator_keeps_jax_method_names():
    from deepspeed_tpu.accelerator.tpu_accelerator import TpuAccelerator

    names = {n for n in dir(TpuAccelerator) if not n.startswith("_")}
    assert names <= {n for n in dir(CudaAccelerator) if not n.startswith("_")}
    cuda = CudaAccelerator("cuda")
    assert cuda.communication_backend_name() == "nccl"
    assert cuda.device_name(1) == "cuda:1" and cuda.platform() == "cuda"
    assert not cuda.on_tpu()
    with pytest.raises(ValueError, match="platform"):
        CudaAccelerator("tpu")


def test_accelerator_uses_the_cpu_only_when_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.delenv("DSTPU_ACCELERATOR", raising=False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        get_accelerator()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        get_accelerator("cuda")
    acc = get_accelerator("cpu")
    assert acc is get_accelerator("cpu")
    assert (acc.platform(), acc.device_kind(), acc.communication_backend_name()) == (
        "cpu", "cpu", "gloo")
    assert acc.memory_stats() == {} and acc.memory_allocated() == 0
    assert acc.current_device() == torch.device("cpu") and acc.process_count() == 1
    assert acc.manual_seed(3).initial_seed() == 3
    acc.synchronize(torch.ones(2))
    monkeypatch.setenv("DSTPU_ACCELERATOR", "cpu")
    assert get_accelerator() is acc


# ---------------------------------------------------------------------------
# the config sections of the instrumented step
# ---------------------------------------------------------------------------
TAKEN = [
    {"wall_clock_breakdown": True, "memory_breakdown": True},
    {"flops_profiler": {"enabled": True, "profile_step": 3, "module_depth": 2,
                        "output_file": "prof.txt"}},
    {"tensorboard": {"enabled": True, "output_path": "tb", "job_name": "j"},
     "csv_monitor": {"enabled": True}},
    {"wandb": {"enabled": True, "project": "p", "team": "t"},
     "comet": {"enabled": True, "samples_log_interval": 5, "online": False}},
    {"data_efficiency": {"enabled": True, "curriculum_learning": {
        "enabled": True, "curriculum_type": "seqlen", "min_difficulty": 8,
        "max_difficulty": 64, "schedule_type": "fixed_linear",
        "schedule_config": {"total_curriculum_step": 10, "difficulty_step": 8}}}},
    {"curriculum_learning": {"enabled": True, "min_difficulty": 8, "max_difficulty": 64,
                             "schedule_type": "fixed_root",
                             "schedule_config": {"total_curriculum_step": 10,
                                                 "difficulty_step": 8, "root_degree": 2}}},
    {"curriculum_learning": {"enabled": True}, "data_efficiency": {"enabled": False}},
    {"progressive_layer_drop": {"enabled": True, "theta": 0.6, "gamma": 0.01}},
]
SECTIONS = ("flops_profiler", "tensorboard", "csv_monitor", "wandb", "comet",
            "data_efficiency", "progressive_layer_drop")


@pytest.mark.parametrize("raw", TAKEN, ids=lambda r: "+".join(r))
def test_step_sections_parse_as_jax(raw):
    j, t = j_parse_config(raw, dp_world_size=1), parse_config(raw, dp_world_size=1)
    for name in SECTIONS:
        assert dataclasses.asdict(getattr(t, name)) == dataclasses.asdict(getattr(j, name))
    for name in ("wall_clock_breakdown", "memory_breakdown"):
        assert getattr(t, name) == getattr(j, name)


@pytest.mark.parametrize("key", ["elasticity", "compile"])
def test_item_9_keys_of_slice_21_parse_as_jax(key):
    """The two item-9 keys this test held refused until slice 21 now parse
    into JAX's values (``tests/test_torch_compile.py`` and
    ``test_torch_elasticity.py`` hold what they do)."""
    raw = {"elasticity": {"enabled": True, "max_train_batch_size": 64,
                          "micro_batch_sizes": [2]}, "compile": {"enabled": False}}
    t, j = parse_config({key: raw[key]}, 1), j_parse_config({key: raw[key]}, dp_world_size=1)
    value = getattr(t, key)
    assert (value if key == "elasticity" else dataclasses.asdict(value)) == \
        (getattr(j, key) if key == "elasticity" else dataclasses.asdict(getattr(j, key)))


def test_a_config_with_every_switch_trains(tmp_path, monkeypatch):
    """Every section this slice takes, on at once, trains through
    ``initialize`` (WandB and Comet absent: they disable themselves, as in
    JAX; TensorBoard writes where its package is installed)."""
    from deepspeed_tpu_torch.data import (DataAnalyzer, MMapIndexedDataset,
                                          MMapIndexedDatasetBuilder)

    monkeypatch.setitem(sys.modules, "wandb", None)
    monkeypatch.setitem(sys.modules, "comet_ml", None)
    rng = np.random.default_rng(0)
    builder = MMapIndexedDatasetBuilder(str(tmp_path / "docs"))
    for n in rng.integers(4, 20, 32):
        builder.add_item(rng.integers(0, 256, int(n)))
    builder.finalize()
    ds = MMapIndexedDataset(str(tmp_path / "docs"))
    DataAnalyzer(ds, num_workers=2, save_path=str(tmp_path / "an")).run_map_reduce(processes=1)

    def pad(samples):
        out = np.zeros((len(samples), 33), np.int64)
        for i, s in enumerate(samples):
            out[i, :len(s)] = s
        return {"input_ids": torch.as_tensor(out)}

    out = str(tmp_path / "mon")
    conf = _engine_config(
        tmp_path / "csv", wall_clock_breakdown=True, memory_breakdown=True,
        flops_profiler={"enabled": True, "profile_step": 2,
                        "output_file": str(tmp_path / "prof.txt")},
        tensorboard={"enabled": True, "output_path": out}, wandb={"enabled": True},
        comet={"enabled": True}, progressive_layer_drop={"enabled": True, "gamma": 0.5},
        curriculum_learning={"enabled": True, "curriculum_type": "seqlen",
                             "min_difficulty": 16, "max_difficulty": 32,
                             "schedule_type": "fixed_linear",
                             "data_analysis_path": str(tmp_path / "an"),
                             "schedule_config": {"total_curriculum_step": 2,
                                                 "difficulty_step": 8}})
    cfg = get_preset("tiny", dtype=torch.float32, attn_impl="flash", remat="selective")
    eng, _, loader, _ = tds.initialize(model=tt.CausalLM(cfg), config=conf, device="cpu",
                                       training_data=ds, collate_fn=pad)
    losses = [float(x) for x in eng.train_on_loader(loader, num_steps=3)]
    assert len(losses) == 3 and np.isfinite(losses).all()
    kinds = sorted(type(w).__name__ for w in eng.monitor.writers)
    assert kinds == sorted(["CsvMonitor"] + ["TensorBoardMonitor"] * jmon.TensorBoardMonitor(
        types.SimpleNamespace(enabled=True, output_path=out, job_name="probe")).enabled)
    assert (tmp_path / "prof.txt").exists() and eng.curriculum_scheduler is not None
    assert eng.timers("step").last() > 0 and len(eng.pld_masks) == 2


# the sections of test_still_refused_keys_name_item_9 that the port now runs
@pytest.mark.parametrize("key", ["eigenvalue", "compression_training", "hybrid_engine"])
def test_item_9_sections_that_run_parse_as_jax(key):
    raw = {"eigenvalue": {"enabled": True}, "compression_training": {"enabled": True},
           "hybrid_engine": {"enabled": True}}
    j, t = j_parse_config({key: raw[key]}, dp_world_size=1), parse_config({key: raw[key]},
                                                                           dp_world_size=1)
    assert dataclasses.asdict(getattr(t, key)) == dataclasses.asdict(getattr(j, key))

"""``elasticity/`` of the port against the JAX package's, on the CPU:
``compute_elastic_config`` (v0.1 and v0.2) over a grid of configs and world
sizes, exactly (integers and lists); the error types; ``initialize``'s
adoption of the elastic batch and its conflict check against JAX's
``initialize``; the elastic agent (world re-formation, the ``ds_elastic``
CLI, rendering through a multinode runner) and its resume at a smaller
world on CPU subprocess workers that train with the port and resume from
its checkpoints (JAX's ``tests/test_elastic_agent.py:131``, one torch
worker)."""
import json
import os
import sys
import textwrap

import jax
import jax.numpy as jnp
import pytest
import torch

import deepspeed_tpu as jds
from deepspeed_tpu import elasticity as J
from deepspeed_tpu.parallel.topology import initialize_mesh

import deepspeed_tpu_torch as tds
from deepspeed_tpu_torch import elasticity as T

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PAPER = {"enabled": True, "max_train_batch_size": 10000, "micro_batch_sizes": [8, 12, 16, 17],
         "min_gpus": 32, "max_gpus": 1500, "min_time": 20, "version": 0.1}
GRID = [
    PAPER,
    dict(PAPER, prefer_larger_batch=False),
    {"enabled": True, "max_train_batch_size": 64, "micro_batch_sizes": [2, 4], "min_gpus": 1,
     "max_gpus": 4, "version": 0.1},
    {"enabled": True, "max_train_batch_size": 2000, "micro_batch_sizes": [2, 4, 6],
     "version": 0.1},
    dict(PAPER, version=0.2, num_gpus_per_node=8, model_parallel_size=2, max_gpus=1024),
    dict(PAPER, version=0.2, num_gpus_per_node=4),
    {"enabled": True, "max_train_batch_size": 96, "micro_batch_sizes": [1, 3], "version": 0.2,
     "num_gpus_per_node": 1},
]
WORLDS = [0, 1, 2, 3, 4, 8, 53, 64, 96, 100]


def _outcome(fn):
    """The result, or the error type's name and nothing else."""
    try:
        return fn()
    except Exception as e:  # noqa: BLE001 — the type is what is compared
        return type(e).__name__


@pytest.mark.parametrize("idx", range(len(GRID)))
def test_compute_elastic_config_equals_jax(idx):
    """Every world size of the grid: (batch, valid GPUs, micro-batch) or the
    error type, equal to JAX's."""
    ds = {"elasticity": GRID[idx]}
    if GRID[idx]["version"] == 0.1:  # v0.2 with no world reads WORLD_SIZE (below)
        assert _outcome(lambda: T.compute_elastic_config(ds)) == \
            _outcome(lambda: J.compute_elastic_config(ds))
    for w in WORLDS:
        if w == 0 and GRID[idx]["version"] == 0.2:
            continue  # reads WORLD_SIZE from the env, asserted below
        got = _outcome(lambda: T.compute_elastic_config(ds, world_size=w, return_microbatch=True))
        want = _outcome(lambda: J.compute_elastic_config(ds, world_size=w,
                                                         return_microbatch=True))
        assert got == want, (w, got, want)


def test_v02_world_from_the_env_and_the_immutable_check(monkeypatch):
    ds = {"elasticity": GRID[5]}
    monkeypatch.setenv("WORLD_SIZE", "16")
    assert T.compute_elastic_config(ds) == J.compute_elastic_config(ds)
    monkeypatch.delenv("WORLD_SIZE")
    with pytest.raises(T.ElasticityConfigError, match="needs world_size"):
        T.compute_elastic_config(ds)
    monkeypatch.setenv(T.elasticity.ELASTICITY_CONFIG_ENV, json.dumps(PAPER))
    T.ensure_immutable_elastic_config(PAPER)
    J.ensure_immutable_elastic_config(PAPER)
    changed = dict(PAPER, micro_batch_sizes=[8])
    for mod in (T, J):
        with pytest.raises(mod.ElasticityConfigError, match="micro_batches"):
            mod.ensure_immutable_elastic_config(changed)
    assert T.elasticity_enabled({"elasticity": PAPER}) and not T.elasticity_enabled({})


@pytest.mark.parametrize("ds", [
    {"elasticity": {"enabled": False}}, {},
    {"elasticity": {"enabled": True, "micro_batch_sizes": [2]}},
    {"elasticity": {"enabled": True, "max_train_batch_size": 100}},
    {"elasticity": {"enabled": True, "max_train_batch_size": 100, "micro_batch_sizes": [2],
                    "model_parallel_size": 4, "version": 0.1}},
    {"elasticity": {"enabled": True, "max_train_batch_size": 100, "micro_batch_sizes": [2],
                    "version": 0.3}},
    {"elasticity": {"enabled": True, "max_train_batch_size": 100, "micro_batch_sizes": [0]}},
    {"elasticity": {"enabled": True, "max_train_batch_size": 100, "micro_batch_sizes": [2],
                    "min_gpus": 4, "max_gpus": 2}},
    {"elasticity": {"enabled": True, "max_train_batch_size": 100, "micro_batch_sizes": [2],
                    "version": 0.2, "num_gpus_per_node": 3, "model_parallel_size": 2}},
], ids=lambda d: json.dumps(d)[:60])
def test_error_types_equal_jax(ds):
    got = _outcome(lambda: T.compute_elastic_config(ds, world_size=2))
    assert isinstance(got, str) and got == _outcome(
        lambda: J.compute_elastic_config(ds, world_size=2))
    # the port's classes keep JAX's hierarchy
    assert issubclass(getattr(T, got, ValueError), (T.ElasticityError, ValueError))


ADOPT = [
    ({"elasticity": GRID[2]}, None),
    ({"elasticity": dict(GRID[6], model_parallel_size=1)}, None),
    ({"elasticity": dict(GRID[2], version=0.2, num_gpus_per_node=2, model_parallel_size=2)},
     None),
    ({"elasticity": GRID[2], "train_micro_batch_size_per_gpu": 2}, "ElasticityConfigError"),
    ({"elasticity": dict(GRID[2], ignore_non_elastic_batch_info=True),
      "train_batch_size": 7, "gradient_accumulation_steps": 7}, None),
]


@pytest.mark.parametrize("extra,error", ADOPT, ids=range(len(ADOPT)))
def test_initialize_adopts_the_elastic_batch_as_jax(extra, error):
    """``initialize`` on one device takes JAX's batch, micro-batch and GAS
    (its world: one device times the model-parallel size), or raises its
    error type for user batch keys beside the elastic section."""
    base = {"optimizer": {"type": "adamw", "params": {"lr": 1e-3}},
            "bf16": {"enabled": False}, "steps_per_print": 1000, **extra}

    def jax_engine():
        return jds.initialize(loss_fn=lambda p, b, r: jnp.sum(p["w"] ** 2),
                              params={"w": jnp.ones((2,))}, config=base,
                              mesh=initialize_mesh(devices=jax.devices()[:1], data=1))[0]

    def port_engine():
        return tds.initialize(loss_fn=lambda p, b, r: (p["w"] ** 2).sum(),
                              params={"w": torch.ones(2)}, config=base, device="cpu")[0]

    if error:
        assert _outcome(port_engine) == _outcome(jax_engine) == error
        return
    j, t = jax_engine().config, port_engine().config
    triple = ("train_batch_size", "train_micro_batch_size_per_gpu",
              "gradient_accumulation_steps")
    assert [getattr(t, k) for k in triple] == [getattr(j, k) for k in triple]


# ---------------------------------------------------------------------------
# the agent
# ---------------------------------------------------------------------------
AGENT_CFG = {"elasticity": GRID[2]}


def test_agent_forms_worlds_and_refuses_as_jax():
    ta, ja = T.ElasticAgent(AGENT_CFG, ["true"]), J.ElasticAgent(AGENT_CFG, ["true"])
    for cap in (4, 3, 2, 1):
        assert ta.compute_world(cap) == ja.compute_world(cap)
    with pytest.raises(T.ElasticityIncompatibleWorldSize):
        ta.compute_world(0)
    with pytest.raises(T.ElasticityError):
        T.ElasticAgent({"elasticity": {"enabled": False}}, ["true"])
    env = ta._attempt_env(3)
    assert env == ja._attempt_env(3)  # WORLD_SIZE and the DS_ELASTIC_* keys


def test_agent_renders_remote_commands_through_the_ports_runner():
    hosts = {"host-a": 1, "host-b": 1, "host-c": 1, "host-d": 1}
    agent = T.ElasticAgent(AGENT_CFG, ["python", "train.py"], hosts=hosts, runner="openmpi")
    cmd = agent.render_remote_commands(4)
    assert cmd[:7] == ["mpirun", "-n", "4", "--map-by", "ppr:1:node", "--host",
                       "host-a:1,host-b:1,host-c:1,host-d:1"]
    exported = dict(c.split("=", 1) for c in cmd[8::2][:-1] if "=" in c)
    assert exported["WORLD_SIZE"] == "4" and exported["MASTER_ADDR"] == "host-a"
    assert exported["DS_ELASTIC_BATCH"] == str(T.compute_elastic_config(AGENT_CFG, 0, 4)[0])
    assert cmd[-2:] == ["python", "train.py"]
    assert agent.render_remote_commands(2)[2] == "2"  # the first two hosts
    with pytest.raises(ValueError, match="one process each"):
        T.ElasticAgent(AGENT_CFG, ["x"], hosts={"a": 8}).render_remote_commands(2)


def test_ds_elastic_cli_prints_what_jax_prints(tmp_path, capsys):
    from deepspeed_tpu.elasticity.elastic_agent import main as jmain

    from deepspeed_tpu_torch.elasticity.elastic_agent import main as tmain

    cfg = tmp_path / "cfg.json"
    cfg.write_text(json.dumps({"elasticity": PAPER}))
    for argv in (["-c", str(cfg), "-w", "96"], ["-c", str(cfg)]):
        assert tmain(argv) == 0
        got = capsys.readouterr().out
        assert jmain(argv) == 0
        assert got == capsys.readouterr().out and "valid_gpus" in got


WORKER = textwrap.dedent("""
    import os, sys, time, pathlib
    rank = int(os.environ["RANK"]); world = int(os.environ["WORLD_SIZE"])
    restart = int(os.environ["DS_ELASTIC_RESTART_COUNT"])
    assert os.environ["MASTER_ADDR"] == "127.0.0.1" and int(os.environ["MASTER_PORT"]) > 0
    workdir = pathlib.Path(sys.argv[1])
    done, stepf = workdir / "done", workdir / "step"
    if rank != 0:
        # compute peers; the highest rank of the first attempt is preempted
        # once training passes step 3
        crash = restart == 0 and rank == world - 1
        while not done.exists():
            if crash and stepf.exists():
                try:
                    if int(stepf.read_text() or 0) >= 3:
                        os._exit(1)
                except ValueError:
                    pass
            time.sleep(0.05)
        sys.exit(0)
    import torch
    import deepspeed_tpu_torch as tds

    # rank 0 trains as a one-device job (out of the world); its peers stand
    # in for the ranks the agent supervises
    for k in ("WORLD_SIZE", "RANK"):
        os.environ.pop(k)

    def loss_fn(p, batch, rng):
        h = torch.tanh(batch["x"] @ p["w1"])
        return ((h @ p["w2"] - batch["y"]) ** 2).mean()

    g = torch.Generator().manual_seed(0)
    params = {"w1": torch.randn(8, 16, generator=g) * 0.3,
              "w2": torch.randn(16, 4, generator=g) * 0.3}
    engine, _, _, _ = tds.initialize(loss_fn=loss_fn, params=params, device="cpu", config={
        "train_micro_batch_size_per_gpu": 2, "bf16": {"enabled": False},
        "optimizer": {"type": "adamw", "params": {"lr": 0.05}}, "steps_per_print": 1000})
    ckpt = str(workdir / "ckpt")
    if os.path.isdir(ckpt):
        engine.load_checkpoint(ckpt)
    x, y = torch.randn(16, 8, generator=g), torch.randn(16, 4, generator=g)
    with open(workdir / "losses.csv", "a") as log:
        while engine.global_steps < 8:
            loss = float(engine.train_batch({"x": x[None], "y": y[None]}))
            log.write(f"{world},{engine.global_steps},{loss}\\n")
            log.flush()
            engine.save_checkpoint(ckpt)
            stepf.write_text(str(engine.global_steps))
            time.sleep(0.15)  # the preemption window
    done.write_text("ok")
""")


def test_agent_resumes_at_a_smaller_world_with_steps_continuing(tmp_path):
    """A worker dies mid-training: the agent re-forms the largest valid
    world that fits, and the relaunched rank 0 resumes from the port's
    checkpoint (steps continue, the loss does not reset)."""
    script = tmp_path / "worker.py"
    script.write_text(WORKER)
    env = {"PYTHONPATH": REPO, "OMP_NUM_THREADS": "1"}
    agent = T.ElasticAgent(AGENT_CFG, [sys.executable, str(script), str(tmp_path)],
                           heartbeat_interval=0.1, env=env)
    assert agent.run(capacity=4) == 0
    resumed_world = agent.compute_world(3)
    assert [h["world"] for h in agent.history] == [4, resumed_world]
    rows = [line.split(",") for line in (tmp_path / "losses.csv").read_text().splitlines()]
    worlds = [int(r[0]) for r in rows]
    steps = [int(r[1]) for r in rows]
    losses = [float(r[2]) for r in rows]
    assert set(worlds) == {4, resumed_world}
    ri = worlds.index(resumed_world)
    assert steps[ri] == max(s for s, w in zip(steps, worlds) if w == 4) + 1, (steps, worlds)
    assert steps[-1] == 8
    assert losses[ri] < losses[0] and losses[ri] < losses[ri - 1] * 1.5
    assert losses[-1] < losses[0] * 0.6  # the descent went on across the restart


ELASTIC_WORKER = textwrap.dedent("""
    import json, os, sys, pathlib, torch
    import deepspeed_tpu_torch as tds
    torch.set_num_threads(1)
    rank = os.environ["RANK"]
    engine, *_ = tds.initialize(
        loss_fn=lambda p, b, r: ((b["x"] @ p["w"] - b["y"]) ** 2).mean(), device="cpu",
        params={"w": torch.ones(4, 2)},
        config={"elasticity": %r, "bf16": {"enabled": False}, "steps_per_print": 1000,
                "zero_optimization": {"stage": 1},
                "optimizer": {"type": "adamw", "params": {"lr": 0.05}}})
    c = engine.config
    g = torch.Generator().manual_seed(1)
    n = c.train_batch_size  # the elastic batch, the world's together
    x, y = torch.randn(n, 4, generator=g), torch.randn(n, 2, generator=g)
    losses = [float(engine.train_batch({"x": x, "y": y})) for _ in range(3)]
    pathlib.Path(sys.argv[1], "rank" + rank).write_text(json.dumps(dict(
        world=engine.dp_world_size, batch=n, micro=c.train_micro_batch_size_per_gpu,
        gas=c.gradient_accumulation_steps, losses=losses,
        w=engine.master_tree()["w"].tolist())))
""" % (GRID[2],))


def test_agent_workers_with_an_elastic_section_are_refused_on_every_rank(tmp_path):
    """The agent's 2 workers form one world (gloo on the CPU) and train one
    model on the elastic batch of world 2, each its half: every rank adopts
    JAX's elastic batch, micro-batch and GAS for world 2 and reports the
    same global losses and parameters.  (Until the distributed layers,
    ``initialize`` refused each rank; the name is kept.)"""
    script = tmp_path / "worker.py"
    script.write_text(ELASTIC_WORKER)
    agent = T.ElasticAgent(AGENT_CFG, [sys.executable, str(script), str(tmp_path)],
                           max_restarts=0, heartbeat_interval=0.1,
                           env={"PYTHONPATH": REPO, "OMP_NUM_THREADS": "1"})
    assert agent.compute_world(2) == 2
    assert agent.run(capacity=2) == 0
    runs = [json.loads((tmp_path / f"rank{r}").read_text()) for r in (0, 1)]
    batch, _, micro = J.compute_elastic_config(AGENT_CFG, world_size=2, return_microbatch=True)
    for run in runs:
        assert (run["world"], run["batch"], run["micro"]) == (2, batch, micro)
        assert run["gas"] == batch // (micro * 2)
    assert runs[0]["losses"] == runs[1]["losses"] and runs[0]["w"] == runs[1]["w"]
    assert runs[0]["losses"][-1] < runs[0]["losses"][0]

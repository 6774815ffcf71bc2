"""``launcher/`` of the port against the JAX package's, on the CPU: the
hostfile parser and the include / exclude filters (results and errors),
runner selection, and each multinode runner's command against JAX's
strings.  The rendezvous env is the one difference, asserted explicitly:
the port hands torch.distributed's ``MASTER_ADDR`` / ``MASTER_PORT`` /
``WORLD_SIZE`` (and ``RANK`` / ``LOCAL_RANK`` where a runner pins ranks)
where JAX hands ``DSTPU_COORDINATOR`` / ``DSTPU_NUM_PROCESSES`` /
``DSTPU_PROCESS_ID``; everything else is JAX's string.  Also the serving
worker's launch through a runner (``serving.remote.remote_launch_cmd``) and
``env_report.collect``'s keys."""
import os

import pytest

from deepspeed_tpu.launcher import multinode_runner as JM
from deepspeed_tpu.launcher import runner as JR
from deepspeed_tpu.serving.remote import worker_launch_cmd as j_worker_cmd

from deepspeed_tpu_torch.launcher import env_report
from deepspeed_tpu_torch.launcher import multinode_runner as TM
from deepspeed_tpu_torch.launcher import runner as TR

HOSTS = {"worker-0": 8, "worker-1.cluster.local": 8, "10.0.0.7": 4}
COORD, PORT = "worker-0", 8476
N = len(HOSTS)
USER_ENV = {"NCCL_DEBUG": "INFO"}
CMD = ["python", "train.py", "--deepspeed_config", "ds config.json"]


HOSTFILES = {
    "plain": "worker-0 slots=8\nworker-1 slots=4\n",
    "comments": "# a pod\nworker-0 slots=8  # the coordinator\n\nworker-1\n10.0.0.7 slots=2\n",
    "duplicate": "a slots=1\na slots=2\n",
    "empty": "# nothing\n\n",
}


def _outcome(fn):
    try:
        return fn()
    except Exception as e:  # noqa: BLE001 — the type is what is compared
        return type(e).__name__


@pytest.mark.parametrize("name", sorted(HOSTFILES))
def test_hostfile_parses_as_jax(tmp_path, name):
    path = tmp_path / "hostfile"
    path.write_text(HOSTFILES[name])
    assert _outcome(lambda: TR.fetch_hostfile(str(path))) == \
        _outcome(lambda: JR.fetch_hostfile(str(path)))
    assert _outcome(lambda: TR.fetch_hostfile(str(tmp_path / "missing"))) == \
        "FileNotFoundError"


@pytest.mark.parametrize("include,exclude", [
    ("", ""), ("worker-0", ""), ("worker-0,10.0.0.7", ""), ("", "worker-0"),
    (" worker-1.cluster.local , worker-0", "worker-0"), ("nope", ""), ("", "nope"),
    ("", "worker-0,worker-1.cluster.local,10.0.0.7"), ("worker-0", "worker-0"),
])
def test_filters_select_as_jax(include, exclude):
    got = _outcome(lambda: TR.filter_hosts(HOSTS, include, exclude))
    assert got == _outcome(lambda: JR.filter_hosts(HOSTS, include, exclude))


def _env_port(jax_cmd):
    """JAX's command with its rendezvous env replaced by the port's, token
    for token in each runner's own syntax."""
    jc, n = f"DSTPU_COORDINATOR={COORD}:{PORT}", f"DSTPU_NUM_PROCESSES={N}"
    out = []
    it = iter(range(len(jax_cmd)))
    for i in it:
        tok = jax_cmd[i]
        if tok == "-x" and jax_cmd[i + 1] == jc:  # openmpi
            out += ["-x", f"MASTER_ADDR={COORD}", "-x", f"MASTER_PORT={PORT}"]
            next(it)
        elif tok == "-x" and jax_cmd[i + 1] == n:
            out += ["-x", f"WORLD_SIZE={N}"]
            next(it)
        elif tok == "-genv" and jax_cmd[i + 1] == "DSTPU_COORDINATOR":  # mpich / impi
            out += ["-genv", "MASTER_ADDR", COORD, "-genv", "MASTER_PORT", str(PORT)]
            next(it), next(it)
        elif tok == "-genv" and jax_cmd[i + 1] == "DSTPU_NUM_PROCESSES":
            out += ["-genv", "WORLD_SIZE", str(N)]
            next(it), next(it)
        elif tok == "-env" and jax_cmd[i + 1] == "DSTPU_PROCESS_ID":  # impi's ranks
            out += ["-env", "RANK", jax_cmd[i + 2], "-env", "LOCAL_RANK", "0"]
            next(it), next(it)
        elif tok == jc:  # mvapich
            out += [f"MASTER_ADDR={COORD}", f"MASTER_PORT={PORT}"]
        elif tok == n:
            out.append(f"WORLD_SIZE={N}")
        else:  # slurm's export list, pdsh's bootstrap
            out.append(tok.replace(jc, f"MASTER_ADDR={COORD} MASTER_PORT={PORT}")
                       .replace(f",MASTER_ADDR={COORD} ", f",MASTER_ADDR={COORD},")
                       .replace(n, f"WORLD_SIZE={N}")
                       .replace("DSTPU_PROCESS_ID=$i", "RANK=$i LOCAL_RANK=0"))
    return out


@pytest.mark.parametrize("name", sorted(JM.RUNNERS))
def test_each_runner_wraps_as_jax_with_the_torch_env(name):
    kw = dict(coordinator=COORD, port=PORT, env=USER_ENV)
    port = TM.get_runner(name, HOSTS, **kw)
    jax = JM.get_runner(name, HOSTS, **kw)
    assert type(port).__name__ == type(jax).__name__ and port.name == jax.name == name
    got, want = port.get_cmd(CMD), _env_port(jax.get_cmd(CMD))
    if name == "mvapich":  # each materializes its own temporary hostfile
        i = got.index("-hostfile") + 1
        assert open(got[i]).read() == open(jax.get_cmd(CMD)[i]).read() == \
            "".join(f"{h}\n" for h in HOSTS)
        got[i] = want[i] = "<hostfile>"
    assert got == want
    # the torch env is there, JAX's is not
    flat = " ".join(got)
    assert f"MASTER_ADDR{'=' if name not in ('mpich', 'impi') else ' '}{COORD}" in flat
    assert "DSTPU_" not in flat and "NCCL_DEBUG" in flat
    assert port.backend_exists() == jax.backend_exists()


def test_runner_selection_and_defaults():
    assert sorted(TM.RUNNERS) == sorted(JM.RUNNERS)
    with pytest.raises(ValueError, match="unknown launcher"):
        TM.get_runner("nope", HOSTS)
    with pytest.raises(ValueError, match="empty host set"):
        TM.get_runner("pdsh", {})
    r = TM.get_runner("slurm", HOSTS)
    assert r.coordinator == "worker-0" and r.port == TR.DEFAULT_MASTER_PORT == 29500
    assert JR.DEFAULT_COORD_PORT == 8476  # JAX's coordinator port


def test_ssh_commands_are_jax_with_the_torch_env(monkeypatch):
    monkeypatch.setenv("FOO_PASSED", "1 2")
    got = TR.build_host_commands(HOSTS, CMD, port=PORT, env_passthrough=["FOO_PASSED", "NOPE"])
    want = JR.build_host_commands(HOSTS, CMD, port=PORT, env_passthrough=["FOO_PASSED", "NOPE"])
    assert [h for h, _ in got] == [h for h, _ in want] == list(HOSTS)
    for i, ((_, g), (_, w)) in enumerate(zip(got, want)):
        assert g[:4] == w[:4] == ["ssh", "-o", "StrictHostKeyChecking=no", g[3]]
        assert g[4] == w[4].replace(
            f"DSTPU_COORDINATOR={COORD}:{PORT} DSTPU_NUM_PROCESSES={N} DSTPU_PROCESS_ID={i}",
            f"MASTER_ADDR={COORD} MASTER_PORT={PORT} WORLD_SIZE={N} RANK={i} LOCAL_RANK=0")
        assert "FOO_PASSED='1 2'" in g[4]


@pytest.mark.parametrize("scheduler,env,want", [
    ("openmpi", {"OMPI_COMM_WORLD_RANK": "3", "OMPI_COMM_WORLD_SIZE": "4",
                 "OMPI_COMM_WORLD_LOCAL_RANK": "1"}, ("3", "4", "1")),
    ("mpich", {"PMI_RANK": "2", "PMI_SIZE": "8"}, ("2", "8", "0")),
    ("slurm", {"SLURM_PROCID": "5", "SLURM_NTASKS": "6", "SLURM_LOCALID": "1"},
     ("5", "6", "1")),
    ("none", {}, None),
])
def test_scheduler_rank_env_reads_what_jax_reads(monkeypatch, scheduler, env, want):
    for k in ("OMPI_COMM_WORLD_RANK", "PMI_RANK", "SLURM_PROCID"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    got, jgot = TM.scheduler_rank_env(), JM.scheduler_rank_env()
    if want is None:
        assert got is None and jgot is None
        return
    assert (got["RANK"], got["WORLD_SIZE"], got["LOCAL_RANK"]) == want
    assert (jgot["DSTPU_PROCESS_ID"], jgot["DSTPU_NUM_PROCESSES"]) == want[:2]


def test_parse_args_and_a_single_host_run(tmp_path):
    a = TR.parse_args(["--hostfile", "h", "--include", "x", "--launcher", "slurm", "t.py",
                       "--lr", "1"])
    j = JR.parse_args(["--hostfile", "h", "--include", "x", "--launcher", "slurm", "t.py",
                       "--lr", "1"])
    assert vars(a) == dict(vars(j), coordinator_port=29500)
    script = tmp_path / "s.py"
    script.write_text("import sys; sys.exit(int(sys.argv[1]))\n")
    assert TR.main([str(script), "3"]) == 3  # no hostfile: the script, locally
    hostfile = tmp_path / "hostfile"
    hostfile.write_text("a slots=1\n")
    if not TM.get_runner("slurm", {"a": 1}).backend_exists():
        assert TR.main(["--hostfile", str(hostfile), "--launcher", "slurm", str(script)]) == 1


def test_a_serving_worker_launches_through_a_runner_as_jax():
    from deepspeed_tpu_torch.serving.remote import remote_launch_cmd, worker_launch_cmd

    spec = {"preset": "tiny", "seed": 0, "dtype": "float32", "device": "cpu"}
    got = remote_launch_cmd(spec, "openmpi", HOSTS, coordinator=COORD, port=PORT,
                            env=USER_ENV, python="python3")
    want = JM.get_runner("openmpi", HOSTS, coordinator=COORD, port=PORT,
                         env=USER_ENV).get_cmd(j_worker_cmd(spec, python="python3"))
    want = _env_port(want)
    assert got[:-len(worker_launch_cmd(spec, "python3"))] == \
        want[:-len(j_worker_cmd(spec, python="python3"))]
    assert got[-len(worker_launch_cmd(spec, "python3")):] == worker_launch_cmd(spec, "python3")
    assert got[-4:-2] == ["-m", "deepspeed_tpu_torch.serving.remote"]


def test_env_report_names_each_tool_or_says_it_is_missing(monkeypatch, capsys):
    info = env_report.collect()
    for key in ("torch", "torch_cuda", "cuda_available", "device_count", "gpus", "nvcc", "g++",
                "triton", "numpy", "deepspeed_tpu_torch"):
        assert key in info, key
    assert any(k.startswith("kernel/flash_fwd") for k in info)
    assert any(k.startswith("op/host_adam") for k in info)
    import torch

    assert info["torch"] == torch.__version__
    monkeypatch.setenv("PATH", "/nonexistent")
    monkeypatch.setenv("CUDA_HOME", "/nonexistent")
    bare = env_report.collect()
    for key in ("gpus", "nvcc", "g++"):
        assert str(bare[key]).startswith("MISSING"), (key, bare[key])
    assert env_report.main() == 0
    assert "deepspeed_tpu_torch environment report" in capsys.readouterr().out


def test_console_scripts_point_at_the_ports_mains():
    """``pyproject.toml``'s port entries name callables that exist, beside
    JAX's entries, which stay as they are."""
    import importlib
    import tomllib

    with open(os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                           "pyproject.toml"), "rb") as fh:
        scripts = tomllib.load(fh)["project"]["scripts"]
    assert scripts["dstpu"] == "deepspeed_tpu.launcher.runner:main"
    for name in ("dstpu_torch", "dstpu_torch_report", "ds_elastic_torch"):
        module, fn = scripts[name].split(":")
        assert module.startswith("deepspeed_tpu_torch.")
        assert callable(getattr(importlib.import_module(module), fn))

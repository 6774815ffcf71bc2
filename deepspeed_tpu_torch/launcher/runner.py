"""`dstpu_torch` launcher CLI — multi-host job launch, counterpart of
``deepspeed_tpu/launcher/runner.py`` (the reference's ``deepspeed`` runner,
``launcher/runner.py:419 main``).

The hostfile format, the host filters and the ssh wrapping are JAX's, and
so is the process model: one process per host of the hostfile.  The
rendezvous env is torch.distributed's, which ``init_process_group(
init_method="env://")`` reads: ``MASTER_ADDR`` / ``MASTER_PORT`` (the
coordinator, default the first host, port 29500), ``WORLD_SIZE`` (the
hosts), ``RANK`` (the host's index) and ``LOCAL_RANK`` 0, where JAX sets
``DSTPU_COORDINATOR`` / ``DSTPU_NUM_PROCESSES`` / ``DSTPU_PROCESS_ID`` for
``jax.distributed.initialize``.  A process per GPU of a many-card host
comes with the distributed layers (ROADMAP queue 1 item 7).  On a single
host it just runs the script.
"""
from __future__ import annotations

import argparse
import os
import shlex
import signal
import subprocess
import sys
from typing import Dict, List, Optional, Tuple

from ..utils.logging import logger

DEFAULT_MASTER_PORT = 29500  # torch.distributed's conventional port


def fetch_hostfile(path: str) -> Dict[str, int]:
    """Parse the reference hostfile format: ``hostname slots=N`` per line
    (reference launcher/runner.py:213)."""
    hosts: Dict[str, int] = {}
    if not os.path.isfile(path):
        raise FileNotFoundError(f"hostfile {path} not found")
    with open(path) as fh:
        for line in fh:
            line = line.split("#")[0].strip()
            if not line:
                continue
            parts = line.split()
            name = parts[0]
            slots = 1
            for p in parts[1:]:
                if p.startswith("slots="):
                    slots = int(p.split("=")[1])
            if name in hosts:
                raise ValueError(f"duplicate host {name} in hostfile")
            hosts[name] = slots
    if not hosts:
        raise ValueError(f"hostfile {path} is empty")
    return hosts


def filter_hosts(hosts: Dict[str, int], include: str = "", exclude: str = "") -> Dict[str, int]:
    """``--include/--exclude`` host filters (reference launcher/runner.py:293;
    hosts only, as in JAX: the @-slot syntax picks GPUs of a host, and a
    host runs one process)."""
    sel = dict(hosts)
    if include:
        names = [h.strip() for h in include.split(",") if h.strip()]
        unknown = [n for n in names if n not in hosts]
        if unknown:
            raise ValueError(f"--include hosts not in hostfile: {unknown}")
        sel = {n: hosts[n] for n in names}
    if exclude:
        for n in exclude.split(","):
            n = n.strip()
            if n and n in sel:
                del sel[n]
    if not sel:
        raise ValueError("host filters removed every host")
    return sel


def rendezvous_env(coordinator: str, port: int, world: int) -> Dict[str, str]:
    """torch.distributed's env for every process of a ``world``-process job
    (each adds its ``RANK`` and ``LOCAL_RANK``)."""
    return {"MASTER_ADDR": coordinator, "MASTER_PORT": str(port), "WORLD_SIZE": str(world)}


def build_host_commands(hosts: Dict[str, int], cmd: List[str],
                        coordinator: Optional[str] = None, port: int = DEFAULT_MASTER_PORT,
                        env_passthrough: Optional[List[str]] = None
                        ) -> List[Tuple[str, List[str]]]:
    """One (host, remote_command) per host, with the rendezvous env set."""
    host_list = list(hosts)
    coordinator = coordinator or host_list[0]
    out = []
    for i, h in enumerate(host_list):
        env = {**rendezvous_env(coordinator, port, len(host_list)), "RANK": str(i),
               "LOCAL_RANK": "0"}
        for k in env_passthrough or []:
            if k in os.environ:
                env[k] = os.environ[k]
        envstr = " ".join(f"{k}={shlex.quote(v)}" for k, v in env.items())
        remote = ["ssh", "-o", "StrictHostKeyChecking=no", h,
                  f"cd {shlex.quote(os.getcwd())} && {envstr} "
                  f"{' '.join(shlex.quote(c) for c in cmd)}"]
        out.append((h, remote))
    return out


def parse_args(argv=None):
    p = argparse.ArgumentParser(prog="dstpu_torch",
                                description="deepspeed_tpu_torch multi-host launcher")
    p.add_argument("--hostfile", default=None, help="hostfile (hostname slots=N lines)")
    p.add_argument("--include", default="", help="comma-separated hosts to include")
    p.add_argument("--exclude", default="", help="comma-separated hosts to exclude")
    p.add_argument("--coordinator", default=None,
                   help="MASTER_ADDR: the rank-0 host (default: the first)")
    p.add_argument("--coordinator-port", type=int, default=DEFAULT_MASTER_PORT,
                   help="MASTER_PORT")
    p.add_argument("--env", action="append", default=[], help="env var names to forward")
    p.add_argument("--launcher", default="ssh",
                   choices=("ssh", "pdsh", "openmpi", "mpich", "impi", "slurm", "mvapich"),
                   help="multinode backend (reference launcher/multinode_runner.py)")
    p.add_argument("script", help="training script")
    p.add_argument("script_args", nargs=argparse.REMAINDER)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    cmd = [sys.executable, args.script] + list(args.script_args)
    if args.hostfile is None:
        logger.info("no hostfile: launching single-process locally")
        return subprocess.call(cmd)
    hosts = filter_hosts(fetch_hostfile(args.hostfile), args.include, args.exclude)
    if args.launcher != "ssh":
        # scheduler-native backends synthesize ONE local launch command
        from .multinode_runner import get_runner

        env = {k: os.environ[k] for k in args.env if k in os.environ}
        runner = get_runner(args.launcher, hosts, coordinator=args.coordinator,
                            port=args.coordinator_port, env=env)
        if not runner.backend_exists():
            logger.error(f"launcher backend '{args.launcher}' not found on PATH")
            return 1
        full = runner.get_cmd(cmd)
        logger.info(f"launching via {args.launcher}: {' '.join(full)}")
        return subprocess.call(full)
    launches = build_host_commands(hosts, cmd, args.coordinator, args.coordinator_port,
                                   args.env)
    procs = []
    for host, remote in launches:
        logger.info(f"launching on {host}: {' '.join(remote[-1:])}")
        procs.append(subprocess.Popen(remote))

    def _kill(signum, frame):
        for p in procs:
            p.terminate()

    signal.signal(signal.SIGINT, _kill)
    signal.signal(signal.SIGTERM, _kill)
    rc = 0
    for p in procs:
        rc = p.wait() or rc
    return rc


if __name__ == "__main__":
    sys.exit(main())

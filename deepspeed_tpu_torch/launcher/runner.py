"""`dstpu_torch` launcher CLI — multi-host job launch, counterpart of
``deepspeed_tpu/launcher/runner.py`` (the reference's ``deepspeed`` runner,
``launcher/runner.py:419 main``).

The hostfile format, the host filters and the ssh wrapping are JAX's.
The rendezvous env is torch.distributed's, which ``init_process_group(
init_method="env://")`` reads (``comm.init_distributed``): ``MASTER_ADDR``
/ ``MASTER_PORT`` (the coordinator, default the first host, port 29500),
``WORLD_SIZE``, ``RANK`` and ``LOCAL_RANK``, where JAX sets
``DSTPU_COORDINATOR`` / ``DSTPU_NUM_PROCESSES`` / ``DSTPU_PROCESS_ID`` for
``jax.distributed.initialize``.

The process model is torch's: one process per local device.  On this host
``--num_gpus N`` (or ``--include localhost:0,2``, the reference's slot
syntax) starts one process per device, each with its own ``LOCAL_RANK``
and ``RANK`` (the device index ``initialize`` binds, ``cuda:LOCAL_RANK``),
all in one world of the devices listed; JAX runs one process a host that
drives every local device.  A hostfile's hosts take one process each, as
in JAX (``WORLD_SIZE`` the hosts, ``LOCAL_RANK`` 0).  With neither, the
script runs alone.
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
    p.add_argument("--num_gpus", "--num_procs", type=int, default=None,
                   help="processes on this host, one a device (ranks 0..N-1)")
    p.add_argument("--launcher", default="ssh",
                   choices=("ssh", "pdsh", "openmpi", "mpich", "impi", "slurm", "mvapich"),
                   help="multinode backend (reference launcher/multinode_runner.py)")
    p.add_argument("script", help="training script")
    p.add_argument("script_args", nargs=argparse.REMAINDER)
    return p.parse_args(argv)


def local_devices(num_gpus: Optional[int], include: str = "") -> Optional[List[int]]:
    """The local device indices to start a process on: ``0..num_gpus-1``,
    or the slots of ``localhost:0,2`` in ``--include`` (the reference's
    ``host:slots`` syntax for this host); None when neither asks."""
    if include and ":" in include:
        host, _, slots = include.partition(":")
        if host not in ("localhost", "127.0.0.1") or "@" in include:
            raise ValueError(f"--include {include!r}: slots are taken on this host only "
                             "(localhost:0,1)")
        return [int(s) for s in slots.split(",") if s.strip()]
    if num_gpus is not None:
        if num_gpus < 1:
            raise ValueError(f"--num_gpus {num_gpus} < 1")
        return list(range(num_gpus))
    return None


def launch_local(cmd: List[str], devices: List[int], port: Optional[int] = None) -> int:
    """One process per local device in one world: ``RANK`` its position in
    ``devices``, ``LOCAL_RANK`` the device index; the first failure stops
    the others.  Returns the first non-zero exit code, or 0."""
    import socket
    import time

    if port is None:
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
    procs = []
    for rank, dev in enumerate(devices):
        env = dict(os.environ, **rendezvous_env("127.0.0.1", port, len(devices)),
                   RANK=str(rank), LOCAL_RANK=str(dev))
        procs.append(subprocess.Popen(cmd, env=env))
    logger.info(f"launched {len(procs)} local processes on devices {devices}")

    def _kill(signum=None, frame=None):
        for p in procs:
            if p.poll() is None:
                p.terminate()

    signal.signal(signal.SIGINT, _kill)
    signal.signal(signal.SIGTERM, _kill)
    rc = 0
    while any(p.poll() is None for p in procs):
        bad = [p.returncode for p in procs if p.returncode not in (None, 0)]
        if bad:
            rc = bad[0]
            _kill()
        time.sleep(0.05)
    for p in procs:
        p.wait()
        rc = rc or p.returncode
    return rc


def main(argv=None) -> int:
    args = parse_args(argv)
    cmd = [sys.executable, args.script] + list(args.script_args)
    devices = local_devices(args.num_gpus, args.include if args.hostfile is None else "")
    if args.hostfile is None:
        if devices is not None:
            return launch_local(cmd, devices, None if args.coordinator_port ==
                                DEFAULT_MASTER_PORT else args.coordinator_port)
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

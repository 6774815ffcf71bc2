"""Elastic agent: worker supervision, world re-formation, relaunch —
counterpart of ``deepspeed_tpu/elasticity/elastic_agent.py``.

Reference: ``elasticity/elastic_agent.py:32 DSElasticAgent`` (a
torchelastic ``LocalElasticAgent`` subclass) — watches worker processes,
and on failure re-runs the rendezvous and restarts the set with refreshed
RANK/WORLD_SIZE env.  ``bin/ds_elastic`` is the companion CLI that prints
``compute_elastic_config`` results for a config (``main``, installed as
``ds_elastic_torch``).

A small supervisor loop over worker subprocesses, as in JAX.  On a worker
death (preemption), the agent

1. kills the remaining workers of the attempt,
2. recomputes the world from the elastic config: the largest entry of
   ``valid_gpus`` that fits the surviving capacity — the same
   highly-composite-number math ``initialize()`` applies, so the relaunched
   workers derive identical batch settings from the config alone,
3. relaunches with refreshed torch.distributed env (``RANK`` /
   ``LOCAL_RANK`` / ``WORLD_SIZE`` / ``MASTER_ADDR`` / ``MASTER_PORT``, a
   fresh port each attempt) and ``DS_ELASTIC_*`` — locally via
   subprocess, or rendered through a ``launcher.multinode_runner`` for
   remote hosts (one process per host, as the runners launch),
4. workers resume from the port's latest checkpoint
   (``engine.load_checkpoint``, ``checkpoint/``), whose state does not
   depend on the world size.

The training script needs no agent-specific code beyond regular
checkpointing: ``initialize()`` reads the elastic config.  It refuses a
world of more than one process (``WORLD_SIZE`` > 1: ``NotImplementedError``,
ROADMAP queue 1 item 7), since the port trains on one device and every
worker would train the whole batch alone; until then a worker of the port
trains in a world of one.
"""
from __future__ import annotations

import os
import socket
import subprocess
import sys
import time
from typing import Dict, List, Optional, Sequence

from ..utils.logging import log_dist
from .elasticity import (
    ElasticityError,
    ElasticityIncompatibleWorldSize,
    compute_elastic_config,
)


class ElasticAgent:
    """Supervise an elastic worker set for one training job.

    ``ds_config``: the DeepSpeed-style config dict (must contain an enabled
    ``elasticity`` section).  ``cmd``: the worker argv; each worker receives
    torch.distributed's ``RANK`` / ``LOCAL_RANK`` / ``WORLD_SIZE`` /
    ``MASTER_ADDR`` / ``MASTER_PORT`` and ``DS_ELASTIC_RESTART_COUNT`` (and
    ``DS_ELASTIC_BATCH`` / ``DS_ELASTIC_MICRO_BATCH`` for observability) in
    its environment.  ``hosts`` (optional {hostname: slots}) renders the
    launch through a multinode runner instead of local subprocesses.
    """

    def __init__(
        self,
        ds_config: Dict,
        cmd: Sequence[str],
        hosts: Optional[Dict[str, int]] = None,
        runner: str = "pdsh",
        max_restarts: int = 10,
        heartbeat_interval: float = 0.2,
        env: Optional[Dict[str, str]] = None,
    ):
        if not (ds_config.get("elasticity") or {}).get("enabled"):
            raise ElasticityError("ElasticAgent needs config['elasticity'].enabled")
        self.ds_config = ds_config
        self.cmd = list(cmd)
        self.hosts = hosts
        self.runner = runner
        self.max_restarts = max_restarts
        self.heartbeat_interval = heartbeat_interval
        self.env = dict(env or {})
        self.restart_count = 0
        # observability for tests/callers
        self.history: List[Dict] = []

    # -- world formation ----------------------------------------------------
    def compute_world(self, capacity: int) -> int:
        """Largest valid world size that fits ``capacity`` workers."""
        version = float(self.ds_config["elasticity"].get("version", 0.1))
        if version >= 0.2:
            # v0.2 reasons about the current world; give it the capacity
            # (never the ambient WORLD_SIZE env, which is the PREVIOUS world)
            _, valid_gpus = compute_elastic_config(
                self.ds_config, world_size=capacity
            )
        else:
            # v0.1: the valid set is world-independent
            _, valid_gpus = compute_elastic_config(self.ds_config)
        fits = [w for w in valid_gpus if w <= capacity]
        if not fits:
            raise ElasticityIncompatibleWorldSize(
                f"no valid world size fits capacity {capacity} "
                f"(valid: {valid_gpus})"
            )
        return max(fits)

    def _attempt_env(self, world: int) -> Dict[str, str]:
        final_batch, valid_gpus, micro = compute_elastic_config(
            self.ds_config, world_size=world, return_microbatch=True
        )
        return {
            "WORLD_SIZE": str(world),
            "DS_ELASTIC_RESTART_COUNT": str(self.restart_count),
            "DS_ELASTIC_MAX_RESTARTS": str(self.max_restarts),
            "DS_ELASTIC_BATCH": str(final_batch),
            "DS_ELASTIC_MICRO_BATCH": str(micro),
        }

    # -- process management -------------------------------------------------
    def _start_local(self, world: int) -> List[subprocess.Popen]:
        base = self._attempt_env(world)
        base.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(_free_port()))
        procs = []
        for rank in range(world):
            env = dict(os.environ)
            env.update(self.env)
            env.update(base)
            env["RANK"] = str(rank)
            env["LOCAL_RANK"] = str(rank)
            procs.append(subprocess.Popen(self.cmd, env=env))
        log_dist(
            f"elastic agent: attempt {self.restart_count} started "
            f"world={world} pids={[p.pid for p in procs]}"
        )
        return procs

    def render_remote_commands(self, world: int) -> List[str]:
        """Multi-host form: the launch command via the configured multinode
        runner (returned, not executed — remote execution is the deployment
        environment's concern).  A runner starts one process per host, so
        the ``world`` workers take the first ``world`` hosts; the runner
        sets ``WORLD_SIZE`` and the ranks."""
        from ..launcher.multinode_runner import get_runner

        if self.hosts is None:
            raise ValueError("render_remote_commands needs hosts={hostname: slots}")
        if world > len(self.hosts):
            raise ValueError(f"world {world} needs {world} hosts (one process each); "
                             f"have {len(self.hosts)}")
        base = self._attempt_env(world)
        del base["WORLD_SIZE"]  # the runner's, over the hosts it launches
        hosts = dict(list(self.hosts.items())[:world])
        runner = get_runner(self.runner, hosts, env={**self.env, **base})
        return runner.get_cmd(self.cmd)

    def _kill_all(self, procs: List[subprocess.Popen]) -> None:
        for p in procs:
            if p.poll() is None:
                p.terminate()
        deadline = time.time() + 5
        for p in procs:
            try:
                p.wait(timeout=max(0.1, deadline - time.time()))
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()

    # -- the supervision loop ----------------------------------------------
    def run(self, capacity: int) -> int:
        """Supervise until the job completes (all workers exit 0), capacity
        is exhausted, or max_restarts is hit.  ``capacity`` = currently
        available worker slots; each failure is treated as lost capacity
        (the preemption model), so the next attempt forms the largest valid
        world that still fits."""
        if self.hosts is not None:
            raise NotImplementedError(
                "run() drives local workers; for multi-host use "
                "render_remote_commands() with your scheduler"
            )
        while True:
            world = self.compute_world(capacity)
            procs = self._start_local(world)
            self.history.append(
                {"attempt": self.restart_count, "world": world}
            )
            while True:
                time.sleep(self.heartbeat_interval)
                states = [p.poll() for p in procs]
                if all(rc == 0 for rc in states):
                    log_dist("elastic agent: job complete")
                    return 0
                n_failed = sum(1 for rc in states if rc is not None and rc != 0)
                if n_failed:
                    log_dist(
                        f"elastic agent: {n_failed} worker(s) died; "
                        "re-forming the world"
                    )
                    self._kill_all(procs)
                    # failures reduce CAPACITY, not the formed world: slack
                    # between capacity and world survives for the relaunch
                    capacity -= n_failed
                    break
            self.restart_count += 1
            if self.restart_count > self.max_restarts:
                raise ElasticityError(
                    f"max_restarts ({self.max_restarts}) exhausted"
                )


def _free_port() -> int:
    """A TCP port free on this host now (the attempt's ``MASTER_PORT``)."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def main(argv=None) -> int:
    """``ds_elastic`` CLI (reference bin/ds_elastic): print the elastic
    schedule for a config, optionally for a specific world size."""
    import argparse
    import json

    parser = argparse.ArgumentParser(prog="ds_elastic_torch")
    parser.add_argument("-c", "--config", required=True,
                        help="DeepSpeed config json")
    parser.add_argument("-w", "--world-size", type=int, default=0)
    args = parser.parse_args(argv)
    with open(args.config) as fh:
        ds_config = json.load(fh)
    print(json.dumps(ds_config.get("elasticity", {}), indent=2, sort_keys=True))
    if args.world_size > 0:
        final_batch, valid_gpus, micro = compute_elastic_config(
            ds_config, world_size=args.world_size, return_microbatch=True
        )
        print(f"final_batch_size .... {final_batch}")
        print(f"valid_gpus .......... {valid_gpus}")
        print(f"micro_batch_size .... {micro}")
    else:
        final_batch, valid_gpus = compute_elastic_config(ds_config)
        print(f"final_batch_size .... {final_batch}")
        print(f"valid_gpus .......... {valid_gpus}")
    return 0


if __name__ == "__main__":  # pragma: no cover
    sys.exit(main())

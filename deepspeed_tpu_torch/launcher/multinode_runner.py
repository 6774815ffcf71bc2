"""Multinode runner backends: pdsh / OpenMPI / MPICH / Intel MPI / Slurm /
MVAPICH — counterpart of ``deepspeed_tpu/launcher/multinode_runner.py``
(reference ``launcher/multinode_runner.py``: ``PDSHRunner:51``,
``OpenMPIRunner:120``, ``MPICHRunner:200``, ``IMPIRunner:272``,
``SlurmRunner:357``, ``MVAPICHRunner:405``).

Each synthesizes the scheduler-native launch command, with JAX's arguments
(one process per host), and hands every process torch.distributed's env in
place of JAX's ``DSTPU_*``: ``MASTER_ADDR`` / ``MASTER_PORT`` /
``WORLD_SIZE`` for all, ``RANK`` and ``LOCAL_RANK`` where the runner pins
ranks itself (pdsh, Intel MPI); under OpenMPI, MPICH and Slurm a process
reads its rank from the scheduler's own variables
(``scheduler_rank_env``, the reference's ``mpi_discovery``).
"""
from __future__ import annotations

import os
import shlex
import shutil
from typing import Dict, List, Optional

from .runner import DEFAULT_MASTER_PORT, rendezvous_env


class MultiNodeRunner:
    """Base runner (reference multinode_runner.py:23): synthesize the launch
    command for a user script across a host set."""

    name = "base"

    def __init__(
        self,
        hosts: Dict[str, int],
        coordinator: Optional[str] = None,
        port: int = DEFAULT_MASTER_PORT,
        env: Optional[Dict[str, str]] = None,
    ):
        if not hosts:
            raise ValueError("empty host set")
        self.hosts = dict(hosts)
        self.coordinator = coordinator or next(iter(hosts))
        self.port = port
        self.env = dict(env or {})

    def backend_exists(self) -> bool:
        raise NotImplementedError

    def get_cmd(self, user_cmd: List[str]) -> List[str]:
        raise NotImplementedError

    @property
    def num_hosts(self) -> int:
        return len(self.hosts)

    def _rendezvous_env(self) -> Dict[str, str]:
        return {**rendezvous_env(self.coordinator, self.port, self.num_hosts), **self.env}


class PDSHRunner(MultiNodeRunner):
    """pdsh fan-out (reference :51): one process per host; pdsh expands no
    rank, so a small bootstrap finds the host's index in the host list and
    sets ``RANK`` from it."""

    name = "pdsh"

    def backend_exists(self) -> bool:
        return shutil.which("pdsh") is not None

    def get_cmd(self, user_cmd: List[str]) -> List[str]:
        env = self._rendezvous_env()
        hostlist = ",".join(self.hosts)
        # rank = index of this node in the host list, matched against both
        # the short and the fully-qualified hostname (hostfiles may carry
        # FQDNs/IPs); a miss is a loud error, not an out-of-range rank
        hosts_spaced = " ".join(self.hosts)
        n = self.num_hosts
        bootstrap = (
            f"i=0; for h in {hosts_spaced}; do "
            "{ [ \"$h\" = \"$(hostname)\" ] || [ \"$h\" = \"$(hostname -f)\" ]; } "
            "&& break; i=$((i+1)); done; "
            f"[ $i -lt {n} ] || {{ echo \"dstpu: $(hostname) not in host list\" >&2; exit 1; }}; "
            + " ".join(f"{k}={shlex.quote(v)}" for k, v in env.items())
            + " RANK=$i LOCAL_RANK=0 "
            + " ".join(shlex.quote(c) for c in user_cmd)
        )
        return ["pdsh", "-S", "-f", "1024", "-w", hostlist, bootstrap]


class OpenMPIRunner(MultiNodeRunner):
    """mpirun (reference :120): ranks come from OMPI_COMM_WORLD_RANK."""

    name = "openmpi"

    def backend_exists(self) -> bool:
        return shutil.which("ompi_info") is not None or shutil.which("mpirun") is not None

    def get_cmd(self, user_cmd: List[str]) -> List[str]:
        cmd = [
            "mpirun", "-n", str(self.num_hosts), "--map-by", "ppr:1:node",
            "--host", ",".join(f"{h}:1" for h in self.hosts),
        ]
        for k, v in self._rendezvous_env().items():
            cmd += ["-x", f"{k}={v}"]
        return cmd + list(user_cmd)


class MPICHRunner(MultiNodeRunner):
    """mpiexec/hydra (reference :200): ranks from PMI_RANK."""

    name = "mpich"

    def backend_exists(self) -> bool:
        return shutil.which("mpiexec.hydra") is not None or shutil.which("mpiexec") is not None

    def get_cmd(self, user_cmd: List[str]) -> List[str]:
        cmd = ["mpiexec", "-n", str(self.num_hosts), "-ppn", "1",
               "-hosts", ",".join(self.hosts)]
        for k, v in self._rendezvous_env().items():
            cmd += ["-genv", k, str(v)]
        return cmd + list(user_cmd)


class IMPIRunner(MultiNodeRunner):
    """Intel MPI (reference :272 IMPIRunner): hydra ``mpirun`` with per-rank
    ``-env`` blocks joined by ``:``.  One process per host, as in JAX,
    ranks pinned explicitly rather than read from PMI so the command is
    scheduler-independent; ``I_MPI_PIN=0`` mirrors the reference's choice
    to keep MPI away from core binding."""

    name = "impi"

    def backend_exists(self) -> bool:
        return shutil.which("mpirun") is not None

    def get_cmd(self, user_cmd: List[str]) -> List[str]:
        cmd = ["mpirun", "-ppn", "1"]
        for k, v in self._rendezvous_env().items():
            cmd += ["-genv", k, str(v)]
        cmd += ["-genv", "I_MPI_PIN", "0"]
        cmd += ["-hosts", ",".join(self.hosts)]
        for i in range(self.num_hosts):
            if i > 0:
                cmd.append(":")
            cmd += ["-n", "1", "-env", "RANK", str(i), "-env", "LOCAL_RANK", "0"] + list(user_cmd)
        return cmd


class SlurmRunner(MultiNodeRunner):
    """srun (reference :357): ranks from SLURM_PROCID; the host set comes
    from the allocation, so --nodelist is advisory."""

    name = "slurm"

    def backend_exists(self) -> bool:
        return shutil.which("srun") is not None

    def get_cmd(self, user_cmd: List[str]) -> List[str]:
        cmd = [
            "srun", "--ntasks", str(self.num_hosts), "--ntasks-per-node", "1",
            "--nodelist", ",".join(self.hosts),
        ]
        exports = [f"{k}={v}" for k, v in self._rendezvous_env().items()]
        if exports:
            cmd += ["--export", "ALL," + ",".join(exports)]
        return cmd + list(user_cmd)


class MVAPICHRunner(MultiNodeRunner):
    """mpirun_rsh (reference :405; it requires an on-disk hostfile, which
    the reference likewise materializes before launching)."""

    name = "mvapich"

    def backend_exists(self) -> bool:
        return shutil.which("mpirun_rsh") is not None

    def get_cmd(self, user_cmd: List[str]) -> List[str]:
        import atexit
        import tempfile

        fh = tempfile.NamedTemporaryFile(
            "w", prefix="dstpu_torch_hostfile_", suffix=".txt", delete=False
        )
        for h in self.hosts:
            fh.write(f"{h}\n")
        fh.close()
        atexit.register(lambda p=fh.name: os.path.exists(p) and os.unlink(p))
        cmd = ["mpirun_rsh", "-np", str(self.num_hosts), "-hostfile", fh.name]
        for k, v in self._rendezvous_env().items():
            cmd.append(f"{k}={v}")
        return cmd + list(user_cmd)


RUNNERS = {
    r.name: r
    for r in (
        PDSHRunner, OpenMPIRunner, MPICHRunner, IMPIRunner, SlurmRunner,
        MVAPICHRunner,
    )
}


def get_runner(name: str, hosts: Dict[str, int], **kw) -> MultiNodeRunner:
    if name not in RUNNERS:
        raise ValueError(f"unknown launcher '{name}' (have {sorted(RUNNERS)})")
    return RUNNERS[name](hosts, **kw)


def scheduler_rank_env() -> Optional[Dict[str, str]]:
    """torch.distributed's ``RANK`` / ``WORLD_SIZE`` / ``LOCAL_RANK`` from a
    scheduler's own variables — the reference's ``mpi_discovery``
    (comm/comm.py:694); JAX derives its ``DSTPU_*`` pair from the same
    variables."""
    for rank_var, size_var, local_var in (
        ("OMPI_COMM_WORLD_RANK", "OMPI_COMM_WORLD_SIZE", "OMPI_COMM_WORLD_LOCAL_RANK"),
        ("PMI_RANK", "PMI_SIZE", "MPI_LOCALRANKID"),
        ("SLURM_PROCID", "SLURM_NTASKS", "SLURM_LOCALID"),
    ):
        if rank_var in os.environ:
            return {
                "RANK": os.environ[rank_var],
                "WORLD_SIZE": os.environ.get(size_var, "1"),
                "LOCAL_RANK": os.environ.get(local_var, "0"),
            }
    return None

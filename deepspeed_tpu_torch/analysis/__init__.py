"""Static analysis over the port (``deepspeed_tpu_torch``) — counterpart of
``deepspeed_tpu/analysis``' source-level halves.

- :mod:`astlint`: AST passes forbidding host syncs (torch's ``.item()``,
  ``.tolist()``, ``.cpu()``, ``.numpy()``, ``synchronize``) in the tick /
  step hot paths, new process-global mutable state, raw
  ``torch.distributed`` collectives outside ``comm/``, and imports of the
  controller or the fleet plane from a tick-path module.
- :mod:`racelint`: the lock-discipline lint (unguarded shared-state writes,
  lock-order cycles, blocking calls under a lock, engine access from a
  non-owner thread) over the host-side serving stack, the prefetcher and
  the controller.
- :mod:`schedviz`: the seeded deterministic-interleaving harness and its
  scenarios, driving the port's scheduler, router, pool, heartbeat
  monitor, online controller and telemetry on the CPU.

JAX's compiled-program auditor (``hlo.py``, ``checks.py``, ``audit.py``)
reads XLA's HLO and waits for its re-expression over profiler and NCCL
records (ROADMAP queue 1, item 9's last entry).
"""
from .astlint import LintViolation, lint_package, lint_source  # noqa: F401
from .racelint import (  # noqa: F401
    RaceViolation,
    lint_race_package,
    lint_race_source,
    stale_race_baseline,
    unbaselined,
)
from .schedviz import Schedule, checkpoint, explore, run_scenarios  # noqa: F401

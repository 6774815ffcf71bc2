"""Monitoring fan-out: TensorBoard / CSV / WandB / Comet writers —
counterpart of ``deepspeed_tpu/monitor/monitor.py`` (the reference's
``deepspeed/monitor/monitor.py:30 MonitorMaster`` and its per-backend
writers).

Events are ``(label, value, step)`` triples, written on rank 0 only (the
``torch.distributed`` rank once a group is up, else 0; JAX's
``jax.process_index()``).  The optional writers (TensorBoard, WandB, Comet)
warn and disable themselves when their package is missing, as in JAX; the
CSV writer needs nothing and writes the same bytes as JAX's.
"""
from __future__ import annotations

import csv
import os
from typing import List, Tuple

from ..utils.logging import _process_index, logger

Event = Tuple[str, float, int]


class Monitor:
    def __init__(self, config):
        self.enabled = bool(getattr(config, "enabled", False))

    def write_events(self, events: List[Event]):
        raise NotImplementedError


class TensorBoardMonitor(Monitor):
    def __init__(self, config):
        super().__init__(config)
        self.summary_writer = None
        if self.enabled:
            try:
                from torch.utils.tensorboard import SummaryWriter

                path = os.path.join(config.output_path or "./runs", config.job_name)
                self.summary_writer = SummaryWriter(log_dir=path)
            except Exception as e:  # noqa: BLE001 — tensorboard is optional
                logger.warning(f"tensorboard unavailable ({e}); disabling")
                self.enabled = False

    def write_events(self, events: List[Event]):
        if self.summary_writer is None:
            return
        for label, value, step in events:
            self.summary_writer.add_scalar(label, value, step)
        self.summary_writer.flush()


class CsvMonitor(Monitor):
    """One ``<label with / as _>.csv`` a label under ``output_path/job_name``,
    a ``step,<label>`` header, then a row an event."""

    def __init__(self, config):
        super().__init__(config)
        self.path = None
        if self.enabled:
            self.path = os.path.join(config.output_path or ".", config.job_name)
            os.makedirs(self.path, exist_ok=True)

    def write_events(self, events: List[Event]):
        # one open a label a flush: the engine's deferred metrics deliver a
        # whole steps_per_print window at once
        by_label: dict = {}
        for label, value, step in events:
            by_label.setdefault(label, []).append((step, value))
        for label, rows in by_label.items():
            fname = os.path.join(self.path, label.replace("/", "_") + ".csv")
            new = not os.path.exists(fname)
            with open(fname, "a", newline="") as fh:
                w = csv.writer(fh)
                if new:
                    w.writerow(["step", label])
                w.writerows(rows)


class WandbMonitor(Monitor):
    def __init__(self, config):
        super().__init__(config)
        self._wandb = None
        if self.enabled:
            try:
                import wandb

                wandb.init(project=config.project, group=config.group, entity=config.team)
                self._wandb = wandb
            except Exception as e:  # noqa: BLE001 — wandb is optional
                logger.warning(f"wandb unavailable ({e}); disabling")
                self.enabled = False

    def write_events(self, events: List[Event]):
        if self._wandb is None:
            return
        # one wandb.log a step, with all of that step's labels
        by_step: dict = {}
        for label, value, step in events:
            by_step.setdefault(step, {})[label] = value
        for step, row in by_step.items():
            self._wandb.log(row, step=step)


class CometMonitor(Monitor):
    """Comet experiment writer (reference ``monitor/comet.py``): starts an
    experiment and logs each event whose step is a multiple of
    ``samples_log_interval``."""

    def __init__(self, config):
        super().__init__(config)
        self._experiment = None
        self._interval = max(1, int(getattr(config, "samples_log_interval", 1) or 1))
        if self.enabled:
            try:
                import comet_ml

                kw = {}
                for attr, key in (("api_key", "api_key"), ("project", "project_name"),
                                  ("workspace", "workspace"),
                                  ("experiment_key", "experiment_key"),
                                  ("online", "online"), ("mode", "mode")):
                    v = getattr(config, attr, None)
                    if v is not None:
                        kw[key] = v
                self._experiment = comet_ml.start(**kw)
                name = getattr(config, "experiment_name", None)
                if name:
                    self._experiment.set_name(name)
            except Exception as e:  # noqa: BLE001 — comet_ml is optional
                logger.warning(f"comet unavailable ({e}); disabling")
                self.enabled = False

    @property
    def experiment(self):
        return self._experiment

    def write_events(self, events: List[Event]):
        if self._experiment is None:
            return
        for label, value, step in events:
            if step % self._interval == 0:
                self._experiment.log_metric(label, value, step=step)


class MonitorMaster(Monitor):
    """Every enabled writer of a ``Config``'s four sections, on rank 0 only
    (reference ``monitor/monitor.py:30``)."""

    def __init__(self, config):
        self.rank0 = _process_index() == 0
        self.writers: List[Monitor] = []
        if self.rank0:
            for w in (TensorBoardMonitor(config.tensorboard), CsvMonitor(config.csv_monitor),
                      WandbMonitor(config.wandb), CometMonitor(config.comet)):
                if w.enabled:
                    self.writers.append(w)
        self.enabled = bool(self.writers)

    def write_events(self, events: List[Event]):
        for w in self.writers:
            w.write_events(events)

"""Rank-aware logging — the port of ``deepspeed_tpu/utils/logging.py``
(``logger`` / ``log_dist``, the reference's ``deepspeed/utils/logging.py``
API): the rank is ``torch.distributed``'s once a process group is up,
else ``DSTPU_PROCESS_INDEX`` (0 for one process).
"""
from __future__ import annotations

import functools
import logging
import os
import sys

LOG_LEVELS = {
    "debug": logging.DEBUG,
    "info": logging.INFO,
    "warning": logging.WARNING,
    "error": logging.ERROR,
    "critical": logging.CRITICAL,
}


@functools.lru_cache(None)
def _create_logger(name: str = "deepspeed_tpu_torch", level=logging.INFO) -> logging.Logger:
    lg = logging.getLogger(name)
    lg.setLevel(os.environ.get("DSTPU_LOG_LEVEL", "").upper() or level)
    lg.propagate = False
    if not lg.handlers:
        handler = logging.StreamHandler(stream=sys.stdout)
        handler.setFormatter(logging.Formatter(
            "[%(asctime)s] [%(levelname)s] [%(name)s] %(message)s",
            datefmt="%Y-%m-%d %H:%M:%S"))
        lg.addHandler(handler)
    return lg


logger = _create_logger()


def _process_index() -> int:
    try:
        import torch.distributed as dist

        if dist.is_available() and dist.is_initialized():
            return dist.get_rank()
    except Exception:  # noqa: BLE001 — a logging call never raises
        pass
    return int(os.environ.get("DSTPU_PROCESS_INDEX", 0))


def log_dist(message: str, ranks=None, level=logging.INFO) -> None:
    """Log ``message`` only on the given process ranks (default: rank 0
    only); ``ranks=[-1]`` logs on every process."""
    ranks = ranks if ranks is not None else [0]
    my_rank = _process_index()
    if -1 in ranks or my_rank in ranks:
        logger.log(level, f"[Rank {my_rank}] {message}")


def warning_once(message: str) -> None:
    cache = getattr(warning_once, "_cache", None)
    if cache is None:
        cache = warning_once._cache = set()
    if message not in cache:
        cache.add(message)
        logger.warning(message)

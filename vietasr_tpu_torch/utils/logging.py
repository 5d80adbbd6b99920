"""Process-aware logging (counterpart of vietasr_tpu/utils/logging.py): one
package logger, its console on rank 0 only, per-rank log files ("%r" in
the file name becomes the rank) and LogMode.ONCE deduplication. The rank
is the torch.distributed rank when a process group is initialized, else
the RANK environment variable (0 when unset)."""

from __future__ import annotations

import enum
import logging
import os
import sys
from typing import Optional, Set

import torch.distributed as dist


class LogMode(enum.IntEnum):
    EACH = 0
    ONCE = 1


class _OnceFilter(logging.Filter):
    def __init__(self):
        super().__init__()
        self._seen: Set[str] = set()

    def filter(self, record: logging.LogRecord) -> bool:
        if getattr(record, "mode", LogMode.EACH) == LogMode.ONCE:
            key = f"{record.pathname}:{record.lineno}:{record.getMessage()}"
            if key in self._seen:
                return False
            self._seen.add(key)
        return True


_LOGGER: Optional[logging.Logger] = None


def _process_index() -> int:
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return int(os.environ.get("RANK", 0))


def get_logger(name: str = "vietasr", *, log_file: Optional[str] = None,
               level: int = logging.INFO) -> logging.Logger:
    """The package logger, made on the first call (`name` and `level`
    count only then): a stderr handler on rank 0. Each `log_file` given
    adds a file handler."""
    global _LOGGER
    if _LOGGER is None:
        logger = logging.getLogger(name)
        logger.setLevel(level)
        logger.addFilter(_OnceFilter())
        if _process_index() == 0:
            h = logging.StreamHandler(sys.stderr)
            h.setFormatter(logging.Formatter(
                "[%(asctime)s %(levelname)s %(name)s] %(message)s",
                datefmt="%H:%M:%S"))
            logger.addHandler(h)
        logger.propagate = False
        _LOGGER = logger
    if log_file is not None:
        path = log_file.replace("%r", str(_process_index()))
        fh = logging.FileHandler(path)
        fh.setFormatter(logging.Formatter(
            "[%(asctime)s %(levelname)s] %(message)s"))
        _LOGGER.addHandler(fh)
    return _LOGGER


def log_once(logger: logging.Logger, msg: str, *args,
             level: int = logging.INFO):
    """Log `msg` the first time this call site logs it."""
    logger.log(level, msg, *args, extra={"mode": LogMode.ONCE},
               stacklevel=2)

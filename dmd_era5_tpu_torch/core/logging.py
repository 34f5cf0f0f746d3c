"""Structured per-module logging.

The port's copy of ``dmd_era5_tpu/core/logging.py``: named loggers writing
to ``<root>/logs/<file>.log`` with the directory auto-created, handlers
reset on re-setup, and a ``log_and_print`` helper that mirrors messages to
stdout with the process's rank in front when a multi-process
``torch.distributed`` group is up, so its lines are attributable.
"""

from __future__ import annotations

import logging

import torch.distributed as dist

from dmd_era5_tpu_torch.core.paths import logs_dir

_FORMAT = "%(asctime)s - %(name)s - %(levelname)s - %(message)s"


def _process_tag() -> str:
    """``[p<rank>] `` in a multi-process group, else empty."""
    if dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1:
        return f"[p{dist.get_rank()}] "
    return ""


def setup_logger(
    name: str, log_file: str, level: int = logging.INFO
) -> logging.Logger:
    """Create (or reconfigure) a named logger writing to ``logs/<log_file>``."""
    formatter = logging.Formatter(_FORMAT)
    path = logs_dir() / log_file

    logger = logging.getLogger(name)
    logger.setLevel(level)

    # Reset handlers so repeated setup calls do not duplicate output.
    for handler in list(logger.handlers):
        logger.removeHandler(handler)

    file_handler = logging.FileHandler(path)
    file_handler.setFormatter(formatter)
    logger.addHandler(file_handler)
    return logger


def log_and_print(logger: logging.Logger, message: str, level: str = "info") -> None:
    """Log ``message`` at ``level`` and mirror it to stdout."""
    getattr(logger, level.lower())(message)
    print(f"{_process_tag()}{message}")

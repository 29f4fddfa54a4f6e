"""Process logger.  Under torchrun each rank is a process: `print_rank_0`
logs on rank 0 only, `print_per_process` on every rank with its index."""

from __future__ import annotations

import logging
import os
import sys


class GlobalLogger:
    _logger = None

    @classmethod
    def get_logger(cls) -> logging.Logger:
        if cls._logger is None:
            logger = logging.getLogger("magi_tpu_torch")
            logger.setLevel(os.getenv("MAGI_LOG_LEVEL", "INFO").upper())
            if not logger.handlers:
                handler = logging.StreamHandler(sys.stdout)
                handler.setFormatter(
                    logging.Formatter("[%(asctime)s][%(levelname)s][magi_tpu_torch] %(message)s", "%H:%M:%S")
                )
                logger.addHandler(handler)
            logger.propagate = False
            cls._logger = logger
        return cls._logger


magi_logger = GlobalLogger.get_logger()


def _process_index() -> int:
    """This process's rank: the process group's once it is joined, else
    torchrun's RANK (0 without a launcher)."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return int(os.environ.get("RANK", "0"))


def print_per_process(message: str) -> None:
    magi_logger.info(f"[process {_process_index()}] {message}")


def print_rank_0(message) -> None:
    """Log only on rank 0."""
    if _process_index() == 0:
        magi_logger.info(message)

"""Process logger.  The port runs one process on one device, so every
message is process 0's."""

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


def print_rank_0(message) -> None:
    magi_logger.info(message)

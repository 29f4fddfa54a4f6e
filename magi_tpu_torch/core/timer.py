"""Event-path timer: logs the wall-clock time between named events.
`synced_record` first waits for the CUDA device (when there is one), so
the interval covers the device work queued before it."""

from __future__ import annotations

import time
from typing import Optional

import torch

from magi_tpu_torch.core.logger import magi_logger


class EventPathTimer:
    def __init__(self) -> None:
        self.prev_name: Optional[str] = None
        self.prev_time: Optional[float] = None

    def reset(self) -> None:
        self.prev_name = None
        self.prev_time = None

    def record(self, name: str) -> None:
        now = time.perf_counter()
        if self.prev_name is not None:
            magi_logger.info(f"Elapsed {(now - self.prev_time) * 1000:.1f} ms: [{self.prev_name}] -> [{name}]")
        self.prev_name, self.prev_time = name, now

    def synced_record(self, name: str) -> None:
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            torch.cuda.synchronize()
        self.record(name)


_global_timer = EventPathTimer()


def event_path_timer() -> EventPathTimer:
    return _global_timer

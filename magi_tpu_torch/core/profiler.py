"""Device memory reporting (`torch.cuda` peak and in-use bytes) and the
walk's profiler trace.

Env flags:
  MAGI_PROFILE_DIR=/path   write a torch.profiler trace of each walk
"""

from __future__ import annotations

import contextlib
import os
from typing import Iterator

import torch

from magi_tpu_torch.core.logger import magi_logger


@contextlib.contextmanager
def maybe_trace(label: str, device: torch.device) -> Iterator[None]:
    """A `torch.profiler` trace of the block (CPU activity, and CUDA
    activity when `device` is a card) written as a Chrome trace to
    `$MAGI_PROFILE_DIR/<label>/trace.json` when MAGI_PROFILE_DIR is set;
    nothing otherwise."""
    trace_dir = os.environ.get("MAGI_PROFILE_DIR")
    if not trace_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    path = os.path.join(trace_dir, label)
    os.makedirs(path, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    magi_logger.info(f"profiling -> {path}")
    with profile(activities=activities) as prof:
        yield
    out = os.path.join(path, "trace.json")
    prof.export_chrome_trace(out)
    magi_logger.info(f"profiler trace written to {out}")


def log_memory(prefix: str, device: torch.device) -> None:
    if device.type != "cuda":
        return
    gb = 1024**3
    magi_logger.info(
        f"{prefix}: device memory in use {torch.cuda.memory_allocated(device) / gb:.2f} GB, "
        f"peak {torch.cuda.max_memory_allocated(device) / gb:.2f} GB"
    )

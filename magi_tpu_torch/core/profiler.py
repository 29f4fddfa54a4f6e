"""Device memory reporting (`torch.cuda` peak and in-use bytes), the walk's
profiler trace, and the program's spans on the profiler's timeline.

Env flags:
  MAGI_PROFILE_DIR=/path   write a torch.profiler trace of each walk

Spans (`span`) mark each layer boundary of the program: a request's set-up,
each denoise step and each chunk decode, named `magi/<layer>/<part>` and,
after one space, `key=value` attributes separated by spaces (a value holds
no space).  They record whenever a `torch.profiler` records, whoever
started it (`maybe_trace`, a benchmark, an operator's own profiler), on
the timeline that carries the device's kernels; otherwise a span is one
flag check and formats nothing.
"""

from __future__ import annotations

import contextlib
import os
from typing import Iterator

import torch

from magi_tpu_torch.core.logger import magi_logger

NO_SPAN = contextlib.nullcontext()  # what `span` returns while no profiler records


def span_name(name: str, attrs: dict) -> str:
    """`name` followed by its attributes as ` key=value` pairs: booleans as
    0 or 1, tuples and lists joined by commas, whitespace dropped from every
    value, and attributes given as None left out."""
    parts = [name]
    for k, v in attrs.items():
        if v is None:
            continue
        if isinstance(v, (tuple, list)):
            v = ",".join(str(int(x) if isinstance(x, bool) else x) for x in v)
        elif isinstance(v, bool):
            v = int(v)
        parts.append(f"{k}={''.join(str(v).split())}")
    return " ".join(parts)


def span(name: str, **attrs):
    """A `record_function` span named `span_name(name, attrs)` while a
    `torch.profiler` records, else the shared no-op `NO_SPAN`."""
    if not torch.autograd._profiler_enabled():
        return NO_SPAN
    return torch.profiler.record_function(span_name(name, attrs))


@contextlib.contextmanager
def maybe_trace(label: str, device: torch.device) -> Iterator[None]:
    """A `torch.profiler` trace of the block (CPU activity, and CUDA
    activity when `device` is a card) written as a Chrome trace to
    `$MAGI_PROFILE_DIR/<label>/trace.json` when MAGI_PROFILE_DIR is set;
    nothing otherwise.  The kernels of a replayed CUDA graph show one by
    one, each under its own symbol, as eager launches do, and the
    program's `magi/` spans (`span`) beside them."""
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

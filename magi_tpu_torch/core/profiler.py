"""Device memory reporting (`torch.cuda` peak and in-use bytes)."""

from __future__ import annotations

import torch

from magi_tpu_torch.core.logger import magi_logger


def log_memory(prefix: str, device: torch.device) -> None:
    if device.type != "cuda":
        return
    gb = 1024**3
    magi_logger.info(
        f"{prefix}: device memory in use {torch.cuda.memory_allocated(device) / gb:.2f} GB, "
        f"peak {torch.cuda.max_memory_allocated(device) / gb:.2f} GB"
    )

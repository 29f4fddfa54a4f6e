"""Small shared utilities."""

from __future__ import annotations

import os
import random

import numpy as np
import torch


def env_is_true(name: str) -> bool:
    value = os.getenv(name, "0")
    return value.lower() in ("1", "true", "yes", "on")


def round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller asks for
    the CPU.  Raises when CUDA is asked for (or defaulted to) and absent;
    an entry point never carries on quietly on the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the plain "
            "PyTorch path on the CPU"
        )
    return dev


def set_random_seed(seed: int, device=None) -> torch.Generator:
    """Seed python/numpy/torch and return a `torch.Generator` on `device`
    for the run's random draws (initial noise, random weights)."""
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
    gen = torch.Generator(device=resolve_device(device))
    gen.manual_seed(seed)
    return gen

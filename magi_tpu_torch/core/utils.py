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


def tree_leaves(tree: dict, prefix: str = ""):
    """(path "a/b/c", leaf) of every leaf of a nested dict, in order."""
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from tree_leaves(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


def nest(items) -> dict:
    """(path "a/b/c", leaf) pairs (or a {path: leaf} dict) -> the nested
    dict `tree_leaves` walks."""
    out: dict = {}
    for path, v in items.items() if isinstance(items, dict) else items:
        node = out
        keys = path.split("/")
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = v
    return out

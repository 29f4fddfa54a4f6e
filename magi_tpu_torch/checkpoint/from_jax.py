"""Carry parameter trees of the JAX package over to the port.

The port keeps the JAX package's parameter trees (nested dictionaries,
same keys, same shapes and layouts), so a tree of numpy arrays taken from
`magi_tpu` becomes the port's parameters leaf by leaf.  bfloat16 leaves
(numpy's `bfloat16` from ml_dtypes) convert exactly through float32.
Tests use this to run both packages on the same weights.
"""

from __future__ import annotations

import numpy as np
import torch


def _leaf(a, device) -> torch.Tensor:
    arr = np.asarray(a)
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.astype(np.float32)).to(device=device, dtype=torch.bfloat16)
    return torch.from_numpy(np.array(arr)).to(device)


def _tree(tree, device):
    if isinstance(tree, dict):
        return {k: _tree(v, device) for k, v in tree.items()}
    return _leaf(tree, device)


def dit_params_from_jax(tree: dict, device="cpu") -> dict:
    """The JAX package's DiT parameter tree (numpy leaves) as the port's."""
    return _tree(tree, torch.device(device))


def vae_params_from_jax(tree: dict, device="cpu") -> dict:
    """The JAX package's ViT-VAE parameter tree (numpy leaves) as the port's."""
    return _tree(tree, torch.device(device))

"""Carry parameter trees of the JAX package over to the port.

The port keeps the JAX package's parameter trees (nested dictionaries,
same keys, same shapes and layouts), so a tree of numpy arrays taken from
`magi_tpu` becomes the port's parameters leaf by leaf.  bfloat16 leaves
(numpy's `bfloat16` from ml_dtypes) convert exactly through float32;
every other leaf keeps its dtype, so an int8-quantized tree (`weight_q`
int8 [L, in, out], `weight_scale` f32, the bf16 `blocks_edge` side tree),
an int4 tree (`weight_q4` uint8 [L, in/2, out], nibble-packed as
`ops.quant.quantize_int4` packs it) and the int8 KV cache dict ({kv: int8,
scale: f32}) carry over with their shapes and values.  The `weight_q` and
`weight_q4` leaves come over k-major ([L, out, in] and [L, out, in/2] in
memory, seen as the JAX shapes), the layout `ops.quant` makes and the
card's quantized GEMMs require, so a tree carried from JAX runs on the
card.  Tests use this to run both packages on the same weights and
caches.
"""

from __future__ import annotations

import numpy as np
import torch

from magi_tpu_torch.ops.quant import k_major


_K_MAJOR_LEAVES = ("weight_q", "weight_q4")


def _leaf(a, device, quantized_weight: bool = False) -> torch.Tensor:
    arr = np.asarray(a)
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.astype(np.float32)).to(device=device, dtype=torch.bfloat16)
    t = torch.from_numpy(np.array(arr))
    # `.to` keeps the strides of a dense tensor (preserve_format)
    return (k_major(t) if quantized_weight and t.dim() >= 2 else t).to(device)


def _tree(tree, device, key=None):
    if isinstance(tree, dict):
        return {k: _tree(v, device, k) for k, v in tree.items()}
    return _leaf(tree, device, key in _K_MAJOR_LEAVES)


def dit_params_from_jax(tree: dict, device="cpu") -> dict:
    """The JAX package's DiT parameter tree (numpy leaves) as the port's."""
    return _tree(tree, torch.device(device))


def kv_cache_from_jax(cache, device="cpu"):
    """A KV cache of the JAX package (an array, or the int8 dict) as the
    port's."""
    return _tree(cache, torch.device(device))


def vae_params_from_jax(tree: dict, device="cpu") -> dict:
    """The JAX package's ViT-VAE parameter tree (numpy leaves) as the port's."""
    return _tree(tree, torch.device(device))


def t5_params_from_jax(tree: dict, device="cpu") -> dict:
    """The JAX package's T5 encoder parameter tree (numpy leaves) as the port's."""
    return _tree(tree, torch.device(device))

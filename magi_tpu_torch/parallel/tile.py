"""Tile-parallel VAE execution (the port of `magi_tpu.parallel.tile`).

A tiled encode or decode batches its equal tiles through one ViT forward
(`pipeline.video_process`); on a mesh the ranks of one model replica (the
ranks of one dp index: they hold the same request) split that batch, each
runs its tiles through the VAE, and an all-gather puts the batch back
together on every one of them.  MAGI's ViT-VAE tiles only in time, with no
overlap, so no blend pass is needed, and equal tiles make the load even.
`replicate_vae_params` keeps the JAX package's name: every rank builds the
same VAE, so nothing moves.
"""

from __future__ import annotations

from typing import Callable

import torch

from magi_tpu_torch.parallel import comm
from magi_tpu_torch.parallel.mesh import get_mesh, mesh_is_trivial


def replicate_vae_params(params: dict, mesh=None) -> dict:
    """The VAE's parameters on a mesh: every rank builds the same VAE (from
    the seed, or the checkpoint), so they are already replicated and
    nothing moves."""
    return params


def pmap_tile_batch(fn: Callable, batch: torch.Tensor) -> torch.Tensor:
    """`fn` over a tile batch split across the model replica's ranks: the
    batch padded to a multiple of the rank count by repeating its first
    tile, the rank's contiguous share run through `fn`, the results
    gathered in rank order and the padding dropped."""
    mesh = get_mesh()
    if mesh_is_trivial(mesh) or mesh.group("tile").size == 1:
        return fn(batch)
    group = mesh.group("tile")
    n = group.size
    B = batch.shape[0]
    Bp = -(-B // n) * n
    if Bp != B:
        batch = torch.cat([batch, batch[:1].expand((Bp - B,) + tuple(batch.shape[1:]))])
    per = Bp // n
    me = group.ranks.index(mesh.rank)
    out = fn(batch[me * per:(me + 1) * per].contiguous())
    return torch.cat(comm.all_gather(out, group))[:B]

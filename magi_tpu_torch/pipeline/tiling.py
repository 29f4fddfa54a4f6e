"""Generic 3D tiled processing with overlap cross-fade blending (the port
of `magi_tpu.pipeline.tiling`).

MAGI's ViT-VAE disables spatial tiling and uses no temporal overlap, so the
batched equal-tile path of `pipeline.video_process` covers it.  This is the
generic form, for tokenizers that allow spatial tiling: a spatial and
temporal tile grid whose overlaps are blended linearly.  Plain tensor ops,
on one device.
"""

from __future__ import annotations

from typing import Callable, List

import torch


def _tile_starts(size: int, tile: int, overlap: int) -> List[int]:
    """Start offsets covering [0, size) with `overlap` shared samples; the
    last tile is clamped to the end."""
    if size <= tile:
        return [0]
    stride = tile - overlap
    starts = list(range(0, size - tile, stride))
    starts.append(size - tile)
    return starts


def _blend_axis(a: torch.Tensor, b: torch.Tensor, axis: int, overlap: int) -> torch.Tensor:
    """`b` cross-faded onto the tail of `a` over `overlap` samples along
    `axis` (weights (i + 1) / (overlap + 1) for b)."""
    if overlap <= 0:
        return torch.cat([a, b], dim=axis)
    axis = axis % a.dim()
    ov = overlap
    shape = [1] * a.dim()
    shape[axis] = ov
    w = ((torch.arange(ov, dtype=torch.float32, device=a.device) + 1.0) / (ov + 1.0)).reshape(shape).to(a.dtype)
    n = a.shape[axis]
    blended = a.narrow(axis, n - ov, ov) * (1 - w) + b.narrow(axis, 0, ov) * w
    return torch.cat([a.narrow(axis, 0, n - ov), blended, b.narrow(axis, ov, b.shape[axis] - ov)], dim=axis)


def tiled_process_3d(
    fn: Callable[[torch.Tensor], torch.Tensor],
    x: torch.Tensor,  # [N, C, T, H, W]
    tile_t: int,
    tile_h: int,
    tile_w: int,
    scale_t: int,  # output / input size ratio per axis (a downsample factor
    scale_h: int,  # for encode; with invert_scale an upsample factor for
    scale_w: int,  # decode)
    overlap_t: float = 0.0,
    overlap_hw: float = 0.25,
    invert_scale: bool = False,
) -> torch.Tensor:
    """`fn` over an overlapping 3D tile grid, the outputs cross-fade-blended.
    `scale_*` map input tile sizes to output tile sizes."""
    N, C, T, H, W = x.shape

    def out_size(v, s):
        return v * s if invert_scale else v // s

    starts_t = _tile_starts(T, min(tile_t, T), int(tile_t * overlap_t))
    starts_h = _tile_starts(H, min(tile_h, H), int(tile_h * overlap_hw))
    starts_w = _tile_starts(W, min(tile_w, W), int(tile_w * overlap_hw))

    tiles = {}
    for ti, t0 in enumerate(starts_t):
        for hi, h0 in enumerate(starts_h):
            for wi, w0 in enumerate(starts_w):
                tile = x[:, :, t0:t0 + min(tile_t, T), h0:h0 + min(tile_h, H), w0:w0 + min(tile_w, W)]
                tiles[(ti, hi, wi)] = fn(tile)

    # blend pairwise; the tail tile may overlap more than the nominal stride
    # (it is clamped to the array's end), so each pair has its own overlap
    def assemble_axis(get_tile, starts, tile_in, s, axis):
        acc = get_tile(0)
        for i in range(1, len(starts)):
            ov_in = max(0, min(starts[i - 1] + min(tile_in, x.shape[axis]) - starts[i], tile_in))
            acc = _blend_axis(acc, get_tile(i), axis=axis - 5, overlap=out_size(ov_in, s))
        return acc

    def along_w(ti, hi):
        return assemble_axis(lambda wi: tiles[(ti, hi, wi)], starts_w, min(tile_w, W), scale_w, 4)

    def along_h(ti):
        return assemble_axis(lambda hi: along_w(ti, hi), starts_h, min(tile_h, H), scale_h, 3)

    return assemble_axis(along_h, starts_t, min(tile_t, T), scale_t, 2)

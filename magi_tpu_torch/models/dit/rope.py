"""Learnable 3D rotary embedding of the DiT.

Per-segment temporal offsets (segment j covers latent frames
[t_offset[j], t_offset[j] + chunk_width)) instead of a [T_total, H, W]
grid, which also covers the unconditional CFG branch (every segment
restarts at t = 0) and the distill ride-along chunk.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch


def default_bands(head_dim: int, temperature: float = 10000.0, device=None) -> torch.Tensor:
    """freq_bands(num_bands=head_dim//8, step=1)."""
    num_bands = head_dim // 8
    exp = torch.arange(0, num_bands, dtype=torch.float32, device=device) / num_bands
    return 1.0 / (temperature**exp)


def rope_3d_segments(
    bands: torch.Tensor,  # [num_bands]
    t_offsets: torch.Tensor,  # int [n_seg] temporal offsets
    chunk_width: int,
    H: int,
    W: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (sin, cos), each [n_seg*chunk_width*H*W, 3*num_bands] fp32,
    feature layout [t-bands | h-bands | w-bands]; spatial axes centred and
    rescaled by sqrt(H*W/256)."""
    dev = bands.device
    nb = bands.shape[0]
    bands = bands.float()
    t_pos = t_offsets.to(dev).float()[:, None] + torch.arange(chunk_width, dtype=torch.float32, device=dev)[None, :]
    rescale = math.sqrt((H * W) / (16 * 16))
    h_pos = torch.arange(H, dtype=torch.float32, device=dev) - (H - 1) / 2
    w_pos = torch.arange(W, dtype=torch.float32, device=dev) - (W - 1) / 2
    if H > 1:
        h_pos = h_pos / (H - 1) * (H / rescale - 1)
    if W > 1:
        w_pos = w_pos / (W - 1) * (W / rescale - 1)

    n_seg = t_offsets.shape[0]
    shape = (n_seg, chunk_width, H, W, nb)
    pos_t = (t_pos[:, :, None, None, None] * bands).expand(shape)
    pos_h = (h_pos[None, None, :, None, None] * bands).expand(shape)
    pos_w = (w_pos[None, None, None, :, None] * bands).expand(shape)
    pos = torch.cat([pos_t, pos_h, pos_w], dim=-1).reshape(n_seg * chunk_width * H * W, 3 * nb)
    return torch.sin(pos), torch.cos(pos)


def apply_rotary(x: torch.Tensor, sin: torch.Tensor, cos: torch.Tensor) -> torch.Tensor:
    """GPT-NeoX (non-interleaved) rotary on the first 2*rot dims of each
    head.  x: [S, heads, head_dim]; sin/cos: [S, rot]."""
    rot = sin.shape[-1]
    s_ = sin[:, None, :].float()
    c_ = cos[:, None, :].float()
    xf = x.float()
    x1, x2, rest = xf[..., :rot], xf[..., rot : 2 * rot], xf[..., 2 * rot :]
    out = torch.cat([x1 * c_ - x2 * s_, x1 * s_ + x2 * c_, rest], dim=-1)
    return out.to(x.dtype)

"""DiT embedders: timestep, caption, final projection, ada gating.  All
run in fp32 (weights of another dtype are cast up first)."""

from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F


def _linear(params, x: torch.Tensor) -> torch.Tensor:
    y = x @ params["weight"].to(x.dtype)
    if "bias" in params:
        y = y + params["bias"].to(x.dtype)
    return y


def timestep_embedding(t: torch.Tensor, dim: int, max_period: float = 10000.0, rescale: float = 1000.0):
    """Sinusoidal embedding with the x1000 transport rescale.  t: [N] -> [N, dim] fp32."""
    half = dim // 2
    freqs = torch.exp(-math.log(max_period) * torch.arange(half, dtype=torch.float32, device=t.device) / half)
    args = t.float()[:, None] * freqs[None] * rescale
    emb = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
    if dim % 2:
        emb = torch.cat([emb, torch.zeros_like(emb[:, :1])], dim=-1)
    return emb


def t_embedder_forward(params, t: torch.Tensor, freq_dim: int = 256) -> torch.Tensor:
    """[n_seg] timesteps -> [n_seg, cond_hidden]."""
    h = timestep_embedding(t, freq_dim)
    h = _linear(params["mlp"]["0"], h)
    h = F.silu(h)
    return _linear(params["mlp"]["2"], h)


def y_embedder_forward(params, y: torch.Tensor, caption_dropout) -> Tuple[torch.Tensor, torch.Tensor]:
    """Caption embedding.  y: [n_seg, L, caption_channels].
    `caption_dropout` (bool, or bool [n_seg]) picks the null caption row
    that feeds adaLN per segment: row -1 when dropped, row -2 otherwise.
    Returns (y_xattn [n_seg, L, xattn_hidden], y_adaln [cond_hidden] or
    [n_seg, cond_hidden])."""
    y = y.float()
    y_xattn = F.silu(_linear(params["y_proj_xattn"]["0"], y))
    null_tab = params["null_caption_embedding"].float()
    if isinstance(caption_dropout, bool):
        tok = null_tab[-1] if caption_dropout else null_tab[-2]
    else:
        drop = caption_dropout.to(null_tab.device)
        tok = torch.where(drop[:, None], null_tab[None, -1], null_tab[None, -2])
    y_adaln = _linear(params["y_proj_adaln"]["0"], tok)
    return y_xattn, y_adaln


def final_linear_forward(params, x: torch.Tensor) -> torch.Tensor:
    return x.float() @ params["linear"]["weight"].float()


def softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    return (cap * torch.tanh(x.float() / cap)).to(x.dtype)


def ada_modulate_forward(params, c: torch.Tensor) -> torch.Tensor:
    """SiLU -> projection to the two gates."""
    return _linear(params["proj"]["0"], F.silu(c))


def init_embedder_params(cfg, device, generator: torch.Generator) -> dict:
    """Random fp32 embedders (normal, std 0.02), drawn on `device`."""
    ch = cfg.cond_hidden_size
    xh = cfg.xattn_cond_hidden_size
    cc = cfg.caption_channels

    def w(shape):
        return torch.randn(shape, generator=generator, device=device, dtype=torch.float32) * 0.02

    def lin(i, o):
        return {"weight": w((i, o)), "bias": torch.zeros((o,), device=device)}

    return {
        "t_embedder": {"mlp": {"0": lin(256, ch), "2": lin(ch, ch)}},
        "y_embedder": {
            "y_proj_xattn": {"0": lin(cc, xh)},
            "y_proj_adaln": {"0": lin(cc, ch)},
            "null_caption_embedding": w((cfg.caption_max_length, cc)),
        },
        "final_linear": {
            "linear": {"weight": w((cfg.hidden_size, cfg.patch_size**2 * cfg.t_patch_size * cfg.out_channels))}
        },
    }

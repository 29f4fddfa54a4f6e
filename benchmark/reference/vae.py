"""MAGI-1's ViT-VAE decoder in plain PyTorch, for the benchmark's check.

A latent chunk [z, T', H', W'] is scaled by 1 / scale_factor, cut into
temporal tiles of `fps / 2` frames' worth of latent, and each tile is
decoded: a linear from z to the width, a class token, the learned position
table resized (trilinear, half-pixel centres, antialiased when shrinking)
to the tile's grid, pre-LN ViT blocks whose tokens attend the whole tile,
a final LayerNorm, the unpatchify to (4, 8, 8) voxels and a 3x3x3
convolution to RGB in [-1, 1], then uint8 frames.  It computes in bf16 as
the program serves the VAE (f32 statistics, softmax and convolution), or,
with `int8`, with every linear w8a8 (per-row and per-output-channel int8):
the control's precision.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F

from benchmark import weights as W
from benchmark.reference.dit import Linear, layer_norm


def _resize_weights(n_in: int, n_out: int) -> np.ndarray:
    inv_scale = n_in / n_out
    kernel_scale = max(inv_scale, 1.0)
    sample = (np.arange(n_out, dtype=np.float32) + 0.5) * np.float32(inv_scale) - 0.5
    x = np.abs(sample[None, :] - np.arange(n_in, dtype=np.float32)[:, None]) / np.float32(kernel_scale)
    w = np.maximum(0.0, 1.0 - x).astype(np.float32)
    total = w.sum(axis=0, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * np.finfo(np.float32).eps, w / np.where(total != 0, total, 1), 0)
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return np.where(inside[None, :], w, 0).astype(np.float32)


def _pos_table(pos, src, tgt, device):
    D = pos.shape[-1]
    cls, grid = pos[:1], pos[1:].float().reshape(*src, D)
    if tuple(src) != tuple(tgt):
        mats = [torch.as_tensor(_resize_weights(a, b), device=device) for a, b in zip(src, tgt)]
        grid = torch.einsum("thwd,ta,hb,wc->abcd", grid, *mats)
    return torch.cat([cls, grid.reshape(-1, D).to(pos.dtype)], dim=0)


def decode_tiles(vc: dict, flat: Dict[str, torch.Tensor], z: torch.Tensor, int8: bool = False) -> torch.Tensor:
    """Tiles z [B, zc, t, h, w] (bf16) -> video [B, 3, t * 4, h * 8, w * 8] (f32 in [-1, 1])."""
    B, C, Tl, Hl, Wl = z.shape
    pt, ps, D, heads = vc["patch_length"], vc["patch_size"], vc["embed_dim"], vc["num_heads"]
    d = "vae/decoder/"

    def lin(name, layer=None):
        w = flat[name + "/weight"] if layer is None else flat[name + "/weight"][layer]
        b = flat.get(name + "/bias")
        f = Linear(w, w8a8=int8)

        def apply(x):
            shp = x.shape
            y = f(x.reshape(-1, shp[-1]).to(torch.bfloat16)).reshape(*shp[:-1], -1)
            return y if b is None else y + (b if layer is None else b[layer]).to(y.dtype)
        return apply

    h = lin(d + "proj_in")(z.permute(0, 2, 3, 4, 1).reshape(B, Tl * Hl * Wl, C))
    h = torch.cat([flat[d + "cls_token"][0].to(h.dtype).expand(B, 1, D), h], dim=1)
    src = (vc["video_length"] // pt, vc["video_size"] // ps, vc["video_size"] // ps)
    h = h + _pos_table(flat[d + "pos_embed"][0], src, (Tl, Hl, Wl), z.device)[None].to(h.dtype)
    N, hd = h.shape[1], D // heads
    for i in range(vc["depth"]):
        blk = d + "blocks/"
        x = layer_norm(h, flat[blk + "norm1/weight"][i], flat[blk + "norm1/bias"][i], 1e-5).to(h.dtype)
        qkv = lin(blk + "attn/qkv", i)(x).reshape(B, N, 3, heads, hd).permute(2, 0, 3, 1, 4)
        att = F.scaled_dot_product_attention(qkv[0], qkv[1], qkv[2]).transpose(1, 2).reshape(B, N, D)
        h = h + lin(blk + "attn/proj", i)(att)
        x = layer_norm(h, flat[blk + "norm2/weight"][i], flat[blk + "norm2/bias"][i], 1e-5).to(h.dtype)
        x = F.gelu(lin(blk + "mlp/fc1", i)(x).float()).to(h.dtype)
        h = h + lin(blk + "mlp/fc2", i)(x)
    h = layer_norm(h, flat[d + "norm/weight"], flat[d + "norm/bias"], 1e-5).to(h.dtype)[:, 1:]
    up = D // (ps * ps * pt)
    h = h.reshape(B, Tl, Hl, Wl, pt, ps, ps, up).permute(0, 7, 1, 4, 2, 5, 3, 6)
    h = h.reshape(B, up, Tl * pt, Hl * ps, Wl * ps)
    out = F.conv3d(h.float(), flat[d + "last_layer/weight"].float(), flat[d + "last_layer/bias"].float(), padding=1)
    return out.to(torch.bfloat16).float()


def decode_chunk(vc: dict, seed: int, device, latent: torch.Tensor, scale_factor: float, fps: int,
                 int8: bool = False) -> np.ndarray:
    """A clean latent chunk [zc, T', H', W'] -> uint8 frames [T, H, W, 3]."""
    flat = {lf.path: (W.draw_stacked(lf, seed, device, vc["depth"]) if lf.stacked else W.draw(lf, seed, device))
            for lf in W.vae_leaves(vc)}
    z = latent.to(device=device, dtype=torch.bfloat16)[None] / scale_factor
    tile = max(1, (fps // 2) // vc["patch_length"])
    parts = [z[:, :, a : a + tile] for a in range(0, z.shape[2], tile)]
    video = torch.cat([decode_tiles(vc, flat, part, int8) for part in parts], dim=2)[0]
    out = np.clip(video.cpu().numpy() * 127.5 + 127.5, 0, 255) + 0.5
    return out.astype(np.uint8).transpose(1, 2, 3, 0)

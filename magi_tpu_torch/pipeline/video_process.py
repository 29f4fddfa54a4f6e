"""Video output and VAE decode glue (the decode side of
`magi_tpu.pipeline.video_process`).

MAGI's ViT-VAE disables spatial tiling and uses no temporal overlap, so
a tiled decode is fixed-length temporal tiles, batched through one ViT
forward."""

from __future__ import annotations

import os
import shutil
import subprocess
import tempfile

import numpy as np
import torch

from magi_tpu_torch.core.config import MagiConfig
from magi_tpu_torch.core.logger import magi_logger
from magi_tpu_torch.core.utils import env_is_true


def f32_cthw_to_u8_thwc(video: np.ndarray) -> np.ndarray:
    """f32 [3, T, H, W] in [-1, 1] -> uint8 [T, H, W, 3]."""
    C, T, H, W = video.shape
    if C != 3:
        raise ValueError(f"expected 3 channels, got {C}")
    out = np.clip(video * 127.5 + 127.5, 0, 255) + 0.5
    return out.astype(np.uint8).transpose(1, 2, 3, 0)


def save_video_to_disk(video: np.ndarray, save_path: str, fps: int) -> str:
    """uint8 [T, H, W, 3] -> mp4 (ffmpeg binary > cv2 VideoWriter > .npz).
    Returns the path written."""
    video = np.ascontiguousarray(video)
    T, H, W, _ = video.shape
    dirname = os.path.dirname(save_path)
    if dirname:
        os.makedirs(dirname, exist_ok=True)

    if shutil.which("ffmpeg"):
        with tempfile.NamedTemporaryFile(suffix=".raw", delete=False) as tf:
            tf.write(video.tobytes())
            raw = tf.name
        try:
            subprocess.run(
                ["ffmpeg", "-y", "-f", "rawvideo", "-pix_fmt", "rgb24", "-s", f"{W}x{H}", "-r", str(fps),
                 "-i", raw, "-vcodec", "libx264", "-pix_fmt", "yuv420p", save_path],
                check=True,
                capture_output=True,
            )
            return save_path
        finally:
            os.remove(raw)

    try:
        import cv2
    except ImportError:
        cv2 = None
    if cv2 is not None:
        vw = cv2.VideoWriter(save_path, cv2.VideoWriter_fourcc(*"mp4v"), fps, (W, H))
        if vw.isOpened():
            for frame in video:
                vw.write(cv2.cvtColor(frame, cv2.COLOR_RGB2BGR))
            vw.release()
            if os.path.getsize(save_path) > 0:
                return save_path
    np.savez_compressed(save_path + ".npz", video=video, fps=fps)
    magi_logger.warning(f"wrote raw frames to {save_path}.npz (no video encoder available)")
    return save_path + ".npz"


_vae_cache: dict = {}


def get_vae(vae_ckpt: str, device: torch.device, z_chans: int = 16):
    """The VAE for decoding.  Under SKIP_LOAD_MODEL with no checkpoint on
    disk: a random MAGI-shaped ViT-VAE (8x spatial / 4x temporal, 1024
    wide, 16 layers of 16 heads) in bf16."""
    key = (vae_ckpt, str(device), z_chans)
    if key in _vae_cache:
        return _vae_cache[key]
    if not (env_is_true("SKIP_LOAD_MODEL") and not os.path.exists(os.path.join(vae_ckpt, "config.json"))):
        raise NotImplementedError("loading a VAE checkpoint (checkpoint/vae_loader.py) is ROADMAP queue 1 item 7")
    from magi_tpu_torch.models.vae.model import VaeConfig, ViTVAE, init_vae_params

    cfg = VaeConfig(
        video_size=256, video_length=16, patch_size=8, patch_length=4,
        in_chans=3, z_chans=z_chans, embed_dim=1024, depth=16, num_heads=16,
    )
    vae = ViTVAE(cfg, init_vae_params(cfg, seed=0, dtype=torch.bfloat16, device=device))
    _vae_cache[key] = vae
    return vae


def _temporal_tiles(T: int, tile: int):
    return [(s, min(s + tile, T)) for s in range(0, T, tile)]


def tiled_decode(vae, z: torch.Tensor, tile_frames: int) -> torch.Tensor:
    """latent [N, z, T', H', W'] -> video in [-1, 1].  Temporal latent tiles
    of tile_frames // temporal_downsample_factor, batched when equal length."""
    N = z.shape[0]
    tile_lat = max(1, tile_frames // vae.temporal_downsample_factor)
    Tl = z.shape[2]
    if Tl <= tile_lat:
        return vae.decode(z)
    spans = _temporal_tiles(Tl, tile_lat)
    full = [s for s in spans if s[1] - s[0] == tile_lat]
    outs = {}
    if full:
        y = vae.decode(torch.cat([z[:, :, a:b] for a, b in full], dim=0))
        for i, (a, _) in enumerate(full):
            outs[a] = y[i * N : (i + 1) * N]
    for a, b in spans:
        if b - a != tile_lat:
            outs[a] = vae.decode(z[:, :, a:b])
    return torch.cat([outs[a] for a, _ in spans], dim=2)


def decode_chunk(chunk: torch.Tensor, config: MagiConfig, device: torch.device) -> np.ndarray:
    """latent [C, T', H', W'] -> uint8 [T, H, W, 3]."""
    rc, mc = config.runtime_config, config.model_config
    vae = get_vae(rc.vae_pretrained, device, z_chans=mc.out_channels // (2 if mc.half_channel_vae else 1))
    z = chunk.to(device=device, dtype=torch.bfloat16)[None] / rc.scale_factor
    video = tiled_decode(vae, z, tile_frames=rc.fps // 2)
    return f32_cthw_to_u8_thwc(video[0].float().cpu().numpy())


def post_chunk_process(chunk: torch.Tensor, config: MagiConfig, device: torch.device) -> np.ndarray:
    return decode_chunk(chunk, config, device)

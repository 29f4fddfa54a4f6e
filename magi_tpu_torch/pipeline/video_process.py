"""Image and video input, video output and the VAE glue (the port of
`magi_tpu.pipeline.video_process`).

MAGI's ViT-VAE disables spatial tiling and uses no temporal overlap, so a
tiled encode or decode is fixed-length temporal tiles, the equal ones
batched through one ViT forward, split across the ranks of a model replica
on a mesh (`parallel.tile.pmap_tile_batch`).  A tokenizer that allows
spatial tiling encodes through the overlap-blended 3D grid
(`pipeline.tiling.tiled_process_3d`).  The loaders import PIL and cv2 only
when they run."""

from __future__ import annotations

import os
import shutil
import subprocess
import tempfile
from typing import Optional

import numpy as np
import torch

from magi_tpu_torch.core.config import MagiConfig
from magi_tpu_torch.core.logger import magi_logger
from magi_tpu_torch.core.profiler import span
from magi_tpu_torch.core.utils import env_is_true


def load_image(image_path: str, w: int, h: int, aspect_policy: str = "fit") -> np.ndarray:
    """-> uint8 [1, h, w, 3]: the image scaled to (w, h) ("fit"), scaled to
    cover and centre-cropped ("crop"), or scaled to fit and centred on
    black ("pad"); bicubic."""
    from PIL import Image

    img = Image.open(image_path).convert("RGB")
    iw, ih = img.size
    if aspect_policy == "crop":
        scale = max(w / iw, h / ih)
        img = img.resize((max(1, round(iw * scale)), max(1, round(ih * scale))), Image.BICUBIC)
        left = (img.size[0] - w) // 2
        top = (img.size[1] - h) // 2
        img = img.crop((left, top, left + w, top + h))
    elif aspect_policy == "pad":
        scale = min(w / iw, h / ih)
        img = img.resize((max(1, round(iw * scale)), max(1, round(ih * scale))), Image.BICUBIC)
        canvas = Image.new("RGB", (w, h), (0, 0, 0))
        canvas.paste(img, ((w - img.size[0]) // 2, (h - img.size[1]) // 2))
        img = canvas
    else:
        if aspect_policy != "fit":
            magi_logger.warning(f"Unknown aspect policy: {aspect_policy}, using fit as fallback")
        img = img.resize((w, h), Image.BICUBIC)
    return np.asarray(img, np.uint8)[None]


def load_video(video_path: Optional[str], fps: int, w: int, h: int, prefix_frame: Optional[int] = None,
               prefix_video_max_chunk: int = 5) -> Optional[np.ndarray]:
    """-> uint8 [T, h, w, 3], resampled to `fps` (a source frame is repeated
    or dropped to keep time), then its first `prefix_frame` frames, or else
    its last whole seconds up to `prefix_video_max_chunk` (one frame when
    shorter than a second)."""
    if video_path is None:
        return None
    import cv2

    cap = cv2.VideoCapture(video_path)
    if not cap.isOpened():
        raise ValueError(f"cannot open video {video_path}")
    src_fps = cap.get(cv2.CAP_PROP_FPS) or fps
    frames = []
    t_next = 0.0
    idx = 0
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        t = idx / src_fps
        while t >= t_next - 1e-9:
            f = cv2.resize(frame, (w, h), interpolation=cv2.INTER_AREA)
            frames.append(cv2.cvtColor(f, cv2.COLOR_BGR2RGB))
            t_next += 1.0 / fps
        idx += 1
    cap.release()
    video = np.asarray(frames, np.uint8)

    if prefix_frame is not None:
        return video[:prefix_frame]
    n = video.shape[0]
    clip = 1 if n < fps else min(n // fps * fps, prefix_video_max_chunk * fps)
    return video[-clip:]


def u8_thwc_to_f32_cthw(frames: np.ndarray) -> np.ndarray:
    """uint8 [T, H, W, 3] -> f32 [3, T, H, W] in [-1, 1]."""
    if frames.shape[-1] != 3:
        raise ValueError(f"expected 3 channels, got {frames.shape[-1]}")
    out = frames.astype(np.float32) / 127.5 - 1.0
    return np.ascontiguousarray(out.transpose(3, 0, 1, 2))


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
    """The VAE: the released checkpoint under `vae_ckpt` (its `config.json`
    and weights) in bf16 on `device`, cached unless OFFLOAD_VAE_CACHE=true.
    Under SKIP_LOAD_MODEL with no checkpoint on disk: a random MAGI-shaped
    ViT-VAE (8x spatial / 4x temporal, 1024 wide, 16 layers of 16 heads,
    encoder and decoder) in bf16."""
    key = (vae_ckpt, str(device), z_chans)
    if key in _vae_cache:
        return _vae_cache[key]
    if env_is_true("SKIP_LOAD_MODEL") and not os.path.exists(os.path.join(vae_ckpt, "config.json")):
        from magi_tpu_torch.models.vae.model import VaeConfig, ViTVAE, init_vae_params

        cfg = VaeConfig(
            video_size=256, video_length=16, patch_size=8, patch_length=4,
            in_chans=3, z_chans=z_chans, embed_dim=1024, depth=16, num_heads=16,
        )
        vae = ViTVAE(cfg, init_vae_params(cfg, seed=0, dtype=torch.bfloat16, device=device))
        _vae_cache[key] = vae
        return vae
    from magi_tpu_torch.checkpoint.vae_loader import load_vae

    vae = load_vae(vae_ckpt, torch.bfloat16, device)
    if os.environ.get("OFFLOAD_VAE_CACHE") == "true":
        return vae
    _vae_cache[key] = vae
    return vae


def _temporal_tiles(T: int, tile: int):
    return [(s, min(s + tile, T)) for s in range(0, T, tile)]


def tiled_encode(vae, video: torch.Tensor, tile_frames: int, tile_hw: int = 256) -> torch.Tensor:
    """video [N, C, T, H, W] in [-1, 1] -> latent.  Temporal tiles of
    `tile_frames`, the full ones batched through one forward (split across
    the mesh's model replica); a VAE with `allow_spatial_tiling` and frames
    wider than `tile_hw` through the overlap-blended 3D tile grid."""
    from magi_tpu_torch.parallel.tile import pmap_tile_batch

    N, C, T, H, W = video.shape
    if getattr(vae, "allow_spatial_tiling", False) and (H > tile_hw or W > tile_hw):
        from magi_tpu_torch.pipeline.tiling import tiled_process_3d

        sd, td = vae.spatial_downsample_factor, vae.temporal_downsample_factor
        return tiled_process_3d(vae.encode, video, tile_t=tile_frames, tile_h=tile_hw, tile_w=tile_hw,
                                scale_t=td, scale_h=sd, scale_w=sd, overlap_t=0.0, overlap_hw=0.25)
    if T <= tile_frames:
        return vae.encode(video)
    spans = _temporal_tiles(T, tile_frames)
    full = [s for s in spans if s[1] - s[0] == tile_frames]
    outs = {}
    if full:
        z = pmap_tile_batch(vae.encode, torch.cat([video[:, :, a:b] for a, b in full], dim=0))
        for i, (a, _) in enumerate(full):
            outs[a] = z[i * N : (i + 1) * N]
    for a, b in spans:
        if b - a != tile_frames:
            outs[a] = vae.encode(video[:, :, a:b])
    return torch.cat([outs[a] for a, _ in spans], dim=2)


def tiled_decode(vae, z: torch.Tensor, tile_frames: int) -> torch.Tensor:
    """latent [N, z, T', H', W'] -> video in [-1, 1].  Temporal latent tiles
    of tile_frames // temporal_downsample_factor, batched when equal length
    (and split across the mesh's model replica)."""
    from magi_tpu_torch.parallel.tile import pmap_tile_batch

    N = z.shape[0]
    tile_lat = max(1, tile_frames // vae.temporal_downsample_factor)
    Tl = z.shape[2]
    if Tl <= tile_lat:
        return vae.decode(z)
    spans = _temporal_tiles(Tl, tile_lat)
    full = [s for s in spans if s[1] - s[0] == tile_lat]
    outs = {}
    if full:
        y = pmap_tile_batch(vae.decode, torch.cat([z[:, :, a:b] for a, b in full], dim=0))
        for i, (a, _) in enumerate(full):
            outs[a] = y[i * N : (i + 1) * N]
    for a, b in spans:
        if b - a != tile_lat:
            outs[a] = vae.decode(z[:, :, a:b])
    return torch.cat([outs[a] for a, _ in spans], dim=2)


def decode_chunk(chunk: torch.Tensor, config: MagiConfig, device: torch.device,
                 req: Optional[int] = None) -> np.ndarray:
    """latent [C, T', H', W'] -> uint8 [T, H, W, 3].  Span `magi/decode`
    with the frames and bytes it makes (and the request id `req` when
    given), over its parts `magi/decode/vae` (the decode and the f32 cast
    on the device), `magi/decode/to_host` (the copy to host memory) and
    `magi/decode/to_uint8` (the frames' conversion on the host)."""
    rc, mc = config.runtime_config, config.model_config
    vae = get_vae(rc.vae_pretrained, device, z_chans=mc.out_channels // (2 if mc.half_channel_vae else 1))
    C, T, H, W = chunk.shape
    frames, sd = T * vae.temporal_downsample_factor, vae.spatial_downsample_factor
    with span("magi/decode", frames=frames, bytes=frames * H * sd * W * sd * 3, req=req):
        with span("magi/decode/vae"):
            z = chunk.to(device=device, dtype=torch.bfloat16)[None] / rc.scale_factor
            video = tiled_decode(vae, z, tile_frames=rc.fps // 2)[0].float()
        with span("magi/decode/to_host", bytes=video.numel() * video.element_size()):
            video = video.cpu().numpy()
        with span("magi/decode/to_uint8"):
            return f32_cthw_to_u8_thwc(video)


def post_chunk_process(chunk: torch.Tensor, config: MagiConfig, device: torch.device,
                       req: Optional[int] = None) -> np.ndarray:
    """`decode_chunk`: a finished chunk's frames; `req` names its request in
    the decode's spans."""
    return decode_chunk(chunk, config, device, req)


def encode_prefix_video(prefix_video: Optional[np.ndarray], fps: int, vae_ckpt: str, scale_factor: float,
                        device: torch.device) -> Optional[torch.Tensor]:
    """uint8 [T, H, W, 3] -> scaled latent [C, T', H', W'] f32 on `device`:
    the bf16 frames through the tiled encode (tiles of fps / 2 frames)."""
    if prefix_video is None:
        return None
    vae = get_vae(vae_ckpt, device)
    video = torch.from_numpy(u8_thwc_to_f32_cthw(np.asarray(prefix_video)))[None].to(device)
    z = tiled_encode(vae, video.to(torch.bfloat16), tile_frames=fps // 2)
    return (z[0] * scale_factor).float()


def process_image(image_path: str, config: MagiConfig, device: torch.device) -> torch.Tensor:
    """The i2v prefix: the image's latent, one frame."""
    rc = config.runtime_config
    img = load_image(image_path, w=rc.video_size_w, h=rc.video_size_h)
    return encode_prefix_video(img, rc.fps, rc.vae_pretrained, rc.scale_factor, device)


def process_prefix_video(prefix_video_path: str, config: MagiConfig, device: torch.device) -> torch.Tensor:
    """The v2v prefix: the latent of the video's first 32 frames."""
    rc = config.runtime_config
    vid = load_video(prefix_video_path, fps=rc.fps, w=rc.video_size_w, h=rc.video_size_h, prefix_frame=32)
    return encode_prefix_video(vid, rc.fps, rc.vae_pretrained, rc.scale_factor, device)

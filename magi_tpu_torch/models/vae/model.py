"""ViT video VAE (the port of `magi_tpu.models.vae.model`).

8x spatial / 4x temporal compression.  The encoder is a Conv3d patch
embed (stride = kernel, so one matmul over patches), a plain ViT stack and
a linear to the Gaussian posterior's statistics; the decoder is a plain
ViT stack, then an unpatchify and a 3x3x3 Conv3d.  Attention runs through
the segmented attention op with one segment per batch element (tile), so
a tiled encode or decode batches its tiles through one forward.  The
parameter tree is the JAX package's (linear weights [in, out], the patch
embed and the final conv weights in OIDHW).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from magi_tpu_torch.core import graphs as G
from magi_tpu_torch.models.dit.model import layer_norm, layer_params
from magi_tpu_torch.ops.attention import segmented_attention_v2


@dataclasses.dataclass(frozen=True)
class VaeConfig:
    """ddconfig of the released ViT-VAE."""

    video_size: int = 256
    video_length: int = 16
    patch_size: int = 8
    patch_length: int = 4
    in_chans: int = 3
    z_chans: int = 4
    double_z: bool = True
    embed_dim: int = 768
    depth: int = 12
    num_heads: int = 12
    mlp_ratio: float = 4.0
    qkv_bias: bool = False
    with_cls_token: bool = True
    norm_code: bool = False
    ln_in_attn: bool = False
    use_rope: bool = False
    use_final_proj: bool = False
    conv_last_layer: bool = True

    @classmethod
    def from_ddconfig(cls, dd: dict) -> "VaeConfig":
        """The config of a released `config.json`'s `ddconfig` (keys this
        config does not know are ignored)."""
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in dd.items() if k in known})

    @property
    def latent_size(self) -> int:
        return self.video_size // self.patch_size

    @property
    def latent_length(self) -> int:
        return self.video_length // self.patch_length

    @property
    def head_dim(self) -> int:
        return self.embed_dim // self.num_heads


@functools.lru_cache(maxsize=32)
def vae_rope(feat_shape, head_dim, dtype=torch.float32, device=None, ref_feat_shape=(4, 16, 16)):
    """3-axis rotary sin/cos, interleaved layout.  Returns (sin, cos),
    each [prod(feat_shape), head_dim].  Cached per shape (a forward's
    captured graph reads the tensors; they are never written)."""
    num_bands = head_dim // (len(feat_shape) * 2)
    bands = 1.0 / (10000.0 ** (np.arange(num_bands, dtype=np.float64) / num_bands))
    axes = []
    for i, s in enumerate(feat_shape):
        t = np.arange(s, dtype=np.float64)
        if i != 0:  # spatial axes centred, temporal not
            t = t - (s - 1) / 2
        if ref_feat_shape is not None:
            t = t / s * ref_feat_shape[i]
        axes.append(t)
    grids = np.meshgrid(*axes, indexing="ij")
    pos = np.stack([g[..., None] * bands for g in grids], axis=-2)  # [*shape, 3, nb]
    pos = pos.reshape(int(np.prod(feat_shape)), len(feat_shape) * num_bands)
    sin = np.repeat(np.sin(pos), 2, axis=-1)
    cos = np.repeat(np.cos(pos), 2, axis=-1)
    return (torch.as_tensor(sin, dtype=dtype, device=device), torch.as_tensor(cos, dtype=dtype, device=device))


def apply_rot_interleaved(x, sin, cos):
    """x*cos + rot(x)*sin with rot = interleave(-odd, even)."""
    x1 = x[..., ::2]
    x2 = x[..., 1::2]
    rot = torch.stack([-x2, x1], dim=-1).reshape(x.shape)
    return x * cos + rot * sin


def _manual_layernorm(x, eps=1e-5):
    """(x - mean) / (std + eps): eps outside the sqrt."""
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    std = (xf - mean).square().mean(-1, keepdim=True).sqrt()
    return ((xf - mean) / (std + eps)).to(x.dtype)


def _linear(p, x):
    y = x @ p["weight"]
    if "bias" in p:
        y = y + p["bias"].to(y.dtype)
    return y


def _block_forward(p, cfg: VaeConfig, x, rope):
    """Pre-LN ViT block.  x: [B, N, D]."""
    B, N, D = x.shape
    h, hd = cfg.num_heads, cfg.head_dim
    residual = x
    xin = x if cfg.ln_in_attn else layer_norm(x, p["norm1"], 1e-5)
    qkv = _linear(p["attn"]["qkv"], xin).reshape(B, N, 3, h, hd)
    if cfg.ln_in_attn:
        qkv = _manual_layernorm(qkv)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    if cfg.use_rope:
        sin, cos = rope  # [N - cls, hd]
        sin, cos = sin[None, :, None, :], cos[None, :, None, :]
        off = 1 if cfg.with_cls_token else 0
        q = torch.cat([q[:, :off], apply_rot_interleaved(q[:, off:], sin, cos).to(q.dtype)], dim=1)
        k = torch.cat([k[:, :off], apply_rot_interleaved(k[:, off:], sin, cos).to(k.dtype)], dim=1)

    # batch -> segments; each sample attends itself.  q, k and v go in as
    # views of qkv (the kernel loads them with TMA)
    starts = torch.arange(B, dtype=torch.int32, device=x.device) * N
    out = segmented_attention_v2(
        q.reshape(B * N, h, hd), k.reshape(B * N, h, hd), v.reshape(B * N, h, hd), starts, starts + N, seg_len=N,
    )
    x = residual + _linear(p["attn"]["proj"], out.reshape(B, N, D))

    residual = x
    hmlp = _linear(p["mlp"]["fc1"], layer_norm(x, p["norm2"], 1e-5))
    hmlp = _linear(p["mlp"]["fc2"], F.gelu(hmlp, approximate="none"))
    return residual + hmlp


def _resize_weights(n_in: int, n_out: int) -> np.ndarray:
    """[n_in, n_out] weights of a linear (triangle-kernel) resize with
    half-pixel centres, antialiased when shrinking, edge weights
    renormalised: the resize `jax.image.resize(..., "trilinear")` does."""
    inv_scale = n_in / n_out
    kernel_scale = max(inv_scale, 1.0)
    sample = (np.arange(n_out, dtype=np.float32) + 0.5) * np.float32(inv_scale) - 0.5
    x = np.abs(sample[None, :] - np.arange(n_in, dtype=np.float32)[:, None]) / np.float32(kernel_scale)
    w = np.maximum(0.0, 1.0 - x).astype(np.float32)
    total = w.sum(axis=0, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * np.finfo(np.float32).eps, w / np.where(total != 0, total, 1), 0)
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return np.where(inside[None, :], w, 0).astype(np.float32)


@functools.lru_cache(maxsize=32)
def _resize_matrix(n_in: int, n_out: int, device) -> torch.Tensor:
    """`_resize_weights` on `device`, cached (a captured forward reads it)."""
    return torch.as_tensor(_resize_weights(n_in, n_out), device=device)


def _resize_pos_embed(posemb, src_shape, tgt_shape):
    D = posemb.shape[-1]
    p = posemb.float().reshape(*src_shape, D)
    mats = [_resize_matrix(a, b, posemb.device) for a, b in zip(src_shape, tgt_shape)]
    p = torch.einsum("thwd,ta,hb,wc->abcd", p, *mats)
    return p.reshape(int(np.prod(tgt_shape)), D).to(posemb.dtype)


def _pos_embed_for(p, cfg: VaeConfig, shape):
    pos = p["pos_embed"][0]  # [P + cls, D]
    cls_n = 1 if cfg.with_cls_token else 0
    src = (cfg.latent_length, cfg.latent_size, cfg.latent_size)
    if tuple(shape) != src:
        pos = torch.cat([pos[:cls_n], _resize_pos_embed(pos[cls_n:], src, tuple(shape))], dim=0)
    return pos


def _run_blocks(p, cfg: VaeConfig, h, feat_shape):
    rope = vae_rope(feat_shape, cfg.head_dim, dtype=h.dtype, device=h.device) if cfg.use_rope else None
    for idx in range(cfg.depth):
        h = _block_forward(layer_params(p["blocks"], idx), cfg, h, rope)
    return h


def encoder_forward(p, cfg: VaeConfig, x: torch.Tensor) -> torch.Tensor:
    """[B, C, T, H, W] -> latent statistics [B, 2*z (or z), T', H', W']."""
    B, C, T, H, W = x.shape
    pt, ps = cfg.patch_length, cfg.patch_size
    Tl, Hl, Wl = T // pt, H // ps, W // ps
    # a Conv3d with stride = kernel drops the remainders
    x = x[:, :, : Tl * pt, : Hl * ps, : Wl * ps]
    # the patch embed as one matmul; features in (C, kt, kh, kw) order
    xp = x.reshape(B, C, Tl, pt, Hl, ps, Wl, ps).permute(0, 2, 4, 6, 1, 3, 5, 7)
    xp = xp.reshape(B, Tl * Hl * Wl, C * pt * ps * ps)
    w = p["patch_embed"]["proj"]["weight"]  # [D, C, kt, kh, kw]
    D = w.shape[0]
    h = xp @ w.reshape(D, -1).t().to(xp.dtype)
    h = h + p["patch_embed"]["proj"]["bias"].to(h.dtype)
    if cfg.with_cls_token:
        h = torch.cat([p["cls_token"][0].to(h.dtype).expand(B, 1, D), h], dim=1)
    h = h + _pos_embed_for(p, cfg, (Tl, Hl, Wl))[None].to(h.dtype)

    h = _run_blocks(p, cfg, h, (Tl, Hl, Wl))
    h = _linear(p["last_layer"], layer_norm(h, p["norm"], 1e-5))
    if cfg.with_cls_token:
        h = h[:, 1:]
    out_ch = cfg.z_chans * (2 if cfg.double_z else 1)
    h = h.reshape(B, Tl, Hl, Wl, out_ch).permute(0, 4, 1, 2, 3)
    if cfg.norm_code:
        hf = h.float()
        h = (hf / torch.linalg.vector_norm(hf, dim=1, keepdim=True)).to(h.dtype)
    return h


def decoder_forward(p, cfg: VaeConfig, z: torch.Tensor) -> torch.Tensor:
    """[B, z, T', H', W'] -> [B, 3, T, H, W]."""
    B, C, Tl, Hl, Wl = z.shape
    pt, ps = cfg.patch_length, cfg.patch_size

    h = _linear(p["proj_in"], z.permute(0, 2, 3, 4, 1).reshape(B, Tl * Hl * Wl, C))
    D = h.shape[-1]
    if cfg.with_cls_token:
        h = torch.cat([p["cls_token"][0].to(h.dtype).expand(B, 1, D), h], dim=1)
    h = h + _pos_embed_for(p, cfg, (Tl, Hl, Wl))[None].to(h.dtype)

    h = layer_norm(_run_blocks(p, cfg, h, (Tl, Hl, Wl)), p["norm"], 1e-5)
    if cfg.with_cls_token:
        h = h[:, 1:]

    if cfg.use_final_proj:
        h = layer_norm(_linear(p["final_proj"], h), p["final_norm"], 1e-5)
        up_ch = 4
    else:
        up_ch = D // (ps * ps * pt)

    # 'B lT lH lW pT pH pW C -> B C (lT pT) (lH pH) (lW pW)'
    h = h.reshape(B, Tl, Hl, Wl, pt, ps, ps, up_ch).permute(0, 7, 1, 4, 2, 5, 3, 6)
    h = h.reshape(B, up_ch, Tl * pt, Hl * ps, Wl * ps)
    out = F.conv3d(h.float(), p["last_layer"]["weight"].float(), p["last_layer"]["bias"].float(), padding=1)
    return out.to(z.dtype)


def gaussian_mode(stats: torch.Tensor) -> torch.Tensor:
    """The posterior's mode (its mean), what inference encodes to."""
    return stats.chunk(2, dim=1)[0]


def gaussian_sample(stats: torch.Tensor, generator: Optional[torch.Generator] = None) -> torch.Tensor:
    mean, logvar = stats.chunk(2, dim=1)
    std = torch.exp(0.5 * torch.clamp(logvar, -30.0, 20.0))
    noise = torch.randn(mean.shape, generator=generator, device=mean.device, dtype=torch.float32).to(mean.dtype)
    return mean + std * noise


class ViTVAE:
    """ViT-VAE with the released model's encode / decode surface.

    On the card (`capture`, the default) the encoder and decoder forwards
    run as CUDA graphs keyed by the input's shape and dtype, the
    counterpart of the JAX package's jitted `_encode` / `_decode`: the first
    call of a shape captures (`core.graphs.StepGraph`, in the VAE's own
    memory pool, on its own capture stream); every call copies the input
    into the graph's input buffer, replays and returns a copy of its
    output.  Calls may come from another thread and stream (the
    interleaved decode), one at a time; a first call captures on the
    calling thread, so a shape a worker will decode is decoded once before
    the worker starts."""

    def __init__(self, cfg: VaeConfig, params: dict, capture: bool = True):
        self.cfg = cfg
        self.params = params
        self.capture = capture
        self._graphs: dict = {}  # (kind, shape, dtype) -> (input buffer, StepGraph)

    def _forward(self, kind: str, fn, x: torch.Tensor) -> torch.Tensor:
        """fn(x) eagerly, or through the graph of (kind, x's shape and dtype)."""
        if not (self.capture and x.device.type == "cuda"):
            return fn(x)
        key = (kind, tuple(x.shape), x.dtype)
        entry = self._graphs.get(key)
        if entry is None:
            static = torch.empty(x.shape, dtype=x.dtype, device=x.device)
            graph = G.StepGraph(f"VAE {kind} of {tuple(x.shape)} {x.dtype}",
                                lambda run: run.piece(kind, fn, static), x.device, "vae", G.Arena(x.device),
                                warm_key=(self.cfg,) + key)
            entry = self._graphs[key] = (static, graph)
        static, graph = entry
        static.copy_(x)
        return graph().clone()

    @property
    def graphs(self) -> int:
        """CUDA graphs captured by this VAE."""
        return G.graph_count(g for _, g in self._graphs.values())

    @property
    def spatial_downsample_factor(self) -> int:
        return self.cfg.patch_size

    @property
    def temporal_downsample_factor(self) -> int:
        return self.cfg.patch_length

    def encode(self, x: torch.Tensor, sample_posterior: bool = False,
               generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """video [B, C, T, H, W] in [-1, 1] -> latent [B, z, T', H', W']: the
        posterior's mode, or a sample of it.  A single frame (an image) is
        repeated to 4 frames and the latent cut back to its first frame."""
        B, C, T, H, W = x.shape
        single = T == 1 and self.cfg.patch_length > 1
        if single:
            x = x.expand(B, C, 4, H, W)
        stats = self._forward("encode", functools.partial(encoder_forward, self.params["encoder"], self.cfg), x)
        z = gaussian_sample(stats, generator) if sample_posterior else gaussian_mode(stats)
        return z[:, :, :1] if single else z

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        """latent [B, z, T', H', W'] -> video [B, 3, T, H, W]."""
        return self._forward("decode", functools.partial(decoder_forward, self.params["decoder"], self.cfg), z)


def init_vae_params(cfg: VaeConfig, seed: int = 0, dtype=torch.float32, device=None) -> dict:
    """Random weights (normal, std 0.02) drawn on `device`; the JAX
    package's key tree under "encoder" and "decoder".  The decoder is drawn
    first, so its weights do not depend on the encoder's."""
    device = torch.device(device or "cuda")
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    D, depth, mlp = cfg.embed_dim, cfg.depth, int(cfg.embed_dim * cfg.mlp_ratio)

    def w(shape, stacked=False):
        s = ((depth,) + shape) if stacked else shape
        return (torch.randn(s, generator=gen, device=device) * 0.02).to(dtype)

    def zeros(shape):
        return torch.zeros(shape, dtype=dtype, device=device)

    def lin(i, o, bias=True, stacked=False):
        p = {"weight": w((i, o), stacked=stacked)}
        if bias:
            p["bias"] = zeros((depth, o) if stacked else (o,))
        return p

    def normp(n, stacked=False):
        s = (depth, n) if stacked else (n,)
        return {"weight": torch.ones(s, dtype=dtype, device=device), "bias": zeros(s)}

    def blocks():
        b = {
            "attn": {"qkv": lin(D, 3 * D, bias=cfg.qkv_bias, stacked=True), "proj": lin(D, D, stacked=True)},
            "norm2": normp(D, stacked=True),
            "mlp": {"fc1": lin(D, mlp, stacked=True), "fc2": lin(mlp, D, stacked=True)},
        }
        if not cfg.ln_in_attn:
            b["norm1"] = normp(D, stacked=True)
        return b

    n_patches = cfg.latent_length * cfg.latent_size**2
    cls_n = 1 if cfg.with_cls_token else 0
    up_ch = 4 if cfg.use_final_proj else D // (cfg.patch_size**2 * cfg.patch_length)
    dec_blocks = blocks()
    dec = {
        "proj_in": lin(cfg.z_chans, D),
        "pos_embed": w((1, n_patches + cls_n, D)),
        "blocks": dec_blocks,
        "norm": normp(D),
        "last_layer": {"weight": w((3, up_ch, 3, 3, 3)), "bias": zeros((3,))},
    }
    if cfg.with_cls_token:
        dec["cls_token"] = w((1, 1, D))
    if cfg.use_final_proj:
        dec["final_proj"] = lin(D, up_ch * cfg.patch_size**2 * cfg.patch_length)
        dec["final_norm"] = normp(up_ch * cfg.patch_size**2 * cfg.patch_length)

    out_ch = cfg.z_chans * (2 if cfg.double_z else 1)
    enc = {
        "patch_embed": {"proj": {"weight": w((D, cfg.in_chans, cfg.patch_length, cfg.patch_size, cfg.patch_size)),
                                 "bias": zeros((D,))}},
        "pos_embed": w((1, n_patches + cls_n, D)),
        "blocks": blocks(),
        "norm": normp(D),
        "last_layer": lin(D, out_ch),
    }
    if cfg.with_cls_token:
        enc["cls_token"] = w((1, 1, D))
    return {"encoder": enc, "decoder": dec}

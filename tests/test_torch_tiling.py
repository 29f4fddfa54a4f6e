"""The port's generic 3D tiling (`magi_tpu_torch.pipeline.tiling`) against
`magi_tpu.pipeline.tiling` on seeded inputs, fp32 on the CPU: the tile
starts (the tail tile clamped to the end), the linear cross-fade, and
`tiled_process_3d` with simple functions (identity with temporal and
spatial overlaps, a 2x downsample, a 2x upsample under `invert_scale`) on
sizes the tiles do not divide; then `tiled_encode` of a VAE that allows
spatial tiling (the tiny ViT-VAE with the flag set: 32x32 tiles of a
48x40 video, overlaps of 8 pixels) against the JAX package's.

Tolerances: the tiling itself moves values exactly (identity, slicing)
or by one f32 blend (1e-6); the VAE's forwards take the VAE tests' 1e-4
(fp32 matmuls in another summation order)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from magi_tpu.models.vae import model as JV
from magi_tpu.pipeline import tiling as JT
from magi_tpu.pipeline import video_process as JVP
from magi_tpu_torch.checkpoint.from_jax import vae_params_from_jax
from magi_tpu_torch.models.vae import model as TV
from magi_tpu_torch.pipeline import tiling as TT
from magi_tpu_torch.pipeline import video_process as TVP
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)


@pytest.mark.parametrize("size,tile,overlap", [(100, 32, 8), (32, 32, 8), (20, 32, 8), (48, 32, 8), (37, 12, 3),
                                               (10, 6, 0)])
def test_tile_starts_match(size, tile, overlap):
    got = TT._tile_starts(size, tile, overlap)
    assert got == JT._tile_starts(size, tile, overlap)
    assert got[-1] == max(0, size - tile)  # the tail tile ends at the array's end


@pytest.mark.parametrize("axis,overlap", [(2, 2), (-1, 3), (3, 0)])
def test_blend_axis_matches(axis, overlap):
    rng = np.random.default_rng(axis + 10 * overlap)
    a = rng.normal(size=(1, 2, 5, 6, 7)).astype(np.float32)
    b = rng.normal(size=(1, 2, 5, 6, 7)).astype(np.float32)
    got = TT._blend_axis(torch.from_numpy(a), torch.from_numpy(b), axis=axis, overlap=overlap).numpy()
    want = np.asarray(JT._blend_axis(jnp.asarray(a), jnp.asarray(b), axis=axis, overlap=overlap))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-6)


def _down(t):
    return t[:, :, ::2, ::2, ::2]


def _up(t):
    return t.repeat_interleave(2, 2).repeat_interleave(2, 3).repeat_interleave(2, 4) if isinstance(t, torch.Tensor) \
        else jnp.repeat(jnp.repeat(jnp.repeat(t, 2, 2), 2, 3), 2, 4)


CASES = {
    # (input shape, tiles (t, h, w), scales, overlaps (t, hw), invert_scale, fn)
    "identity_overlaps_tail": ((1, 3, 10, 21, 19), (6, 12, 12), (1, 1, 1), (0.25, 0.25), False, None),
    "downsample": ((1, 3, 8, 16, 16), (4, 8, 8), (2, 2, 2), (0.0, 0.0), False, _down),
    "downsample_overlap": ((2, 3, 12, 20, 20), (4, 8, 8), (2, 2, 2), (0.5, 0.25), False, _down),
    "upsample_overlap": ((1, 2, 6, 10, 9), (4, 6, 6), (2, 2, 2), (0.25, 0.5), True, _up),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_tiled_process_3d_matches(case):
    shape, (tt, th, tw), (st, sh, sw), (ot, ohw), inv, fn = CASES[case]
    x = np.random.default_rng(len(case)).normal(size=shape).astype(np.float32)
    kw = dict(tile_t=tt, tile_h=th, tile_w=tw, scale_t=st, scale_h=sh, scale_w=sw, overlap_t=ot, overlap_hw=ohw,
              invert_scale=inv)
    got = TT.tiled_process_3d(fn or (lambda t: t), torch.from_numpy(x), **kw).numpy()
    want = np.asarray(JT.tiled_process_3d(fn or (lambda t: t), jnp.asarray(x), **kw))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-6)
    if fn is None:  # overlapping tiles of the same values blend back to them
        np.testing.assert_allclose(got, x, atol=1e-6)


class _JaxSpatialVAE(JV.ViTVAE):
    allow_spatial_tiling = property(lambda self: True)


class _TorchSpatialVAE(TV.ViTVAE):
    allow_spatial_tiling = property(lambda self: True)


def test_tiled_encode_with_spatial_tiling_matches():
    jcfg = JV.VaeConfig(video_size=32, video_length=8, patch_size=8, patch_length=4, in_chans=3, z_chans=4,
                        embed_dim=64, depth=1, num_heads=4, qkv_bias=True, use_final_proj=True)
    jparams = JV.init_vae_params(jcfg, seed=2)
    tvae = _TorchSpatialVAE(TV.VaeConfig(**dataclasses.asdict(jcfg)), vae_params_from_jax(jax.tree.map(np.asarray,
                                                                                                        jparams)))
    assert TV.ViTVAE.allow_spatial_tiling.fget(tvae) is False  # MAGI's VAE tiles only in time
    x = np.random.default_rng(5).uniform(-1, 1, size=(1, 3, 8, 48, 40)).astype(np.float32)
    got = TVP.tiled_encode(tvae, torch.from_numpy(x), tile_frames=8, tile_hw=32).numpy()
    want = np.asarray(JVP.tiled_encode(_JaxSpatialVAE(jcfg, jparams), jnp.asarray(x), tile_frames=8, tile_hw=32))
    assert got.shape == want.shape == (1, 4, 2, 6, 5)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)

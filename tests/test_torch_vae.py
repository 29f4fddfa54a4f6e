"""magi_tpu_torch.models.vae (decoder) and the tiled decode against
magi_tpu on the same numpy weights (`vae_params_from_jax`), fp32 on the
CPU.  Covers the cls token, final projection or plain unpatchify, the
interleaved VAE rotary with the in-attention LayerNorm, and the
trilinear pos-embed resize in both directions (the 4-frame training grid
shrinks to the 3-frame decode tile of the pipeline).

Tolerance: 1e-4 absolute and relative (fp32 matmuls, LayerNorms and a
Conv3d in another summation order)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from magi_tpu.models.vae import model as JV
from magi_tpu.pipeline.video_process import tiled_decode as jax_tiled_decode
from magi_tpu_torch.checkpoint.from_jax import vae_params_from_jax
from magi_tpu_torch.models.vae import model as TV
from magi_tpu_torch.pipeline.video_process import tiled_decode as torch_tiled_decode

TOL = dict(atol=1e-4, rtol=1e-4)

BASE = dict(video_size=32, video_length=16, patch_size=8, patch_length=4, in_chans=3, z_chans=4, embed_dim=64,
            depth=2, num_heads=4, qkv_bias=True)
CASES = {
    # (config overrides, latent T', H', W')
    "final_proj_training_grid": (dict(use_final_proj=True), (4, 4, 4)),
    "final_proj_resized": (dict(use_final_proj=True), (3, 6, 5)),
    "unpatchify_upsampled": (dict(patch_size=4, patch_length=2, video_length=8), (7, 9, 9)),
    "rope_ln_in_attn": (dict(embed_dim=96, use_rope=True, ln_in_attn=True, use_final_proj=True), (2, 4, 4)),
    "no_cls_token": (dict(with_cls_token=False, use_final_proj=True), (1, 4, 3)),
}


def _pair(overrides, seed):
    jcfg = JV.VaeConfig(**{**BASE, **overrides})
    jparams = JV.init_vae_params(jcfg, seed=seed)
    return jcfg, jparams, TV.VaeConfig(**dataclasses.asdict(jcfg)), vae_params_from_jax(jax.tree.map(np.asarray, jparams))


@pytest.mark.parametrize("case", sorted(CASES))
def test_decoder_forward_matches(case):
    overrides, (Tl, Hl, Wl) = CASES[case]
    jcfg, jparams, tcfg, tparams = _pair(overrides, seed=len(case))
    z = np.random.default_rng(0).normal(size=(2, jcfg.z_chans, Tl, Hl, Wl)).astype(np.float32)
    got = TV.decoder_forward(tparams["decoder"], tcfg, torch.from_numpy(z)).numpy()
    want = np.asarray(JV.decoder_forward(jparams["decoder"], jcfg, jnp.asarray(z)))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, **TOL)


def test_tiled_decode_and_rope_match():
    jcfg, jparams, tcfg, tparams = _pair(dict(use_final_proj=True), seed=3)
    # 7 latent frames: two full 3-frame tiles batched, then a 1-frame rest
    z = np.random.default_rng(1).normal(size=(1, jcfg.z_chans, 7, 4, 4)).astype(np.float32)
    got = torch_tiled_decode(TV.ViTVAE(tcfg, tparams), torch.from_numpy(z), tile_frames=12).numpy()
    want = np.asarray(jax_tiled_decode(JV.ViTVAE(jcfg, jparams), jnp.asarray(z), tile_frames=12))
    assert got.shape == (1, 3, 28, 32, 32)
    np.testing.assert_allclose(got, want, **TOL)
    for got_t, want_t in zip(TV.vae_rope((2, 4, 6), 24), JV.vae_rope((2, 4, 6), 24)):
        np.testing.assert_allclose(got_t.numpy(), np.asarray(want_t), atol=1e-6, rtol=1e-6)

"""magi_tpu_torch.models.vae (encoder and decoder), the tiled encode and
decode, and the image and video loaders against magi_tpu on the same
numpy weights (`vae_params_from_jax`) and files, fp32 on the CPU.  Covers
the cls token, final projection or plain unpatchify, the interleaved VAE
rotary with the in-attention LayerNorm, the trilinear pos-embed resize in
both directions (the 4-frame training grid shrinks to the 3-frame tile of
the pipeline), the patch embed's remainder truncation, `norm_code`, and
`ViTVAE.encode` of one frame (repeated to 4, cut back to 1 latent frame).

Tolerance: 1e-4 absolute and relative (fp32 matmuls, LayerNorms and a
Conv3d in another summation order).  The loaders are held equal: both
packages decode the same file with the same PIL or cv2 calls."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from magi_tpu.models.vae import model as JV
from magi_tpu.pipeline import video_process as JVP
from magi_tpu.pipeline.video_process import tiled_decode as jax_tiled_decode
from magi_tpu.runtime_native import u8_thwc_to_f32_cthw as jax_u8_to_f32
from magi_tpu_torch.checkpoint.from_jax import vae_params_from_jax
from magi_tpu_torch.models.vae import model as TV
from magi_tpu_torch.pipeline import video_process as TVP
from magi_tpu_torch.pipeline.video_process import tiled_decode as torch_tiled_decode
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)

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


ENC_CASES = {
    # (config overrides, video T, H, W)
    "training_grid": (dict(), (16, 32, 32)),
    "resized_with_remainder": (dict(), (13, 27, 41)),  # 3 x 3 x 5 patches, remainders dropped
    "rope_ln_in_attn": (dict(embed_dim=96, use_rope=True, ln_in_attn=True), (8, 32, 32)),
    "no_cls_norm_code_single_z": (dict(with_cls_token=False, norm_code=True, double_z=False), (4, 16, 24)),
}


@pytest.mark.parametrize("case", sorted(ENC_CASES))
def test_encoder_forward_matches(case):
    overrides, (T, H, W) = ENC_CASES[case]
    jcfg, jparams, tcfg, tparams = _pair(overrides, seed=len(case) + 1)
    x = np.random.default_rng(2).uniform(-1, 1, size=(2, 3, T, H, W)).astype(np.float32)
    got = TV.encoder_forward(tparams["encoder"], tcfg, torch.from_numpy(x)).numpy()
    want = np.asarray(JV.encoder_forward(jparams["encoder"], jcfg, jnp.asarray(x)))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("T", [1, 12])
def test_vae_encode_matches(T):
    """ViTVAE.encode (the posterior's mode); T = 1 is an image."""
    jcfg, jparams, tcfg, tparams = _pair(dict(use_final_proj=True), seed=5)
    x = np.random.default_rng(T).uniform(-1, 1, size=(1, 3, T, 32, 32)).astype(np.float32)
    got = TV.ViTVAE(tcfg, tparams).encode(torch.from_numpy(x)).numpy()
    want = np.asarray(JV.ViTVAE(jcfg, jparams).encode(jnp.asarray(x)))
    assert got.shape == want.shape == (1, jcfg.z_chans, max(1, T // 4), 4, 4)
    np.testing.assert_allclose(got, want, **TOL)
    # a sample of the posterior has the mode's shape
    gen = torch.Generator().manual_seed(0)
    assert TV.ViTVAE(tcfg, tparams).encode(torch.from_numpy(x), sample_posterior=True, generator=gen).shape == got.shape


def test_tiled_encode_matches():
    """32 frames in tiles of 12: two full tiles batched, then 8 frames:
    8 latent frames, the v2v prefix of the pipeline."""
    jcfg, jparams, tcfg, tparams = _pair(dict(use_final_proj=True), seed=7)
    x = np.random.default_rng(3).uniform(-1, 1, size=(1, 3, 32, 32, 32)).astype(np.float32)
    got = TVP.tiled_encode(TV.ViTVAE(tcfg, tparams), torch.from_numpy(x), tile_frames=12).numpy()
    want = np.asarray(JVP.tiled_encode(JV.ViTVAE(jcfg, jparams), jnp.asarray(x), tile_frames=12))
    assert got.shape == want.shape == (1, jcfg.z_chans, 8, 4, 4)
    np.testing.assert_allclose(got, want, **TOL)
    frames = np.random.default_rng(4).integers(0, 256, size=(5, 8, 6, 3), dtype=np.uint8)
    # the port keeps the numpy branch (x / 127.5 - 1); the JAX package's
    # native library, where it is built, may round the last bit otherwise
    np.testing.assert_allclose(TVP.u8_thwc_to_f32_cthw(frames), jax_u8_to_f32(frames), atol=2.5e-7, rtol=0)


def test_init_vae_params_tree_matches():
    """The random VAE's tree has the JAX package's keys and shapes, encoder
    and decoder."""
    cfg = dict(BASE, use_final_proj=True)
    want = jax.tree.map(np.shape, JV.init_vae_params(JV.VaeConfig(**cfg)))
    got = TV.init_vae_params(TV.VaeConfig(**cfg), device="cpu")

    def shapes(t):
        return {k: shapes(v) if isinstance(v, dict) else tuple(v.shape) for k, v in t.items()}

    assert shapes(got) == want


@pytest.mark.parametrize("policy,size", [("fit", (40, 24)), ("crop", (24, 24)), ("pad", (32, 20))])
def test_load_image_matches(tmp_path, policy, size):
    from PIL import Image

    path = str(tmp_path / "img.png")
    Image.fromarray(np.random.default_rng(0).integers(0, 256, size=(30, 50, 3), dtype=np.uint8)).save(path)
    w, h = size
    got = TVP.load_image(path, w=w, h=h, aspect_policy=policy)
    want = JVP.load_image(path, w=w, h=h, aspect_policy=policy)
    assert got.dtype == np.uint8 and got.shape == (1, h, w, 3)
    np.testing.assert_array_equal(got, want)


def test_load_video_matches(tmp_path):
    """An mp4 of 50 frames at 30 fps, resampled to 24 fps: its first 32
    frames (v2v's prefix) and its trailing whole seconds."""
    import cv2

    path = str(tmp_path / "vid.mp4")
    vw = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), 30, (48, 32))
    assert vw.isOpened()
    rng = np.random.default_rng(1)
    for _ in range(50):
        vw.write(rng.integers(0, 256, size=(32, 48, 3), dtype=np.uint8))
    vw.release()
    for kwargs in (dict(prefix_frame=32), dict()):
        got = TVP.load_video(path, fps=24, w=24, h=16, **kwargs)
        want = JVP.load_video(path, fps=24, w=24, h=16, **kwargs)
        assert got.dtype == np.uint8 and got.shape[1:] == (16, 24, 3) and got.shape[0] > 0
        np.testing.assert_array_equal(got, want)
    assert TVP.load_video(path, fps=24, w=24, h=16, prefix_frame=32).shape[0] == 32
    assert TVP.load_video(None, fps=24, w=24, h=16) is None


def vae_state_dict(tree: dict, cfg) -> dict:
    """The released checkpoint's key names for a VAE tree (numpy leaves):
    the inverse of `convert_vae_state`, linear weights back to [out, in]."""
    state = {}
    for tower in ("encoder", "decoder"):
        t, p = tree[tower], tower + "."
        for i in range(cfg.depth):
            b = f"{p}blocks.{i}."
            for group, names in (("attn", ("qkv", "proj")), ("mlp", ("fc1", "fc2"))):
                for n in names:
                    node = t["blocks"][group][n]
                    state[f"{b}{group}.{n}.weight"] = node["weight"][i].T
                    if "bias" in node:
                        state[f"{b}{group}.{n}.bias"] = node["bias"][i]
            for n in ("norm1", "norm2"):
                if n in t["blocks"]:
                    for leaf in ("weight", "bias"):
                        state[f"{b}{n}.{leaf}"] = t["blocks"][n][leaf][i]
        for name in ("pos_embed", "cls_token"):
            if name in t:
                state[p + name] = t[name]
        for n in ("norm", "final_norm"):
            if n in t:
                state[f"{p}{n}.weight"], state[f"{p}{n}.bias"] = t[n]["weight"], t[n]["bias"]
        for n in ("proj_in", "final_proj") + (("last_layer",) if tower == "encoder" else ()):
            if n in t:
                state[f"{p}{n}.weight"], state[f"{p}{n}.bias"] = t[n]["weight"].T, t[n]["bias"]
        if tower == "encoder":
            state[p + "patch_embed.proj.weight"] = t["patch_embed"]["proj"]["weight"]
            state[p + "patch_embed.proj.bias"] = t["patch_embed"]["proj"]["bias"]
        else:
            for leaf in ("weight", "bias"):
                state[f"{p}last_layer.{leaf}"] = t["last_layer"][leaf]
    return {k: np.ascontiguousarray(v, np.float32) for k, v in state.items()}


@pytest.mark.parametrize("fmt", ["safetensors", "bin"])
def test_load_vae_matches(tmp_path, fmt):
    """`load_vae` of a diffusers-format directory (config.json with the
    ddconfig; `diffusion_pytorch_model.safetensors`, or a `.bin` when no
    safetensors file is there): the tree equals the JAX package's
    `convert_vae_state` of the same state, in f32 and in bf16, and a decode
    agrees."""
    import json

    from magi_tpu.checkpoint import vae_loader as JVL
    from magi_tpu_torch.checkpoint import vae_loader as TVL

    dd = dict(BASE, use_final_proj=True, extra_key_the_config_ignores=1)
    jcfg = JV.VaeConfig.from_ddconfig(dd)
    assert TV.VaeConfig.from_ddconfig(dd) == TV.VaeConfig(**dataclasses.asdict(jcfg))
    state = vae_state_dict(jax.tree.map(np.asarray, JV.init_vae_params(jcfg, seed=9)), jcfg)
    (tmp_path / "config.json").write_text(json.dumps({"_class_name": "ViTVAE", "ddconfig": dd}))
    if fmt == "safetensors":
        from safetensors.numpy import save_file

        save_file(state, str(tmp_path / "diffusion_pytorch_model.safetensors"))
    else:
        torch.save({k: torch.from_numpy(np.array(v)) for k, v in state.items()},
                   str(tmp_path / "diffusion_pytorch_model.bin"))
    for jdt, tdt in ((jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16)):
        want = JVL.convert_vae_state(state, jcfg, jdt)
        vae = TVL.load_vae(str(tmp_path), tdt, "cpu")
        assert vae.cfg == TV.VaeConfig(**dataclasses.asdict(jcfg))
        flat_w = jax.tree_util.tree_flatten_with_path(jax.tree.map(np.asarray, want))[0]
        flat_g = jax.tree_util.tree_flatten_with_path(vae.params)[0]
        assert [p for p, _ in flat_w] == [p for p, _ in flat_g]
        for (path, w), (_, g) in zip(flat_w, flat_g):
            assert g.dtype == tdt and tuple(g.shape) == w.shape, path
            np.testing.assert_array_equal(g.float().numpy(), w.astype(np.float32), err_msg=str(path))
    jvae = JVL.load_vae(str(tmp_path), dtype=jnp.float32)
    tvae = TVL.load_vae(str(tmp_path), torch.float32, "cpu")
    z = np.random.default_rng(0).normal(size=(1, jcfg.z_chans, 2, 4, 4)).astype(np.float32)
    np.testing.assert_allclose(tvae.decode(torch.from_numpy(z)).numpy(), np.asarray(jvae.decode(jnp.asarray(z))), **TOL)

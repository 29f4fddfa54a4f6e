"""magi_tpu_torch.models.dit (rope, embedders, model) against
magi_tpu.models.dit on the same numpy weights, carried over with
`dit_params_from_jax`, in fp32 on the CPU.

Tolerance: 2e-5 for the single ops, 1e-4 absolute / 1e-4 relative for
whole forwards (two layers of fp32 matmuls and LayerNorms in another
summation order)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from magi_tpu.models.dit import embedders as JE
from magi_tpu.models.dit import model as JM
from magi_tpu.models.dit import rope as JR
from magi_tpu.sampling.transport import _meta as jax_meta
from magi_tpu_torch.checkpoint.from_jax import dit_params_from_jax
from magi_tpu_torch.core.config import MagiConfig
from magi_tpu_torch.models.dit import embedders as TE
from magi_tpu_torch.models.dit import model as TM
from magi_tpu_torch.models.dit import rope as TR
from magi_tpu_torch.sampling.transport import _meta as torch_meta
from tests.tiny import tiny_config

TOL = dict(atol=1e-4, rtol=1e-4)


def torch_config(cfg) -> MagiConfig:
    """The port's config with the same field values as a magi_tpu config."""
    d = {p: dataclasses.asdict(getattr(cfg, p)) for p in ("model_config", "runtime_config", "engine_config")}
    d["model_config"]["params_dtype"] = str(np.dtype(cfg.model_config.params_dtype))
    return MagiConfig.from_dict(d)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


# tiny (head_dim 16: q-norm outside the kernel) and head_dim 128 (the
# fused q prologue path of the attention wrappers)
CONFIGS = {
    "hd16": {},
    "hd128": {"model": dict(hidden_size=256, num_attention_heads=2, num_query_groups=1, kv_channels=128)},
}


def _setup(name):
    cfg = tiny_config(**CONFIGS[name])
    params = JM.init_dit_params(jax.random.PRNGKey(0), cfg)
    return cfg, torch_config(cfg), params, dit_params_from_jax(_np_tree(params))


def test_rope_and_embedders_match():
    rng = np.random.default_rng(0)
    bands = JR.default_bands(128)
    np.testing.assert_allclose(TR.default_bands(128).numpy(), np.asarray(bands), atol=0, rtol=1e-7)
    offs = np.array([0, 6, 12], np.int32)
    for got, want in zip(TR.rope_3d_segments(torch.from_numpy(np.array(bands)), torch.from_numpy(offs), 6, 5, 7),
                         JR.rope_3d_segments(bands, jnp.asarray(offs), 6, 5, 7)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5, rtol=2e-5)
    x = rng.normal(size=(20, 3, 128)).astype(np.float32)
    sin, cos = (rng.normal(size=(20, 48)).astype(np.float32) for _ in range(2))
    np.testing.assert_allclose(
        TR.apply_rotary(*map(torch.from_numpy, (x, sin, cos))).numpy(),
        np.asarray(JR.apply_rotary(*map(jnp.asarray, (x, sin, cos)))), atol=2e-5, rtol=2e-5)

    cfg = tiny_config()
    emb = JE.init_embedder_params(rng, cfg.model_config)
    temb = dit_params_from_jax(_np_tree(emb))
    t = np.array([0.1, 0.5, 0.999], np.float32)
    np.testing.assert_allclose(TE.t_embedder_forward(temb["t_embedder"], torch.from_numpy(t)).numpy(),
                               np.asarray(JE.t_embedder_forward(emb["t_embedder"], jnp.asarray(t))), atol=2e-5)
    y = rng.normal(size=(3, 32, 32)).astype(np.float32)
    for drop in (True, False, np.array([True, False, True])):
        tdrop = drop if isinstance(drop, bool) else torch.from_numpy(drop)
        for got, want in zip(TE.y_embedder_forward(temb["y_embedder"], torch.from_numpy(y), tdrop),
                             JE.y_embedder_forward(emb["y_embedder"], jnp.asarray(y), jnp.asarray(drop))):
            np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5, rtol=2e-5)
    h = rng.normal(size=(5, cfg.model_config.hidden_size)).astype(np.float32)
    np.testing.assert_allclose(TE.final_linear_forward(temb["final_linear"], torch.from_numpy(h)).numpy(),
                               np.asarray(JE.final_linear_forward(emb["final_linear"], jnp.asarray(h))), atol=2e-5)
    np.testing.assert_allclose(TE.softcap(torch.from_numpy(h), 1.0).numpy(),
                               np.asarray(JE.softcap(jnp.asarray(h), 1.0)), atol=2e-6)
    p = {"proj": {"0": {"weight": rng.normal(size=(16, 8)).astype(np.float32),
                        "bias": rng.normal(size=(8,)).astype(np.float32)}}}
    c = rng.normal(size=(3, 16)).astype(np.float32)
    np.testing.assert_allclose(TE.ada_modulate_forward(dit_params_from_jax(p), torch.from_numpy(c)).numpy(),
                               np.asarray(JE.ada_modulate_forward(p, jnp.asarray(c))), atol=2e-5)


def test_init_params_tree_and_cache_shape_match():
    cfg = tiny_config()
    jp = JM.init_dit_params(jax.random.PRNGKey(0), cfg)
    tp = TM.init_dit_params(torch_config(cfg), "cpu")
    jflat = {jax.tree_util.keystr(k): v for k, v in jax.tree_util.tree_flatten_with_path(jp)[0]}
    tflat = {jax.tree_util.keystr(k): v for k, v in jax.tree_util.tree_flatten_with_path(tp)[0]}
    assert sorted(jflat) == sorted(tflat)
    for k, v in jflat.items():
        assert tuple(tflat[k].shape) == tuple(v.shape), k
        assert str(tflat[k].dtype).replace("torch.", "") == str(np.dtype(v.dtype)), k
    assert TM.kv_cache_shape(torch_config(cfg), 96) == JM.kv_cache_shape(cfg, 96)
    x = np.random.default_rng(1).normal(size=(4, 6, 8, 8)).astype(np.float32)
    mc = cfg.model_config
    np.testing.assert_array_equal(TM.patchify(torch.from_numpy(x), mc).numpy(),
                                  np.asarray(JM.patchify(jnp.asarray(x), mc)))
    tok = np.random.default_rng(2).normal(size=(6 * 16, 16)).astype(np.float32)
    np.testing.assert_array_equal(TM.unpatchify(torch.from_numpy(tok), mc, 6, 4, 4).numpy(),
                                  np.asarray(JM.unpatchify(jnp.asarray(tok), mc, 6, 4, 4)))


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_dit_forward_with_cache_write_and_uncond(name):
    cfg, tcfg, jparams, tparams = _setup(name)
    mc = cfg.model_config
    rng = np.random.default_rng(3)
    H = W = 8
    cw = cfg.runtime_config.chunk_width
    n_seg, ctn = 3, cw * (H // 2) * (W // 2)
    x = rng.normal(size=(mc.in_channels, n_seg * cw, H, W)).astype(np.float32)
    t = rng.uniform(size=(n_seg,)).astype(np.float32)
    y = rng.normal(size=(n_seg, mc.caption_max_length, mc.caption_channels)).astype(np.float32)
    ylens = np.array([5, 32, 0], np.int32)
    cache = rng.normal(size=JM.kv_cache_shape(cfg, 5 * ctn)).astype(np.float32)

    # conditional forward: 2 chunks in the cache, this window writes 3 more
    sp = 2
    ks = np.array([0, ctn, 2 * ctn], np.int32)
    ke = np.array([3 * ctn, 4 * ctn, 5 * ctn], np.int32)
    toff = (sp + np.arange(n_seg, dtype=np.int32)) * cw
    jmeta = jax_meta(n_seg, ctn, H // 2, W // 2, sp, ks, ke, ylens, update=True, use_cache=True)
    jv, jc = JM.dit_forward(jparams, cfg, jnp.asarray(x), jnp.asarray(t), jnp.asarray(y), jnp.asarray(False),
                            jnp.asarray(cache), jmeta, jnp.asarray(toff))
    tmeta = torch_meta(n_seg, ctn, H // 2, W // 2, sp, ks, ke, ylens, update=True, use_cache=True, device="cpu")
    tv, tc = TM.dit_forward(tparams, tcfg, torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(y), False,
                            torch.from_numpy(cache.copy()), tmeta, torch.from_numpy(toff))
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), **TOL)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), **TOL)

    # unconditional forward: no cache, self-only ranges, offsets from 0
    us = np.arange(n_seg, dtype=np.int32) * ctn
    jmeta = jax_meta(n_seg, ctn, H // 2, W // 2, 0, us, us + ctn, ylens, update=False, use_cache=False)
    jv, _ = JM.dit_forward(jparams, cfg, jnp.asarray(x), jnp.asarray(t), jnp.asarray(y), jnp.asarray(True),
                           jnp.zeros(JM.kv_cache_shape(cfg, 0)), jmeta, jnp.zeros(n_seg, jnp.int32))
    tmeta = torch_meta(n_seg, ctn, H // 2, W // 2, 0, us, us + ctn, ylens, update=False, use_cache=False,
                       device="cpu")
    tv, _ = TM.dit_forward(tparams, tcfg, torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(y), True,
                           None, tmeta, torch.zeros(n_seg, dtype=torch.int32))
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), **TOL)

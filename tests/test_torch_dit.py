"""magi_tpu_torch.models.dit (rope, embedders, model) against
magi_tpu.models.dit on the same numpy weights, carried over with
`dit_params_from_jax`, in fp32 on the CPU.

Tolerance: 2e-5 for the single ops, 1e-4 absolute / 1e-4 relative for
whole forwards (two layers of fp32 matmuls and LayerNorms in another
summation order).

The distill forward on an int8 tree with int8 attention quantizes
activations, kv and the cache with the same f32 operations as the JAX
package, and layer by layer matches it to 3e-7.  Through three layers the
fp32 summation orders leave differences of about 1e-5 relative, and a
value that close to an int8 rounding edge takes the other int8 value; one
such step spreads through attention to every query of that kv token.  The
port alone moves as much when its input is perturbed by 1e-6 relative
(2.0e-4 at most, 6.1e-5 relative L2).  So the forward is held to a
relative L2 error of 2e-3 and 2e-3 absolute + 1e-2 relative per element
(outputs about 0.1; seen 4.7e-4 relative L2, 6.7e-4 at most), the bf16
cache (values about 1) to the same relative L2 and 1e-2 absolute + 1e-2
relative per element (7.4e-3 seen at most), and the int8 cache to equal values
except one step on under 1% of them (0.28% seen, in the layers after the
first), scales to 1e-2 relative (2.4e-3 seen).  The gated int4 forwards
(with and without the bf16 edge layers) are held to the same limits (seen
5.6e-6 and 2.4e-6 relative L2); the gated f32 forward to the whole-forward
tolerance above (seen 2e-7 relative L2)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from magi_tpu.models.dit import embedders as JE
from magi_tpu.models.dit import model as JM
from magi_tpu.models.dit import rope as JR
from magi_tpu.ops import quant as JQ
from magi_tpu.sampling.transport import _meta as jax_meta
from magi_tpu_torch.checkpoint.from_jax import dit_params_from_jax, kv_cache_from_jax
from magi_tpu_torch.core.config import MagiConfig
from magi_tpu_torch.models.dit import embedders as TE
from magi_tpu_torch.models.dit import model as TM
from magi_tpu_torch.models.dit import rope as TR
from magi_tpu_torch.sampling.transport import _meta as torch_meta
from tests.tiny import tiny_config
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)

TOL = dict(atol=1e-4, rtol=1e-4)


def torch_config(cfg) -> MagiConfig:
    """The port's config with the same field values as a magi_tpu config."""
    d = {p: dataclasses.asdict(getattr(cfg, p)) for p in ("model_config", "runtime_config", "engine_config")}
    d["model_config"]["params_dtype"] = str(np.dtype(cfg.model_config.params_dtype))
    return MagiConfig.from_dict(d)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


# tiny (head_dim 16: q-norm outside the kernel), head_dim 128 (the fused
# q prologue path of the attention wrappers), and the gated (SwiGLU) MLP of
# the 24B model
CONFIGS = {
    "hd16": {},
    "hd128": {"model": dict(hidden_size=256, num_attention_heads=2, num_query_groups=1, kv_channels=128)},
    "gated": {"model": dict(gated_linear_unit=True)},
}


def _setup(name):
    cfg = tiny_config(**CONFIGS[name])
    params = JM.init_dit_params(jax.random.PRNGKey(0), cfg)
    return cfg, torch_config(cfg), params, dit_params_from_jax(_np_tree(params))


def test_rope_and_embedders_match():
    """The rotary bands are held to 2 ulp: 1 / 10000**(i / 16) goes through
    an f32 `pow` on both sides, and neither XLA's code for the host CPU nor
    ATen's (SLEEF) is correctly rounded.  Against the float64 value rounded
    to f32 each sits up to about 1 ulp away (1.006 ulp at band 5, 0.869 at
    band 10), so a host whose `pow` rounds a band the other way splits the
    two by one ulp; rtol=1e-7 is below one f32 ulp and failed there.

    The atol-only checks, against the magnitudes they compare (differences
    seen on the CPU in brackets): the timestep embedder 2e-5 at outputs up
    to 0.027 (9.2e-8), the final linear 2e-5 at up to 0.44 (8.2e-8),
    softcap 2e-6 at up to 0.996 (1.8e-7, tanh on both sides) and the
    adaLN modulation 2e-5 at up to 4.6 (4.8e-7): each an f32 sum in
    another order, far below the bound, which stays."""
    rng = np.random.default_rng(0)
    bands = JR.default_bands(128)
    np.testing.assert_array_max_ulp(TR.default_bands(128).numpy(), np.asarray(bands), maxulp=2)
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
    jv = np.asarray(jv)
    assert np.linalg.norm(tv.numpy() - jv) / np.linalg.norm(jv) < 2e-3
    np.testing.assert_allclose(tv.numpy(), jv, atol=2e-3, rtol=1e-2)


@pytest.mark.parametrize("branch", ["cache_ride_along", "uncond"])
def test_attention_forward_int8_layer_matches(monkeypatch, branch):
    """One middle layer's attention_forward on an int8 tree with int8
    attention (int8 q/qx/k/v and kv_xattn linears, the per-forward
    requantized bf16 cache): on one layer nothing sits on a rounding edge
    here, and it matches to 1e-5 (fp32 summation orders)."""
    monkeypatch.setenv("MAGI_ATTN_INT8", "1")
    monkeypatch.setenv("MAGI_ATTN_INT8_STORE", "0")
    cfg = tiny_config(model=dict(num_layers=3, **CONFIGS["hd128"]["model"]))
    jparams = JQ.quantize_params_int8(JM.init_dit_params(jax.random.PRNGKey(0), cfg))
    tparams = dit_params_from_jax(_np_tree(jparams))
    jblk = jax.tree.map(lambda a: a[1], jparams["blocks"])["self_attention"]
    tblk = TM.layer_params(tparams["blocks"], 1)["self_attention"]
    mc = cfg.model_config
    rng = np.random.default_rng(7)
    ctn, n_seg = 32, 3
    S = n_seg * ctn
    x = rng.normal(size=(S, mc.hidden_size)).astype(np.float32)
    yx = rng.normal(size=(n_seg, mc.caption_max_length, mc.hidden_size)).astype(np.float32)
    ang = rng.normal(size=(S, 48)).astype(np.float32)
    sin, cos = np.sin(ang), np.cos(ang)
    ylens = np.array([5, 20, 5], np.int32)
    if branch == "uncond":
        ks = np.arange(n_seg, dtype=np.int32) * ctn
        ke, sp, kw = ks + ctn, 0, dict(update=False, use_cache=False)
        jcache = tcache = None
    else:
        sp, vmax = 2, 4 * ctn
        ks, ke = np.array([ctn, 0, vmax], np.int32), np.array([3 * ctn, 4 * ctn, vmax + ctn], np.int32)
        kw = dict(update=True, use_cache=True, distill_nearly=True)
        prev = rng.normal(size=(2, mc.num_query_groups, 5 * ctn, mc.kv_channels)).astype(np.float32)
        jcache, tcache = jnp.asarray(prev), torch.from_numpy(prev.copy())
    jmeta = jax_meta(n_seg, ctn, 4, 4, sp, ks, ke, ylens, **kw)
    tmeta = torch_meta(n_seg, ctn, 4, 4, sp, ks, ke, ylens, device="cpu", **kw)
    jc, jx, jnew = JM.attention_forward(jblk, mc, jnp.asarray(x), jnp.asarray(yx), jnp.asarray(sin), jnp.asarray(cos),
                                        jcache, jmeta, False, True)
    tc, tx = TM.attention_forward(tblk, mc, torch.from_numpy(x), torch.from_numpy(yx), torch.from_numpy(sin),
                                  torch.from_numpy(cos), tcache, tmeta, True, True, False)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), atol=1e-5, rtol=1e-5)
    if tcache is not None:
        np.testing.assert_allclose(tcache.numpy(), np.asarray(jnew), atol=1e-5, rtol=1e-5)


def _quantized_distill_forward_check(monkeypatch, store, quantize, model=None):
    """A distill forward (distill_factor) of a quantized tree (three layers:
    the middle one on int8 activations, the edges bf16 from blocks_edge or,
    without it, bf16 activations on the dequantized weights) with int8
    attention, with the int8-stored cache (store "1") or a bf16 cache
    quantized every forward (store "0"); it writes the cache and carries
    the ride-along chunk, which attends only itself and is not written.
    `quantize` makes the JAX package's quantized tree from its bf16 one."""
    monkeypatch.setenv("MAGI_ATTN_INT8", "1")
    monkeypatch.setenv("MAGI_ATTN_INT8_STORE", store)
    cfg = tiny_config(model=dict(num_layers=3, **(model or {})), runtime=dict(cfg_number=1),
                      engine=dict(distill=True, fp8_quant=True))
    tcfg = torch_config(cfg)
    jparams = quantize(JM.init_dit_params(jax.random.PRNGKey(0), cfg))
    tparams = dit_params_from_jax(_np_tree(jparams))
    mc = cfg.model_config
    rng = np.random.default_rng(4)
    H = W = 8
    cw = cfg.runtime_config.chunk_width
    n_seg, ctn = 3, cw * (H // 2) * (W // 2)  # two denoised chunks + the ride-along copy
    x = rng.normal(size=(mc.in_channels, n_seg * cw, H, W)).astype(np.float32)
    t = rng.uniform(size=(n_seg,)).astype(np.float32)
    y = rng.normal(size=(n_seg, mc.caption_max_length, mc.caption_channels)).astype(np.float32)
    ylens = np.array([5, 32, 5], np.int32)
    jcache = JM.init_kv_cache(cfg, 5 * ctn)
    assert isinstance(jcache, dict) == (store == "1")
    # earlier chunks in the cache: random, then the JAX package's own
    # quantization of them when the cache is int8
    prev = rng.normal(size=JM.kv_cache_shape(cfg, 5 * ctn)).astype(np.float32)
    if store == "1":
        from magi_tpu.ops.attention_q8 import quantize_kv_per_token

        kv8, sc = jax.vmap(quantize_kv_per_token)(jnp.asarray(prev))
        jcache = {"kv": kv8, "scale": sc}
    else:
        jcache = jnp.asarray(prev)
    tcache = kv_cache_from_jax(_np_tree(jcache))
    if store == "1":
        assert tcache["kv"].dtype == torch.int8 and tcache["scale"].dtype == torch.float32

    sp = 2
    vmax = (sp + n_seg - 1) * ctn  # the ride-along segment attends only itself
    ks = np.array([ctn, 0, vmax], np.int32)
    ke = np.array([3 * ctn, 4 * ctn, vmax + ctn], np.int32)
    toff = (sp + np.arange(n_seg, dtype=np.int32)) * cw
    kw = dict(update=True, use_cache=True, distill_nearly=True)
    jmeta = jax_meta(n_seg, ctn, H // 2, W // 2, sp, ks, ke, ylens, **kw)
    jv, jc = JM.dit_forward(jparams, cfg, jnp.asarray(x), jnp.asarray(t), jnp.asarray(y), jnp.asarray(False),
                            jcache, jmeta, jnp.asarray(toff), distill_factor=jnp.float32(4.0))
    tmeta = torch_meta(n_seg, ctn, H // 2, W // 2, sp, ks, ke, ylens, device="cpu", **kw)
    tv, tc = TM.dit_forward(tparams, tcfg, torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(y), False,
                            tcache, tmeta, torch.from_numpy(toff), distill_factor=4.0)
    jv = np.asarray(jv)
    assert np.linalg.norm(tv.numpy() - jv) / np.linalg.norm(jv) < 2e-3
    np.testing.assert_allclose(tv.numpy(), jv, atol=2e-3, rtol=1e-2)
    if store == "1":
        dq = tc["kv"].numpy().astype(np.int32) - np.asarray(jc["kv"], np.int32)
        assert np.abs(dq).max() <= 1 and (dq != 0).mean() < 1e-2, (np.abs(dq).max(), (dq != 0).mean())
        np.testing.assert_allclose(tc["scale"].numpy(), np.asarray(jc["scale"]), rtol=1e-2, atol=0)
    else:
        jc = np.asarray(jc)
        assert np.linalg.norm(tc.numpy() - jc) / np.linalg.norm(jc) < 2e-3
        np.testing.assert_allclose(tc.numpy(), jc, atol=1e-2, rtol=1e-2)
    with pytest.raises(ValueError, match="distill_factor"):
        TM.dit_forward(tparams, tcfg, torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(y), False,
                       tcache, tmeta, torch.from_numpy(toff))


@pytest.mark.parametrize("store", ["1", "0"])
def test_dit_forward_int8_distill_matches(monkeypatch, store):
    """The int8 tree (edge layers from blocks_edge) with int8 attention."""
    _quantized_distill_forward_check(monkeypatch, store, JQ.quantize_params_int8)


@pytest.mark.parametrize("edge", [True, False])
def test_dit_forward_int4_gated_distill_matches(monkeypatch, edge):
    """The 24B's tree at tiny width: a gated MLP on nibble-packed int4
    weights (w4a8) with the int8-stored cache, with the bf16 edge layers of
    blocks_edge, or without them (edge layers on the dequant GEMM, K7's
    plain version; the middle layer's fc2 input through K8s's)."""
    _quantized_distill_forward_check(
        monkeypatch, "1", lambda p: JQ.quantize_params_int4(p, keep_edge_bf16=edge), model=dict(gated_linear_unit=True))


def test_dit_uncond_forward_int8_attention_matches(monkeypatch):
    """The no-cache (uncond CFG) forward with int8 attention: an empty first
    source, the current window quantized per token.  A float tree, so only
    the attention is int8; held as the int8 forward above (one kv value on
    a rounding edge moves the outputs of every query of its segment; the
    port alone moves 1.8e-4 under a 1e-6 relative input perturbation)."""
    monkeypatch.setenv("MAGI_ATTN_INT8", "1")
    cfg, tcfg, jparams, tparams = _setup("hd128")
    mc = cfg.model_config
    rng = np.random.default_rng(6)
    H = W = 8
    cw = cfg.runtime_config.chunk_width
    n_seg, ctn = 2, cw * (H // 2) * (W // 2)
    x = rng.normal(size=(mc.in_channels, n_seg * cw, H, W)).astype(np.float32)
    t = rng.uniform(size=(n_seg,)).astype(np.float32)
    y = rng.normal(size=(n_seg, mc.caption_max_length, mc.caption_channels)).astype(np.float32)
    ylens = np.array([32, 9], np.int32)
    us = np.arange(n_seg, dtype=np.int32) * ctn
    jmeta = jax_meta(n_seg, ctn, H // 2, W // 2, 0, us, us + ctn, ylens, update=False, use_cache=False)
    jv, _ = JM.dit_forward(jparams, cfg, jnp.asarray(x), jnp.asarray(t), jnp.asarray(y), jnp.asarray(True),
                           JM.init_kv_cache(cfg, 0), jmeta, jnp.zeros(n_seg, jnp.int32))
    tmeta = torch_meta(n_seg, ctn, H // 2, W // 2, 0, us, us + ctn, ylens, update=False, use_cache=False,
                       device="cpu")
    tv, _ = TM.dit_forward(tparams, tcfg, torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(y), True,
                           None, tmeta, torch.zeros(n_seg, dtype=torch.int32))
    jv = np.asarray(jv)
    assert np.linalg.norm(tv.numpy() - jv) / np.linalg.norm(jv) < 2e-3
    np.testing.assert_allclose(tv.numpy(), jv, atol=2e-3, rtol=1e-2)

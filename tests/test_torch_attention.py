"""magi_tpu_torch.ops.attention (plain PyTorch versions of K1, K2/K2g, K3)
against magi_tpu.ops.attention's Pallas kernels in interpret mode and its
jnp references, in fp32 on the CPU.

Tolerance: 2e-5 absolute and relative.  Both sides compute in fp32; they
differ only in summation order and in the exp2-domain online softmax of
the Pallas kernels (a few fp32 ulps)."""

import functools
import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from magi_tpu.ops import attention as J
from magi_tpu_torch.ops import attention as T
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)

TOL = dict(atol=2e-5, rtol=2e-5)
J2 = functools.partial(J.segmented_attention_two_source, interpret=True, block_q=128, block_k=128)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _prologue(rng, S, hd, rot):
    w = rng.normal(size=(hd,)).astype(np.float32)
    b = (0.1 * rng.normal(size=(hd,))).astype(np.float32)
    if not rot:
        return (w, b, None, None, 1e-6)
    ang = rng.uniform(0, 6.28, size=(S, rot)).astype(np.float32)
    return (w, b, np.sin(ang), np.cos(ang), 1e-6)


def _jpro(p):
    return None if p is None else tuple(None if a is None else (jnp.asarray(a) if not isinstance(a, float) else a)
                                         for a in p)


def _tpro(p):
    return None if p is None else tuple(None if a is None else (_t(a) if not isinstance(a, float) else a) for a in p)


# K1: (n_seg, seg_len, L1, L2, hq, hk, hd, rot, r1, r2)
TWO_SOURCE_CASES = {
    # the ARDF step: cache [0, C0) + current window, GQA 3:1, fused prologue
    "cache_plus_current": (2, 40, 64, 80, 6, 2, 128, 48, [(0, 64), (24, 64)], [(0, 40), (0, 80)]),
    # the uncond branch: a zero-token cache, self-only ranges
    "empty_source1": (3, 40, 0, 120, 4, 2, 128, 48, [(0, 0)] * 3, [(0, 40), (40, 80), (80, 120)]),
    # noise2clean split across the source boundary, ranges in mid-tile
    "mid_tile_split": (2, 37, 100, 74, 4, 4, 128, 0, [(13, 100), (100, 100)], [(5, 37), (0, 74)]),
    "empty_ranges": (2, 16, 32, 32, 2, 1, 128, 48, [(0, 0), (0, 0)], [(0, 0), (3, 19)]),
    "head_dim_64": (2, 33, 50, 66, 4, 2, 64, 0, [(0, 50), (10, 20)], [(0, 33), (7, 66)]),
}


@pytest.mark.parametrize("case", sorted(TWO_SOURCE_CASES))
def test_two_source_matches_pallas_and_reference(case):
    n_seg, seg_len, L1, L2, hq, hk, hd, rot, r1, r2 = TWO_SOURCE_CASES[case]
    rng = np.random.default_rng(zlib.crc32(case.encode()))
    S = n_seg * seg_len
    q = rng.normal(size=(S, hq, hd)).astype(np.float32)
    kv1 = rng.normal(size=(2, hk, L1, hd)).astype(np.float32)
    kv2 = rng.normal(size=(2, hk, L2, hd)).astype(np.float32)
    rs = [np.asarray([r[i] for r in rr], np.int32) for rr in (r1, r2) for i in (0, 1)]
    pro = _prologue(rng, S, hd, rot) if rot else None  # the JAX two-source prologue always ropes

    got = T.segmented_attention_two_source(_t(q), _t(kv1), _t(kv2), *map(_t, rs), seg_len=seg_len,
                                           q_prologue=_tpro(pro)).numpy()
    want = np.asarray(J2(jnp.asarray(q), jnp.asarray(kv1), jnp.asarray(kv2), *map(jnp.asarray, rs),
                         seg_len=seg_len, q_prologue=_jpro(pro)))
    np.testing.assert_allclose(got, want, **TOL)
    if pro is None:
        ref = np.asarray(J.segmented_attention_two_source_reference(
            jnp.asarray(q), jnp.asarray(kv1), jnp.asarray(kv2), *map(jnp.asarray, rs), seg_len=seg_len))
        np.testing.assert_allclose(got, ref, **TOL)
    for i, (a, b) in enumerate(zip(*rs[:2])):
        if a == b and rs[2][i] == rs[3][i]:
            np.testing.assert_array_equal(got[i * seg_len : (i + 1) * seg_len], 0.0)


# K2 / K2g: (n_seg, seg_len, kv_len, hq, hk, hd, ranges, norm-only prologue)
SINGLE_SOURCE_CASES = {
    # the DiT caption cross-attention: caption slabs of L, one empty
    "caption_v2": (3, 24, 3 * 20, 6, 2, 128, [(0, 7), (20, 40), (40, 40)], True),
    "caption_v2_no_prologue": (2, 30, 2 * 20, 4, 4, 128, [(0, 20), (25, 31)], False),
    # the VAE self-attention: hd 64, unaligned seg_len, one segment per tile
    "vae_hd64": (2, 49, 98, 4, 4, 64, [(0, 49), (49, 98)], False),
}


@pytest.mark.parametrize("case", sorted(SINGLE_SOURCE_CASES))
def test_single_source_matches_pallas_and_reference(case):
    n_seg, seg_len, kv_len, hq, hk, hd, ranges, norm = SINGLE_SOURCE_CASES[case]
    rng = np.random.default_rng(zlib.crc32(case.encode()))
    S = n_seg * seg_len
    q = rng.normal(size=(S, hq, hd)).astype(np.float32)
    k = rng.normal(size=(kv_len, hk, hd)).astype(np.float32)
    v = rng.normal(size=(kv_len, hk, hd)).astype(np.float32)
    st = np.asarray([a for a, _ in ranges], np.int32)
    en = np.asarray([b for _, b in ranges], np.int32)
    pro = _prologue(rng, S, hd, 0) if norm else None
    args_t = (_t(q), _t(k), _t(v), _t(st), _t(en))
    args_j = tuple(map(jnp.asarray, (q, k, v, st, en)))

    got = T.segmented_attention_v2(*args_t, seg_len=seg_len, q_prologue=_tpro(pro)).numpy()
    want = np.asarray(J.segmented_attention_v2(*args_j, seg_len=seg_len, interpret=True, q_prologue=_jpro(pro)))
    np.testing.assert_allclose(got, want, **TOL)
    if hd % 128:
        # the grid kernel (v2 falls back to it at this head_dim)
        grid_t = T.segmented_attention(*args_t, seg_len=seg_len).numpy()
        grid_j = np.asarray(J.segmented_attention(*args_j, seg_len=seg_len, interpret=True, block_q=128,
                                                  block_k=128))
        np.testing.assert_allclose(grid_t, grid_j, **TOL)
    if pro is None:
        ref = np.asarray(J.segmented_attention_reference(*args_j, seg_len=seg_len))
        np.testing.assert_allclose(got, ref, **TOL)


def test_single_source_prologue_at_head_dim_64():
    """The port's v2 takes the norm-only prologue at head_dim 64 (the Pallas
    v2 refuses it there): it equals the grid kernel on the normalised q."""
    rng = np.random.default_rng(64)
    n_seg, seg_len, hq, hk, hd = 2, 21, 4, 2, 64
    q = rng.normal(size=(n_seg * seg_len, hq, hd)).astype(np.float32)
    k = rng.normal(size=(50, hk, hd)).astype(np.float32)
    v = rng.normal(size=(50, hk, hd)).astype(np.float32)
    st, en = np.asarray([0, 20], np.int32), np.asarray([17, 50], np.int32)
    w, b, _, _, eps = _prologue(rng, q.shape[0], hd, 0)
    mean = q.mean(-1, keepdims=True)
    qn = (q - mean) / np.sqrt(np.square(q - mean).mean(-1, keepdims=True) + eps) * w + b
    got = T.segmented_attention_v2(_t(q), _t(k), _t(v), _t(st), _t(en), seg_len=seg_len,
                                   q_prologue=(_t(w), _t(b), None, None, eps)).numpy()
    want = np.asarray(J.segmented_attention(*map(jnp.asarray, (qn, k, v, st, en)), seg_len=seg_len,
                                            interpret=True, block_q=128, block_k=128))
    np.testing.assert_allclose(got, want, **TOL)


def test_ranges_clip_to_sources():
    """Ranges past a source's tokens (or before its start) are clipped to
    the source: the same output as the clipped ranges through the Pallas
    kernels."""
    rng = np.random.default_rng(7)
    n_seg, seg_len, hq, hk, hd, L1, L2 = 3, 20, 4, 2, 128, 30, 40
    q = rng.normal(size=(n_seg * seg_len, hq, hd)).astype(np.float32)
    kv1 = rng.normal(size=(2, hk, L1, hd)).astype(np.float32)
    kv2 = rng.normal(size=(2, hk, L2, hd)).astype(np.float32)
    rs = [np.asarray(r, np.int32) for r in ([-5, 20, 60], [L1 + 9, L1 + 1, 90], [-3, 35, 0], [L2 + 64, L2 + 9, 10])]
    clipped = [np.clip(r, 0, n) for r, n in zip(rs, (L1, L1, L2, L2))]
    got = T.segmented_attention_two_source(_t(q), _t(kv1), _t(kv2), *map(_t, rs), seg_len=seg_len).numpy()
    want = np.asarray(J2(jnp.asarray(q), jnp.asarray(kv1), jnp.asarray(kv2), *map(jnp.asarray, clipped),
                         seg_len=seg_len))
    np.testing.assert_allclose(got, want, **TOL)
    k, v = np.ascontiguousarray(kv2[0].transpose(1, 0, 2)), np.ascontiguousarray(kv2[1].transpose(1, 0, 2))
    got = T.segmented_attention(_t(q), _t(k), _t(v), _t(rs[2]), _t(rs[3]), seg_len=seg_len).numpy()
    want = np.asarray(J.segmented_attention(*map(jnp.asarray, (q, k, v, clipped[2], clipped[3])), seg_len=seg_len,
                                            interpret=True, block_q=128, block_k=128))
    np.testing.assert_allclose(got, want, **TOL)


# (rep, rot, S, block_s): S off the Pallas kernel's token block, at a
# block of 64 and at its default 512
KV_PACK_CASES = [(1, 48, 70, 64), (2, 48, 70, 64), (1, 0, 70, 64), (2, 48, 600, 512), (1, 0, 600, 512)]


@pytest.mark.parametrize("rep,rot,S,block_s", [
    pytest.param(*c, id=f"{c[0]}-{c[1]}" + ("" if c[2] == 70 else f"-S{c[2]}")) for c in KV_PACK_CASES])
def test_kv_norm_rope_pack_matches_pallas(rep, rot, S, block_s):
    rng = np.random.default_rng(rep * 100 + rot + (S != 70))
    hk, hd = 2, 128
    k = rng.normal(size=(S, hk, hd)).astype(np.float32)
    v = rng.normal(size=(S, hk, hd)).astype(np.float32)
    kw = rng.normal(size=(hd,)).astype(np.float32)
    kb = rng.normal(size=(hd,)).astype(np.float32)
    ang = rng.uniform(0, 6.28, size=(S, max(rot, 1))).astype(np.float32)
    sin, cos = (np.sin(ang), np.cos(ang)) if rot else (None, None)
    got = T.kv_norm_rope_pack(_t(k), _t(v), _t(kw), _t(kb), None if sin is None else _t(sin),
                              None if cos is None else _t(cos), eps=1e-6, rep=rep).numpy()
    jargs = [jnp.asarray(a) for a in (k, v, kw, kb)] + [None if a is None else jnp.asarray(a) for a in (sin, cos)]
    want = np.asarray(J.kv_norm_rope_pack(*jargs, eps=1e-6, rep=rep, block_s=block_s, interpret=True))
    assert got.shape == want.shape == (2, hk * rep, S, hd)
    np.testing.assert_allclose(got, want, **TOL)
    ref = np.asarray(J.kv_norm_rope_pack_reference(*jargs, eps=1e-6, rep=rep))
    np.testing.assert_allclose(got, ref, **TOL)


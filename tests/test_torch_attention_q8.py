"""magi_tpu_torch.ops.attention_q8 and the int8 kv pack (the plain
versions of K5 and K3q) against magi_tpu.ops.attention_q8 and
ops.attention, Pallas kernels in interpret mode with blocks of 128, on the
CPU.

Tolerances:
* `quantize_kv_per_token` is exact (int8 equal, scales to 1e-6 relative).
* The dequant reference matches the JAX package's to 2e-5 (fp32 on both
  sides, another summation order).
* The sage and dq plain versions at tile 128 against the Pallas kernel
  of the same scheme at block_k 128: 2e-3 absolute + 1e-2 relative.  They
  walk the same tiles with the same online softmax, so what differs is
  summation order (the LayerNorm, the bf16 dot of dq, the row sums) and
  exp2's last bits; for sage such a difference can flip one p8 step,
  which moves an output by at most max|v| / 127 * p / l, under 1e-3 at
  these spans.
* The qk8 plain version against the Pallas qk8 kernel: 2e-3 absolute +
  1e-2 relative, on outputs of about 0.05 to 0.1 (spans of 128 to 512
  keys).  Both quantize q the same way, but the plain version rounds
  p * sv to bf16 against each row's global max where the kernel rounds it
  against a running max (and XLA on the CPU may keep the kernel's bf16
  intermediates in f32): bf16 roundings of p, 2**-9 relative each.  A q
  element on a rounding edge may also move by one int8 step when the two
  LayerNorms sum in different orders.
* The K3q plain version (k quantized from its f32 normed, roped values)
  against `kv_norm_rope_pack(quantize=True)` in interpret mode: int8 equal
  except one step on under 1e-3 of the values (the LayerNorm in another
  summation order), scales to 1e-6 relative."""

import functools
import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from magi_tpu.ops import attention as JA
from magi_tpu.ops import attention_q8 as J8
from magi_tpu_torch.ops import attention as TA
from magi_tpu_torch.ops import attention_q8 as T8
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)

QK8_TOL = dict(atol=2e-3, rtol=1e-2)
J8K = functools.partial(J8.segmented_attention_two_source_q8, interpret=True, block_q=128, block_k=128)
TILED_TOL = dict(atol=2e-3, rtol=1e-2)


def _t(a):
    return torch.from_numpy(np.array(a))


def _bf16(a):
    """numpy f32 values rounded to bf16 (as f32), the kernels' q dtype."""
    return np.asarray(jnp.asarray(a, jnp.bfloat16), np.float32)


def _quantized_kv(rng, hk, L, hd):
    kv, sc = J8.quantize_kv_per_token(jnp.asarray(rng.standard_normal((2, hk, L, hd)), jnp.bfloat16))
    return np.asarray(kv), np.asarray(sc)


def test_quantize_kv_per_token_matches():
    rng = np.random.default_rng(0)
    kv = (rng.normal(size=(2, 3, 50, 64)) * rng.uniform(0.1, 5, size=(2, 3, 50, 1))).astype(np.float32)
    kv[0, 1, 7] = 0.0  # a zero token: scale 1e-8 / 127, values 0
    got8, got_sc = T8.quantize_kv_per_token(_t(kv))
    want8, want_sc = J8.quantize_kv_per_token(jnp.asarray(kv))
    np.testing.assert_array_equal(got8.numpy(), np.asarray(want8))
    np.testing.assert_allclose(got_sc.numpy(), np.asarray(want_sc), rtol=1e-6, atol=0)


# (n_seg, seg_len, L1, L2, hq, hk, r1, r2, prologue rot): the JAX package's
# q8 kernel test cases
CASES = {
    "basic_two_source": (3, 128, 256, 384, 4, 2, [(0, 256), (0, 200), (100, 100)], [(0, 128), (0, 256), (0, 384)],
                         None),
    "empty_ranges_mid_tile": (2, 128, 256, 256, 4, 2, [(200, 200), (0, 256)], [(0, 256), (70, 70)], None),
    "gqa_fold": (2, 128, 256, 256, 8, 2, [(0, 256), (64, 192)], [(0, 128), (0, 256)], None),
    "fused_q_prologue": (2, 128, 256, 256, 4, 2, [(0, 256), (0, 128)], [(0, 128), (0, 256)], 32),
    "all_empty_segment": (2, 128, 128, 128, 4, 2, [(0, 0), (0, 100)], [(5, 5), (0, 128)], 32),
}


def _case_inputs(case):
    n_seg, seg_len, L1, L2, hq, hk, r1, r2, rot = CASES[case]
    hd = 128
    rng = np.random.default_rng(zlib.crc32(case.encode()))
    S = n_seg * seg_len
    q = _bf16(rng.standard_normal((S, hq, hd)))
    kv1, sc1 = _quantized_kv(rng, hk, L1, hd)
    kv2, sc2 = _quantized_kv(rng, hk, L2, hd)
    rs = [np.asarray([r[i] for r in rr], np.int32) for rr in (r1, r2) for i in (0, 1)]
    pro = None
    if rot:
        ang = rng.standard_normal((S, rot)).astype(np.float32)
        pro = ((rng.standard_normal(hd) * 0.1 + 1.0).astype(np.float32),
               (rng.standard_normal(hd) * 0.05).astype(np.float32), np.sin(ang), np.cos(ang), 1e-6)
    jpro = None if pro is None else tuple(jnp.asarray(a) if isinstance(a, np.ndarray) else a for a in pro)
    tpro = None if pro is None else tuple(_t(a) if isinstance(a, np.ndarray) else a for a in pro)
    jargs = (jnp.asarray(q, jnp.bfloat16), *map(jnp.asarray, (kv1, sc1, kv2, sc2)), *map(jnp.asarray, rs))
    targs = (_t(q).to(torch.bfloat16), *map(_t, (kv1, sc1, kv2, sc2)), *map(_t, rs))
    return n_seg, seg_len, rs, jargs, jpro, targs, tpro


@pytest.mark.parametrize("case", sorted(CASES))
def test_qk8_plain_matches_pallas(case):
    n_seg, seg_len, rs, jargs, jpro, targs, tpro = _case_inputs(case)
    want = np.asarray(J8K(*jargs, seg_len=seg_len, q_prologue=jpro, scheme="qk8"), np.float32)
    got = T8.segmented_attention_two_source_q8_qk8_reference(*targs, seg_len=seg_len, q_prologue=tpro)
    np.testing.assert_allclose(got.float().numpy(), want, **QK8_TOL)
    # the wrapper on CPU tensors is this plain version
    wrapped = T8.segmented_attention_two_source_q8(*targs, seg_len=seg_len, q_prologue=tpro, scheme="qk8")
    np.testing.assert_array_equal(wrapped.float().numpy(), got.float().numpy())
    for i in range(n_seg):
        if rs[0][i] == rs[1][i] and rs[2][i] == rs[3][i]:
            assert not got[i * seg_len : (i + 1) * seg_len].float().any()


TILED = {"sage": T8.segmented_attention_two_source_q8_sage_reference,
         "dq": T8.segmented_attention_two_source_q8_dq_reference}


@pytest.mark.parametrize("scheme", sorted(TILED))
@pytest.mark.parametrize("case", sorted(CASES))
def test_tiled_plain_matches_pallas(case, scheme):
    """The sage and dq plain versions, tile 128, against the Pallas kernel
    of the same scheme in interpret mode at block_k 128."""
    n_seg, seg_len, rs, jargs, jpro, targs, tpro = _case_inputs(case)
    want = np.asarray(J8K(*jargs, seg_len=seg_len, q_prologue=jpro, scheme=scheme), np.float32)
    got = TILED[scheme](*targs, seg_len=seg_len, q_prologue=tpro, block_k=128)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, **TILED_TOL)
    for i in range(n_seg):
        if rs[0][i] == rs[1][i] and rs[2][i] == rs[3][i]:
            assert not got[i * seg_len : (i + 1) * seg_len].float().any()


def test_dequant_reference_matches():
    rng = np.random.default_rng(11)
    n_seg, seg_len, hq, hk, hd = 2, 24, 4, 2, 16
    q = rng.normal(size=(n_seg * seg_len, hq, hd)).astype(np.float32)
    kv1, sc1 = _quantized_kv(rng, hk, 30, hd)
    kv2, sc2 = _quantized_kv(rng, hk, 48, hd)
    rs = [np.asarray(r, np.int32) for r in ([0, 10], [30, 20], [0, 5], [24, 48])]
    want = J8.segmented_attention_two_source_q8_reference(
        jnp.asarray(q), *map(jnp.asarray, (kv1, sc1, kv2, sc2)), *map(jnp.asarray, rs), seg_len=seg_len)
    got = T8.segmented_attention_two_source_q8_reference(_t(q), *map(_t, (kv1, sc1, kv2, sc2)), *map(_t, rs),
                                                         seg_len=seg_len)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5, rtol=2e-5)


def test_scheme_switch(monkeypatch):
    """`MAGI_ATTN_Q8_SCHEME` picks the scheme; on CPU tensors the wrapper
    returns that scheme's plain version (sage and dq at the kernel's tile
    width)."""
    monkeypatch.delenv("MAGI_ATTN_Q8_SCHEME", raising=False)
    assert T8.default_scheme() == "qk8"
    _, seg_len, _, _, _, targs, tpro = _case_inputs("fused_q_prologue")
    plain = {"qk8": T8.segmented_attention_two_source_q8_qk8_reference,
             "sage": functools.partial(TILED["sage"], block_k=T8.KERNEL_BLOCK_K),
             "dq": functools.partial(TILED["dq"], block_k=T8.KERNEL_BLOCK_K)}
    outs = {}
    for scheme in ("sage", "qk8", "dq"):
        monkeypatch.setenv("MAGI_ATTN_Q8_SCHEME", scheme)
        assert T8.default_scheme() == scheme
        outs[scheme] = T8.segmented_attention_two_source_q8(*targs, seg_len=seg_len, q_prologue=tpro)
        want = plain[scheme](*targs, seg_len=seg_len, q_prologue=tpro)
        np.testing.assert_array_equal(outs[scheme].float().numpy(), want.float().numpy())
    assert not torch.equal(outs["sage"], outs["qk8"]) and not torch.equal(outs["dq"], outs["qk8"])
    monkeypatch.setenv("MAGI_ATTN_Q8_SCHEME", "int4")
    with pytest.raises(ValueError, match="MAGI_ATTN_Q8_SCHEME"):
        T8.default_scheme()


# (rep, rot, S, block_s): S off the Pallas kernel's token block, at a
# block of 64 and at its default 512
KV_PACK_Q8_CASES = [(1, 48, 70, 64), (2, 0, 70, 64), (1, 0, 70, 64), (2, 48, 70, 64), (2, 48, 600, 512),
                    (1, 0, 600, 512)]


@pytest.mark.parametrize("rep,rot,S,block_s", [
    pytest.param(*c, id=f"{c[0]}-{c[1]}" + ("" if c[2] == 70 else f"-S{c[2]}")) for c in KV_PACK_Q8_CASES])
def test_kv_norm_rope_pack_q8_matches_pallas(rep, rot, S, block_s):
    rng = np.random.default_rng(rep * 10 + rot + (S != 70))
    hk, hd = 2, 128
    k = _bf16(rng.normal(size=(S, hk, hd)))
    v = _bf16(rng.normal(size=(S, hk, hd)))
    kw = rng.normal(size=(hd,)).astype(np.float32)
    kb = rng.normal(size=(hd,)).astype(np.float32)
    ang = rng.uniform(0, 6.28, size=(S, max(rot, 1))).astype(np.float32)
    sin, cos = (np.sin(ang), np.cos(ang)) if rot else (None, None)
    jargs = [jnp.asarray(a, jnp.bfloat16) for a in (k, v)] + [jnp.asarray(a) for a in (kw, kb)]
    jargs += [None if a is None else jnp.asarray(a) for a in (sin, cos)]
    want8, want_sc = JA.kv_norm_rope_pack(*jargs, eps=1e-6, rep=rep, block_s=block_s, quantize=True,
                                          interpret=True)
    targs = [_t(a).to(torch.bfloat16) for a in (k, v)] + [_t(a) for a in (kw, kb)]
    targs += [None if a is None else _t(a) for a in (sin, cos)]
    for got8, got_sc in (TA.kv_norm_rope_pack_q8_reference(*targs, eps=1e-6, rep=rep),
                         TA.kv_norm_rope_pack(*targs, eps=1e-6, rep=rep, quantize=True)):
        assert got8.dtype == torch.int8 and tuple(got8.shape) == want8.shape == (2, hk * rep, S, hd)
        np.testing.assert_allclose(got_sc.numpy(), np.asarray(want_sc), rtol=1e-6, atol=0)
        dq = got8.numpy().astype(np.int32) - np.asarray(want8, np.int32)
        assert np.abs(dq).max() <= 1 and (dq != 0).mean() < 1e-3, (np.abs(dq).max(), (dq != 0).mean())

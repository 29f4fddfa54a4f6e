"""magi_tpu_torch.ops.quant and ops.act_quant (int8 and int4 weights,
row quantization, the plain versions of K6, K7, K8 and K8s) against
magi_tpu.ops.quant and ops.act_quant, Pallas kernels in interpret mode
with blocks of 128, on the CPU.

Tolerances: the int8 trees, the row quantization and the int8 GEMM are
exact against the JAX package's plain versions (the same f32 operations in
the same order: int8 values equal, scales equal to 1e-6 relative, GEMM
outputs equal).  Against the Pallas row-quantization kernel in interpret
mode, which XLA may compute as x * (1 / scale), an int8 value may differ by
one on under 1e-3 of the elements (quotients on a rounding tie), the
criterion of the JAX package's own test of that kernel.  K8's "ln" mode takes
its LayerNorm statistics in float64 (so the CUDA kernel matches it bit for
bit in any summation order) where the JAX package takes them in f32: an
element whose LayerNorm output sits on a bf16 rounding edge can move by
one bf16 step, so its int8 value may differ by one on under 1e-3 of the
elements; a row's scale is equal to 1e-6 relative unless its bf16 maximum
moved, and then that maximum is one bf16 step away (on these inputs none
moved).  The JAX package's own test of that kernel allows the same
one-step differences.  `_linears_shared` on int8 weights matches within
1e-5 (the LayerNorm in another summation order can flip an int8 value at
a rounding edge; none does on these inputs).

Weight quantization (int8 and int4) takes its scale as amax * f32(1 / qmax),
which is how XLA compiles the JAX package's `amax / qmax` inside its
jitted tree quantization; the JAX package's eager `quantize_int4` divides
instead and moves about 0.3% of bf16 weights, those on a rounding tie, by
one step.  So the port's weights, packed bytes and unpacked int8 values
are equal to the jitted JAX package's.  K7's plain version is the JAX
package's reference, the scale applied to the weight before the sum: in
f32 it matches that reference to 1e-6 and the Pallas kernel, which
applies the scale after the sum, to 1e-5 relative; in bf16 both within one
bf16 step (2**-7 relative, 1e-3 absolute).  K8s's plain version equals the
JAX package's reference chain; against the Pallas kernel in interpret
mode its int8 values are one step apart on under 1e-3 of the elements and
its scales within one bf16 step (seen: within 1e-6), because the two
compute silu's f32 value by other formulas (x / (1 + exp(-x)) against
x * sigmoid(x)), which can differ in the last bit and move an element
across a bf16 rounding edge.

The smooth-quant fold (s·W quantized per layer, `act_smooth` from an fp8
checkpoint) is bit-equal to the JAX package's jitted
`_quantize_stacked_smooth` / `_quantize_stacked4_smooth`, k-major;
`_linears_shared` with `act_smooth` (the divide by s after the producer,
inside the row quantization of the int8 branch or before the dequant
branch) matches within 1e-5, as the other int8 groups.  The row
quantization's plain version with s is its documented chain bit for bit
(the producer rounded to bf16, then f32(y) * (1 / s) rounded to bf16, then
q8), and for "plain" and "swiglu" the JAX package's chain too."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from magi_tpu.models.dit import model as JM
from magi_tpu.ops import act_quant as JA
from magi_tpu.ops import quant as JQ
from magi_tpu_torch.checkpoint.from_jax import dit_params_from_jax
from magi_tpu_torch.core.utils import tree_leaves
from magi_tpu_torch.models.dit import model as TM
from magi_tpu_torch.ops import act_quant as TA
from magi_tpu_torch.ops import attention_q8 as TA8
from magi_tpu_torch.ops import quant as TQ
from tests.tiny import tiny_config
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)


def _t(a):
    return torch.from_numpy(np.array(a))


def _flat(tree):
    return {jax.tree_util.keystr(k): v for k, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_params_int8_tree_matches(dtype):
    cfg = tiny_config(model=dict(num_layers=3, params_dtype=jnp.dtype(dtype)))
    jparams = JM.init_dit_params(jax.random.PRNGKey(0), cfg)
    want = _flat(jax.tree.map(np.asarray, JQ.quantize_params_int8(jparams)))
    got = _flat(TQ.quantize_params_int8(dit_params_from_jax(jax.tree.map(np.asarray, jparams))))
    assert sorted(got) == sorted(want)
    assert any("weight_q" in k for k in want) and any("blocks_edge" in k for k in want)
    for k, w in want.items():
        g = got[k]
        assert tuple(g.shape) == w.shape, k
        assert str(g.dtype).replace("torch.", "") == str(w.dtype), k
        if "weight_scale" in k:
            np.testing.assert_allclose(g.numpy(), w, rtol=1e-6, atol=0, err_msg=k)
        else:
            np.testing.assert_array_equal(g.float().numpy(), w.astype(np.float32), err_msg=k)


def test_act_quant_rowwise_matches():
    rng = np.random.default_rng(3)
    x = (rng.normal(size=(64, 96)) * rng.uniform(0.1, 10, size=(64, 1))).astype(np.float32)
    x[5] = 0.0
    xq, rs = TQ.act_quant_rowwise(_t(x))
    jq, jrs = JQ.act_quant_rowwise(jnp.asarray(x))
    np.testing.assert_array_equal(xq.numpy(), np.asarray(jq))
    np.testing.assert_allclose(rs.numpy(), np.asarray(jrs), rtol=1e-6, atol=0)


@pytest.mark.parametrize("out", ["float32", "bfloat16"])
def test_quantized_matmul_i8_plain_matches_pallas(out):
    rng = np.random.default_rng(4)
    x = rng.normal(size=(130, 256)).astype(np.float32)
    w = rng.normal(size=(256, 200)).astype(np.float32)
    wq, ws = JQ.quantize_int8(jnp.asarray(w))
    xq, rs = JQ.act_quant_rowwise(jnp.asarray(x))
    jdt, tdt = jnp.dtype(out), getattr(torch, out)
    pallas = JQ.quantized_matmul_i8(xq, rs, wq, ws, out_dtype=jdt, interpret=True, block_m=128, block_k=128,
                                    block_n=128)
    ref = JQ.quantized_matmul_i8_reference(xq, rs, wq, ws, out_dtype=jdt)
    args = [_t(a) for a in (xq, rs, wq, ws)]
    # the wrapper takes its plain version on CPU tensors
    for fn in (TQ.quantized_matmul_i8_reference, TQ.quantized_matmul_i8):
        got = fn(*args, out_dtype=tdt).float().numpy()
        np.testing.assert_array_equal(got, np.asarray(pallas, np.float32))
        np.testing.assert_array_equal(got, np.asarray(ref, np.float32))


def _rowquant_cases(rng):
    x = (rng.normal(size=(300, 256)) * 3).astype(np.float32)
    x[7] = 0.0
    w = (rng.normal(size=(256,)) * 0.2 + 1.0).astype(np.float32)
    b = (rng.normal(size=(256,)) * 0.1).astype(np.float32)
    return jnp.asarray(x, jnp.bfloat16), w, b


@pytest.mark.parametrize("mode", ["plain", "ln"])
def test_rowquant_fused_plain_matches_pallas(mode):
    x, w, b = _rowquant_cases(np.random.default_rng(0))
    lw, lb = (w, b) if mode == "ln" else (None, None)
    jargs = (None if lw is None else jnp.asarray(lw), None if lb is None else jnp.asarray(lb))
    pallas = JA.rowquant_fused(x, mode, *jargs, eps=1e-6, block_s=128, interpret=True)
    ref = JA.rowquant_fused_reference(x, mode, *jargs, eps=1e-6)
    xt = torch.from_numpy(np.asarray(x, np.float32)).to(torch.bfloat16)
    targs = (None if lw is None else _t(lw), None if lb is None else _t(lb))
    if mode == "ln":
        # each row's bf16 LayerNorm maximum from the port's float64 statistics
        amax_t = TA._layer_norm_f64_stats(xt, *targs, 1e-6).to(torch.bfloat16).float().abs().amax(-1).numpy()
    for got in (TA.rowquant_fused_reference(xt, mode, *targs, eps=1e-6), TA.rowquant_fused(xt, mode, *targs, eps=1e-6)):
        q, s = got[0].numpy().astype(np.int32), got[1].numpy()
        for wq, ws in (pallas, ref):
            dq = q - np.asarray(wq, np.int32)
            if mode == "plain":
                np.testing.assert_allclose(s, np.asarray(ws), rtol=1e-6, atol=0)
                if wq is ref[0]:
                    assert not dq.any()
                else:
                    assert np.abs(dq).max() <= 1 and (dq != 0).mean() < 1e-3, (dq != 0).mean()
            else:
                assert np.abs(dq).max() <= 1 and (dq != 0).mean() < 1e-3, (np.abs(dq).max(), (dq != 0).mean())
                # a scale moves only with its row's bf16 maximum (JAX's from
                # its scale: amax / 127 recovers amax to a bf16 rounding), by
                # one bf16 step
                ws = np.asarray(ws)
                amax_j = np.asarray(jnp.asarray(ws * 127).astype(jnp.bfloat16), np.float32)
                bf16_step = 2.0 ** (np.floor(np.log2(np.minimum(amax_t, amax_j))) - 7)
                same = amax_t == amax_j
                np.testing.assert_allclose(s[same], ws[same], rtol=1e-6, atol=0)
                np.testing.assert_array_equal(np.abs(amax_t - amax_j)[~same], bf16_step[~same])
                np.testing.assert_allclose(s[~same], ws[~same], rtol=2 ** -7, atol=0)
                assert same.mean() > 0.95, same.mean()
    if mode == "plain":  # a zero row: scale 1, values 0
        assert float(got[1][7]) == 1.0 and not got[0][7].any()


@pytest.mark.parametrize("act_ok", [True, False])
def test_linears_shared_int8_matches(act_ok):
    """The int8 (act_ok) and dequant branches of `_linears_shared`, with the
    shared pre-LayerNorm riding in as `pre`."""
    rng = np.random.default_rng(5)
    D, N, S = 128, 64, 40
    x = rng.normal(size=(S, D)).astype(np.float32)
    lnp = {"weight": (rng.normal(size=(D,)) * 0.1 + 1.0).astype(np.float32), "bias": np.zeros((D,), np.float32)}
    plist = []
    for _ in range(2):
        q8, sc = JQ.quantize_int8(jnp.asarray(rng.normal(size=(D, N)).astype(np.float32) * 0.1))
        plist.append({"weight_q": np.asarray(q8), "weight_scale": np.asarray(sc)})
    jax_out = JM._linears_shared(jnp.asarray(x), jax.tree.map(jnp.asarray, plist), act_ok,
                                 pre=("ln", jax.tree.map(jnp.asarray, lnp)), eps=1e-6)
    got = TM._linears_shared(_t(x), [dit_params_from_jax(pp) for pp in plist], act_ok,
                             pre=("ln", dit_params_from_jax(lnp)), eps=1e-6)
    for g, j in zip(got, jax_out):
        np.testing.assert_allclose(g.numpy(), np.asarray(j), atol=1e-5, rtol=1e-5)


def test_paths_not_ported_raise():
    """Smooth-quant trees and linears (fp8 checkpoints), which raised before
    their port, now run and match the JAX package on the same inputs; K5's
    sage and dq schemes run their plain versions on the CPU (here over
    empty ranges: zeros), and an unknown scheme is refused."""
    w = np.zeros((1, 16, 16), np.float32)
    smooth = {"blocks": {"mlp": {"linear_fc1": {"weight": w, "act_smooth": np.ones((1, 16), np.float32)}}}}
    for tq, jq in ((TQ.quantize_params_int8, JQ.quantize_params_int8),
                   (TQ.quantize_params_int4, JQ.quantize_params_int4)):
        want = _flat(jax.tree.map(np.asarray, jq(jax.tree.map(jnp.asarray, smooth))))
        got = _flat(tq(dit_params_from_jax(smooth)))
        assert sorted(got) == sorted(want)
        for k, v in want.items():
            np.testing.assert_array_equal(got[k].float().numpy(), v.astype(np.float32), err_msg=k)
    q8, sc = TQ.quantize_int8(torch.ones((16, 16)))
    linear = {"weight_q": q8, "weight_scale": sc, "act_smooth": torch.ones(16)}
    jlinear = {k: jnp.asarray(v.numpy()) for k, v in linear.items()}
    for act_ok in (True, False):
        (got,) = TM._linears_shared(torch.ones((4, 16)), [linear], act_ok)
        (want,) = JM._linears_shared(jnp.ones((4, 16)), [jlinear], act_ok)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    z = torch.zeros(1, dtype=torch.int32)
    kv, ksc = torch.zeros((2, 1, 0, 128), dtype=torch.int8), torch.zeros((2, 1, 0))
    q = torch.zeros((4, 1, 128), dtype=torch.bfloat16)
    for scheme in ("sage", "dq"):
        out = TA8.segmented_attention_two_source_q8(q, kv, ksc, kv, ksc, z, z, z, z, seg_len=4, scheme=scheme)
        assert out.shape == q.shape and not out.float().any()
    with pytest.raises(ValueError, match="scheme"):
        TA8.segmented_attention_two_source_q8(q, kv, ksc, kv, ksc, z, z, z, z, seg_len=4, scheme="int4")


@pytest.mark.parametrize("bits", [8, 4])
def test_smooth_fold_matches_jax(bits):
    """The smooth-folded quantization of a stacked bf16 weight, s·W per
    layer (`act_smooth` in [0.5, 2], a zero column), bit-equal to the JAX
    package's jitted `_quantize_stacked_smooth` / `_quantize_stacked4_smooth`,
    and k-major; and the tree of `quantize_params_int*` on a tree carrying
    `act_smooth`: edge layers unfolded in `blocks_edge`, `act_smooth` kept
    beside the folded weight only."""
    rng = np.random.default_rng(8)
    L, k, n = 3, 64, 48
    w = jnp.asarray(rng.normal(size=(L, k, n)) * 0.05, jnp.bfloat16)
    w = w.at[:, :, 5].set(0)
    s = rng.uniform(0.5, 2.0, size=(L, k)).astype(np.float32)
    jfold = JQ._quantize_stacked_smooth if bits == 8 else JQ._quantize_stacked4_smooth
    jq, js = jfold(w, jnp.asarray(s))
    wt = dit_params_from_jax({"w": np.asarray(w)})["w"]
    tq, ts = TQ._quantize_stacked(wt, bits, torch.from_numpy(s))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert tq.transpose(1, 2).is_contiguous() and tq.stride(1) == 1
    # the folded weight dequantizes to s·W
    deq = (TQ.unpack_int4(tq) if bits == 4 else tq).float() * ts[:, None, :]
    folded = wt.float() * torch.from_numpy(s)[:, :, None]
    assert float((deq - folded).abs().max()) <= float(ts.max()) * 0.51

    cfg = tiny_config(model=dict(num_layers=3, params_dtype=jnp.bfloat16))
    jparams = jax.tree.map(np.asarray, JM.init_dit_params(jax.random.PRNGKey(1), cfg))
    for node in (jparams["blocks"]["mlp"]["linear_fc2"], jparams["blocks"]["self_attention"]["linear_proj"]):
        sm = rng.uniform(0.5, 2.0, size=node["weight"].shape[:2]).astype(np.float32)
        sm[0] = sm[-1] = 1.0
        node["act_smooth"] = sm
    jtree = JQ.quantize_params_int8 if bits == 8 else JQ.quantize_params_int4
    ttree = TQ.quantize_params_int8 if bits == 8 else TQ.quantize_params_int4
    want = _flat(jax.tree.map(np.asarray, jtree(jax.tree.map(jnp.asarray, jparams))))
    got = _flat(ttree(dit_params_from_jax(jparams)))
    assert sorted(got) == sorted(want)
    assert sum("act_smooth" in k for k in got) == 2 and not any("blocks_edge" in k and "act_smooth" in k for k in got)
    for key, v in want.items():
        np.testing.assert_array_equal(got[key].float().numpy(), v.astype(np.float32), err_msg=key)


@pytest.mark.parametrize("act_ok", [True, False])
@pytest.mark.parametrize("pre", ["ln", "plain", "swiglu"])
def test_linears_shared_smooth_matches(pre, act_ok):
    """A smooth-quant linear (folded weight, `act_smooth`) in `_linears_shared`:
    the producer (a LayerNorm, none, or SwiGLU on a gated fc1 output)
    unfused, the input divided by s, then the int8 branch (K8 plain + K6's
    plain versions) or the dequant branch (K7's), against the JAX
    package's."""
    rng = np.random.default_rng(9)
    K, N, S = 128, 64, 40
    x = rng.normal(size=(S, 2 * K if pre == "swiglu" else K)).astype(np.float32)
    s = rng.uniform(0.5, 2.0, size=(1, K)).astype(np.float32)
    jw = jnp.asarray(rng.normal(size=(1, K, N)).astype(np.float32) * 0.1)
    wq, ws = JQ._quantize_stacked_smooth(jw, jnp.asarray(s))
    pp = {"weight_q": np.asarray(wq[0]), "weight_scale": np.asarray(ws[0]), "act_smooth": s[0]}
    lnp = {"weight": (rng.normal(size=(K,)) * 0.1 + 1.0).astype(np.float32), "bias": np.zeros((K,), np.float32)}
    jpre = {"ln": ("ln", jax.tree.map(jnp.asarray, lnp)), "plain": None, "swiglu": ("swiglu",)}[pre]
    tpre = {"ln": ("ln", dit_params_from_jax(lnp)), "plain": None, "swiglu": ("swiglu",)}[pre]
    (want,) = JM._linears_shared(jnp.asarray(x), [jax.tree.map(jnp.asarray, pp)], act_ok, pre=jpre, eps=1e-6)
    (got,) = TM._linears_shared(_t(x), [dit_params_from_jax(pp)], act_ok, pre=tpre, eps=1e-6)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("mode", ["plain", "ln", "swiglu"])
def test_rowquant_fused_smooth_is_the_chain(mode):
    """K8 / K8s's plain version with a smooth-quant vector s: the producer
    rounded to bf16, divided by s as `smooth_divide` does, then q8, bit for
    bit; for "plain" and "swiglu" also the model's old unfused chain
    (`_apply_pre`, the divide, K8 "plain") and the JAX package's (its
    reference producer, f32(y) * (1 / s) cast to bf16, its row
    quantization)."""
    rng = np.random.default_rng(21)
    S, K = 300, 256
    x = rng.normal(size=(S, 2 * K if mode == "swiglu" else K)) * 3
    x[7] = 0.0  # a zero row: scale 1, values 0
    xt = torch.from_numpy(x.astype(np.float32)).to(torch.bfloat16)
    s = torch.from_numpy(rng.uniform(0.5, 2.0, size=(K,)).astype(np.float32))
    w = torch.from_numpy((rng.normal(size=(K,)) * 0.2 + 1.0).astype(np.float32))
    b = torch.from_numpy((rng.normal(size=(K,)) * 0.1).astype(np.float32))
    lw, lb = (w, b) if mode == "ln" else (None, None)
    if mode == "swiglu":
        y = (torch.nn.functional.silu(xt[:, :K].float()).bfloat16() * xt[:, K:]).bfloat16()
    elif mode == "ln":
        y = TA._layer_norm_f64_stats(xt, w, b, 1e-6).bfloat16()
    else:
        y = xt
    ys = (y.float() * (1.0 / s)).bfloat16()
    want = TQ.act_quant_rowwise(ys)
    for q, sc in (TA.rowquant_fused_reference(xt, mode, lw, lb, eps=1e-6, smooth=s),
                  TA.rowquant_fused(xt, mode, lw, lb, eps=1e-6, smooth=s)):
        assert q.dtype == torch.int8 and tuple(q.shape) == (S, K)
        assert torch.equal(q, want[0]) and torch.equal(sc, want[1])
    if mode == "ln":
        return
    assert float(want[1][7]) == 1.0 and not want[0][7].any()
    pre = ("swiglu",) if mode == "swiglu" else None
    old = TA.rowquant_fused_reference(TA.smooth_divide(TM._apply_pre(xt, pre, 1e-6), s), "plain")
    assert torch.equal(old[0], want[0]) and torch.equal(old[1], want[1])
    xj = jnp.asarray(np.asarray(xt.float()), jnp.bfloat16)
    yj = xj
    if mode == "swiglu":
        yj = (jax.nn.silu(xj[:, :K].astype(jnp.float32)).astype(jnp.bfloat16) * xj[:, K:]).astype(jnp.bfloat16)
    ysj = (yj.astype(jnp.float32) * (1.0 / jnp.asarray(s.numpy()))).astype(jnp.bfloat16)
    jq, jsc = JA.rowquant_fused_reference(ysj, "plain")
    np.testing.assert_array_equal(want[0].numpy(), np.asarray(jq))
    np.testing.assert_array_equal(want[1].numpy(), np.asarray(jsc))


def test_int4_pack_unpack_matches():
    rng = np.random.default_rng(6)
    w = rng.normal(size=(64, 48)).astype(np.float32)
    w[:, 3] = 0.0  # a zero column: scale 1, values 8 (zero) in both nibbles
    # jitted, as the JAX package's tree quantization runs it (see above)
    jq, js = jax.jit(JQ.quantize_int4)(jnp.asarray(w))
    tq, ts = TQ.quantize_int4(_t(w))
    assert tq.dtype == torch.uint8 and tuple(tq.shape) == (32, 48)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert float(ts[3]) == 1.0 and (tq[:, 3] == 0x88).all()
    unpacked = TQ.unpack_int4(tq)
    assert unpacked.dtype == torch.int8 and int(unpacked.abs().max()) == 7
    np.testing.assert_array_equal(unpacked.numpy(), np.asarray(JQ.unpack_int4(jq)))
    # row 2i in the low nibble, 2i+1 in the high one
    np.testing.assert_array_equal(unpacked[0::2].numpy(), (tq & 0xF).numpy().astype(np.int8) - 8)
    # a stacked leaf, and one carried as bf16 (exact for 0..255)
    stacked = np.stack([np.asarray(jq), np.asarray(jq)[::-1]])
    want = np.asarray(JQ.unpack_int4(jnp.asarray(stacked)))
    np.testing.assert_array_equal(TQ.unpack_int4(_t(stacked)).numpy(), want)
    np.testing.assert_array_equal(TQ.unpack_int4(_t(stacked).to(torch.bfloat16)).numpy(), want)
    np.testing.assert_array_equal(
        np.asarray(JQ.unpack_int4(jnp.asarray(stacked, jnp.bfloat16))), want)
    with pytest.raises(ValueError, match="even"):
        TQ.quantize_int4(torch.ones((3, 4)))


@pytest.mark.parametrize("keep_edge", [True, False])
def test_quantize_params_int4_tree_matches(keep_edge):
    cfg = tiny_config(model=dict(num_layers=3, params_dtype=jnp.bfloat16, gated_linear_unit=True))
    jparams = JM.init_dit_params(jax.random.PRNGKey(0), cfg)
    want = _flat(jax.tree.map(np.asarray, JQ.quantize_params_int4(jparams, keep_edge_bf16=keep_edge)))
    got = _flat(TQ.quantize_params_int4(dit_params_from_jax(jax.tree.map(np.asarray, jparams)),
                                        keep_edge_bf16=keep_edge))
    assert sorted(got) == sorted(want)
    assert any("weight_q4" in k for k in want) and not any("'weight_q'" in k for k in want)
    assert any("blocks_edge" in k for k in want) == keep_edge
    for k, w in want.items():
        g = got[k]
        assert tuple(g.shape) == w.shape, k
        assert str(g.dtype).replace("torch.", "") == str(w.dtype), k
        if "weight_scale" in k:
            np.testing.assert_allclose(g.numpy(), w, rtol=1e-6, atol=0, err_msg=k)
        else:
            np.testing.assert_array_equal(g.float().numpy(), w.astype(np.float32), err_msg=k)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantized_matmul_plain_matches_pallas(dtype):
    """K7's plain version against the Pallas kernel in interpret mode and
    the JAX package's reference (130 rows: a ragged row block)."""
    rng = np.random.default_rng(7)
    x = rng.normal(size=(130, 256)).astype(np.float32)
    wq, ws = JQ.quantize_int8(jnp.asarray(rng.normal(size=(256, 200)).astype(np.float32) * 0.02))
    jx = jnp.asarray(x, jnp.dtype(dtype))
    pallas = np.asarray(JQ.quantized_matmul(jx, wq, ws, block_m=128, block_k=128, block_n=128, interpret=True),
                        np.float32)
    ref = np.asarray(JQ.quantized_matmul_reference(jx, wq, ws), np.float32)
    tx = torch.from_numpy(np.array(jx, np.float32)).to(getattr(torch, dtype))
    # the wrapper takes its plain version on CPU tensors
    for fn in (TQ.quantized_matmul_reference, TQ.quantized_matmul):
        got = fn(tx, _t(wq), _t(ws))
        assert got.dtype == tx.dtype
        got = got.float().numpy()
        if dtype == "float32":
            np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)
            np.testing.assert_allclose(got, pallas, rtol=1e-5, atol=1e-5)
        else:
            for want in (ref, pallas):
                np.testing.assert_allclose(got, want, rtol=2**-7, atol=1e-3)


@pytest.mark.parametrize("d_out", [2048, 4096])
def test_rowquant_fused_swiglu_plain_matches_pallas(d_out):
    rng = np.random.default_rng(d_out)
    x = (rng.normal(size=(300, 2 * d_out)) * 3).astype(np.float32)
    x[7] = 0.0  # a zero row: scale 1, values 0
    x[9, :d_out] = -100.0  # silu of a large negative gate is -0
    xb = jnp.asarray(x, jnp.bfloat16)
    pallas = JA.rowquant_fused(xb, "swiglu", block_s=128, interpret=True)
    ref = JA.rowquant_fused_reference(xb, "swiglu")
    xt = torch.from_numpy(np.array(xb, np.float32)).to(torch.bfloat16)
    for q, s in (TA.rowquant_fused_reference(xt, "swiglu"), TA.rowquant_fused(xt, "swiglu")):
        assert q.dtype == torch.int8 and tuple(q.shape) == (300, d_out)
        q, s = q.numpy().astype(np.int32), s.numpy()
        np.testing.assert_array_equal(q, np.asarray(ref[0], np.int32))
        np.testing.assert_allclose(s, np.asarray(ref[1]), rtol=1e-6, atol=0)
        dq = q - np.asarray(pallas[0], np.int32)
        assert np.abs(dq).max() <= 1 and (dq != 0).mean() < 1e-3, (np.abs(dq).max(), (dq != 0).mean())
        np.testing.assert_allclose(s, np.asarray(pallas[1]), rtol=2**-7, atol=0)
        assert s[7] == 1.0 and not q[7].any() and s[9] == 1.0 and not q[9].any()


@pytest.mark.parametrize("act_ok", [True, False])
def test_linears_shared_int4_swiglu_matches(act_ok):
    """A gated MLP's fc2 on int4 weights: the SwiGLU rides in as `pre`, the
    weights unpack to int8, then the int8 branch (K8s + K6 plain versions)
    or the dequant branch (K7's plain version)."""
    rng = np.random.default_rng(8)
    F, N, S = 64, 48, 40
    x = rng.normal(size=(S, 2 * F)).astype(np.float32)
    plist = []
    for _ in range(2):
        q4, sc = JQ.quantize_int4(jnp.asarray(rng.normal(size=(F, N)).astype(np.float32) * 0.1))
        plist.append({"weight_q4": np.asarray(q4), "weight_scale": np.asarray(sc)})
    jax_out = JM._linears_shared(jnp.asarray(x), jax.tree.map(jnp.asarray, plist), act_ok, pre=("swiglu",))
    got = TM._linears_shared(_t(x), [dit_params_from_jax(pp) for pp in plist], act_ok, pre=("swiglu",))
    for g, j in zip(got, jax_out):
        np.testing.assert_allclose(g.numpy(), np.asarray(j), atol=1e-5, rtol=1e-5)


def _assert_k_major(t, name=""):
    """A [..., k, n] tensor laid out as a contiguous [..., n, k]."""
    assert t.transpose(-1, -2).is_contiguous(), (name, tuple(t.shape), t.stride())


@pytest.mark.parametrize("bits", [8, 4])
def test_quantized_weights_are_k_major(bits):
    """quantize_int8 / quantize_int4 / unpack_int4 and both tree
    quantizations store the weights k-major, with the values of a plain
    row-major quantization (the JAX layout at every function)."""
    rng = np.random.default_rng(9)
    w = _t(rng.normal(size=(64, 48)).astype(np.float32))
    q, s = (TQ.quantize_int8 if bits == 8 else TQ.quantize_int4)(w)
    _assert_k_major(q)
    assert tuple(q.shape) == ((64, 48) if bits == 8 else (32, 48))
    if bits == 8:
        np.testing.assert_array_equal(q.numpy(), torch.round(w / s).clamp(-127, 127).to(torch.int8).numpy())
    else:
        unpacked = TQ.unpack_int4(q)
        _assert_k_major(unpacked)
        np.testing.assert_array_equal(unpacked.numpy(), torch.round(w / s).clamp(-7, 7).to(torch.int8).numpy())
        # a row-major packed leaf unpacks to the same values, k-major
        row_major = q.contiguous()
        assert not row_major.transpose(0, 1).is_contiguous()
        again = TQ.unpack_int4(row_major)
        _assert_k_major(again)
        assert torch.equal(again, unpacked)
    cfg = tiny_config(model=dict(num_layers=3, params_dtype=jnp.bfloat16))
    params = dit_params_from_jax(jax.tree.map(np.asarray, JM.init_dit_params(jax.random.PRNGKey(0), cfg)))
    tree = TQ.quantize_params_int8(params) if bits == 8 else TQ.quantize_params_int4(params)
    leaf = "weight_q" if bits == 8 else "weight_q4"
    found = 0
    for path, v in tree_leaves(tree):
        if path.rsplit("/", 1)[-1] == leaf:
            _assert_k_major(v, path)
            _assert_k_major(v[1], path)  # one layer's [in, out] view
            found += 1
    assert found


def test_dit_params_from_jax_quantized_leaves_are_k_major():
    """A JAX quantized tree carried over: weight_q and weight_q4 leaves come
    k-major with equal values, every other leaf as it was."""
    cfg = tiny_config(model=dict(num_layers=3, params_dtype=jnp.bfloat16, gated_linear_unit=True))
    jparams = JM.init_dit_params(jax.random.PRNGKey(0), cfg)
    for jtree in (JQ.quantize_params_int8(jparams), JQ.quantize_params_int4(jparams)):
        flat = _flat(jax.tree.map(np.asarray, jtree))
        got = _flat(dit_params_from_jax(jax.tree.map(np.asarray, jtree)))
        n_quant = 0
        for k, want in flat.items():
            np.testing.assert_array_equal(got[k].float().numpy(), want.astype(np.float32), err_msg=k)
            if "'weight_q'" in k or "'weight_q4'" in k:
                _assert_k_major(got[k], k)
                n_quant += 1
            elif got[k].dim():
                assert got[k].is_contiguous(), k
        assert n_quant


@pytest.mark.parametrize("act_ok", [True, False])
def test_linears_shared_k_major_tree_matches(act_ok):
    """`_linears_shared` on weights quantized by the port (k-major) against
    the JAX package on its own row-major quantization of the same weights:
    the int8 branch and the dequant branch."""
    rng = np.random.default_rng(10)
    D, N, S = 128, 64, 40
    x = rng.normal(size=(S, D)).astype(np.float32)
    ws = [rng.normal(size=(D, N)).astype(np.float32) * 0.1 for _ in range(2)]
    jlist = [dict(zip(("weight_q", "weight_scale"), jax.jit(JQ.quantize_int8)(jnp.asarray(w)))) for w in ws]
    tlist = [dict(zip(("weight_q", "weight_scale"), TQ.quantize_int8(_t(w)))) for w in ws]
    for pp in tlist:
        _assert_k_major(pp["weight_q"])
    jax_out = JM._linears_shared(jnp.asarray(x), jlist, act_ok)
    got = TM._linears_shared(_t(x), tlist, act_ok)
    for g, j in zip(got, jax_out):
        np.testing.assert_allclose(g.numpy(), np.asarray(j), atol=1e-5, rtol=1e-5)


def test_kernel_weight_check_refuses_row_major():
    """The quantized GEMMs' operand check (run before each launch on the
    card) takes a k-major weight and refuses a row-major one, naming what
    makes the layout; it never copies."""
    q, _ = TQ.quantize_int8(torch.ones((32, 16)))
    cpu = torch.device("cpu")
    TQ._check_weight("quantized_matmul_i8", q, cpu, 32, 16)
    with pytest.raises(ValueError, match="k-major.*quantize_int8.*unpack_int4"):
        TQ._check_weight("quantized_matmul_i8", q.contiguous(), cpu, 32, 16)
    with pytest.raises(ValueError, match="shape"):
        TQ._check_weight("quantized_matmul", q, cpu, 16, 32)

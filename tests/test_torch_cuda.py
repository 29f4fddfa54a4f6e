"""The port's CUDA kernels against their plain PyTorch versions on the
card, at small shapes.  Marked `cuda`: each test skips without a CUDA
device.  On the GPU, where jax is not installed, run them without the
suite's conftest: `python -m pytest --noconftest -m cuda
tests/test_torch_cuda.py`; `chip_smoke.py` holds the same kernels at the
main path's shapes.

Tolerances (bf16 outputs): K3 and K4 one or two bf16 ulps (1e-2 absolute
+ 1e-2 relative; K3 and K3q on token counts below, at and past the
kernel's 4-token tile, with and without GQA replication and rotary, rows
of mean 30, head_dim 64 and 256, rotary widths off the 8-lane grid, and
the head dims and misaligned operands they refuse before any launch); attention 4e-3 absolute + 1e-2 relative, well below
outputs of ~n**-0.5 for spans of n keys (q is rounded to bf16 after the
sm_scale*log2e fold in the kernel and before it in the plain version, and
P is rounded to bf16 for the PV product).  A segment of a dozen keys has
outputs near 1 and takes 2e-2 absolute + relative, one or two bf16 ulps
there, as `chip_smoke.py` does for its short captions.

The quantized kernels: K6 (int8 GEMM; with bf16 output and with the f32
output of a row-parallel linear's partial sums), K8 (row quantization)
and K8s (SwiGLU + row quantization) are bit-equal to their plain
versions.  K4 on shards of the token axis (a first row inside a segment,
a shard across a segment boundary, padding rows) gives the rows of one
launch over the whole axis, bit for bit.  K6
and K7 take their int8 weights k-major (as `quantize_int8` makes them)
and refuse a row-major one.  K7
(the bf16 x int8 dequant GEMM) sums before it scales and its plain
version scales the weight first: one bf16 step apart at most (2**-7
relative + 1e-3 absolute).  K3q's int8 values are equal except one step on
under 1e-3 of them (its LayerNorm sums in another order than the plain
version's, which moves a quotient sitting on a rounding edge) and its
scales agree to 1e-6 relative.  K5 (int8 attention, qk8) is held to the
attention tolerance against its step-by-step plain version, and against
the dequant reference (which does not quantize q) by the JAX package's
own criterion for its q8 kernel: mean |error| under 4% of mean |output|.
The sage and dq schemes of K5 are held the same way against their tiled
plain versions at the kernel's tile width, on the two-source cases too;
no scheme reads a k or v scale outside the attended ranges.

The single-source kernels (K2, K2g: persistent, TMA + wgmma) are held to
the attention tolerances on cases that cover more work items than the
card has blocks, a seg_len off the 64-row grid, spans from 7 to 800
tokens, clipped and empty ranges (exactly 0), hq / hk of 1, 2, 3 and 6,
the prologue at head_dim 64 and with rotary, and the VAE's 3073-token
segments, and q rows whose mean is large against their spread (the
LayerNorm's variance taken about the mean, as the plain version does);
views of a fused qkv or kv give their contiguous copies' bits.

Step capture (`core.graphs`): tiny walks replayed from CUDA graphs (base,
packed, distill + int8, host-streamed bf16 and int8, two requests lockstep
and interleaved) are bit-equal to their eager walks with equal launches
of every kernel, a second sampler of an equal config gives the same
chunks, a host read inside a captured step raises naming the variant, and
the VAE's encode and decode graphs give the eager forwards' bits.  In a
traced captured walk the program's step spans and the kernels share one
clock: each step's kernels start inside its replay span and end by the end
of its sync span.

Model-parallel meshes on the one card (gloo, `tests/torch_dist.py`'s world
with every rank on cuda:0): tiny cp 2 (bf16 3-CFG), tp 2 and pp 2 (int8,
row-parallel K6 with f32 out, layer broadcasts into fixed slots) walks,
captured in pieces between their collectives, are bit-equal to their
eager walks with equal launches, and a second captured walk captures
nothing; `parallel.comm`'s collectives write into their `out` slots in
place on a one-rank gloo group; a pp layer broadcast into a slot waits
for the work queued before it, the slot's last reader (without that wait
the write overtakes a slow reader)."""

import pytest
import torch

from magi_tpu_torch.models.dit import model as M
from magi_tpu_torch.ops import act_quant as AQ
from magi_tpu_torch.ops import attention as A
from magi_tpu_torch.ops import attention_q8 as A8
from magi_tpu_torch.ops import fused_norm as FN
from magi_tpu_torch.ops import quant as Q

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _randn(gen, dev, *shape, dtype=torch.bfloat16):
    return torch.randn(shape, generator=gen, device=dev).to(dtype)


def _gen(dev):
    g = torch.Generator(device=dev)
    g.manual_seed(0)
    return g


ATTN_TOL = dict(atol=4e-3, rtol=1e-2)
SHORT_SPAN_TOL = dict(atol=2e-2, rtol=2e-2)


def _ln_affine(gen, dev, hd):
    """q-LayerNorm weight (+1 applied) and bias of the model's scale."""
    return 1.0 + 0.1 * _randn(gen, dev, hd, dtype=torch.float32), 0.1 * _randn(gen, dev, hd, dtype=torch.float32)


def _close(out, ref, atol, rtol):
    torch.cuda.synchronize()
    assert torch.isfinite(out.float()).all()
    torch.testing.assert_close(out.float(), ref.float(), atol=atol, rtol=rtol)


# Cases of K3 and K3q: (S, hk, hd, rep, rot, mean of k's rows).  The
# kernel's tile is 4 tokens at hd 128 and hk 8 (csrc/norm.cu), so S runs
# below, at both sides of and well past one tile, each with and without
# GQA replication and rotary.  Then k rows of mean 30 (the variance taken
# about the mean), hd 64 and 256, hk 3 (a tile of 10 tokens) and hk 48
# (one token, rows in two passes), and rotary widths that are not a
# multiple of 8 (the partner through shared memory).
KV_PACK_TILE = 4
KV_PACK_CASES = [(S, 8, 128, rep, rot, 0.0) for S in (1, 7, KV_PACK_TILE - 1, KV_PACK_TILE + 1, 300, 1537)
                 for rep in (1, 2) for rot in (48, 0)]
KV_PACK_CASES += [(300, 8, 128, 1, 48, 30.0), (300, 8, 128, 2, 0, 30.0), (300, 8, 64, 2, 24, 0.0),
                  (37, 8, 256, 1, 48, 0.0), (300, 3, 128, 2, 48, 0.0), (41, 48, 128, 1, 48, 0.0),
                  (300, 8, 128, 2, 20, 0.0), (37, 8, 64, 1, 20, 0.0)]


def _kv_pack_inputs(dev, S, hk, hd, rot, shift):
    g = _gen(dev)
    k, v = _randn(g, dev, S, hk, hd, dtype=torch.float32), _randn(g, dev, S, hk, hd)
    k = (k + shift).bfloat16()
    kw, kb = _ln_affine(g, dev, hd)
    ang = torch.rand((S, rot), generator=g, device=dev) * 6.28
    sin, cos = (torch.sin(ang), torch.cos(ang)) if rot else (None, None)
    return k, v, kw, kb, sin, cos


def _kv_pack_id(c):
    return "S{}-hk{}-hd{}-rep{}-rot{}".format(*c[:5]) + (f"-mean{c[5]:g}" if c[5] else "")


@pytest.mark.parametrize("S,hk,hd,rep,rot,shift", [pytest.param(*c, id=_kv_pack_id(c)) for c in KV_PACK_CASES])
def test_kv_norm_rope_pack_kernel(dev, S, hk, hd, rep, rot, shift):
    args = _kv_pack_inputs(dev, S, hk, hd, rot, shift)
    before = A.kv_norm_rope_pack.launches
    out = A.kv_norm_rope_pack(*args, eps=1e-6, rep=rep)
    assert A.kv_norm_rope_pack.launches == before + 1
    assert out.dtype == torch.bfloat16 and out.shape == (2, hk * rep, S, hd)
    _close(out, A.kv_norm_rope_pack_reference(*args, eps=1e-6, rep=rep), atol=1e-2, rtol=1e-2)


def test_kv_norm_rope_pack_kernels_refuse_other_layouts(dev):
    """Head dims other than 64, 128 and 256 and operands off 16 bytes
    raise before any launch; nothing falls back to the plain version."""
    counts = lambda: (A.kv_norm_rope_pack.launches, A.kv_norm_rope_pack_q8.launches)
    before = counts()
    for hd in (32, 96, 192):
        args = _kv_pack_inputs(dev, 9, 8, hd, 16, 0.0)
        for quantize in (False, True):
            with pytest.raises(ValueError, match="head_dim"):
                A.kv_norm_rope_pack(*args, eps=1e-6, quantize=quantize)
    k, v, kw, kb, sin, cos = _kv_pack_inputs(dev, 9, 8, 128, 48, 0.0)
    k_off = torch.empty(k.numel() + 1, dtype=k.dtype, device=dev)[1:].view(k.shape)
    k_off.copy_(k)
    for quantize in (False, True):
        with pytest.raises(ValueError, match="16 bytes"):
            A.kv_norm_rope_pack(k_off, v, kw, kb, sin, cos, eps=1e-6, quantize=quantize)
    assert counts() == before


def test_gate_norm_residual_kernel(dev):
    g = _gen(dev)
    n_seg, seg, D = 3, 100, 3072
    x, res = _randn(g, dev, n_seg * seg, D), _randn(g, dev, n_seg * seg, D)
    gate, w, b = (_randn(g, dev, *s, dtype=torch.float32) for s in ((n_seg, D), (D,), (D,)))
    kw = dict(eps=1e-6, zero_centered=True, n_seg=n_seg)
    _close(FN.gate_norm_residual(x, res, gate, w, b, **kw), FN.gate_norm_residual_reference(x, res, gate, w, b, **kw),
           atol=1e-2, rtol=1e-2)


@pytest.mark.parametrize("shard_rows", [150, 128, 300, 77])
def test_gate_norm_residual_sharded_kernel(dev, shard_rows):
    """K4 on shards of the token axis (row offsets into a segment, shards
    that straddle a segment boundary, padding past the last segment) gives
    the rows of one launch over the whole axis."""
    g = _gen(dev)
    n_seg, seg, D = 3, 100, 3072
    S = n_seg * seg
    pad = -S % shard_rows
    x, res = _randn(g, dev, S + pad, D), _randn(g, dev, S + pad, D)
    gate, w, b = (_randn(g, dev, *s, dtype=torch.float32) for s in ((n_seg, D), (D,), (D,)))
    kw = dict(eps=1e-6, zero_centered=True, n_seg=n_seg)
    full = FN.gate_norm_residual(x[:S], res[:S], gate, w, b, **kw)
    before = FN.gate_norm_residual.launches
    parts = [FN.gate_norm_residual_sharded(x[r: r + shard_rows], res[r: r + shard_rows], gate, w, b, seg_len=seg,
                                           row_start=r, **kw) for r in range(0, S + pad, shard_rows)]
    assert FN.gate_norm_residual.launches == before + len(parts)
    torch.cuda.synchronize()
    assert torch.equal(torch.cat(parts)[:S], full)


# Cases of the two-source kernels (K1 and K5 qk8), 3 segments of 130 q
# tokens, head_dim 128: (hq, hk, tokens of source 1, ranges of source 1
# and of source 2 per segment; source 2 holds the 390 current tokens).
# "0" and "200": a cache of 0 or 200 tokens, the third segment attending
# nothing when it is empty.  "48x8": the 24B's 6 q heads per kv head, two
# blocks per kv head.  "off_grid": every range starts and ends off the
# 64-token tile grid with attended-by-no-one tokens on both sides of it in
# both sources (a TMA tile past a range's end reads real tokens, which
# must be masked).  "short": a source shorter than one tile and ranges of
# 5 tokens; the third segment attends only 5 keys, whose outputs reach 1,
# and takes the short-span tolerance, as the captions of 7 and 13 keys do
# (P is rounded to bf16 for the PV product, which with 5 keys moves an
# output by up to three of its bf16 steps).
TWO_SOURCE_CASES = {
    "0": (24, 8, 0, ([0, 0, 0], [0, 0, 0]), ([0, 0, 7], [130, 260, 7])),
    "200": (24, 8, 200, ([0, 50, 0], [200, 200, 0]), ([0, 0, 7], [130, 260, 7])),
    "48x8": (48, 8, 200, ([0, 50, 0], [200, 200, 0]), ([0, 0, 7], [130, 260, 7])),
    "off_grid": (24, 8, 300, ([13, 70, 150], [90, 235, 290]), ([3, 140, 200], [120, 333, 389])),
    "short": (24, 8, 40, ([3, 0, 0], [8, 40, 0]), ([0, 17, 200], [100, 150, 205])),
}


def _close_two_source(out, ref, case, seg):
    """The attention tolerance, except the short-span one on the segment
    of the "short" case that attends 5 keys only."""
    n = 2 * seg if case == "short" else out.shape[0]
    _close(out[:n], ref[:n], **ATTN_TOL)
    if n < out.shape[0]:
        _close(out[n:], ref[n:], **SHORT_SPAN_TOL)


def _two_source_case(g, dev, case, kv_of):
    """q, prologue, sources (kv_of(L) makes one of L tokens) and ranges of
    a TWO_SOURCE_CASES entry."""
    hq, hk, L1, (r1s, r1e), (r2s, r2e) = TWO_SOURCE_CASES[case]
    n_seg, seg, hd, rot = 3, 130, 128, 48
    S = n_seg * seg
    q = _randn(g, dev, S, hq, hd)
    src1, src2 = kv_of(hk, L1), kv_of(hk, S)
    i32 = dict(dtype=torch.int32, device=dev)
    ranges = [torch.tensor(r, **i32) for r in (r1s, r1e, r2s, r2e)]
    qw, qb = _ln_affine(g, dev, hd)
    pro = (qw, qb, torch.sin(_randn(g, dev, S, rot, dtype=torch.float32)),
           torch.cos(_randn(g, dev, S, rot, dtype=torch.float32)), 1e-6)
    return q, pro, src1, src2, ranges, seg


@pytest.mark.parametrize("case", list(TWO_SOURCE_CASES))
def test_two_source_kernel(dev, case):
    g = _gen(dev)
    q, pro, kv1, kv2, ranges, seg = _two_source_case(g, dev, case, lambda hk, L: _randn(g, dev, 2, hk, L, 128))
    before = A.segmented_attention_two_source.launches
    out = A.segmented_attention_two_source(q, kv1, kv2, *ranges, seg_len=seg, q_prologue=pro)
    assert A.segmented_attention_two_source.launches == before + 1
    ref = A.segmented_attention_two_source_reference(A.apply_q_prologue(q, pro), kv1, kv2, *ranges, seg_len=seg)
    _close_two_source(out, ref, case, seg)
    if case == "0":
        assert (out[2 * seg :].float() == 0).all()  # the third segment attends nothing


@pytest.mark.parametrize("hd,hq,hk,norm", [(128, 24, 8, True), (64, 16, 16, False), (64, 8, 4, True)])
def test_single_source_kernel(dev, hd, hq, hk, norm):
    g = _gen(dev)
    n_seg, seg, L = 2, 97, 80
    q = _randn(g, dev, n_seg * seg, hq, hd)
    k, v = _randn(g, dev, n_seg * L, hk, hd), _randn(g, dev, n_seg * L, hk, hd)
    st = torch.arange(n_seg, dtype=torch.int32, device=dev) * L
    en = st + torch.tensor([L, 13], dtype=torch.int32, device=dev)
    pro = (*_ln_affine(g, dev, hd), None, None, 1e-6) if norm else None
    # without a prologue, head_dim 64 goes to the grid kernel's wrapper
    wrapper = A.segmented_attention if hd % 128 and not norm else A.segmented_attention_v2
    before = wrapper.launches
    out = A.segmented_attention_v2(q, k, v, st, en, seg_len=seg, q_prologue=pro)
    assert wrapper.launches == before + 1
    ref = A.segmented_attention_reference(q if pro is None else A.apply_q_prologue(q, pro), k, v, st, en, seg_len=seg)
    _close(out[:seg], ref[:seg], **ATTN_TOL)  # 80 keys
    _close(out[seg:], ref[seg:], **SHORT_SPAN_TOL)  # 13 keys


# Cases of the single-source kernels (K2 `segmented_attention_v2`, K2g
# `segmented_attention`): (wrapper, head_dim, hq, hk, prologue, seg_len, kv
# ranges per segment, kv tokens).  "spans": kv spans of 7, 50, 64, 65 and
# 800 tokens and an empty one in one call, seg_len 97 (not a multiple of
# 64), 3 q heads per kv head.  "clip": ranges clipped at both ends of the
# source (a negative start, ends past it, a range wholly past it).  "mha",
# "gqa2", "gqa6": hq / hk of 1, 2 (both kernels) and 6 (two head groups).
# "hd64_norm", "hd64_rope", "rope": the prologue at head_dim 64 and with
# rotary.  "vae": K2g at the VAE's 3073-token segments (256x256), 50 work
# items per segment and head group.  "captions": K2 at the DiT's shapes
# (4 segments of 1536, 24/8 heads, captions of 50, 7, 800 and 0), 768
# work items, more than the card has blocks.  "shifted", "shifted_hd64":
# the norm prologue on q rows of mean 30 and spread 1, whose variance must
# be taken about the mean (E[x^2] - mean^2 cancels in f32).
SINGLE_SOURCE_CASES = {
    "spans": ("v2", 128, 24, 8, "norm", 97,
              [(0, 7), (800, 850), (1600, 1664), (2400, 2465), (3200, 4000), (4000, 4000)], 4800),
    "clip": ("grid", 128, 8, 4, None, 70, [(-5, 40), (60, 220), (200, 300)], 120),
    "mha": ("grid", 64, 16, 16, None, 97, [(0, 80), (80, 93)], 160),
    "gqa2": ("v2", 128, 16, 8, None, 130, [(10, 200), (0, 64)], 200),
    "gqa2_hd64": ("grid", 64, 8, 4, None, 130, [(10, 200), (0, 64)], 200),
    "gqa6": ("v2", 128, 48, 8, "norm", 130, [(0, 300), (100, 165)], 300),
    "hd64_norm": ("v2", 64, 16, 16, "norm", 97, [(0, 80), (80, 200)], 200),
    "hd64_rope": ("v2", 64, 8, 4, "rope", 97, [(0, 80), (80, 200)], 200),
    "rope": ("v2", 128, 24, 8, "rope", 130, [(0, 100), (30, 230)], 230),
    "vae": ("grid", 64, 16, 16, None, 3073, [(0, 3073), (3073, 6146)], 6146),
    "captions": ("v2", 128, 24, 8, "norm", 1536, [(0, 50), (800, 807), (1600, 2400), (2400, 2400)], 3200),
    "shifted": ("v2", 128, 24, 8, "shifted", 130, [(0, 300), (100, 165), (0, 200)], 300),
    "shifted_hd64": ("v2", 64, 24, 8, "shifted", 130, [(0, 300), (100, 165), (0, 200)], 300),
}


def _single_source_case(g, dev, case):
    kind, hd, hq, hk, pro_kind, seg, ranges, L = SINGLE_SOURCE_CASES[case]
    n_seg = len(ranges)
    S = n_seg * seg
    q = _randn(g, dev, S, hq, hd)
    if pro_kind == "shifted":
        q = (q.float() + 30.0).to(torch.bfloat16)
    k, v = _randn(g, dev, L, hk, hd), _randn(g, dev, L, hk, hd)
    i32 = dict(dtype=torch.int32, device=dev)
    st = torch.tensor([r[0] for r in ranges], **i32)
    en = torch.tensor([r[1] for r in ranges], **i32)
    pro = None
    if pro_kind is not None:
        rot = 48 if hd == 128 else 16
        sincos = (None, None)
        if pro_kind == "rope":
            ang = torch.rand((S, rot), generator=g, device=dev) * 6.28
            sincos = (torch.sin(ang), torch.cos(ang))
        pro = (*_ln_affine(g, dev, hd), *sincos, 1e-6)
    wrapper = A.segmented_attention_v2 if kind == "v2" else A.segmented_attention
    return wrapper, q, k, v, st, en, pro, seg


@pytest.mark.parametrize("case", list(SINGLE_SOURCE_CASES))
def test_single_source_kernel_cases(dev, case):
    g = _gen(dev)
    wrapper, q, k, v, st, en, pro, seg = _single_source_case(g, dev, case)
    kw = dict(seg_len=seg) if pro is None else dict(seg_len=seg, q_prologue=pro)
    before = wrapper.launches
    out = wrapper(q, k, v, st, en, **kw)
    assert wrapper.launches == before + 1
    ref = A.segmented_attention_reference(q if pro is None else A.apply_q_prologue(q, pro), k, v, st, en, seg_len=seg)
    L = k.shape[0]
    for i, (s, e) in enumerate(zip(st.tolist(), en.tolist())):
        n = max(min(e, L) - max(s, 0), 0)
        o, r = out[i * seg : (i + 1) * seg], ref[i * seg : (i + 1) * seg]
        if n == 0:
            torch.cuda.synchronize()
            assert (o.float() == 0).all()  # exactly 0, not merely close
        else:
            _close(o, r, **(SHORT_SPAN_TOL if n <= 50 else ATTN_TOL))


def test_single_source_kernels_take_views_and_refuse_other_layouts(dev):
    """K2 and K2g load q, k and v with TMA: the views the model passes (the
    VAE's q, k, v inside its qkv; the DiT's caption v inside kv_x) give the
    result of their contiguous copies bit for bit; a strided last
    dimension or a base off 16 bytes raises and launches nothing."""
    g = _gen(dev)
    B, N, h, hd = 2, 97, 4, 64
    qkv = _randn(g, dev, B, N, 3, h, hd)
    q, k, v = (qkv[:, :, i].reshape(B * N, h, hd) for i in range(3))
    assert not q.is_contiguous()
    st = torch.arange(B, dtype=torch.int32, device=dev) * N
    out = A.segmented_attention_v2(q, k, v, st, st + N, seg_len=N)
    dense = A.segmented_attention_v2(q.contiguous(), k.contiguous(), v.contiguous(), st, st + N, seg_len=N)
    _close(out, dense, atol=0, rtol=0)

    n_seg, seg, hq, hk, hd, L = 3, 70, 24, 8, 128, 60
    qx = _randn(g, dev, n_seg * seg, hq, hd)
    kv_x = _randn(g, dev, n_seg * L, hk, 2 * hd)
    k_x, v_x = kv_x[..., :hd].contiguous(), kv_x[..., hd:]
    xs = torch.arange(n_seg, dtype=torch.int32, device=dev) * L
    xe = xs + torch.tensor([L, 20, 0], dtype=torch.int32, device=dev)
    pro = (*_ln_affine(g, dev, hd), None, None, 1e-6)
    out = A.segmented_attention_v2(qx, k_x, v_x, xs, xe, seg_len=seg, q_prologue=pro)
    dense = A.segmented_attention_v2(qx, k_x, v_x.contiguous(), xs, xe, seg_len=seg, q_prologue=pro)
    _close(out, dense, atol=0, rtol=0)

    counts = lambda: (A.segmented_attention_v2.launches, A.segmented_attention.launches)
    before = counts()
    strided = _randn(g, dev, n_seg * L, hk, 2 * hd)[..., ::2]
    flat = torch.empty(n_seg * L * hk * hd + 1, dtype=torch.bfloat16, device=dev)
    misaligned = flat[1:].view(n_seg * L, hk, hd)
    for bad in (strided, misaligned):
        with pytest.raises(ValueError, match="16 bytes"):
            A.segmented_attention_v2(qx, k_x, bad, xs, xe, seg_len=seg, q_prologue=pro)
        with pytest.raises(ValueError, match="16 bytes"):
            A.segmented_attention(qx, bad, v_x, xs, xe, seg_len=seg)
    with pytest.raises(ValueError, match="16 bytes"):
        A.segmented_attention(_randn(g, dev, n_seg * seg, hq, 2 * hd)[..., ::2], k_x, v_x, xs, xe, seg_len=seg)
    assert counts() == before


def test_ranges_clip_to_sources(dev):
    """Range ends past a source's tokens (and a negative start) are clipped
    to the source, as in the plain versions: no read leaves the source."""
    g = _gen(dev)
    n_seg, seg, hq, hk, hd, L1, L2 = 3, 70, 8, 4, 128, 90, 120
    i32 = dict(dtype=torch.int32, device=dev)
    q = _randn(g, dev, n_seg * seg, hq, hd)
    kv1, kv2 = _randn(g, dev, 2, hk, L1, hd), _randn(g, dev, 2, hk, L2, hd)
    r1s, r1e = torch.tensor([-5, 60, 200], **i32), torch.tensor([L1 + 40, L1 + 1, 300], **i32)
    r2s, r2e = torch.tensor([0, 100, 0], **i32), torch.tensor([L2 + 64, L2 + 500, 30], **i32)
    out = A.segmented_attention_two_source(q, kv1, kv2, r1s, r1e, r2s, r2e, seg_len=seg)
    ref = A.segmented_attention_two_source_reference(q, kv1, kv2, r1s, r1e, r2s, r2e, seg_len=seg)
    _close(out, ref, **ATTN_TOL)
    clipped = [r.clamp(0, n) for r, n in ((r1s, L1), (r1e, L1), (r2s, L2), (r2e, L2))]
    _close(out, A.segmented_attention_two_source_reference(q, kv1, kv2, *clipped, seg_len=seg), **ATTN_TOL)
    k, v = kv2[0].transpose(0, 1).contiguous(), kv2[1].transpose(0, 1).contiguous()
    for wrapper in (A.segmented_attention, A.segmented_attention_v2):
        out = wrapper(q, k, v, r2s, r2e, seg_len=seg)
        _close(out, A.segmented_attention_reference(q, k, v, r2s, r2e, seg_len=seg), **ATTN_TOL)


def test_two_source_kernels_take_views_and_refuse_other_layouts(dev):
    """K1 and K5 (each scheme) load their sources with TMA: a token slice of a larger
    cache (a strided view) gives the result of its contiguous copy; a
    source whose last dimension is strided or whose base is not 16-byte
    aligned, and head_dim 64, raise and launch nothing."""
    g = _gen(dev)
    n_seg, seg, hq, hk, hd, L1 = 2, 70, 8, 4, 128, 100
    i32 = dict(dtype=torch.int32, device=dev)
    q = _randn(g, dev, n_seg * seg, hq, hd)
    big = _randn(g, dev, 2, hk, 3 * L1, hd)
    kv1, kv2 = big[:, :, :L1], _randn(g, dev, 2, hk, n_seg * seg, hd)
    assert not kv1.is_contiguous()
    ranges = (torch.tensor([0, 30], **i32), torch.tensor([L1, 90], **i32), torch.tensor([0, 5], **i32),
              torch.tensor([seg, 2 * seg], **i32))
    out = A.segmented_attention_two_source(q, kv1, kv2, *ranges, seg_len=seg)
    _close(out, A.segmented_attention_two_source(q, kv1.contiguous(), kv2, *ranges, seg_len=seg), atol=0, rtol=0)
    (k8, s8), (k8b, s8b) = _q8_inputs(g, dev, hk, 3 * L1, hd), _q8_inputs(g, dev, hk, n_seg * seg, hd)
    args = (q, k8[:, :, :L1], s8[:, :, :L1], k8b, s8b, *ranges)
    dense = (q, k8[:, :, :L1].contiguous(), s8[:, :, :L1].contiguous(), k8b, s8b, *ranges)
    for scheme in A8.SCHEMES:
        out = A8.segmented_attention_two_source_q8(*args, seg_len=seg, scheme=scheme)
        _close(out, A8.segmented_attention_two_source_q8(*dense, seg_len=seg, scheme=scheme), atol=0, rtol=0)

    counts = lambda: (A.segmented_attention_two_source.launches, A8.segmented_attention_two_source_q8.launches)
    before = counts()
    strided = _randn(g, dev, 2, hk, L1, 2 * hd)[..., ::2]
    flat = torch.empty(2 * hk * L1 * hd + 1, dtype=torch.bfloat16, device=dev)
    misaligned = flat[1:].view(2, hk, L1, hd)
    for bad in (strided, misaligned):
        with pytest.raises(ValueError, match="16 bytes"):
            A.segmented_attention_two_source(q, bad, kv2, *ranges, seg_len=seg)
    strided8 = torch.randint(-127, 128, (2, hk, L1, 2 * hd), generator=g, device=dev, dtype=torch.int8)[..., ::2]
    with pytest.raises(ValueError, match="16 bytes"):
        A8.segmented_attention_two_source_q8(q, strided8, s8[:, :, :L1], k8b, s8b, *ranges, seg_len=seg, scheme="qk8")
    q64 = _randn(g, dev, n_seg * seg, hq, 64)
    with pytest.raises(ValueError, match="head_dim 128"):
        A.segmented_attention_two_source(q64, kv1[..., :64].contiguous(), kv2[..., :64].contiguous(), *ranges,
                                         seg_len=seg)
    assert counts() == before


@pytest.mark.parametrize("S,hk,hd,rep,rot,shift", [pytest.param(*c, id=_kv_pack_id(c)) for c in KV_PACK_CASES])
def test_kv_norm_rope_pack_q8_kernel(dev, S, hk, hd, rep, rot, shift):
    args = _kv_pack_inputs(dev, S, hk, hd, rot, shift)
    before = A.kv_norm_rope_pack_q8.launches
    q8, sc = A.kv_norm_rope_pack(*args, eps=1e-6, rep=rep, quantize=True)
    assert A.kv_norm_rope_pack_q8.launches == before + 1
    ref8, ref_sc = A.kv_norm_rope_pack_q8_reference(*args, eps=1e-6, rep=rep)
    torch.cuda.synchronize()
    assert q8.dtype == torch.int8 and q8.shape == ref8.shape == (2, hk * rep, S, hd)
    assert sc.shape == ref_sc.shape == (2, hk * rep, S)
    torch.testing.assert_close(sc, ref_sc, atol=0, rtol=1e-6)
    dq = (q8.int() - ref8.int()).abs()
    assert int(dq.max()) <= 1 and float((dq > 0).float().mean()) < 1e-3


def _q8_inputs(g, dev, hk, L, hd):
    kv, sc = A8.quantize_kv_per_token(_randn(g, dev, 2, hk, L, hd))
    return kv, sc


@pytest.mark.parametrize("case", list(TWO_SOURCE_CASES))
def test_two_source_q8_kernel(dev, case):
    g = _gen(dev)
    q, pro, (kv1, sc1), (kv2, sc2), ranges, seg = _two_source_case(
        g, dev, case, lambda hk, L: _q8_inputs(g, dev, hk, L, 128))
    args = (q, kv1, sc1, kv2, sc2, *ranges)
    before = A8.segmented_attention_two_source_q8.launches
    out = A8.segmented_attention_two_source_q8(*args, seg_len=seg, q_prologue=pro)
    assert A8.segmented_attention_two_source_q8.launches == before + 1
    _close_two_source(out, A8.segmented_attention_two_source_q8_qk8_reference(*args, seg_len=seg, q_prologue=pro),
                      case, seg)
    deq = A8.segmented_attention_two_source_q8_reference(A.apply_q_prologue(q, pro), *args[1:], seg_len=seg).float()
    attended = slice(0, 2 * seg) if case == "0" else slice(0, 3 * seg)  # "0": the third segment attends nothing
    err = (out.float() - deq)[attended].abs().mean() / deq[attended].abs().mean()
    assert float(err) < 0.04, float(err)
    if case == "0":
        assert (out[2 * seg :].float() == 0).all()


def test_two_source_q8_kernel_captions(dev):
    """The int8 cross-attention: caption kv as source 1, an empty source 2,
    the norm-only prologue, head_dim 128."""
    g = _gen(dev)
    n_seg, seg, L, hq, hk, hd = 2, 97, 80, 24, 8, 128
    q = _randn(g, dev, n_seg * seg, hq, hd)
    kv1, sc1 = _q8_inputs(g, dev, hk, n_seg * L, hd)
    kv2, sc2 = kv1[:, :, :0], sc1[:, :, :0]
    st = torch.arange(n_seg, dtype=torch.int32, device=dev) * L
    en = st + torch.tensor([L, 13], dtype=torch.int32, device=dev)
    z = torch.zeros_like(st)
    pro = (*_ln_affine(g, dev, hd), None, None, 1e-6)
    args = (q, kv1, sc1, kv2, sc2, st, en, z, z)
    out = A8.segmented_attention_two_source_q8(*args, seg_len=seg, q_prologue=pro)
    ref = A8.segmented_attention_two_source_q8_qk8_reference(*args, seg_len=seg, q_prologue=pro)
    _close(out[:seg], ref[:seg], **ATTN_TOL)  # 80 keys
    _close(out[seg:], ref[seg:], **SHORT_SPAN_TOL)  # 13 keys


SCHEME_WRAPPERS = {"sage": "segmented_attention_two_source_q8_sage", "dq": "segmented_attention_two_source_q8_dq"}
SCHEME_PLAIN = {"sage": "segmented_attention_two_source_q8_sage_reference",
                "dq": "segmented_attention_two_source_q8_dq_reference"}


@pytest.mark.parametrize("L1", [0, 200])
@pytest.mark.parametrize("scheme", ["sage", "dq"])
def test_two_source_q8_scheme_kernel(dev, scheme, L1, monkeypatch):
    """K5 under `MAGI_ATTN_Q8_SCHEME` sage and dq: its own launch count,
    the attention tolerance against the tiled plain version at the
    kernel's tile width (ranges that start off the tile grid), and the
    dequant reference's 4% mean error."""
    monkeypatch.setenv("MAGI_ATTN_Q8_SCHEME", scheme)
    g = _gen(dev)
    n_seg, seg, hq, hk, hd, rot = 3, 130, 24, 8, 128, 48
    S = n_seg * seg
    q = _randn(g, dev, S, hq, hd)
    kv1, sc1 = _q8_inputs(g, dev, hk, L1, hd)
    kv2, sc2 = _q8_inputs(g, dev, hk, S, hd)
    i32 = dict(dtype=torch.int32, device=dev)
    r1s = torch.tensor([0, 50, 0], **i32).clamp(max=L1)
    r1e = torch.tensor([L1, L1, 0], **i32)
    r2s, r2e = torch.tensor([0, 70, 7], **i32), torch.tensor([seg, 2 * seg, 7], **i32)
    qw, qb = _ln_affine(g, dev, hd)
    pro = (qw, qb, torch.sin(_randn(g, dev, S, rot, dtype=torch.float32)),
           torch.cos(_randn(g, dev, S, rot, dtype=torch.float32)), 1e-6)
    args = (q, kv1, sc1, kv2, sc2, r1s, r1e, r2s, r2e)
    wrapper = getattr(A8, SCHEME_WRAPPERS[scheme])
    before = (wrapper.launches, A8.segmented_attention_two_source_q8.launches)
    out = A8.segmented_attention_two_source_q8(*args, seg_len=seg, q_prologue=pro)
    assert (wrapper.launches, A8.segmented_attention_two_source_q8.launches) == (before[0] + 1, before[1])
    plain = getattr(A8, SCHEME_PLAIN[scheme])(*args, seg_len=seg, q_prologue=pro, block_k=A8.KERNEL_BLOCK_K)
    _close(out, plain, **ATTN_TOL)
    deq = A8.segmented_attention_two_source_q8_reference(A.apply_q_prologue(q, pro), *args[1:], seg_len=seg).float()
    attended = slice(0, 2 * seg) if L1 == 0 else slice(0, S)  # L1 == 0: the third segment attends nothing
    err = (out.float() - deq)[attended].abs().mean() / deq[attended].abs().mean()
    assert float(err) < 0.04, float(err)
    if L1 == 0:
        assert (out[2 * seg :].float() == 0).all()


@pytest.mark.parametrize("scheme", ["sage", "dq"])
def test_two_source_q8_scheme_kernel_captions(dev, scheme):
    """The int8 cross-attention under sage and dq: caption kv as source 1
    (segments start off the tile grid), an empty source 2, the norm-only
    prologue."""
    g = _gen(dev)
    n_seg, seg, L, hq, hk, hd = 2, 97, 80, 24, 8, 128
    q = _randn(g, dev, n_seg * seg, hq, hd)
    kv1, sc1 = _q8_inputs(g, dev, hk, n_seg * L, hd)
    kv2, sc2 = kv1[:, :, :0], sc1[:, :, :0]
    st = torch.arange(n_seg, dtype=torch.int32, device=dev) * L
    en = st + torch.tensor([L, 13], dtype=torch.int32, device=dev)
    z = torch.zeros_like(st)
    pro = (*_ln_affine(g, dev, hd), None, None, 1e-6)
    args = (q, kv1, sc1, kv2, sc2, st, en, z, z)
    out = A8.segmented_attention_two_source_q8(*args, seg_len=seg, q_prologue=pro, scheme=scheme)
    ref = getattr(A8, SCHEME_PLAIN[scheme])(*args, seg_len=seg, q_prologue=pro)
    _close(out[:seg], ref[:seg], **ATTN_TOL)  # 80 keys
    _close(out[seg:], ref[seg:], **SHORT_SPAN_TOL)  # 13 keys


@pytest.mark.parametrize("case", list(TWO_SOURCE_CASES))
@pytest.mark.parametrize("scheme", ["sage", "dq"])
def test_two_source_q8_scheme_cases(dev, scheme, case):
    """K5 sage and dq on the two-source cases, whose tiles are aligned to 64
    tokens within each source: ranges that start inside a tile in both
    sources ("off_grid": the tokens of the first tile before the range
    start are masked), a source shorter than one tile ("short"), two head
    groups per kv head ("48x8"), and a segment with empty ranges, whose
    output is exactly 0 ("0")."""
    g = _gen(dev)
    q, pro, (kv1, sc1), (kv2, sc2), ranges, seg = _two_source_case(
        g, dev, case, lambda hk, L: _q8_inputs(g, dev, hk, L, 128))
    args = (q, kv1, sc1, kv2, sc2, *ranges)
    wrapper = getattr(A8, SCHEME_WRAPPERS[scheme])
    before = wrapper.launches
    out = A8.segmented_attention_two_source_q8(*args, seg_len=seg, q_prologue=pro, scheme=scheme)
    assert wrapper.launches == before + 1
    _close_two_source(out, getattr(A8, SCHEME_PLAIN[scheme])(*args, seg_len=seg, q_prologue=pro), case, seg)
    deq = A8.segmented_attention_two_source_q8_reference(A.apply_q_prologue(q, pro), *args[1:], seg_len=seg).float()
    attended = slice(0, 2 * seg) if case == "0" else slice(0, 3 * seg)  # "0": the third segment attends nothing
    err = (out.float() - deq)[attended].abs().mean() / deq[attended].abs().mean()
    assert float(err) < 0.04, float(err)
    if case == "0":
        assert (out[2 * seg :].float() == 0).all()


@pytest.mark.parametrize("scheme", A8.SCHEMES)
def test_two_source_q8_kernels_never_read_scales_outside_ranges(dev, scheme):
    """Every K5 kernel reads the k and v scales of attended tokens only: with
    the scales of the tokens no segment attends set to NaN (before and
    after the ranges, some inside a tile that a range starts or ends in),
    the output is bit-equal to the one with finite scales."""
    g = _gen(dev)
    q, pro, (kv1, sc1), (kv2, sc2), ranges, seg = _two_source_case(
        g, dev, "off_grid", lambda hk, L: _q8_inputs(g, dev, hk, L, 128))
    call = lambda s1, s2: A8.segmented_attention_two_source_q8(q, kv1, s1, kv2, s2, *ranges, seg_len=seg,
                                                               q_prologue=pro, scheme=scheme)
    nan_sc = []
    for sc, starts, ends in ((sc1, *ranges[:2]), (sc2, *ranges[2:])):
        used = torch.zeros(sc.shape[-1], dtype=torch.bool, device=dev)
        for a, b in zip(starts.tolist(), ends.tolist()):
            used[a:b] = True
        assert not used.all()
        nan_sc.append(sc.masked_fill(~used, float("nan")))
    out = call(sc1, sc2)
    _close(call(*nan_sc), out, atol=0, rtol=0)


# ragged M, N and K around the kernels' tiles (K6 128 x 256 with k tiles of
# 128, K7 256 tokens x 128 weight rows with k tiles of 64) and one full
# 4.5B GEMM (fc1 of a segment batch)
QMM_SHAPES = [(300, 256, 384), (1, 16, 16), (129, 3072, 1024), (1, 16400, 1040), (4000, 3072, 272),
              (4000, 16400, 1040), (7680, 3072, 12288)]


@pytest.mark.parametrize("m,k,n", QMM_SHAPES)
def test_quantized_matmul_i8_kernel(dev, m, k, n):
    g = _gen(dev)
    xq, rs = Q.act_quant_rowwise(_randn(g, dev, m, k))
    wq, ws = Q.quantize_int8(_randn(g, dev, k, n))
    before = Q.quantized_matmul_i8.launches
    out = Q.quantized_matmul_i8(xq, rs, wq, ws)
    assert Q.quantized_matmul_i8.launches == before + 1
    ref = Q.quantized_matmul_i8_reference(xq, rs, wq, ws)
    torch.cuda.synchronize()
    assert torch.equal(out, ref)


@pytest.mark.parametrize("m,k,n", [(300, 256, 384), (129, 1536, 3072), (3840, 6144, 3072)])
def test_quantized_matmul_i8_kernel_f32_out(dev, m, k, n):
    """K6's f32 epilogue (a row-parallel linear's partial sums) gives its
    plain version's bits, and the bf16 output is their rounding."""
    g = _gen(dev)
    xq, rs = Q.act_quant_rowwise(_randn(g, dev, m, k))
    wq, ws = Q.quantize_int8(_randn(g, dev, k, n))
    before = Q.quantized_matmul_i8.launches
    out = Q.quantized_matmul_i8(xq, rs, wq, ws, out_dtype=torch.float32)
    assert Q.quantized_matmul_i8.launches == before + 1 and out.dtype == torch.float32
    ref = Q.quantized_matmul_i8_reference(xq, rs, wq, ws, out_dtype=torch.float32)
    torch.cuda.synchronize()
    assert torch.equal(out, ref)
    assert torch.equal(out.bfloat16(), Q.quantized_matmul_i8(xq, rs, wq, ws))


@pytest.mark.parametrize("mode,k", [("plain", 6144), ("plain", 260), ("ln", 3072), ("ln", 12288)])
def test_rowquant_fused_kernel(dev, mode, k):
    g = _gen(dev)
    x = (3 * torch.randn((300, k), generator=g, device=dev)).to(torch.bfloat16)
    x[7] = 0  # a zero row: scale 1, values 0
    w, b = (_ln_affine(g, dev, k) if mode == "ln" else (None, None))
    before = AQ.rowquant_fused.launches
    q8, sc = AQ.rowquant_fused(x, mode, w, b, eps=1e-6)
    assert AQ.rowquant_fused.launches == before + 1
    ref8, ref_sc = AQ.rowquant_fused_reference(x, mode, w, b, eps=1e-6)
    torch.cuda.synchronize()
    assert torch.equal(q8, ref8) and torch.equal(sc, ref_sc)
    if mode == "plain":
        assert float(sc[7]) == 1.0 and int(q8[7].abs().max()) == 0


@pytest.mark.parametrize("pre", ["ln", None])
def test_linears_shared_int8_runs_the_kernels(dev, pre, monkeypatch):
    """The model's int8 linear group on the card: one K8 row quantization
    and one K6 GEMM per linear, whatever the JAX package's Pallas/XLA
    switches say, bit-equal to the plain versions."""
    for var in ("MAGI_QMM_IMPL", "MAGI_FUSED_ACT_QUANT"):
        monkeypatch.delenv(var, raising=False)
    g = _gen(dev)
    x = _randn(g, dev, 200, 256)
    w, b = _ln_affine(g, dev, 256)
    lnp = {"weight": w.to(torch.bfloat16), "bias": b.to(torch.bfloat16)}
    plist = [dict(zip(("weight_q", "weight_scale"), Q.quantize_int8(_randn(g, dev, 256, n)))) for n in (128, 64)]
    k6, k8 = Q.quantized_matmul_i8.launches, AQ.rowquant_fused.launches
    out = M._linears_shared(x, plist, True, pre=None if pre is None else ("ln", lnp), eps=1e-6)
    assert (Q.quantized_matmul_i8.launches - k6, AQ.rowquant_fused.launches - k8) == (2, 1)
    xq, rs = AQ.rowquant_fused_reference(x, pre or "plain", lnp["weight"], lnp["bias"], eps=1e-6)
    torch.cuda.synchronize()
    for o, pp in zip(out, plist):
        assert o.dtype == torch.bfloat16
        assert torch.equal(o, Q.quantized_matmul_i8_reference(xq, rs, pp["weight_q"], pp["weight_scale"]))


K7_TOL = dict(atol=1e-3, rtol=2**-7)


@pytest.mark.parametrize("m,k,n", QMM_SHAPES + [(129, 6144, 1024), (200, 16400, 272)])
def test_quantized_matmul_kernel(dev, m, k, n):
    g = _gen(dev)
    x = _randn(g, dev, m, k)
    wq, ws = Q.quantize_int8(0.02 * _randn(g, dev, k, n, dtype=torch.float32))
    before = Q.quantized_matmul.launches
    out = Q.quantized_matmul(x, wq, ws)
    assert Q.quantized_matmul.launches == before + 1
    assert out.dtype == torch.bfloat16 and out.shape == (m, n)
    _close(out, Q.quantized_matmul_reference(x, wq, ws), **K7_TOL)


@pytest.mark.parametrize("m,k,n", [(300, 256, 384), (3840, 6144, 3072)])
def test_quantized_matmul_kernel_f32_out(dev, m, k, n):
    """K7's f32 epilogue (a row-parallel linear's partial sums): its bf16
    rounding is the bf16 kernel's output bit for bit, and it is within f32
    rounding (the sum's order, the scale after it) of its plain version."""
    g = _gen(dev)
    x = _randn(g, dev, m, k)
    wq, ws = Q.quantize_int8(0.02 * _randn(g, dev, k, n, dtype=torch.float32))
    before = (Q.quantized_matmul.launches, Q.quantized_matmul.launches_f32)
    out = Q.quantized_matmul(x, wq, ws, out_dtype=torch.float32)
    assert (Q.quantized_matmul.launches, Q.quantized_matmul.launches_f32) == (before[0] + 1, before[1] + 1)
    assert out.dtype == torch.float32 and out.shape == (m, n)
    assert torch.equal(out.bfloat16(), Q.quantized_matmul(x, wq, ws))
    ref = Q.quantized_matmul_reference(x, wq, ws, out_dtype=torch.float32)
    torch.testing.assert_close(out, ref, atol=1e-4, rtol=1e-4)


def test_dot_f32_keeps_the_bf16_product_unrounded(dev):
    """A row-parallel bf16 linear's partial sums on the card: the bf16
    product accumulated and written in f32, as the exact f32 product of the
    same values (TF32 off) gives it, to f32 rounding."""
    from magi_tpu_torch.models.dit.model import _dot_f32

    g = _gen(dev)
    x, w = _randn(g, dev, 300, 1536), _randn(g, dev, 1536, 384)
    out = _dot_f32(x, w)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        ref = x.float() @ w.float()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    assert out.dtype == torch.float32
    torch.testing.assert_close(out, ref, atol=1e-3, rtol=1e-5)
    assert not torch.equal(out, (x @ w).float())  # the bf16 product would be rounded


@pytest.mark.parametrize("f", [1536, 16384])
def test_rowquant_fused_swiglu_kernel(dev, f):
    g = _gen(dev)
    x = (3 * torch.randn((300, 2 * f), generator=g, device=dev)).to(torch.bfloat16)
    x[7] = 0  # a zero row: scale 1, values 0
    x[9, :f] = -100.0  # silu of a large negative gate: -0
    before = AQ.rowquant_swiglu.launches
    q8, sc = AQ.rowquant_fused(x, "swiglu")
    assert AQ.rowquant_swiglu.launches == before + 1
    ref8, ref_sc = AQ.rowquant_fused_reference(x, "swiglu")
    torch.cuda.synchronize()
    assert q8.shape == (300, f) and torch.equal(q8, ref8) and torch.equal(sc, ref_sc)
    assert float(sc[7]) == 1.0 and int(q8[7].abs().max()) == 0 and float(sc[9]) == 1.0


def test_int4_gated_layer_runs_the_kernels(dev, monkeypatch):
    """A gated MLP on int4 weights: the middle layer's fc2 group runs one
    K8s and one K6 per linear; the same group in a layer without act_ok (a
    tree without blocks_edge) runs K7 per linear on the unfused SwiGLU."""
    for var in ("MAGI_QMM_IMPL", "MAGI_FUSED_ACT_QUANT"):
        monkeypatch.delenv(var, raising=False)
    g = _gen(dev)
    f, n = 256, 128
    x = _randn(g, dev, 200, 2 * f)
    plist = [dict(zip(("weight_q4", "weight_scale"), Q.quantize_int4(0.02 * _randn(g, dev, f, n))))
             for _ in range(2)]
    counts = lambda: (Q.quantized_matmul_i8.launches, AQ.rowquant_swiglu.launches, Q.quantized_matmul.launches)
    before = counts()
    out = M._linears_shared(x, plist, True, pre=("swiglu",))
    assert tuple(a - b for a, b in zip(counts(), before)) == (2, 1, 0)
    xq, rs = AQ.rowquant_fused_reference(x, "swiglu")
    torch.cuda.synchronize()
    for o, pp in zip(out, plist):
        ref = Q.quantized_matmul_i8_reference(xq, rs, Q.unpack_int4(pp["weight_q4"]), pp["weight_scale"])
        assert torch.equal(o, ref)
    before = counts()
    out = M._linears_shared(x, plist, False, pre=("swiglu",))
    assert tuple(a - b for a, b in zip(counts(), before)) == (0, 0, 2)
    xs = M._apply_pre(x, ("swiglu",), 1e-6)
    for o, pp in zip(out, plist):
        _close(o, Q.quantized_matmul_reference(xs, Q.unpack_int4(pp["weight_q4"]), pp["weight_scale"]), **K7_TOL)


def test_quantized_matmuls_refuse_row_major_weights(dev):
    """K6 and K7 take only k-major weights on the card: a row-major copy of
    the same values raises, naming what makes the layout, and launches
    nothing (no copy, no fallback)."""
    g = _gen(dev)
    xq, rs = Q.act_quant_rowwise(_randn(g, dev, 64, 256))
    wq, ws = Q.quantize_int8(_randn(g, dev, 256, 128))
    row_major = wq.contiguous()
    assert torch.equal(row_major, wq) and row_major.stride() == (128, 1)
    before = (Q.quantized_matmul_i8.launches, Q.quantized_matmul.launches)
    with pytest.raises(ValueError, match="k-major.*quantize_int8.*unpack_int4"):
        Q.quantized_matmul_i8(xq, rs, row_major, ws)
    with pytest.raises(ValueError, match="k-major.*quantize_int8.*unpack_int4"):
        Q.quantized_matmul(_randn(g, dev, 64, 256), row_major, ws)
    assert (Q.quantized_matmul_i8.launches, Q.quantized_matmul.launches) == before


@pytest.mark.parametrize("act_ok", [True, False])
@pytest.mark.parametrize("pre", ["ln", None, "swiglu"])
def test_linears_shared_smooth_runs_the_kernels(dev, pre, act_ok):
    """A smooth-quant linear (`act_smooth` s, weight quantized s·W, k-major)
    on the card: its producer unfused, the divide by s (the same bits as
    on the CPU), then one K8 `plain` and one K6 (bit-equal to their plain
    versions), or one K7 without act_ok; never K8s, a smoothed gated fc2
    included."""
    g = _gen(dev)
    k, n = 256, 128
    x = _randn(g, dev, 200, 2 * k if pre == "swiglu" else k)
    s = 0.5 + 1.5 * torch.rand((1, k), generator=g, device=dev)
    wq, ws = Q._quantize_stacked(0.02 * _randn(g, dev, 1, k, n), 8, s)
    assert wq.stride()[1] == 1
    w, b = _ln_affine(g, dev, k)
    lnp = {"weight": w.to(torch.bfloat16), "bias": b.to(torch.bfloat16)}
    prod = {"ln": ("ln", lnp), None: None, "swiglu": ("swiglu",)}[pre]
    pp = {"weight_q": wq[0], "weight_scale": ws[0], "act_smooth": s[0]}
    counts = lambda: (AQ.rowquant_fused.launches, Q.quantized_matmul_i8.launches, Q.quantized_matmul.launches,
                      AQ.rowquant_swiglu.launches)
    before = counts()
    (out,) = M._linears_shared(x, [pp], act_ok, pre=prod, eps=1e-6)
    assert tuple(a - c for a, c in zip(counts(), before)) == ((1, 1, 0, 0) if act_ok else (0, 0, 1, 0))
    xs = M._smooth_divide(M._apply_pre(x, prod, 1e-6), s[0])
    assert torch.equal(xs.cpu(), M._smooth_divide(M._apply_pre(x, prod, 1e-6).cpu(), s[0].cpu()))
    if act_ok:
        xq, rs = AQ.rowquant_fused_reference(xs, "plain")
        assert torch.equal(out, Q.quantized_matmul_i8_reference(xq, rs, pp["weight_q"], pp["weight_scale"]))
    else:
        _close(out, Q.quantized_matmul_reference(xs, pp["weight_q"], pp["weight_scale"]), **K7_TOL)


def test_fp8_dequant_on_the_card_matches_the_cpu(dev, tmp_path):
    """The loader's leaf-by-leaf fp8 dequant (a PerTensor and a smooth-quant
    linear, as released) on the card: the same bits as on the CPU."""
    from magi_tpu_torch.checkpoint import loader as L
    from magi_tpu_torch.checkpoint import safetensors_io as SIO

    g = torch.Generator().manual_seed(0)
    state = {}
    for name, (o, i) in (("q", (96, 64)), ("fc2", (64, 160))):
        w = torch.randn((o, i), generator=g) * 0.02
        smooth = 0.5 + 1.5 * torch.rand(i, generator=g)
        if name == "fc2":
            w = w * smooth[None, :]
            state[f"{name}.input_scale"] = torch.tensor([0.01])
            state[f"{name}.smooth_scale"] = (smooth * 0.01)[None]
        ws = w.abs().max() / 448.0
        state[f"{name}.weight"] = (w / ws).clamp(-448, 448).to(torch.float8_e4m3fn)[None]
        state[f"{name}.weight_scale"] = ws.reshape(1)
    (tmp_path / "inference_weight.fp8").mkdir()
    SIO.save_file(state, str(tmp_path / "inference_weight.fp8" / "model.safetensors"))
    loaded = L.load_state_dict(str(tmp_path), fp8_quant=True)
    on_card, on_cpu = L._dequant_fp8(loaded, dev), L._dequant_fp8(loaded, "cpu")
    assert sorted(on_card) == ["fc2.act_smooth", "fc2.weight", "q.weight"]
    for key in on_cpu:
        got = on_card[key]
        assert got.device.type == "cuda" and got.dtype == torch.float32, key
        assert torch.equal(got.cpu(), on_cpu[key]), key


class _Tokenizer:
    def __call__(self, texts, max_length, **kwargs):
        import numpy as np

        ids = np.zeros((len(texts), max_length), np.int64)
        ids[:, :4] = [5, 9, 13, 1]
        return {"input_ids": ids, "attention_mask": (ids != 0).astype(np.int64)}


def test_t5_staged_encode_frees_the_card(dev, tmp_path):
    """A T5 embedder staged onto the card (t5_device "auto"): its weights
    stay on the host, the device memory after an encode is what it was
    before, and the output equals the encode of a resident copy."""
    import json

    from magi_tpu_torch.checkpoint import safetensors_io as SIO
    from magi_tpu_torch.models.t5 import model as T5

    cfg = dict(vocab_size=64, d_model=64, d_kv=16, num_heads=4, d_ff=128, num_layers=2,
               relative_attention_num_buckets=8, relative_attention_max_distance=16)
    (tmp_path / "config.json").write_text(json.dumps(cfg))
    g = torch.Generator().manual_seed(1)
    state = {"shared.weight": torch.randn((64, 64), generator=g),
             T5._REL_BIAS: torch.randn((8, 4), generator=g),
             "encoder.final_layer_norm.weight": torch.ones(64)}
    for i in range(2):
        for key, (fmt, _) in T5._T5_LAYER_FMTS.items():
            shape = {"ln1": (64,), "ln2": (64,), "o": (64, 64), "wi_0": (128, 64), "wi_1": (128, 64),
                     "wo": (64, 128)}.get(key, (64, 64))
            state[fmt.format(i)] = torch.ones(shape) if key.startswith("ln") else 0.1 * torch.randn(shape, generator=g)
    SIO.save_file(state, str(tmp_path / "model.safetensors"))
    emb = T5.T5Embedder(str(tmp_path), model_max_length=16, dtype=torch.float32, device="auto",
                        pipeline_device=dev, tokenizer=_Tokenizer())
    assert emb.device.type == "cuda" and emb.params["blocks"]["q"].device.type == "cpu"
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated(dev)
    got, mask = emb.get_text_embeddings(["a red cube"])
    torch.cuda.synchronize()
    assert torch.cuda.memory_allocated(dev) == before
    assert got.device.type == "cpu" and tuple(got.shape) == (1, 16, 64)
    resident = T5._tree_to(emb.params, dev)
    ids = torch.as_tensor(emb.tokenizer(["a red cube"], 16)["input_ids"])
    want = T5.t5_encoder_forward(resident, emb.config, ids, mask).cpu()
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------------------
# the walk's modes on the card: packed CFG, the host-streamed cache, several
# requests (tiny models at head_dim 128, so every kernel of the path runs)
# ---------------------------------------------------------------------------


def test_packed_forward_two_source_kernel(dev):
    """K1 on the packed forward's operands: window segments over 2 cached
    chunks, then uncond segments whose ranges lie past the window's in the
    current source (source 1 empty at the split, as `attention_forward`
    clamps them)."""
    g = _gen(dev)
    hq, hk, hd, rot, ctn, n_seg, n_den, cache_sp = 24, 8, 128, 48, 192, 3, 2, 2
    S, start = (n_seg + n_den) * ctn, cache_sp * ctn
    q = _randn(g, dev, S, hq, hd)
    kv1, kv2 = _randn(g, dev, 2, hk, 4 * ctn, hd), _randn(g, dev, 2, hk, S, hd)
    gs = torch.tensor([0, ctn, start] + [start + (n_seg + i) * ctn for i in range(n_den)], dtype=torch.int32,
                      device=dev)
    ge = torch.tensor([start + (i + 1) * ctn for i in range(n_seg)] + [start + (n_seg + i + 1) * ctn
                                                                       for i in range(n_den)], dtype=torch.int32,
                      device=dev)
    ranges = (gs.clamp(max=start), ge.clamp(max=start), (gs - start).clamp(min=0), (ge - start).clamp(min=0))
    assert (ranges[0][n_seg:] == ranges[1][n_seg:]).all()
    qw, qb = _ln_affine(g, dev, hd)
    pro = (qw, qb, torch.sin(_randn(g, dev, S, rot, dtype=torch.float32)),
           torch.cos(_randn(g, dev, S, rot, dtype=torch.float32)), 1e-6)
    out = A.segmented_attention_two_source(q, kv1, kv2, *ranges, seg_len=ctn, q_prologue=pro)
    ref = A.segmented_attention_two_source_reference(A.apply_q_prologue(q, pro), kv1, kv2, *ranges, seg_len=ctn)
    _close(out, ref, **ATTN_TOL)


def _tiny_card_dict(name: str, **engine) -> dict:
    """An example config at head_dim 128 with 3 layers (one middle layer),
    its default kv ranges, a 16x16 latent and 3 chunks of 2 frames."""
    import json
    import os

    with open(os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "example", "4.5B", name)) as f:
        d = json.load(f)
    d["model_config"].update(num_layers=3, hidden_size=768, ffn_hidden_size=1536, num_attention_heads=6,
                             num_query_groups=2, caption_channels=64, caption_max_length=32)
    d["runtime_config"].update(num_steps=8, window_size=2, chunk_width=2, noise2clean_kvrange=[],
                               video_size_h=128, video_size_w=128, num_frames=24)
    d["engine_config"].update(engine)
    return d


def _tiny_card_input(cfg, dev, g):
    from magi_tpu_torch.sampling.transport import InferenceInput

    mc = cfg.model_config
    L, n = mc.caption_max_length, 3
    return InferenceInput(caption_embs=torch.randn((n, L, mc.caption_channels), generator=g, device=dev),
                          caption_lens=[9, 20, 5], null_emb=torch.randn((L, mc.caption_channels), generator=g,
                                                                        device=dev),
                          null_len=5, latent_size=(mc.in_channels, 2 * n, 16, 16), num_steps=8, chunk_num=n,
                          has_text=True)


@pytest.mark.parametrize("int8", [False, True])
def test_streamed_walk_is_bit_equal_to_the_resident_walk(dev, int8):
    """The host-streamed KV cache (`kv_offload`, default kv ranges) on the
    card: K1 and K3 (bf16), K5 and K3q (the int8 dict) read and write
    token-major slabs copied up from pinned host memory, and the walk emits
    the resident walk's latents bit for bit and leaves the resident cache's
    bits in the host buffer."""
    from magi_tpu_torch.core.config import MagiConfig
    from magi_tpu_torch.models.dit.model import init_dit_params
    from magi_tpu_torch.sampling.transport import ArdfSampler

    name = "4.5B_distill_quant_config.json" if int8 else "4.5B_base_config.json"
    cfgs = [MagiConfig.from_dict(_tiny_card_dict(name, attn_int8=int8, kv_offload=offload))
            for offload in (False, True)]
    g = _gen(dev)
    params = init_dit_params(cfgs[0], dev, g)
    if int8:
        params = Q.quantize_params_int8(params)
    inp = _tiny_card_input(cfgs[0], dev, g)
    noise = torch.randn(inp.latent_size, generator=g, device=dev)
    attn = A8.segmented_attention_two_source_q8 if int8 else A.segmented_attention_two_source
    runs = []
    for cfg in cfgs:
        s = ArdfSampler(cfg, params, inp, noise=noise, device=dev)
        before = attn.launches
        chunks = [c for _, c in s.walk()]
        torch.cuda.synchronize()
        runs.append((s, chunks, attn.launches - before))
    (res, a, na), (st, b, nb) = runs
    assert st.host_mode and st.cache is None and not res.host_mode and na == nb > 0
    assert len(a) == len(b) == 3 and all(torch.equal(x, y) for x, y in zip(a, b))
    buf = st.host_cache.buf
    for k in (("kv", "scale") if int8 else (None,)):
        host, dense = (buf, res.cache) if k is None else (buf[k], res.cache[k])
        assert host.is_pinned() and torch.equal(host, dense.cpu())


# The released 24B base config's stage-3 step at 256x256 (chip_smoke.py
# phase 18a): 48 / 8 heads, 4 segments of 1536 tokens, every segment's
# noise2clean span reaching chunk 0, no cache before the window; and stage
# 4's second step, 3 segments over one cached chunk.
STEP_24B = {"stage3": (0, [0, 0, 0, 0], [1, 2, 3, 4]), "stage4": (1, [0, 0, 0], [2, 3, 4])}


@pytest.mark.parametrize("step", list(STEP_24B))
def test_kernels_at_the_24b_step(dev, step):
    """K3 (bf16, 8 kv heads) packs the step's k and v, and K1 (6 q heads a
    kv head) attends over them and the cache, cond ranges and the uncond
    forward's self-only ones, against their plain versions."""
    hq, hk, hd, rot, ctn, eps = 48, 8, 128, 48, 1536, 1e-6
    cached, starts, ends = STEP_24B[step]
    g = _gen(dev)
    n_seg = len(starts)
    S, st = n_seg * ctn, cached * ctn
    k, v = _randn(g, dev, S, hk, hd), _randn(g, dev, S, hk, hd)
    kw, kb = _ln_affine(g, dev, hd)
    ang = torch.rand((S, rot), generator=g, device=dev) * 6.28
    sin, cos = torch.sin(ang), torch.cos(ang)
    kv2 = A.kv_norm_rope_pack(k, v, kw, kb, sin, cos, eps=eps)
    _close(kv2, A.kv_norm_rope_pack_reference(k, v, kw, kb, sin, cos, eps=eps), 1e-2, 1e-2)
    cache = torch.zeros((2, hk, 4 * ctn, hd), dtype=torch.bfloat16, device=dev)
    cache[:, :, :st] = _randn(g, dev, 2, hk, st, hd)
    i32 = dict(dtype=torch.int32, device=dev)
    gs, ge = torch.tensor(starts, **i32) * ctn, torch.tensor(ends, **i32) * ctn
    ranges = (torch.clamp(gs, max=st), torch.clamp(ge, max=st), torch.clamp(gs - st, min=0),
              torch.clamp(ge - st, min=0))
    z, us = torch.zeros(n_seg, **i32), torch.arange(n_seg, **i32) * ctn
    qw, qb = _ln_affine(g, dev, hd)
    q = _randn(g, dev, S, hq, hd)
    pro = (qw, qb, sin, cos, eps)
    qn = A.apply_q_prologue(q, pro)
    for src1, rr in ((cache, ranges), (cache[:, :, :0], (z, z, us, us + ctn))):
        out = A.segmented_attention_two_source(q, src1, kv2, *rr, seg_len=ctn, q_prologue=pro)
        _close(out, A.segmented_attention_two_source_reference(qn, src1, kv2, *rr, seg_len=ctn), **ATTN_TOL)


def test_streamed_walk_at_24b_width_is_bit_equal_to_the_resident_walk(dev):
    """The released 24B distill config (bf16, gated MLP, the half-channel
    latent) at full width cut to 3 layers, walked under the default kv
    ranges with the cache resident and then host-streamed (`kv_offload`):
    the bf16 slabs at 8 kv heads, 6 q heads each, give the resident walk's
    latents bit for bit and leave its cache's bits in the host buffer."""
    import json
    import os

    from magi_tpu_torch.core.config import MagiConfig
    from magi_tpu_torch.models.dit.model import init_dit_params
    from magi_tpu_torch.sampling.transport import ArdfSampler, InferenceInput

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(root, "example", "24B", "24B_distill_config.json")) as f:
        d = json.load(f)
    d["model_config"]["num_layers"] = 3
    d["runtime_config"].update(num_steps=8, window_size=2, noise2clean_kvrange=[], video_size_h=128,
                               video_size_w=128, num_frames=72)
    d["engine_config"]["cp_size"] = 1
    cfgs = []
    for offload in (False, True):
        d["engine_config"]["kv_offload"] = offload
        cfgs.append(MagiConfig.from_dict(d))
    mc = cfgs[0].model_config
    g = _gen(dev)
    params = init_dit_params(cfgs[0], dev, g)
    L, n = mc.caption_max_length, 3
    inp = InferenceInput(caption_embs=torch.randn((n, L, mc.caption_channels), generator=g, device=dev),
                         caption_lens=[9, 20, 5], null_emb=torch.randn((L, mc.caption_channels), generator=g,
                                                                       device=dev),
                         null_len=50, latent_size=(mc.in_channels // 2, 6 * n, 16, 16), num_steps=8, chunk_num=n,
                         has_text=True)
    noise = torch.randn(inp.latent_size, generator=g, device=dev)
    runs = []
    for cfg in cfgs:
        s = ArdfSampler(cfg, params, inp, noise=noise, device=dev)
        before = A.segmented_attention_two_source.launches
        chunks = [c.clone() for _, c in s.walk()]
        torch.cuda.synchronize()
        runs.append((s, chunks, A.segmented_attention_two_source.launches - before))
    (res, a, na), (st, b, nb) = runs
    assert st.host_mode and st.cache is None and not res.host_mode and na == nb > 0
    assert len(a) == len(b) == n and all(torch.equal(x, y) for x, y in zip(a, b))
    assert st.host_cache.buf.is_pinned() and torch.equal(st.host_cache.buf, res.cache.cpu())


def test_interleaved_decode_on_its_stream_matches_solo_runs(dev, tmp_path, monkeypatch):
    """`run_text_to_video_many` decodes each chunk on a worker thread on its
    own stream while the walk goes on: its frames equal those of solo
    `_run`s of the same requests (the same weights, each request's
    generator)."""
    import json

    import numpy as np

    from magi_tpu_torch.pipeline import pipeline as P

    monkeypatch.setenv("SKIP_LOAD_MODEL", "1")
    path = tmp_path / "tiny.json"
    path.write_text(json.dumps(_tiny_card_dict("4.5B_base_config.json")))
    pipe = P.MagiPipeline(str(path), device=dev)
    frames, params = {}, {}
    real_get, real_save = P.get_dit, P.save_video_to_disk

    def keep(*args):
        params["tree"] = real_get(*args)
        return params["tree"]

    def capture(video, out, fps):
        frames[out] = video.copy()
        return real_save(video, out, fps)

    monkeypatch.setattr(P, "get_dit", keep)
    monkeypatch.setattr(P, "save_video_to_disk", capture)
    prompts = ["a red cube", "a blue ball on the grass"]
    many = [str(tmp_path / f"many_{i}.mp4") for i in range(2)]
    stats = pipe.run_text_to_video_many(prompts, many)
    assert [s["mode"] for s in stats] == ["interleaved"] * 2
    monkeypatch.setattr(P, "get_dit", lambda *args: params["tree"])
    monkeypatch.setattr(pipe, "_reseed", lambda: None)  # each solo run walks with its request's generator
    for i, prompt in enumerate(prompts):
        pipe.generator = pipe._request_generator(i)
        solo = str(tmp_path / f"solo_{i}.mp4")
        pipe._run(prompt, None, solo)
        assert np.array_equal(frames[solo], frames[many[i]])


# ---------------------------------------------------------------------------
# step capture: CUDA graphs against the eager walk
# ---------------------------------------------------------------------------

# (config file, engine overrides, K5 scheme): the tiny walks captured and
# eager; "streamed" is the host-streamed cache (default kv ranges)
CAPTURE_WALKS = {
    "base": ("4.5B_base_config.json", {}),
    "packed": ("4.5B_base_config.json", dict(pack_uncond=True)),
    "distill_int8": ("4.5B_distill_quant_config.json", dict(attn_int8=True)),
    "streamed": ("4.5B_base_config.json", dict(kv_offload=True)),
    "streamed_int8": ("4.5B_distill_quant_config.json", dict(attn_int8=True, kv_offload=True)),
}


def _capture_setup(dev, case):
    from magi_tpu_torch.core.config import MagiConfig
    from magi_tpu_torch.models.dit.model import init_dit_params

    name, engine = CAPTURE_WALKS[case]
    cfg = MagiConfig.from_dict(_tiny_card_dict(name, **engine))
    g = _gen(dev)
    params = init_dit_params(cfg, dev, g)
    if cfg.engine_config.attn_int8:
        params = Q.quantize_params_int8(params)
    inp = _tiny_card_input(cfg, dev, g)
    return cfg, params, inp, torch.randn(inp.latent_size, generator=g, device=dev)


def _counted_walk(walk):
    """The chunks of `walk()` and the launches of every kernel it made."""
    from magi_tpu_torch.core import graphs as G

    before = G.launch_counts()
    chunks = [c for _, c in walk()]
    torch.cuda.synchronize()
    return chunks, [a - b for a, b in zip(G.launch_counts(), before)]


@pytest.mark.parametrize("case", list(CAPTURE_WALKS))
def test_captured_walk_is_bit_equal_to_the_eager_walk(dev, case, monkeypatch):
    """A walk's steps replayed from CUDA graphs (the default on the card)
    emit the eager walk's latents bit for bit with the same launches of
    every kernel; `warm_step_variants` captures one step callable per
    variant of the walk (the JAX package's compiled variants: CPU test
    `test_step_variants_match_the_jax_compiled_ones`), and a second
    sampler of an equal config gives the same chunks."""
    from magi_tpu_torch.sampling.transport import ArdfSampler

    monkeypatch.setenv("MAGI_ATTN_Q8_SCHEME", "qk8")
    cfg, params, inp, noise = _capture_setup(dev, case)
    eager, n_eager = _counted_walk(ArdfSampler(cfg, params, inp, noise=noise, device=dev, capture=False).walk)
    s = ArdfSampler(cfg, params, inp, noise=noise, device=dev)
    assert s.warm_step_variants() == len(s.step_variants()) == len(s._steps) > 1
    assert s.graphs >= len(s._steps) and s.capture_seconds > 0
    captured, n_captured = _counted_walk(s.walk)
    assert s.host_mode == case.startswith("streamed")
    assert len(eager) == len(captured) == 3 and all(torch.equal(a, b) for a, b in zip(eager, captured))
    assert n_captured == n_eager and sum(n_eager) > 0
    again, n_again = _counted_walk(ArdfSampler(cfg, params, inp, noise=noise, device=dev).walk)
    assert all(torch.equal(a, b) for a, b in zip(eager, again)) and n_again == n_eager


def test_captured_requests_are_bit_equal_to_eager_ones(dev):
    """Two requests, lockstep (one graph a variant for both) and interleaved
    (`walk_many`, each sampler its own graphs, captured before the first
    step): each request's latents and the launches equal the eager walks'."""
    from magi_tpu_torch.sampling.batched import DpBatchedSampler
    from magi_tpu_torch.sampling.transport import ArdfSampler, walk_many

    cfg, params, inp, noise = _capture_setup(dev, "distill_int8")
    noises = [noise, torch.flip(noise, dims=[1])]
    runs = {}
    for capture in (False, True):
        batched, n_b = _counted_walk(
            DpBatchedSampler(cfg, params, [inp, inp], noises=noises, device=dev, capture=capture).walk)

        def many():
            samplers = [ArdfSampler(cfg, params, inp, noise=n, device=dev, capture=capture) for n in noises]
            return ((r, c) for r, _, c in walk_many(samplers))

        many_chunks, n_m = _counted_walk(many)
        runs[capture] = (batched, n_b, many_chunks, n_m)
    (b0, nb0, m0, nm0), (b1, nb1, m1, nm1) = runs[False], runs[True]
    assert all(torch.equal(x, y) for x, y in zip(b0, b1)) and nb0 == nb1
    assert all(torch.equal(x, y) for x, y in zip(m0, m1)) and nm0 == nm1 and len(m1) == 6


def test_step_spans_share_the_kernels_clock(dev, tmp_path):
    """The program's step spans and the card's kernels lie on one clock in a
    traced captured walk: no kernel of a step starts before the step's
    `magi/step/replay` span starts, and its `magi/step/sync` span ends no
    earlier than the step's last kernel, within 50 us.  A device operation
    belongs to the step whose `magi/step` span holds the host call that
    issued it (the trace's correlation ids)."""
    import json

    from torch.profiler import ProfilerActivity, profile

    from magi_tpu_torch.sampling.transport import ArdfSampler

    cfg, params, inp, noise = _capture_setup(dev, "base")
    s = ArdfSampler(cfg, params, inp, noise=noise, device=dev)
    s.warm_step_variants()
    s.prepare()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for step in range(s.total_forward_steps()):
            s.timed_step(step)
    s.release()
    prof.export_chrome_trace(str(tmp_path / "trace.json"))
    events = [e for e in json.loads((tmp_path / "trace.json").read_text())["traceEvents"] if e.get("ph") == "X"]

    def spans(path):
        return sorted((e["ts"], e["ts"] + e["dur"]) for e in events
                      if e.get("cat") == "user_annotation" and e["name"].split(" ")[0] == path)

    steps, replays, syncs = spans("magi/step"), spans("magi/step/replay"), spans("magi/step/sync")
    assert len(steps) == len(replays) == len(syncs) == s.total_forward_steps()
    issued = {e["args"]["correlation"]: e["ts"] for e in events
              if e.get("cat") in ("cuda_runtime", "cuda_driver") and "correlation" in e.get("args", {})}
    kernels = [[] for _ in steps]
    for e in events:
        at = issued.get(e.get("args", {}).get("correlation"))
        if e.get("cat") == "kernel" and at is not None:
            i = next((i for i, (a, b) in enumerate(steps) if a <= at <= b), None)
            if i is not None:
                kernels[i].append((e["ts"], e["ts"] + e["dur"]))
    for i, ((a, b), replay, sync) in enumerate(zip(steps, replays, syncs)):
        assert a <= replay[0] and sync[1] <= b and kernels[i], i
        assert min(k[0] for k in kernels[i]) >= replay[0], i
        assert sync[1] >= max(k[1] for k in kernels[i]) - 50, i


def test_host_sync_in_a_captured_step_raises(dev, monkeypatch):
    """A host read of a device value inside a step's captured region fails
    its capture: the walk raises, naming the step variant, and runs no step
    eagerly in its place."""
    from magi_tpu_torch.sampling import transport as T

    cfg, params, inp, noise = _capture_setup(dev, "base")
    real = T._combine3

    def synced(xs, si, *args):
        if int(si.sp) < 0:  # a host read of a device value
            raise AssertionError
        return real(xs, si, *args)

    monkeypatch.setattr(T, "_combine3", synced)
    s = T.ArdfSampler(cfg, params, inp, noise=noise, device=dev)
    with pytest.raises(RuntimeError, match="step variant"):
        s.warm_step_variants()
    assert not s.step_seconds and not s.counts


def test_vae_graphs_match_eager(dev):
    """The VAE's encode and decode replayed from shape-keyed CUDA graphs
    give the eager forwards' bits with K2g's launches, a second call of a
    shape replaying the first call's graph."""
    from magi_tpu_torch.models.vae.model import VaeConfig, ViTVAE, init_vae_params

    cfg = VaeConfig(video_size=64, video_length=8, patch_size=8, patch_length=4, z_chans=4, embed_dim=256, depth=2,
                    num_heads=4)
    params = init_vae_params(cfg, seed=0, dtype=torch.bfloat16, device=dev)
    eager, graphs = ViTVAE(cfg, params, capture=False), ViTVAE(cfg, params)
    g = _gen(dev)
    x = torch.rand((2, 3, 8, 64, 64), generator=g, device=dev).bfloat16() * 2 - 1
    z = torch.randn((2, 4, 2, 8, 8), generator=g, device=dev).bfloat16()
    for fn, arg in (("encode", x), ("decode", z), ("decode", z * 0.5)):
        before = A.segmented_attention.launches
        want = getattr(eager, fn)(arg)
        n_eager = A.segmented_attention.launches - before
        before = A.segmented_attention.launches
        got = getattr(graphs, fn)(arg)
        torch.cuda.synchronize()
        assert torch.equal(got, want) and A.segmented_attention.launches - before == n_eager > 0
    assert graphs.graphs == 2


# ---------------------------------------------------------------------------
# workspaces: step graphs that outlive a walk; the service on the card
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", ["resident", "streamed", "lockstep", "walk_many"])
def test_second_walk_of_an_equal_config_captures_nothing(dev, case, monkeypatch):
    """A second walk of an equal config through new samplers (the same
    weights and noise) takes the first walk's workspace: it captures no
    graph, and its chunks and every kernel's launches equal the first
    walk's, with the cache resident or host-streamed, lockstep and
    interleaved."""
    from magi_tpu_torch.core import graphs as G
    from magi_tpu_torch.sampling.batched import DpBatchedSampler
    from magi_tpu_torch.sampling.transport import ArdfSampler, walk_many

    monkeypatch.setenv("MAGI_ATTN_Q8_SCHEME", "qk8")
    cfg, params, inp, noise = _capture_setup(dev, {"resident": "base", "streamed": "streamed_int8"}.get(
        case, "distill_int8"))
    noises = [noise, torch.flip(noise, dims=[1])]

    def walk():
        if case == "lockstep":
            return DpBatchedSampler(cfg, params, [inp, inp], noises=noises, device=dev).walk()
        if case == "walk_many":
            return ((r, c) for r, _, c in walk_many([ArdfSampler(cfg, params, inp, noise=n, device=dev)
                                                     for n in noises]))
        return ArdfSampler(cfg, params, inp, noise=noise, device=dev).walk()

    runs = []
    for _ in range(2):
        before = G.captures("walk")
        chunks, launches = _counted_walk(walk)
        runs.append((chunks, launches, G.captures("walk") - before))
    (a, na, ca), (b, nb, cb) = runs
    assert ca > 0 and cb == 0
    assert len(a) == len(b) > 0 and all(torch.equal(x, y) for x, y in zip(a, b))
    assert na == nb and sum(na) > 0


def _tiny_pipeline_config(tmp_path) -> str:
    import json

    path = tmp_path / "tiny_distill.json"
    path.write_text(json.dumps(_tiny_card_dict("4.5B_distill_quant_config.json", attn_int8=True)))
    return str(path)


def test_pipeline_requests_replay_the_first_requests_graphs(dev, tmp_path, monkeypatch):
    """Two requests on one pipeline, then one on a new pipeline of the same
    config (as the ComfyUI node builds one per call): the DiT tree stays
    resident, the later walks capture no step graph, and all three videos
    are equal (each request draws its weights and noise from the seed)."""
    import numpy as np

    from magi_tpu_torch.core import graphs as G
    from magi_tpu_torch.pipeline import pipeline as P

    monkeypatch.setenv("SKIP_LOAD_MODEL", "1")
    G.release_workspaces()
    path = _tiny_pipeline_config(tmp_path)
    frames = []
    monkeypatch.setattr(P, "save_video_to_disk", lambda video, out, fps: frames.append(video.copy()) or out)
    first = P.MagiPipeline(path, device=dev)
    captured = []
    for i, pipe in enumerate((first, first, P.MagiPipeline(path, device=dev))):
        before = G.captures("walk")
        pipe.run_text_to_video("a red cube", str(tmp_path / f"v{i}.mp4"))
        captured.append(G.captures("walk") - before)
    assert captured[0] > 0 and captured[1:] == [0, 0]
    assert frames[0].std() > 0 and all(np.array_equal(frames[0], f) for f in frames[1:])
    G.release_workspaces()


def test_service_round_trip_on_the_card(dev, tmp_path, monkeypatch):
    """The port's service on a tiny distill int8 config: health says ready
    with the card, a direct request and a two-prompt batch each run an
    engine subprocess on the card, and every download equals the file the
    engine wrote."""
    import os
    import threading
    from http.server import ThreadingHTTPServer

    from magi_tpu_torch.serve import service
    from magi_tpu_torch.serve.client import MagiVideoClient

    monkeypatch.setenv("SKIP_LOAD_MODEL", "1")
    out_dir, dl = tmp_path / "out", tmp_path / "dl"
    out_dir.mkdir()
    dl.mkdir()
    monkeypatch.setattr(service, "OUT_DIR", str(out_dir))
    monkeypatch.setattr(service, "MAGI_CONFIG_FILE", _tiny_pipeline_config(tmp_path))
    served = []
    real = service.generate_magi_video
    monkeypatch.setattr(service, "generate_magi_video", lambda *a, **k: served.append(real(*a, **k)) or served[-1])
    srv = ThreadingHTTPServer(("127.0.0.1", 0), service.MagiHandler)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    try:
        client = MagiVideoClient(f"http://127.0.0.1:{srv.server_port}", timeout=600)
        health = client.health()
        assert health["status"] == "healthy" and health["dependencies"]["devices"] >= 1
        assert health["dependencies"]["device_name"] == torch.cuda.get_device_name(0)
        direct = client.generate_video_direct("a red cube", output_path=str(dl / "direct"))
        batch = client.generate_video_batch(["a red cube", "a blue ball"], output_dir=str(dl))
    finally:
        srv.shutdown()
        srv.server_close()
    assert len(served) == 1 and served[0]["success"] and len(batch) == 2
    pairs = [(direct, served[0]["output_path"])] + [(p, str(out_dir / os.path.basename(p))) for p in batch]
    for got, written in pairs:
        with open(got, "rb") as f, open(written, "rb") as g:
            data = f.read()
            assert len(data) > 0 and data == g.read()


# ---------------------------------------------------------------------------
# model-parallel meshes: captured pieces between collectives
# ---------------------------------------------------------------------------


def _mesh_card_dict(name: str, **engine) -> dict:
    """`_tiny_card_dict` at 8 q / 2 kv heads and 4 layers (a pp 2 split, kv
    replication on 4 head shards), the backend gloo (the ranks share the
    card)."""
    d = _tiny_card_dict(name, distributed_backend="gloo", **engine)
    d["model_config"].update(num_layers=4, hidden_size=1024, ffn_hidden_size=2048, num_attention_heads=8)
    return d


def test_captured_mesh_walks_are_bit_equal_to_eager_ones(dev, tmp_path):
    """Two ranks on the card over gloo: cp 2 (bf16, 3-branch CFG), tp 2 and
    pp 2 (distill int8 with int8 attention): the captured walk's chunks and
    launches equal the eager walk's; a second captured walk (the first's
    workspace) captures nothing and gives the same chunks."""
    import importlib.util
    import os

    from magi_tpu_torch.ops import _lib

    # by its file: an installed package named `tests` can shadow this directory
    spec = importlib.util.spec_from_file_location("torch_dist", os.path.join(os.path.dirname(__file__),
                                                                             "torch_dist.py"))
    torch_dist = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(torch_dist)
    _lib.lib()  # built once here, before the ranks load it
    q = "4.5B_distill_quant_config.json"
    cases = {
        "cp2_base": dict(kind="card_walk", mesh=dict(cp=2), config=_mesh_card_dict("4.5B_base_config.json", cp_size=2)),
        "tp2_int8": dict(kind="card_walk", mesh=dict(tp=2), quant_bits=8,
                         config=_mesh_card_dict(q, tp_size=2, attn_int8=True)),
        "pp2_int8": dict(kind="card_walk", mesh=dict(pp=2), quant_bits=8,
                         config=_mesh_card_dict(q, pp_size=2, attn_int8=True)),
    }
    res = torch_dist.start_world(2, cases, tmp_path).results(timeout=900)
    for rank in res:
        for name, r in rank.items():
            eager, cap, again = r["eager"], r["captured"], r["again"]
            assert len(eager["chunks"]) == 3 and sum(eager["launches"]) > 0, name
            assert all(torch.equal(a, b) for a, b in zip(eager["chunks"], cap["chunks"])), name
            assert all(torch.equal(a, b) for a, b in zip(eager["chunks"], again["chunks"])), name
            assert cap["launches"] == eager["launches"] == again["launches"], name
            assert eager["graphs"] == 0 and cap["graphs"] > 0 and again["graphs"] == 0, name


def test_comm_writes_its_out_slots_on_a_one_rank_gloo_group(dev, tmp_path):
    """On a one-rank gloo group the collectives write the `out` slot they
    are given (the buffer a captured piece reads) and return it, and
    all_reduce works in place."""
    import socket

    import torch.distributed as dist

    from magi_tpu_torch.parallel import comm
    from magi_tpu_torch.parallel.mesh import Group

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", world_size=1, rank=0)
    try:
        group = Group((0,), dist.new_group([0]), "gloo", dev)
        x = torch.arange(6, dtype=torch.bfloat16, device=dev)
        out = torch.full((6,), -1.0, dtype=torch.bfloat16, device=dev)
        assert comm.all_to_all(x, group, [6], [6], out=out) is out and torch.equal(out, x)
        slot = torch.zeros((1, 6), dtype=torch.bfloat16, device=dev)
        got = comm.all_gather(x, group, out=slot)
        assert got[0].data_ptr() == slot.data_ptr() and torch.equal(slot[0], x)
        y = x.float()
        assert comm.all_reduce(y, group, "max") is y
        done = comm.broadcast_many([y], 0, group).wait()
        assert done[0] is y and torch.equal(y, x.float())
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("ordered", [True, False])
def test_pp_layer_slot_waits_for_its_last_reader(dev, ordered, monkeypatch):
    """A non-owner rank receives layers 0 and 2 into the same slot (parity
    0).  Under NCCL the broadcast runs on a side stream, which first waits
    for the work queued on the current stream: layer 0's (slow) reader
    still sees layer 0's bytes.  Without that wait (`ordered` False) layer
    2's write overtakes the reader: the hazard it guards."""
    import numpy as np
    import torch.distributed as dist

    from magi_tpu_torch.core.graphs import Arena
    from magi_tpu_torch.parallel import comm
    from magi_tpu_torch.parallel import mesh as PM

    class Work:
        def wait(self):
            pass

    def fake_broadcast(t, src, group=None, async_op=False):
        t.fill_(fake_broadcast.value)  # on the stream the broadcast was issued on
        return Work()

    monkeypatch.setattr(dist, "broadcast", fake_broadcast)
    side = comm._side_stream(dev)
    if not ordered:
        monkeypatch.setattr(type(side), "wait_stream", lambda self, other: None)
    arena = Arena(dev)

    class Run:
        copies_live = True

        def slot(self, name, shape, dtype, device):
            return arena.slot(name, shape, dtype)

    # pp 2, this rank pp index 1 of 8 layers: layers 0-3 arrive from rank 0
    mesh = PM.Mesh(np.arange(2).reshape(1, 2, 1, 1), rank=1, backend="nccl", device=dev,
                   groups={"pp": PM.Group((0, 1), None, "nccl", dev)})
    blocks = {"w": torch.zeros((4, 256, 256), device=dev)}
    fake_broadcast.value = 1
    layer0 = PM.pp_gather_layer(blocks, 0, 8, mesh, run=Run()).wait()["w"]
    seen = torch.empty_like(layer0)
    torch.cuda._sleep(200_000_000)  # a slow reader of layer 0's slot
    seen.copy_(layer0)
    fake_broadcast.value = 3
    layer2 = PM.pp_gather_layer(blocks, 2, 8, mesh, run=Run()).wait()["w"]
    torch.cuda.synchronize()
    assert layer2.data_ptr() == layer0.data_ptr()  # the same slot
    assert (layer2.view(torch.uint8) == 3).all()
    assert (seen.view(torch.uint8) == (1 if ordered else 3)).all()

"""The port's CUDA kernels against their plain PyTorch versions on the
card, at small shapes.  Marked `cuda`: each test skips without a CUDA
device.  On the GPU, where jax is not installed, run them without the
suite's conftest: `python -m pytest --noconftest -m cuda
tests/test_torch_cuda.py`; `chip_smoke.py` holds the same kernels at the
main path's shapes.

Tolerances (bf16 outputs): K3 and K4 one or two bf16 ulps (1e-2 absolute
+ 1e-2 relative); attention 4e-3 absolute + 1e-2 relative, well below
outputs of ~n**-0.5 for spans of n keys (q is rounded to bf16 after the
sm_scale*log2e fold in the kernel and before it in the plain version, and
P is rounded to bf16 for the PV product).  A segment of a dozen keys has
outputs near 1 and takes 2e-2 absolute + relative, one or two bf16 ulps
there, as `chip_smoke.py` does for its short captions."""

import pytest
import torch

from magi_tpu_torch.ops import attention as A
from magi_tpu_torch.ops import fused_norm as FN

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


def test_kv_norm_rope_pack_kernel(dev):
    g = _gen(dev)
    S, hk, hd, rot = 300, 8, 128, 48
    k, v = _randn(g, dev, S, hk, hd), _randn(g, dev, S, hk, hd)
    kw, kb = (_randn(g, dev, hd, dtype=torch.float32) for _ in range(2))
    sin, cos = (_randn(g, dev, S, rot, dtype=torch.float32) for _ in range(2))
    for rep in (1, 2):
        before = A.kv_norm_rope_pack.launches
        out = A.kv_norm_rope_pack(k, v, kw, kb, sin, cos, eps=1e-6, rep=rep)
        assert A.kv_norm_rope_pack.launches == before + 1
        _close(out, A.kv_norm_rope_pack_reference(k, v, kw, kb, sin, cos, eps=1e-6, rep=rep), atol=1e-2, rtol=1e-2)


def test_gate_norm_residual_kernel(dev):
    g = _gen(dev)
    n_seg, seg, D = 3, 100, 3072
    x, res = _randn(g, dev, n_seg * seg, D), _randn(g, dev, n_seg * seg, D)
    gate, w, b = (_randn(g, dev, *s, dtype=torch.float32) for s in ((n_seg, D), (D,), (D,)))
    kw = dict(eps=1e-6, zero_centered=True, n_seg=n_seg)
    _close(FN.gate_norm_residual(x, res, gate, w, b, **kw), FN.gate_norm_residual_reference(x, res, gate, w, b, **kw),
           atol=1e-2, rtol=1e-2)


@pytest.mark.parametrize("L1", [0, 200])
def test_two_source_kernel(dev, L1):
    g = _gen(dev)
    n_seg, seg, hq, hk, hd, rot = 3, 130, 24, 8, 128, 48
    S = n_seg * seg
    q = _randn(g, dev, S, hq, hd)
    kv1, kv2 = _randn(g, dev, 2, hk, L1, hd), _randn(g, dev, 2, hk, S, hd)
    i32 = dict(dtype=torch.int32, device=dev)
    r1s = torch.tensor([0, 50, 0], **i32).clamp(max=L1)
    r1e = torch.tensor([L1, L1, 0], **i32)
    r2s, r2e = torch.tensor([0, 0, 7], **i32), torch.tensor([seg, 2 * seg, 7], **i32)
    qw, qb = _ln_affine(g, dev, hd)
    pro = (qw, qb, torch.sin(_randn(g, dev, S, rot, dtype=torch.float32)),
           torch.cos(_randn(g, dev, S, rot, dtype=torch.float32)), 1e-6)
    before = A.segmented_attention_two_source.launches
    out = A.segmented_attention_two_source(q, kv1, kv2, r1s, r1e, r2s, r2e, seg_len=seg, q_prologue=pro)
    assert A.segmented_attention_two_source.launches == before + 1
    ref = A.segmented_attention_two_source_reference(A.apply_q_prologue(q, pro), kv1, kv2, r1s, r1e, r2s, r2e,
                                                     seg_len=seg)
    _close(out, ref, **ATTN_TOL)
    if L1 == 0:
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

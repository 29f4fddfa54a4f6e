"""Two-source segmented attention over an int8 KV cache (the port of
`magi_tpu.ops.attention_q8`).

kv is stored int8 [2, hk, tok, hd] with f32 per-token symmetric scales
[2, hk, tok] (k scales, then v scales), the layout of the int8-stored KV
cache and of `kv_norm_rope_pack_q8`'s output.  The ranges, GQA and the
optional fused q prologue are those of `segmented_attention_two_source`
(`ops/attention.py`).

`MAGI_ATTN_Q8_SCHEME` picks how the kernel consumes the int8 kv, as in the
JAX package (default "qk8").  Each scheme is its own CUDA kernel of K5 in
`csrc/attention_tma.cu`, on TMA and wgmma like K1, whose rules for the
sources (head_dim 128, any view with a contiguous last dimension and
16-byte aligned base and strides) all three share, with a wrapper and
launch count of its own:

  * "qk8" (`segmented_attention_two_source_q8`): q quantized per row
    (token, head) to int8 after the prologue; logits (q8 . k8)_int32 *
    sq_row * sk_token; online softmax in f32 (exp2); p times the per-token
    v scale cast to bf16, times the int8 v cast to bf16.
    `segmented_attention_two_source_q8_qk8_reference` is its plain
    version, step by step.
  * "sage" (`segmented_attention_two_source_q8_sage`, SageAttention): q
    and the logits as in qk8; then per kv tile pv = p * sv, requantized per
    row against the tile's row max (sp = max(rowmax(pv), 1e-20) / 127, p8 =
    round(pv / sp)), and p.v runs int8: o += (p8 . v8)_int32 * sp.  The
    requantization depends on each tile's columns and on the running max,
    so the plain version (`segmented_attention_two_source_q8_sage_reference`)
    walks the same tiles as the kernel: `block_k` wide, aligned to
    `block_k` within each source.
  * "dq" (`segmented_attention_two_source_q8_dq`): q stays bf16 (rounded
    after the prologue); logits (q . bf16(k8)) * (sk_token * sm_scale *
    log2e); p.v as in qk8.  Its plain version
    (`segmented_attention_two_source_q8_dq_reference`) walks the same
    tiles.

The tiled plain versions run the Pallas kernel's online softmax without
its `tile_opt` cuts: masked logits take a large negative value and their p
is set to 0.  On CPU tensors `segmented_attention_two_source_q8` returns
the selected scheme's plain version (tile width `KERNEL_BLOCK_K`, the
kernel's).

`segmented_attention_two_source_q8_reference` is the JAX package's
dequantize + bf16 reference: it does not quantize q.  The model's CPU path
uses it, as the JAX package's CPU path does.
"""

from __future__ import annotations

import os
from typing import Optional

import torch

from magi_tpu_torch.ops import _lib
from magi_tpu_torch.ops.quant import div127
from magi_tpu_torch.ops.attention import (
    LOG2E,
    TMA_HEAD_DIM,
    _check_q,
    _check_ranges,
    _prologue_operands,
    _require,
    _tma_source,
    norm_rope_f32,
    segmented_attention_two_source_reference,
)

SCHEMES = ("sage", "qk8", "dq")
KERNEL_BLOCK_K = 64  # kv tokens per tile of the kernels (csrc/attention_tma.cu kBK)
_SCHEME_ID = {"qk8": 0, "sage": 1, "dq": 2}  # the scheme argument of magi_seg_attn_two_source_int8
MASK_VALUE = -0.7 * float(torch.finfo(torch.float32).max)  # the Pallas kernels' masked logit


def default_scheme() -> str:
    s = os.environ.get("MAGI_ATTN_Q8_SCHEME", "qk8")
    if s not in SCHEMES:
        raise ValueError(f"MAGI_ATTN_Q8_SCHEME must be one of {SCHEMES}, got {s!r}")
    return s


def _check_scheme(scheme: Optional[str]) -> str:
    scheme = scheme or default_scheme()
    if scheme not in SCHEMES:
        raise ValueError(f"scheme must be one of {SCHEMES}, got {scheme!r}")
    return scheme


def quantize_kv_per_token(kv: torch.Tensor, eps: float = 1e-8):
    """[2, hk, S, hd] -> (int8 same shape, f32 scales [2, hk, S]):
    scale max(amax, eps) / 127 per token, value round(kv / scale)."""
    kvf = kv.float()
    scale = div127(torch.clamp(kvf.abs().amax(-1), min=eps))
    return torch.round(kvf / scale[..., None]).clamp(-127, 127).to(torch.int8), scale


def segmented_attention_two_source_q8_reference(
    q, kv1, sc1, kv2, sc2, r1_start, r1_end, r2_start, r2_end, *, seg_len, sm_scale=None, scheme=None
):
    """Dequantize to bf16, then the bf16 two-source reference (q as given:
    normed and roped by the caller).  `scheme` is accepted and ignored."""
    dq1 = (kv1.float() * sc1[..., None]).to(torch.bfloat16)
    dq2 = (kv2.float() * sc2[..., None]).to(torch.bfloat16)
    return segmented_attention_two_source_reference(
        q, dq1, dq2, r1_start, r1_end, r2_start, r2_end, seg_len=seg_len, sm_scale=sm_scale
    )


def _prologue_f32(q, q_prologue):
    """q after the optional fused prologue, in f32."""
    if q_prologue is None:
        return q.float()
    qw, qb, sin, cos, eps = q_prologue
    return norm_rope_f32(q, qw, qb, sin, cos, eps)


def _quantize_q(qf, c: float):
    """Per-row int8 q of the qk8 and sage kernels: scale max(amax, 1e-8) *
    (1/127), value round(q * (1 / scale)); returns (int8 values in f32, the
    scale times `c` = sm_scale * log2e, both f32 as in the kernel)."""
    sq = torch.clamp(qf.abs().amax(-1, keepdim=True), min=1e-8) * (1.0 / 127.0)
    q8 = torch.round(qf * (1.0 / sq)).clamp(-127, 127)
    return q8, sq * c


def segmented_attention_two_source_q8_qk8_reference(
    q, kv1, sc1, kv2, sc2, r1_start, r1_end, r2_start, r2_end, *, seg_len, sm_scale=None, q_prologue=None
):
    """Plain version of the qk8 kernel, one segment at a time: the same q
    quantization, int32 logits (exact in f32 here: |q8 . k8| <= 127**2 * hd
    < 2**24), dequant order, bf16 rounding of p * sv and bf16 p.v product.
    The softmax is taken against each row's global max, where the kernel's
    online softmax rounds p against a running max; the two differ by bf16
    roundings of p."""
    total_q, hq, hd = q.shape
    hk = kv1.shape[1]
    rep = hq // hk
    if sm_scale is None:
        sm_scale = hd ** -0.5
    q8, sq = _quantize_q(_prologue_f32(q, q_prologue), sm_scale * LOG2E)  # sq [S, hq, 1]
    L1 = kv1.shape[2]
    k8 = torch.cat([kv1[0], kv2[0]], dim=1).float().repeat_interleave(rep, dim=0)  # [hq, L, hd]
    v8 = torch.cat([kv1[1], kv2[1]], dim=1).float().repeat_interleave(rep, dim=0).to(torch.bfloat16)
    sk = torch.cat([sc1[0], sc2[0]], dim=1).float().repeat_interleave(rep, dim=0)  # [hq, L]
    sv = torch.cat([sc1[1], sc2[1]], dim=1).float().repeat_interleave(rep, dim=0)
    col = torch.arange(k8.shape[1], device=q.device)
    out = torch.empty((total_q, hq, hd), dtype=torch.float32, device=q.device)
    for i in range(total_q // seg_len):
        rows = slice(i * seg_len, (i + 1) * seg_len)
        a1, b1 = max(int(r1_start[i]), 0), min(int(r1_end[i]), L1)
        a2, b2 = max(int(r2_start[i]), 0) + L1, min(int(r2_end[i]), kv2.shape[2]) + L1
        valid = ((col >= a1) & (col < b1)) | ((col >= a2) & (col < b2))
        qs = q8[rows].transpose(0, 1)  # [hq, seg, hd]
        s = torch.einsum("hqd,hkd->hqk", qs, k8) * sq[rows].transpose(0, 1) * sk[:, None, :]
        s = s.masked_fill(~valid, float("-inf"))
        m = s.amax(-1, keepdim=True)
        m = torch.where(torch.isinf(m), torch.zeros_like(m), m)
        p = torch.exp2(s - m)
        l = p.sum(-1, keepdim=True)
        pv = (p * sv[:, None, :]).to(torch.bfloat16).float()
        o = torch.einsum("hqk,hkd->hqd", pv, v8.float())
        o = torch.where(l == 0, torch.zeros_like(o), o / l)
        out[rows] = o.transpose(0, 1)
    return out.to(q.dtype)


def _q8_tiled_reference(
    scheme, q, kv1, sc1, kv2, sc2, r1_start, r1_end, r2_start, r2_end, *, seg_len, sm_scale, q_prologue, block_k
):
    """The sage and dq kernels step by step, one segment at a time: source 1
    then source 2, each in tiles of `block_k` tokens aligned to `block_k`
    within the source (the Pallas kernel's `lo = start // block_k`), each
    tile through the online softmax of the Pallas kernel without
    `tile_opt`.  Integer products are exact in f32 here (|sum| <= 127**2 *
    max(hd, block_k) < 2**24)."""
    total_q, hq, hd = q.shape
    rep = hq // kv1.shape[1]
    if sm_scale is None:
        sm_scale = hd ** -0.5
    c = sm_scale * LOG2E
    qf = _prologue_f32(q, q_prologue)
    if scheme == "sage":
        qm, sq = _quantize_q(qf, c)
    else:  # dq: q stays bf16
        qm, sq = qf.to(torch.bfloat16).float(), None
    dev = q.device
    out = torch.empty((total_q, hq, hd), dtype=torch.float32, device=dev)
    sources = ((kv1, sc1, r1_start, r1_end), (kv2, sc2, r2_start, r2_end))
    for i in range(total_q // seg_len):
        rows = slice(i * seg_len, (i + 1) * seg_len)
        qs = qm[rows].transpose(0, 1)  # [hq, seg, hd]
        sqs = None if sq is None else sq[rows].transpose(0, 1)  # [hq, seg, 1]
        m = torch.full((hq, seg_len, 1), float("-inf"), device=dev)
        l = torch.zeros((hq, seg_len, 1), device=dev)
        acc = torch.zeros((hq, seg_len, hd), device=dev)
        for kv, sc, rs, re in sources:
            n = kv.shape[2]
            lo, hi = max(int(rs[i]), 0), min(int(re[i]), n)
            if hi <= lo:
                continue
            for t0 in range(lo // block_k * block_k, hi, block_k):
                t1 = min(t0 + block_k, n)
                k8 = kv[0, :, t0:t1].float().repeat_interleave(rep, dim=0)  # [hq, bk, hd]
                v8 = kv[1, :, t0:t1].float().repeat_interleave(rep, dim=0)
                sk = sc[0, :, t0:t1].float().repeat_interleave(rep, dim=0)[:, None, :]  # [hq, 1, bk]
                sv = sc[1, :, t0:t1].float().repeat_interleave(rep, dim=0)[:, None, :]
                col = torch.arange(t0, t1, device=dev)
                valid = (col >= lo) & (col < hi)
                raw = torch.matmul(qs, k8.transpose(1, 2))
                s = raw * sqs * sk if scheme == "sage" else raw * (sk * c)
                s = torch.where(valid, s, MASK_VALUE)
                m_next = torch.maximum(m, s.amax(-1, keepdim=True))
                p = torch.where(valid, torch.exp2(s - m_next), 0.0)
                alpha = torch.exp2(m - m_next)
                l = p.sum(-1, keepdim=True) + alpha * l
                m = m_next
                pv = p * sv
                if scheme == "sage":
                    sp = torch.clamp(pv.amax(-1, keepdim=True), min=1e-20) * (1.0 / 127.0)
                    o = torch.matmul(torch.round(pv * (1.0 / sp)), v8) * sp
                else:
                    o = torch.matmul(pv.to(torch.bfloat16).float(), v8)
                acc = acc * alpha + o
        out[rows] = (acc * torch.where(l == 0, 1.0, 1.0 / l)).transpose(0, 1)
    return out.to(q.dtype)


def segmented_attention_two_source_q8_sage_reference(
    q, kv1, sc1, kv2, sc2, r1_start, r1_end, r2_start, r2_end, *, seg_len, sm_scale=None, q_prologue=None,
    block_k: int = KERNEL_BLOCK_K,
):
    """Plain version of the sage kernel, tile by tile (see `_q8_tiled_reference`):
    q8 and the logits as in qk8; per tile pv = p * sv, sp = max(rowmax(pv),
    1e-20) * (1/127), p8 = round(pv * (1/sp)), o = o * alpha + (p8 . v8) * sp."""
    return _q8_tiled_reference("sage", q, kv1, sc1, kv2, sc2, r1_start, r1_end, r2_start, r2_end, seg_len=seg_len,
                               sm_scale=sm_scale, q_prologue=q_prologue, block_k=block_k)


def segmented_attention_two_source_q8_dq_reference(
    q, kv1, sc1, kv2, sc2, r1_start, r1_end, r2_start, r2_end, *, seg_len, sm_scale=None, q_prologue=None,
    block_k: int = KERNEL_BLOCK_K,
):
    """Plain version of the dq kernel, tile by tile (see `_q8_tiled_reference`):
    q rounded to bf16 after the prologue; logits (q . k8) * (sk * sm_scale *
    log2e); bf16(p * sv) . v8."""
    return _q8_tiled_reference("dq", q, kv1, sc1, kv2, sc2, r1_start, r1_end, r2_start, r2_end, seg_len=seg_len,
                               sm_scale=sm_scale, q_prologue=q_prologue, block_k=block_k)


_PLAIN = {
    "qk8": segmented_attention_two_source_q8_qk8_reference,
    "sage": segmented_attention_two_source_q8_sage_reference,
    "dq": segmented_attention_two_source_q8_dq_reference,
}


def _token_scales(fn: str, name: str, sc: torch.Tensor, device, hk: int, L: int):
    """(pointer, head stride, k|v stride) of per-token scales [2, hk, L] f32
    with contiguous tokens (the kernels load them 4 bytes at a time)."""
    if sc.device != device or sc.dtype != torch.float32 or tuple(sc.shape) != (2, hk, L) or (
        L > 1 and sc.stride(2) != 1
    ):
        raise ValueError(f"{fn}: {name} must be float32 [2, {hk}, {L}] with contiguous tokens on {device}; got "
                         f"{sc.dtype} {tuple(sc.shape)} strides {sc.stride()} on {sc.device}")
    return sc.data_ptr(), sc.stride(1), sc.stride(0)


def _launch(wrapper, scheme, q, kv1, sc1, kv2, sc2, r1_start, r1_end, r2_start, r2_end, *, seg_len, sm_scale,
            q_prologue):
    """Check the operands and launch the `scheme` kernel of K5 on q's
    device; bumps `wrapper.launches`."""
    fn = wrapper.__name__
    total_q, hq, hd = q.shape
    hk, L1, L2 = kv1.shape[1], kv1.shape[2], kv2.shape[2]
    _require(f"{fn}: q", q, q.device, torch.bfloat16, q.shape)
    n_seg = _check_q(fn, q, hk, seg_len)
    if hd != TMA_HEAD_DIM:
        raise ValueError(f"{fn}: the {scheme} kernel takes head_dim {TMA_HEAD_DIM}, got {hd}")
    src1 = _tma_source(fn, "kv1", kv1, q.device, torch.int8, hk, hd)
    src2 = _tma_source(fn, "kv2", kv2, q.device, torch.int8, hk, hd)
    sc1_ = _token_scales(fn, "sc1", sc1, q.device, hk, L1)
    sc2_ = _token_scales(fn, "sc2", sc2, q.device, hk, L2)
    _check_ranges(fn, q.device, n_seg, r1_start, r1_end, r2_start, r2_end)
    qw, qb, sin, cos, rot, eps = _prologue_operands(fn, q, q_prologue)
    out = torch.empty_like(q)
    if total_q == 0:
        return out
    err = _lib.lib().magi_seg_attn_two_source_int8(
        q.data_ptr(), out.data_ptr(), *src1, *sc1_, *src2, *sc2_,
        r1_start.data_ptr(), r1_end.data_ptr(), r2_start.data_ptr(), r2_end.data_ptr(),
        _lib.ptr(qw), _lib.ptr(qb), _lib.ptr(sin), _lib.ptr(cos),
        n_seg, seg_len, hq, hk, hd, rot, float(eps), float(sm_scale * LOG2E), _SCHEME_ID[scheme],
        _lib.stream(q.device),
    )
    _lib.check(err, fn)
    wrapper.launches += 1
    return out


def segmented_attention_two_source_q8(
    q: torch.Tensor,  # [n_seg * seg_len, hq, hd] bf16 (raw if q_prologue)
    kv1: torch.Tensor,  # [2, hk, kv1_len, hd] int8
    sc1: torch.Tensor,  # [2, hk, kv1_len] f32
    kv2: torch.Tensor,  # [2, hk, kv2_len, hd] int8
    sc2: torch.Tensor,  # [2, hk, kv2_len] f32
    r1_start: torch.Tensor,
    r1_end: torch.Tensor,
    r2_start: torch.Tensor,
    r2_end: torch.Tensor,
    *,
    seg_len: int,
    sm_scale: Optional[float] = None,
    q_prologue=None,  # (qw, qb, sin, cos, eps) as in segmented_attention_two_source
    scheme: Optional[str] = None,
) -> torch.Tensor:
    """K5: int8 two-source segmented attention under `scheme` (by default
    `MAGI_ATTN_Q8_SCHEME`).  Returns [S, hq, hd]: the scheme's CUDA kernel
    on CUDA tensors (qk8 counted here, sage and dq by their own wrappers),
    the scheme's plain version on CPU tensors."""
    scheme = _check_scheme(scheme)
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    args = (q, kv1, sc1, kv2, sc2, r1_start, r1_end, r2_start, r2_end)
    if q.device.type == "cpu":
        return _PLAIN[scheme](*args, seg_len=seg_len, sm_scale=sm_scale, q_prologue=q_prologue)
    wrapper = {"qk8": segmented_attention_two_source_q8, "sage": segmented_attention_two_source_q8_sage,
               "dq": segmented_attention_two_source_q8_dq}[scheme]
    return _launch(wrapper, scheme, *args, seg_len=seg_len, sm_scale=sm_scale, q_prologue=q_prologue)


def segmented_attention_two_source_q8_sage(q, kv1, sc1, kv2, sc2, r1_start, r1_end, r2_start, r2_end, *, seg_len,
                                           sm_scale=None, q_prologue=None):
    """K5 under scheme "sage", with a launch count of its own."""
    return segmented_attention_two_source_q8(q, kv1, sc1, kv2, sc2, r1_start, r1_end, r2_start, r2_end,
                                             seg_len=seg_len, sm_scale=sm_scale, q_prologue=q_prologue, scheme="sage")


def segmented_attention_two_source_q8_dq(q, kv1, sc1, kv2, sc2, r1_start, r1_end, r2_start, r2_end, *, seg_len,
                                         sm_scale=None, q_prologue=None):
    """K5 under scheme "dq", with a launch count of its own."""
    return segmented_attention_two_source_q8(q, kv1, sc1, kv2, sc2, r1_start, r1_end, r2_start, r2_end,
                                             seg_len=seg_len, sm_scale=sm_scale, q_prologue=q_prologue, scheme="dq")


segmented_attention_two_source_q8.launches = 0
segmented_attention_two_source_q8_sage.launches = 0
segmented_attention_two_source_q8_dq.launches = 0

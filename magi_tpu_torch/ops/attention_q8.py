"""Two-source segmented attention over an int8 KV cache (the port of
`magi_tpu.ops.attention_q8`).

kv is stored int8 [2, hk, tok, hd] with f32 per-token symmetric scales
[2, hk, tok] (k scales, then v scales), the layout of the int8-stored KV
cache and of `kv_norm_rope_pack_q8`'s output.  The ranges, GQA and the
optional fused q prologue are those of `segmented_attention_two_source`
(`ops/attention.py`).

`MAGI_ATTN_Q8_SCHEME` picks how the kernel consumes the int8 kv, as in the
JAX package (default "qk8"):

  * "qk8": q quantized per row (token, head) to int8 after the prologue;
    logits (q8 . k8)_int32 * sq_row * sk_token; online softmax in f32
    (exp2); p times the per-token v scale cast to bf16, times the int8 v
    cast to bf16.  The CUDA kernel (`csrc/attention_q8.cu`, K5) computes
    this one; `segmented_attention_two_source_q8_qk8_reference` is its
    plain version, step by step.
  * "sage" and "dq" are not ported yet (ROADMAP queue 2 K5) and raise.

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
    _check_q,
    _check_ranges,
    _require,
    norm_rope_f32,
    segmented_attention_two_source_reference,
)

SCHEMES = ("sage", "qk8", "dq")


def default_scheme() -> str:
    s = os.environ.get("MAGI_ATTN_Q8_SCHEME", "qk8")
    if s not in SCHEMES:
        raise ValueError(f"MAGI_ATTN_Q8_SCHEME must be one of {SCHEMES}, got {s!r}")
    return s


def _check_scheme(scheme: Optional[str]) -> str:
    scheme = scheme or default_scheme()
    if scheme not in SCHEMES:
        raise ValueError(f"scheme must be one of {SCHEMES}, got {scheme!r}")
    if scheme != "qk8":
        raise NotImplementedError(f"int8 attention scheme {scheme!r} is ROADMAP queue 2 K5 (sage, dq); qk8 is ported")
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
    if q_prologue is not None:
        qw, qb, sin, cos, eps = q_prologue
        qf = norm_rope_f32(q, qw, qb, sin, cos, eps)
    else:
        qf = q.float()
    sq = torch.clamp(qf.abs().amax(-1, keepdim=True), min=1e-8) * (1.0 / 127.0)
    q8 = torch.round(qf * (1.0 / sq)).clamp(-127, 127)
    sq = sq * (sm_scale * LOG2E)  # [S, hq, 1], f32 as in the kernel

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
    """K5: int8 two-source segmented attention, scheme qk8.  Returns
    [S, hq, hd]; the CUDA kernel on CUDA tensors, the qk8 plain version on
    CPU tensors."""
    _check_scheme(scheme)
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    if q.device.type == "cpu":
        return segmented_attention_two_source_q8_qk8_reference(
            q, kv1, sc1, kv2, sc2, r1_start, r1_end, r2_start, r2_end, seg_len=seg_len, sm_scale=sm_scale,
            q_prologue=q_prologue,
        )
    fn = "segmented_attention_two_source_q8"
    total_q, hq, hd = q.shape
    hk, L1, L2 = kv1.shape[1], kv1.shape[2], kv2.shape[2]
    n_seg = _check_q(fn, q, hk, seg_len)
    _require(f"{fn}: kv1", kv1, q.device, torch.int8, (2, hk, L1, hd))
    _require(f"{fn}: sc1", sc1, q.device, torch.float32, (2, hk, L1))
    _require(f"{fn}: kv2", kv2, q.device, torch.int8, (2, hk, L2, hd))
    _require(f"{fn}: sc2", sc2, q.device, torch.float32, (2, hk, L2))
    _check_ranges(fn, q.device, n_seg, r1_start, r1_end, r2_start, r2_end)
    qw = qb = sin = cos = None
    rot, eps = 0, 0.0
    if q_prologue is not None:
        qw, qb, sin, cos, eps = q_prologue
        qw = qw.float().contiguous()
        qb = qb.float().contiguous()
        _require(f"{fn}: qw", qw, q.device, torch.float32, (hd,))
        _require(f"{fn}: qb", qb, q.device, torch.float32, (hd,))
        if sin is not None:
            rot = sin.shape[-1]
            if 2 * rot > hd:
                raise ValueError(f"{fn}: rotary width 2*{rot} exceeds head_dim {hd}")
            _require(f"{fn}: sin", sin, q.device, torch.float32, (total_q, rot))
            _require(f"{fn}: cos", cos, q.device, torch.float32, (total_q, rot))
    out = torch.empty_like(q)
    if total_q == 0:
        return out
    err = _lib.lib().magi_seg_attn_two_source_q8(
        q.data_ptr(), out.data_ptr(), kv1.data_ptr(), sc1.data_ptr(), L1, kv2.data_ptr(), sc2.data_ptr(), L2,
        r1_start.data_ptr(), r1_end.data_ptr(), r2_start.data_ptr(), r2_end.data_ptr(),
        _lib.ptr(qw), _lib.ptr(qb), _lib.ptr(sin), _lib.ptr(cos),
        n_seg, seg_len, hq, hk, hd, rot, float(eps), float(sm_scale * LOG2E), _lib.stream(q.device),
    )
    _lib.check(err, fn)
    segmented_attention_two_source_q8.launches += 1
    return out


segmented_attention_two_source_q8.launches = 0

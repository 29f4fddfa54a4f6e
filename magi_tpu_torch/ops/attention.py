"""Segmented attention and the k-side LayerNorm + rotary + pack.

Semantics (as in `magi_tpu.ops.attention`): queries are `n_seg`
contiguous blocks of `seg_len` tokens, token-major `[S, hq, hd]`; segment
i attends kv tokens `[kv_start[i], kv_end[i])`.  The two-source variant
attends `[r1s, r1e)` of a read-only source (the KV cache) and then
`[r2s, r2e)` of a second one (the current window's kv), both in the
kernel layout `[2, hk, tok, hd]`.  A range is clipped to its source's
tokens.  A segment with empty ranges outputs 0.
GQA: q head h reads kv head h // (hq // hk).

Each public function launches a CUDA kernel (`csrc/attention.cu`,
`csrc/norm.cu`) when its tensors are on a CUDA device and runs the plain
PyTorch version beside it when they are on the CPU.  Each keeps a count
of its kernel launches in its `launches` attribute.

`q_prologue = (qw, qb, sin, cos, eps)` asks for the fused q-side
LayerNorm (weight `qw` with any +1 already applied) and GPT-NeoX rotary
on the first 2*rot dims (`sin`/`cos` `[S, rot]`, or None for norm only).
The kernel folds sm_scale*log2(e) into (qw, qb) and casts q to bf16
after scaling; the plain version casts first and scales in fp32, as the
JAX package's CPU path does.  The two differ by at most one bf16 ulp of
the scaled q.
"""

from __future__ import annotations

from typing import Optional

import torch

from magi_tpu_torch.ops import _lib

LOG2E = 1.4426950408889634


# ---------------------------------------------------------------------------
# plain PyTorch versions
# ---------------------------------------------------------------------------


def apply_q_prologue(q: torch.Tensor, q_prologue) -> torch.Tensor:
    """fp32 LayerNorm (+ NeoX rotary) of q, cast back to q's dtype."""
    qw, qb, sin, cos, eps = q_prologue
    qf = q.float()
    mean = qf.mean(-1, keepdim=True)
    var = (qf - mean).square().mean(-1, keepdim=True)
    qn = (qf - mean) * torch.rsqrt(var + eps) * qw.float() + qb.float()
    if sin is not None:
        rot = sin.shape[-1]
        s_ = sin.float()[:, None, :]
        c_ = cos.float()[:, None, :]
        x1, x2, tail = qn[..., :rot], qn[..., rot : 2 * rot], qn[..., 2 * rot :]
        qn = torch.cat([x1 * c_ - x2 * s_, x1 * s_ + x2 * c_, tail], dim=-1)
    return qn.to(q.dtype)


def _masked_softmax_attention(q, k, v, valid, *, seg_len, sm_scale):
    """Dense masked softmax attention.  q [S, hq, hd], k/v [kv, hk, hd],
    valid [n_seg, kv] bool.  Fully masked rows give 0."""
    total_q, hq, hd = q.shape
    hk = k.shape[1]
    n_seg = total_q // seg_len
    kf = k.float().repeat_interleave(hq // hk, dim=1)
    vf = v.float().repeat_interleave(hq // hk, dim=1)
    qf = q.float().reshape(n_seg, seg_len, hq, hd)
    scores = torch.einsum("nqhd,khd->nhqk", qf, kf) * sm_scale
    scores = scores.masked_fill(~valid[:, None, None, :], float("-inf"))
    probs = torch.softmax(scores, dim=-1)
    probs = torch.nan_to_num(probs, nan=0.0)
    out = torch.einsum("nhqk,khd->nqhd", probs, vf)
    return out.reshape(total_q, hq, hd).to(q.dtype)


def segmented_attention_reference(q, k, v, kv_start, kv_end, *, seg_len: int, sm_scale: Optional[float] = None):
    """Plain version of `segmented_attention` (k/v token-major [kv, hk, hd])."""
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    col = torch.arange(k.shape[0], device=q.device)[None, :]
    valid = (col >= kv_start.long()[:, None]) & (col < kv_end.long()[:, None])
    return _masked_softmax_attention(q, k, v, valid, seg_len=seg_len, sm_scale=sm_scale)


def segmented_attention_two_source_reference(
    q, kv1, kv2, r1_start, r1_end, r2_start, r2_end, *, seg_len: int, sm_scale: Optional[float] = None
):
    """Plain version of `segmented_attention_two_source`: concatenate both
    sources and mask with the union of the two (offset) ranges."""
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    L1 = kv1.shape[2]
    k = torch.cat([kv1[0].transpose(0, 1), kv2[0].transpose(0, 1)], dim=0)
    v = torch.cat([kv1[1].transpose(0, 1), kv2[1].transpose(0, 1)], dim=0)
    col = torch.arange(k.shape[0], device=q.device)[None, :]
    in1 = (col >= r1_start.long()[:, None]) & (col < r1_end.long()[:, None]) & (col < L1)
    in2 = (col >= r2_start.long()[:, None] + L1) & (col < r2_end.long()[:, None] + L1) & (col >= L1)
    return _masked_softmax_attention(q, k, v, in1 | in2, seg_len=seg_len, sm_scale=sm_scale)


def kv_norm_rope_pack_reference(k, v, kw, kb, sin, cos, *, eps: float, rep: int = 1, out_dtype=None):
    """Plain version of `kv_norm_rope_pack`."""
    out_dtype = out_dtype or k.dtype
    kf = k.float()
    mean = kf.mean(-1, keepdim=True)
    var = (kf - mean).square().mean(-1, keepdim=True)
    kn = (kf - mean) * torch.rsqrt(var + eps) * kw.float() + kb.float()
    if sin is not None:
        rot = sin.shape[-1]
        s_ = sin.float()[:, None, :]
        c_ = cos.float()[:, None, :]
        x1, x2, tail = kn[..., :rot], kn[..., rot : 2 * rot], kn[..., 2 * rot :]
        kn = torch.cat([x1 * c_ - x2 * s_, x1 * s_ + x2 * c_, tail], dim=-1)
    kv = torch.stack([kn.to(out_dtype), v.to(out_dtype)], dim=0).transpose(1, 2)  # [2, hk, S, hd]
    if rep > 1:
        kv = kv.repeat_interleave(rep, dim=1)
    return kv.contiguous()


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------


def _require(name: str, t: torch.Tensor, device, dtype, shape) -> None:
    if t.device != device or t.dtype != dtype or tuple(t.shape) != tuple(shape) or not t.is_contiguous():
        raise ValueError(
            f"{name} must be a contiguous {dtype} tensor of shape {tuple(shape)} on {device}; got "
            f"{t.dtype} {tuple(t.shape)} on {t.device} (contiguous={t.is_contiguous()})"
        )


def _check_q(fn: str, q: torch.Tensor, hk: int, seg_len: int) -> int:
    total_q, hq, hd = q.shape
    _require(f"{fn}: q", q, q.device, torch.bfloat16, q.shape)
    if hd not in (64, 128):
        raise ValueError(f"{fn}: head_dim {hd} not supported by the kernel (64 or 128)")
    if hq % hk:
        raise ValueError(f"{fn}: GQA needs hq % hk == 0, got hq={hq} hk={hk}")
    if seg_len <= 0 or total_q % seg_len:
        raise ValueError(f"{fn}: {total_q} query tokens are not a multiple of seg_len {seg_len}")
    return total_q // seg_len


def _prologue_operands(fn: str, q: torch.Tensor, q_prologue, sm_scale: float):
    """(qw, qb, sin, cos, rot, eps) for the kernel, sm_scale*log2e folded
    into the LayerNorm affine (rotary is a rotation, so scaling commutes)."""
    if q_prologue is None:
        return None, None, None, None, 0, 0.0
    qw, qb, sin, cos, eps = q_prologue
    total_q, _, hd = q.shape
    qw = (qw.float() * (sm_scale * LOG2E)).contiguous()
    qb = (qb.float() * (sm_scale * LOG2E)).contiguous()
    _require(f"{fn}: qw", qw, q.device, torch.float32, (hd,))
    _require(f"{fn}: qb", qb, q.device, torch.float32, (hd,))
    rot = 0
    if sin is not None:
        rot = sin.shape[-1]
        if 2 * rot > hd:
            raise ValueError(f"{fn}: rotary width 2*{rot} exceeds head_dim {hd}")
        _require(f"{fn}: sin", sin, q.device, torch.float32, (total_q, rot))
        _require(f"{fn}: cos", cos, q.device, torch.float32, (total_q, rot))
    return qw, qb, sin, cos, rot, float(eps)


def _check_ranges(fn: str, device, n_seg: int, *ranges) -> None:
    for i, r in enumerate(ranges):
        _require(f"{fn}: range {i}", r, device, torch.int32, (n_seg,))


def segmented_attention_two_source(
    q: torch.Tensor,  # [n_seg * seg_len, hq, hd]
    kv1: torch.Tensor,  # [2, hk, kv1_len, hd] (k, v stacked)
    kv2: torch.Tensor,  # [2, hk, kv2_len, hd]
    r1_start: torch.Tensor,
    r1_end: torch.Tensor,
    r2_start: torch.Tensor,
    r2_end: torch.Tensor,
    *,
    seg_len: int,
    sm_scale: Optional[float] = None,
    q_prologue=None,
) -> torch.Tensor:
    """Two-source segmented flash attention: the DiT self-attention over
    the read-only KV cache (source 1, may hold 0 tokens) and the current
    kv (source 2).  Returns [S, hq, hd]."""
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    if q.device.type == "cpu":
        if q_prologue is not None:
            q = apply_q_prologue(q, q_prologue)
        return segmented_attention_two_source_reference(
            q, kv1, kv2, r1_start, r1_end, r2_start, r2_end, seg_len=seg_len, sm_scale=sm_scale
        )
    fn = "segmented_attention_two_source"
    total_q, hq, hd = q.shape
    hk, L1, L2 = kv1.shape[1], kv1.shape[2], kv2.shape[2]
    n_seg = _check_q(fn, q, hk, seg_len)
    _require(f"{fn}: kv1", kv1, q.device, torch.bfloat16, (2, hk, L1, hd))
    _require(f"{fn}: kv2", kv2, q.device, torch.bfloat16, (2, hk, L2, hd))
    _check_ranges(fn, q.device, n_seg, r1_start, r1_end, r2_start, r2_end)
    qw, qb, sin, cos, rot, eps = _prologue_operands(fn, q, q_prologue, sm_scale)
    out = torch.empty_like(q)
    if total_q == 0:
        return out
    err = _lib.lib().magi_seg_attn_two_source(
        q.data_ptr(), out.data_ptr(), kv1.data_ptr(), L1, kv2.data_ptr(), L2,
        r1_start.data_ptr(), r1_end.data_ptr(), r2_start.data_ptr(), r2_end.data_ptr(),
        _lib.ptr(qw), _lib.ptr(qb), _lib.ptr(sin), _lib.ptr(cos),
        n_seg, seg_len, hq, hk, hd, rot, eps, float(sm_scale * LOG2E), _lib.stream(q.device),
    )
    _lib.check(err, fn)
    segmented_attention_two_source.launches += 1
    return out


segmented_attention_two_source.launches = 0


# kernel kinds of `magi_seg_attn` in csrc/attention.cu
_KIND_V2, _KIND_GRID = 1, 2


def _single_source(wrapper, kind: int, q, k, v, kv_start, kv_end, *, seg_len, sm_scale, q_prologue):
    """Launch the single-source kernel `kind` for `wrapper`, whose launch
    count it bumps."""
    fn = wrapper.__name__
    total_q, hq, hd = q.shape
    kv_len, hk = k.shape[0], k.shape[1]
    n_seg = _check_q(fn, q, hk, seg_len)
    _require(f"{fn}: k", k, q.device, torch.bfloat16, (kv_len, hk, hd))
    _require(f"{fn}: v", v, q.device, torch.bfloat16, (kv_len, hk, hd))
    _check_ranges(fn, q.device, n_seg, kv_start, kv_end)
    qw, qb, sin, cos, rot, eps = _prologue_operands(fn, q, q_prologue, sm_scale)
    out = torch.empty_like(q)
    if total_q == 0:
        return out
    err = _lib.lib().magi_seg_attn(
        q.data_ptr(), out.data_ptr(), k.data_ptr(), v.data_ptr(), kv_len, kv_start.data_ptr(), kv_end.data_ptr(),
        _lib.ptr(qw), _lib.ptr(qb), _lib.ptr(sin), _lib.ptr(cos),
        n_seg, seg_len, hq, hk, hd, rot, eps, float(sm_scale * LOG2E), kind, _lib.stream(q.device),
    )
    _lib.check(err, fn)
    wrapper.launches += 1
    return out


def segmented_attention(
    q: torch.Tensor,  # [n_seg * seg_len, hq, hd]
    k: torch.Tensor,  # [kv_len, hk, hd]
    v: torch.Tensor,  # [kv_len, hk, hd]
    kv_start: torch.Tensor,  # int32 [n_seg]
    kv_end: torch.Tensor,  # int32 [n_seg]
    *,
    seg_len: int,
    sm_scale: Optional[float] = None,
) -> torch.Tensor:
    """Single-source segmented attention without a q prologue (the JAX
    package's grid kernel; the VAE's head_dim-64 attention lands here)."""
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    if q.device.type == "cpu":
        return segmented_attention_reference(q, k, v, kv_start, kv_end, seg_len=seg_len, sm_scale=sm_scale)
    return _single_source(
        segmented_attention, _KIND_GRID, q, k, v, kv_start, kv_end, seg_len=seg_len, sm_scale=sm_scale,
        q_prologue=None,
    )


segmented_attention.launches = 0


def segmented_attention_v2(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    kv_start: torch.Tensor,
    kv_end: torch.Tensor,
    *,
    seg_len: int,
    sm_scale: Optional[float] = None,
    q_prologue=None,
) -> torch.Tensor:
    """Single-source segmented attention with the optional fused q
    prologue (the DiT caption cross-attention uses it norm-only).  As in
    the JAX package, a head_dim that is not a multiple of 128 goes to
    `segmented_attention` when there is no prologue; unlike the Pallas
    kernel, this one also takes the prologue at head_dim 64."""
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    if q.shape[-1] % 128 and q_prologue is None:
        return segmented_attention(q, k, v, kv_start, kv_end, seg_len=seg_len, sm_scale=sm_scale)
    if q.device.type == "cpu":
        if q_prologue is not None:
            q = apply_q_prologue(q, q_prologue)
        return segmented_attention_reference(q, k, v, kv_start, kv_end, seg_len=seg_len, sm_scale=sm_scale)
    return _single_source(
        segmented_attention_v2, _KIND_V2, q, k, v, kv_start, kv_end, seg_len=seg_len, sm_scale=sm_scale,
        q_prologue=q_prologue,
    )


segmented_attention_v2.launches = 0


def kv_norm_rope_pack(
    k: torch.Tensor,  # [S, hk, hd] raw (pre-norm, pre-rope)
    v: torch.Tensor,  # [S, hk, hd]
    kw: torch.Tensor,  # f32 [hd] k-LayerNorm weight (+1 applied by the caller)
    kb: torch.Tensor,  # f32 [hd]
    sin: Optional[torch.Tensor],  # f32 [S, rot] or None
    cos: Optional[torch.Tensor],
    *,
    eps: float,
    rep: int = 1,
    out_dtype=None,
) -> torch.Tensor:
    """fp32 k-LayerNorm + rotary + cast, packed with v into the cache /
    kernel layout [2, hk*rep, S, hd] (bf16 on the card)."""
    if k.device.type == "cpu":
        return kv_norm_rope_pack_reference(k, v, kw, kb, sin, cos, eps=eps, rep=rep, out_dtype=out_dtype)
    fn = "kv_norm_rope_pack"
    S, hk, hd = k.shape
    if (out_dtype or k.dtype) != torch.bfloat16:
        raise ValueError(f"{fn}: the kernel writes bf16, got out_dtype {out_dtype}")
    if hd % 32 or hd > 256:
        raise ValueError(f"{fn}: head_dim {hd} must be a multiple of 32 and at most 256")
    _require(f"{fn}: k", k, k.device, torch.bfloat16, (S, hk, hd))
    _require(f"{fn}: v", v, k.device, torch.bfloat16, (S, hk, hd))
    _require(f"{fn}: kw", kw, k.device, torch.float32, (hd,))
    _require(f"{fn}: kb", kb, k.device, torch.float32, (hd,))
    rot = 0
    if sin is not None:
        rot = sin.shape[-1]
        if 2 * rot > hd:
            raise ValueError(f"{fn}: rotary width 2*{rot} exceeds head_dim {hd}")
        _require(f"{fn}: sin", sin, k.device, torch.float32, (S, rot))
        _require(f"{fn}: cos", cos, k.device, torch.float32, (S, rot))
    out = torch.empty((2, hk * rep, S, hd), dtype=torch.bfloat16, device=k.device)
    if S == 0:
        return out
    err = _lib.lib().magi_kv_norm_rope_pack(
        k.data_ptr(), v.data_ptr(), kw.data_ptr(), kb.data_ptr(), _lib.ptr(sin), _lib.ptr(cos), out.data_ptr(),
        S, hk, hd, rep, rot, float(eps), _lib.stream(k.device),
    )
    _lib.check(err, fn)
    kv_norm_rope_pack.launches += 1
    return out


kv_norm_rope_pack.launches = 0

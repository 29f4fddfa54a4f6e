"""Segmented attention and the k-side LayerNorm + rotary + pack.

Semantics (as in `magi_tpu.ops.attention`): queries are `n_seg`
contiguous blocks of `seg_len` tokens, token-major `[S, hq, hd]`; segment
i attends kv tokens `[kv_start[i], kv_end[i])`.  The two-source variant
attends `[r1s, r1e)` of a read-only source (the KV cache) and then
`[r2s, r2e)` of a second one (the current window's kv), both in the
kernel layout `[2, hk, tok, hd]`.  A range is clipped to its source's
tokens.  A segment with empty ranges outputs 0.
GQA: q head h reads kv head h // (hq // hk).

Each public function launches a CUDA kernel (`csrc/attention_tma.cu` for
the two-source attention, `csrc/attention.cu` for the single-source one,
`csrc/norm.cu`) when its tensors are on a CUDA device and runs the plain
PyTorch version beside it when they are on the CPU.  The attention
kernels load with TMA: the two-source kernels (K1 here, K5 in
`ops/attention_q8.py`, head_dim 128) their sources, the single-source ones
(K2, K2g: head_dim 64 or 128) q, k and v.  Each may be any view with a
contiguous last dimension whose base and other strides are multiples of
16 bytes; anything else raises.  Each keeps a count
of its kernel launches in its `launches` attribute.  The int8 attention
over an int8 KV cache is in `ops/attention_q8.py`; its cache writer is
`kv_norm_rope_pack(..., quantize=True)` here.

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


def norm_rope_f32(x: torch.Tensor, w, b, sin, cos, eps: float) -> torch.Tensor:
    """fp32 LayerNorm of the rows of x [S, h, hd] with (w, b), then GPT-NeoX
    rotary on the first 2*rot dims (`sin`/`cos` [S, rot], or None)."""
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    var = (xf - mean).square().mean(-1, keepdim=True)
    xn = (xf - mean) * torch.rsqrt(var + eps) * w.float() + b.float()
    if sin is not None:
        rot = sin.shape[-1]
        s_ = sin.float()[:, None, :]
        c_ = cos.float()[:, None, :]
        x1, x2, tail = xn[..., :rot], xn[..., rot : 2 * rot], xn[..., 2 * rot :]
        xn = torch.cat([x1 * c_ - x2 * s_, x1 * s_ + x2 * c_, tail], dim=-1)
    return xn


def apply_q_prologue(q: torch.Tensor, q_prologue) -> torch.Tensor:
    """fp32 LayerNorm (+ NeoX rotary) of q, cast back to q's dtype."""
    qw, qb, sin, cos, eps = q_prologue
    return norm_rope_f32(q, qw, qb, sin, cos, eps).to(q.dtype)


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
    kn = norm_rope_f32(k, kw, kb, sin, cos, eps)
    kv = torch.stack([kn.to(out_dtype), v.to(out_dtype)], dim=0).transpose(1, 2)  # [2, hk, S, hd]
    if rep > 1:
        kv = kv.repeat_interleave(rep, dim=1)
    return kv.contiguous()


def _quantize_rows_mul(x: torch.Tensor):
    """Per-row symmetric int8 of x [..., hd] as the Pallas kernels take it:
    scale max(amax, 1e-8) * (1/127), value round(x * (1 / scale))."""
    scale = torch.clamp(x.abs().amax(-1, keepdim=True), min=1e-8) * (1.0 / 127.0)
    return torch.round(x * (1.0 / scale)).clamp(-127, 127).to(torch.int8), scale[..., 0]


def kv_norm_rope_pack_q8_reference(k, v, kw, kb, sin, cos, *, eps: float, rep: int = 1):
    """Plain version of `kv_norm_rope_pack(quantize=True)`: k quantized
    per token from its f32 normed, roped values (not their bf16 round), v
    from its own values; returns (int8 [2, hk*rep, S, hd], f32 [2, hk*rep, S])."""
    kn = norm_rope_f32(k, kw, kb, sin, cos, eps)
    kv = torch.stack([kn, v.float()], dim=0).transpose(1, 2)  # [2, hk, S, hd]
    if rep > 1:
        kv = kv.repeat_interleave(rep, dim=1)
    q8, scale = _quantize_rows_mul(kv)
    return q8.contiguous(), scale.contiguous()


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
    """The number of segments in q [n_seg * seg_len, hq, hd]; raises on
    shapes the kernels do not take (q's layout is the caller's check)."""
    total_q, hq, hd = q.shape
    if hd not in (64, 128):
        raise ValueError(f"{fn}: head_dim {hd} not supported by the kernel (64 or 128)")
    if hq % hk:
        raise ValueError(f"{fn}: GQA needs hq % hk == 0, got hq={hq} hk={hk}")
    if seg_len <= 0 or total_q % seg_len:
        raise ValueError(f"{fn}: {total_q} query tokens are not a multiple of seg_len {seg_len}")
    return total_q // seg_len


def _prologue_operands(fn: str, q: torch.Tensor, q_prologue):
    """(qw, qb, sin, cos, rot, eps) for the kernel: the plain LayerNorm
    affine in f32 (K1 and K2 scale it by sm_scale*log2e as they read it;
    rotary is a rotation, so scaling commutes)."""
    if q_prologue is None:
        return None, None, None, None, 0, 0.0
    qw, qb, sin, cos, eps = q_prologue
    total_q, _, hd = q.shape
    qw, qb = (w.float().contiguous() for w in (qw, qb))
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


TMA_HEAD_DIM = 128  # the head_dim of the two-source kernels (csrc/attention_tma.cu)


def _tma_source(fn: str, name: str, kv: torch.Tensor, device, dtype, hk: int, hd: int):
    """(pointer, tokens, token / head / k|v strides in elements) of a source
    [2, hk, len, hd] for the TMA kernels.  Raises unless the last dimension
    is contiguous and the base and the other strides are multiples of 16
    bytes, which TMA needs."""
    if kv.device != device or kv.dtype != dtype or kv.dim() != 4 or tuple(kv.shape[:2]) != (2, hk) or (
        kv.shape[3] != hd
    ):
        raise ValueError(f"{fn}: {name} must be a {dtype} tensor [2, {hk}, tokens, {hd}] on {device}; got "
                         f"{kv.dtype} {tuple(kv.shape)} on {kv.device}")
    L = kv.shape[2]
    if L == 0:
        return kv.data_ptr(), 0, 0, 0, 0  # never read
    s_kv, s_h, s_t, s_d = kv.stride()
    if hk == 1:
        s_h = s_t * L  # the stride of a single head is never used
    es = kv.element_size()
    if s_d != 1 or kv.data_ptr() % 16 or any(st * es % 16 for st in (s_t, s_h, s_kv)):
        raise ValueError(f"{fn}: {name} must have a contiguous last dimension and a base and strides that are "
                         f"multiples of 16 bytes (TMA); got strides {kv.stride()} at address {kv.data_ptr():#x}")
    return kv.data_ptr(), L, s_t, s_h, s_kv


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
    hk = kv1.shape[1]
    _require(f"{fn}: q", q, q.device, torch.bfloat16, q.shape)
    n_seg = _check_q(fn, q, hk, seg_len)
    if hd != TMA_HEAD_DIM:
        raise ValueError(f"{fn}: the kernel takes head_dim {TMA_HEAD_DIM}, got {hd}")
    src1 = _tma_source(fn, "kv1", kv1, q.device, torch.bfloat16, hk, hd)
    src2 = _tma_source(fn, "kv2", kv2, q.device, torch.bfloat16, hk, hd)
    _check_ranges(fn, q.device, n_seg, r1_start, r1_end, r2_start, r2_end)
    qw, qb, sin, cos, rot, eps = _prologue_operands(fn, q, q_prologue)
    out = torch.empty_like(q)
    if total_q == 0:
        return out
    err = _lib.lib().magi_seg_attn_two_source(
        q.data_ptr(), out.data_ptr(), *src1, *src2,
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


def token_major_view(fn: str, name: str, t: torch.Tensor, device, shape) -> tuple:
    """(pointer, token stride, head stride), in elements, of a bf16
    token-major tensor [tokens, heads, hd] that the single-source kernels
    load with TMA.  Raises unless it lies on `device` with `shape`, its last
    dimension is contiguous, and its base and other strides are multiples
    of 16 bytes.  The stride of a single head is never used: it is given as
    hd."""
    if t.device != device or t.dtype != torch.bfloat16 or tuple(t.shape) != tuple(shape):
        raise ValueError(f"{fn}: {name} must be a bfloat16 tensor of shape {tuple(shape)} on {device}; got "
                         f"{t.dtype} {tuple(t.shape)} on {t.device}")
    s_t, s_h, s_d = t.stride()
    if t.numel() == 0:
        return t.data_ptr(), s_t, s_h  # never read
    if shape[1] == 1:
        s_h = shape[2]
    if shape[0] <= 1:
        s_t = shape[1] * shape[2]
    es = t.element_size()
    if s_d != 1 or t.data_ptr() % 16 or s_t * es % 16 or s_h * es % 16:
        raise ValueError(f"{fn}: {name} must have a contiguous last dimension and a base and strides that are "
                         f"multiples of 16 bytes (TMA); got strides {t.stride()} at address {t.data_ptr():#x}")
    return t.data_ptr(), s_t, s_h


def _single_source(wrapper, kind: int, q, k, v, kv_start, kv_end, *, seg_len, sm_scale, q_prologue):
    """Launch the single-source kernel `kind` for `wrapper`, whose launch
    count it bumps.  q, k and v may be views (`token_major_view`)."""
    fn = wrapper.__name__
    total_q, hq, hd = q.shape
    kv_len, hk = k.shape[0], k.shape[1]
    n_seg = _check_q(fn, q, hk, seg_len)
    vq = token_major_view(fn, "q", q, q.device, (total_q, hq, hd))
    vk = token_major_view(fn, "k", k, q.device, (kv_len, hk, hd))
    vv = token_major_view(fn, "v", v, q.device, (kv_len, hk, hd))
    _check_ranges(fn, q.device, n_seg, kv_start, kv_end)
    qw, qb, sin, cos, rot, eps = _prologue_operands(fn, q, q_prologue)
    out = torch.empty((total_q, hq, hd), dtype=q.dtype, device=q.device)
    if total_q == 0:
        return out
    err = _lib.lib().magi_seg_attn(
        *vq, out.data_ptr(), *vk, *vv, kv_len, kv_start.data_ptr(), kv_end.data_ptr(),
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


def _kv_pack_rot(fn: str, k, v, kw, kb, sin, cos) -> int:
    """Check the kv pack kernels' operands; returns the rotary width.  The
    kernel moves 8 values a lane, so every operand starts on 16 bytes.
    All conditions are tested in one pass (the wrappers run tens of
    microseconds of kernel each); the checks that name the fault run only
    when one fails."""
    S, hk, hd = k.shape
    rot = 0 if sin is None else sin.shape[-1]
    ops = (k, v, kw, kb, sin, cos) if rot else (k, v, kw, kb)
    dev = k.device
    if (hd in (64, 128, 256) and 2 * rot <= hd and k.dtype == v.dtype == torch.bfloat16 and v.shape == k.shape
            and kw.dtype == kb.dtype == torch.float32 and kw.shape == kb.shape == (hd,)
            and (not rot or (sin.dtype == cos.dtype == torch.float32 and sin.shape == cos.shape == (S, rot)))
            and all(t.device == dev and t.is_contiguous() and not t.data_ptr() % 16 for t in ops)):
        return rot
    if hd not in (64, 128, 256):
        raise ValueError(f"{fn}: head_dim {hd} not supported by the kernel (64, 128 or 256)")
    if 2 * rot > hd:
        raise ValueError(f"{fn}: rotary width 2*{rot} exceeds head_dim {hd}")
    for name, t, dtype, shape in (("k", k, torch.bfloat16, (S, hk, hd)), ("v", v, torch.bfloat16, (S, hk, hd)),
                                  ("kw", kw, torch.float32, (hd,)), ("kb", kb, torch.float32, (hd,)),
                                  ("sin", sin, torch.float32, (S, rot)), ("cos", cos, torch.float32, (S, rot))):
        if rot or name not in ("sin", "cos"):
            _require(f"{fn}: {name}", t, dev, dtype, shape)
    raise ValueError(f"{fn}: k, v, kw, kb, sin and cos must start on 16 bytes")


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
    quantize: bool = False,
):
    """fp32 k-LayerNorm + rotary + cast, packed with v into the cache /
    kernel layout [2, hk*rep, S, hd] (bf16 on the card).  `quantize=True`
    is `kv_norm_rope_pack_q8`: (int8 kv, f32 per-token scales)."""
    if quantize:
        return kv_norm_rope_pack_q8(k, v, kw, kb, sin, cos, eps=eps, rep=rep)
    if k.device.type == "cpu":
        return kv_norm_rope_pack_reference(k, v, kw, kb, sin, cos, eps=eps, rep=rep, out_dtype=out_dtype)
    fn = "kv_norm_rope_pack"
    S, hk, hd = k.shape
    if (out_dtype or k.dtype) != torch.bfloat16:
        raise ValueError(f"{fn}: the kernel writes bf16, got out_dtype {out_dtype}")
    rot = _kv_pack_rot(fn, k, v, kw, kb, sin, cos)
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


def kv_norm_rope_pack_q8(k, v, kw, kb, sin, cos, *, eps: float, rep: int = 1):
    """K3q: the k-side pack of the int8-stored KV cache.  Returns (int8
    [2, hk*rep, S, hd], f32 per-token scales [2, hk*rep, S]); k is quantized
    from its f32 normed, roped values.  The kernel's LayerNorm sums in
    another order than the plain version's, so an element whose quotient
    sits on a rounding edge may differ by one int8 step."""
    if k.device.type == "cpu":
        return kv_norm_rope_pack_q8_reference(k, v, kw, kb, sin, cos, eps=eps, rep=rep)
    fn = "kv_norm_rope_pack_q8"
    S, hk, hd = k.shape
    rot = _kv_pack_rot(fn, k, v, kw, kb, sin, cos)
    out = torch.empty((2, hk * rep, S, hd), dtype=torch.int8, device=k.device)
    scale = torch.empty((2, hk * rep, S), dtype=torch.float32, device=k.device)
    if S == 0:
        return out, scale
    err = _lib.lib().magi_kv_norm_rope_pack_q8(
        k.data_ptr(), v.data_ptr(), kw.data_ptr(), kb.data_ptr(), _lib.ptr(sin), _lib.ptr(cos), out.data_ptr(),
        scale.data_ptr(), S, hk, hd, rep, rot, float(eps), _lib.stream(k.device),
    )
    _lib.check(err, fn)
    kv_norm_rope_pack_q8.launches += 1
    return out, scale


kv_norm_rope_pack_q8.launches = 0

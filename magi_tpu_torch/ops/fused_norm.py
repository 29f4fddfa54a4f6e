"""Fused gate-modulate + LayerNorm + residual add: the post-attention and
post-MLP epilogue of every DiT layer,
``out = bf16( LN_fp32(gate[seg] * x) * (w (+1)) + b + residual )``.

`gate_norm_residual` launches the CUDA kernel (`csrc/norm.cu`) on CUDA
tensors and runs `gate_norm_residual_reference`, the plain PyTorch chain
with the same semantics, on CPU tensors.
"""

from __future__ import annotations

import torch

from magi_tpu_torch.ops import _lib


def _row_gates(gate, S: int, seg_len: int, row0: int):
    """The gate row of each of S rows that start row0 tokens into segment 0."""
    return gate.float()[torch.div(torch.arange(S, device=gate.device) + row0, seg_len, rounding_mode="floor")]


def gate_norm_residual_reference(x, residual, gate, weight, bias, *, eps: float, zero_centered: bool, n_seg: int,
                                 seg_len=None, row0: int = 0):
    """Plain PyTorch version: fp32 gate, LayerNorm and residual add, cast
    to the residual's dtype."""
    S, D = x.shape
    if seg_len is None:
        xf = (x.float().reshape(n_seg, S // n_seg, D) * gate.float()[:, None, :]).reshape(S, D)
    else:
        xf = x.float() * _row_gates(gate, S, seg_len, row0)
    mean = xf.mean(-1, keepdim=True)
    var = (xf - mean).square().mean(-1, keepdim=True)
    xn = (xf - mean) * torch.rsqrt(var + eps)
    w = weight.float() + (1.0 if zero_centered else 0.0)
    out = xn * w + bias.float() + residual.float()
    return out.to(residual.dtype)


def gate_norm_residual(
    x: torch.Tensor,  # [S, D] bf16
    residual: torch.Tensor,  # [S, D] bf16
    gate: torch.Tensor,  # [n_seg, D] f32
    weight: torch.Tensor,  # [D] f32
    bias: torch.Tensor,  # [D] f32
    *,
    eps: float,
    zero_centered: bool,
    n_seg: int,
    seg_len=None,
    row0: int = 0,
) -> torch.Tensor:
    """Returns bf16( LN_fp32(gate[seg] * x) + residual ) in one pass over
    device memory; the plain version for CPU tensors.  By default the S
    rows are n_seg equal segments; with `seg_len` they are a shard of the
    token axis that starts `row0` tokens into segment 0 (0 <= row0 <
    seg_len), row r taking gate row (r + row0) // seg_len of the n_seg rows
    of `gate` (`gate_norm_residual_sharded`)."""
    S, D = x.shape
    if seg_len is None:
        if S % n_seg:
            raise ValueError(f"token count {S} is not a multiple of n_seg {n_seg}")
        seg_len, row0 = max(S // n_seg, 1), 0
    elif not 0 <= row0 < seg_len or (S and (S - 1 + row0) // seg_len >= n_seg):
        raise ValueError(f"gate_norm_residual: {S} rows from offset {row0} need more than {n_seg} segments of {seg_len}")
    if x.device.type == "cpu":
        return gate_norm_residual_reference(
            x, residual, gate, weight, bias, eps=eps, zero_centered=zero_centered, n_seg=n_seg, seg_len=seg_len,
            row0=row0,
        )
    for name, t, dt, shape in (
        ("x", x, torch.bfloat16, (S, D)),
        ("residual", residual, torch.bfloat16, (S, D)),
        ("gate", gate, torch.float32, (n_seg, D)),
        ("weight", weight, torch.float32, (D,)),
        ("bias", bias, torch.float32, (D,)),
    ):
        if t.device != x.device or t.dtype != dt or tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(
                f"gate_norm_residual: {name} must be a contiguous {dt} tensor of shape {shape} on {x.device}, "
                f"got {t.dtype} {tuple(t.shape)} on {t.device} (contiguous={t.is_contiguous()})"
            )
    if D % 4:
        raise ValueError(f"gate_norm_residual: hidden size {D} must be a multiple of 4")
    out = torch.empty_like(residual)
    if S == 0:
        return out
    err = _lib.lib().magi_gate_norm_residual(
        x.data_ptr(), residual.data_ptr(), gate.data_ptr(), weight.data_ptr(), bias.data_ptr(), out.data_ptr(),
        S, D, seg_len, row0, float(eps), int(bool(zero_centered)), _lib.stream(x.device),
    )
    _lib.check(err, "gate_norm_residual")
    gate_norm_residual.launches += 1
    return out


gate_norm_residual.launches = 0


def gate_norm_residual_sharded(x, residual, gate, weight, bias, *, eps: float, zero_centered: bool, n_seg: int,
                               seg_len: int, row_start: int):
    """The epilogue on a rank's shard of the token axis (the port of
    `magi_tpu.ops.fused_norm.gate_norm_residual_sharded`): x and residual
    hold rows [row_start, row_start + S_loc) of the n_seg * seg_len tokens
    (rows past the last segment are padding, gated by zeros and dropped
    later); one launch with the gate rows of the segments the shard
    touches, its first row `row_start % seg_len` into the first of them,
    whether or not the shard straddles a segment boundary."""
    S = x.shape[0]
    first = row_start // seg_len
    last = (row_start + max(S, 1) - 1) // seg_len
    g = gate[first: min(last, n_seg - 1) + 1]
    if last >= n_seg:  # padding rows past the last segment
        g = torch.cat([g, torch.zeros((last + 1 - max(first, n_seg), gate.shape[1]), dtype=gate.dtype,
                                      device=gate.device)])
    return gate_norm_residual(x, residual, g.contiguous(), weight, bias, eps=eps, zero_centered=zero_centered,
                              n_seg=g.shape[0], seg_len=seg_len, row0=row_start - first * seg_len)

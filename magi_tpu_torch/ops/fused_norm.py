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


def gate_norm_residual_reference(x, residual, gate, weight, bias, *, eps: float, zero_centered: bool, n_seg: int):
    """Plain PyTorch version: fp32 gate, LayerNorm and residual add, cast
    to the residual's dtype."""
    S, D = x.shape
    xf = x.float().reshape(n_seg, S // n_seg, D) * gate.float()[:, None, :]
    xf = xf.reshape(S, D)
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
) -> torch.Tensor:
    """Returns bf16( LN_fp32(gate[seg] * x) + residual ) in one pass over
    device memory; the plain version for CPU tensors."""
    S, D = x.shape
    if S % n_seg:
        raise ValueError(f"token count {S} is not a multiple of n_seg {n_seg}")
    if x.device.type == "cpu":
        return gate_norm_residual_reference(
            x, residual, gate, weight, bias, eps=eps, zero_centered=zero_centered, n_seg=n_seg
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
        S, D, S // n_seg, float(eps), int(bool(zero_centered)), _lib.stream(x.device),
    )
    _lib.check(err, "gate_norm_residual")
    gate_norm_residual.launches += 1
    return out


gate_norm_residual.launches = 0

"""Fused producer + per-row int8 quantization of a linear group's input
(K8 and K8s, the port of `magi_tpu.ops.act_quant`).

Modes, as in the JAX package:

  * "plain":  q8(x)                        (proj, fc2 after GELU, kv_xattn inputs)
  * "ln":     q8(bf16(LayerNorm(x)))       (the shared pre-LN -> q/qx/k/v, mlp LN -> fc1)
  * "swiglu": q8(bf16(bf16(silu_f32(x_gate)) * x_up)) of x = [gate | up],
              a gated MLP's fc2 input: [S, 2F] -> [S, F] (K8s)

q8 is `act_quant_rowwise`: scale amax / 127 per row (1 for a zero row),
value round(x / scale) half to even, clipped to [-127, 127].

Each mode takes an optional smooth-quant vector s (`smooth`, the
`act_smooth` of a linear whose weight was quantized s·W): the producer's
value y becomes `smooth_divide(y, s)`, bf16(f32(y) * (1 / s)) per input
channel, before q8, in the same launch (the kernels read 1 / s, taken
once a launch).  For "plain" and "swiglu" that is the unfused chain's
bits; "ln" keeps its float64 statistics.

`rowquant_fused` launches the CUDA kernels (`csrc/quant.cu`) on CUDA
tensors (bf16; "swiglu" through `rowquant_swiglu`, which counts K8s's
launches apart from K8's) and runs `rowquant_fused_reference` on CPU
tensors, where the "ln" and "swiglu" producers are rounded to x's dtype
(bf16, as the kernels do, or f32 for an f32 model, as the unfused chain
does).  silu is `F.silu`, g / (1 + exp(-g)) in f32, which the kernel
computes with the same IEEE operations.  Unlike the Pallas kernel,
"swiglu" takes any F that is a multiple of 8: the Pallas kernel's
F % 2048 came from the TPU's 16 MB VMEM.  The LayerNorm's mean and variance
are taken in float64 by both: the sum of a row of bf16 inputs is then
exact in any order, so the kernel gives the plain version's bits.  The
JAX package takes them in f32; the two differ by an f32 ulp or so of the
statistics, which can move an element across a bf16 rounding edge.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from magi_tpu_torch.ops import _lib
from magi_tpu_torch.ops.quant import act_quant_rowwise

MODES = ("plain", "ln", "swiglu")


def _layer_norm_f64_stats(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, eps: float) -> torch.Tensor:
    """f32 LayerNorm ((x - mean) * rstd) * w + b of the rows of x, with the
    mean and variance (two passes) and rstd = 1 / sqrt(var + eps) in
    float64, eps taken at its f32 value."""
    n = x.shape[-1]
    xd = x.double()
    mean = xd.sum(-1, keepdim=True) / n
    var = (xd - mean).square().sum(-1, keepdim=True) / n
    rstd = (1.0 / torch.sqrt(var + float(np.float32(eps)))).float()
    return (x.float() - mean.float()) * rstd * w.float() + b.float()


def smooth_divide(x: torch.Tensor, smooth: torch.Tensor) -> torch.Tensor:
    """x / s per input channel, the JAX package's f32(x) * (1 / s) cast back
    to x's dtype: the product is taken in f32 and rounded once as it is
    written in x's dtype (1 / s is an IEEE reciprocal on either device)."""
    return torch.mul(x, torch.reciprocal(smooth.float()), out=torch.empty(x.shape, dtype=x.dtype, device=x.device))


def _check_x(fn: str, x: torch.Tensor) -> None:
    if x.dtype != torch.bfloat16 or not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError(f"{fn}: x must be a contiguous, 16-byte aligned bf16 tensor, got {x.dtype} "
                         f"(contiguous={x.is_contiguous()})")


def _inv_smooth(fn: str, smooth: Optional[torch.Tensor], width: int, device) -> Optional[torch.Tensor]:
    """1 / `smooth` as the kernels read it: f32 [width] on x's device, the
    IEEE reciprocal `smooth_divide` takes (None stays None)."""
    if smooth is None:
        return None
    if tuple(smooth.shape) != (width,):
        raise ValueError(f"{fn}: smooth must have shape ({width},), got {tuple(smooth.shape)}")
    return torch.reciprocal(smooth.to(device=device, dtype=torch.float32))


def rowquant_fused_reference(x, mode: str = "plain", ln_w=None, ln_b=None, *, eps: float = 1e-6, smooth=None):
    """The plain op chain of each mode; with `smooth`, the producer's value
    divided by it (`smooth_divide`) before the row quantization."""
    if mode == "swiglu":
        d = x.shape[-1] // 2
        x = (F.silu(x[:, :d].float()).to(x.dtype) * x[:, d:]).to(x.dtype)
    elif mode == "ln":
        x = _layer_norm_f64_stats(x, ln_w, ln_b, eps).to(x.dtype)
    elif mode != "plain":
        raise ValueError(f"rowquant_fused mode must be one of {MODES}, got {mode!r}")
    if smooth is not None:
        x = smooth_divide(x, smooth)
    return act_quant_rowwise(x)


def rowquant_fused(
    x: torch.Tensor,  # [S, K] bf16
    mode: str = "plain",
    ln_w: Optional[torch.Tensor] = None,  # [K] (zero-centered +1 already applied)
    ln_b: Optional[torch.Tensor] = None,
    *,
    eps: float = 1e-6,
    smooth: Optional[torch.Tensor] = None,  # [d_out] f32: divide the producer's value by it
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (int8 [S, d_out], f32 row scales [S]); d_out = K, or K / 2
    for "swiglu"."""
    if x.device.type == "cpu":
        return rowquant_fused_reference(x, mode, ln_w, ln_b, eps=eps, smooth=smooth)
    fn = "rowquant_fused"
    if mode == "swiglu":
        return rowquant_swiglu(x, smooth)
    if mode not in MODES:
        raise ValueError(f"{fn}: mode must be one of {MODES}, got {mode!r}")
    S, K = x.shape
    _check_x(fn, x)
    if K % 4:
        raise ValueError(f"{fn}: width {K} must be a multiple of 4")
    w = b = None
    if mode == "ln":
        w = ln_w.to(device=x.device, dtype=torch.float32).contiguous()
        b = ln_b.to(device=x.device, dtype=torch.float32).contiguous()
        if w.shape != (K,) or b.shape != (K,):
            raise ValueError(f"{fn}: ln_w and ln_b must have shape ({K},), got {tuple(w.shape)}, {tuple(b.shape)}")
    r = _inv_smooth(fn, smooth, K, x.device)
    q = torch.empty((S, K), dtype=torch.int8, device=x.device)
    scale = torch.empty((S,), dtype=torch.float32, device=x.device)
    if S == 0:
        return q, scale
    err = _lib.lib().magi_rowquant(
        x.data_ptr(), _lib.ptr(w), _lib.ptr(b), _lib.ptr(r), q.data_ptr(), scale.data_ptr(), S, K, float(eps),
        _lib.stream(x.device),
    )
    _lib.check(err, fn)
    rowquant_fused.launches += 1
    rowquant_fused.launches_smooth += r is not None
    return q, scale


rowquant_fused.launches = 0
rowquant_fused.launches_smooth = 0  # of `launches`, those with a smooth-quant vector


def rowquant_swiglu(x: torch.Tensor, smooth: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """K8s, `rowquant_fused(x, "swiglu", smooth=smooth)` with a launch count
    of its own: x = [gate | up] bf16 [S, 2F] (F a multiple of 8) -> (int8
    [S, F], f32 row scales [S])."""
    if x.device.type == "cpu":
        return rowquant_fused_reference(x, "swiglu", smooth=smooth)
    S, K = x.shape
    _check_x("rowquant_swiglu", x)
    if K % 16:
        raise ValueError(f"rowquant_swiglu: width {K} must be a multiple of 16")
    r = _inv_smooth("rowquant_swiglu", smooth, K // 2, x.device)
    q = torch.empty((S, K // 2), dtype=torch.int8, device=x.device)
    scale = torch.empty((S,), dtype=torch.float32, device=x.device)
    if S == 0:
        return q, scale
    err = _lib.lib().magi_rowquant_swiglu(x.data_ptr(), _lib.ptr(r), q.data_ptr(), scale.data_ptr(), S, K // 2,
                                          _lib.stream(x.device))
    _lib.check(err, "rowquant_swiglu")
    rowquant_swiglu.launches += 1
    rowquant_swiglu.launches_smooth += r is not None
    return q, scale


rowquant_swiglu.launches = 0
rowquant_swiglu.launches_smooth = 0  # of `launches`, those with a smooth-quant vector

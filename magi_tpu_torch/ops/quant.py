"""int8 weight and activation quantization and the int8 GEMM (the port of
`magi_tpu.ops.quant`, int8 half).

* `quantize_int8` / `quantize_params_int8`: per-output-channel symmetric
  int8 weights with f32 scales, the JAX package's tree (`weight_q` int8
  [L, in, out] + `weight_scale` f32 [L, out] per quantized linear, and the
  bf16 first/last layers in a `blocks_edge/{first,last}` side tree), in
  the same [in, out] layout.  Quantized one layer at a time, so a bf16
  tree never has a whole f32 copy.
* `act_quant_rowwise`: per-row dynamic int8 of an activation (plain
  PyTorch, as XLA does it in the JAX package).
* `quantized_matmul_i8` (K6): int8 x int8 -> int32 GEMM with the f32
  epilogue `acc * row_scale[m] * col_scale[n]`, a CUDA kernel
  (`csrc/quant.cu`) on CUDA tensors and `quantized_matmul_i8_reference`
  on the CPU.

int4 (w4a8), smooth-quant (`act_smooth`) and the bf16 x int8 dequant GEMM
`quantized_matmul` (K7) on the card are the next slice and raise
`NotImplementedError` (ROADMAP queue 1 item 11, queue 2 K7).
"""

from __future__ import annotations

from typing import Tuple

import torch

from magi_tpu_torch.ops import _lib

QUANTIZABLE_SUFFIXES = (
    "self_attention/linear_qkv/q/weight",
    "self_attention/linear_qkv/qx/weight",
    "self_attention/linear_qkv/k/weight",
    "self_attention/linear_qkv/v/weight",
    "self_attention/linear_kv_xattn/weight",
    "self_attention/linear_proj/weight",
    "mlp/linear_fc1/weight",
    "mlp/linear_fc2/weight",
)

_INT4 = "int4 weights (w4a8: quantize_int4, unpack_int4) are ROADMAP queue 1 item 11, the 24B w4a8 slice"


def div127(t: torch.Tensor) -> torch.Tensor:
    """t / 127 as a true f32 quotient on every backend (PyTorch's CUDA
    division by a Python scalar multiplies by its reciprocal instead)."""
    return t / torch.tensor(127.0, dtype=t.dtype, device=t.device)


def _scale_of(amax: torch.Tensor) -> torch.Tensor:
    return torch.where(amax == 0, torch.ones_like(amax), div127(amax))


def quantize_int8(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """[in, out] -> (int8 [in, out], f32 scales [out]): per-output-channel
    symmetric quantization, round half to even."""
    wf = w.float()
    scale = _scale_of(wf.abs().amax(dim=0))
    return torch.round(wf / scale).clamp(-127, 127).to(torch.int8), scale


def quantize_int4(w):
    raise NotImplementedError(_INT4)


def unpack_int4(packed):
    raise NotImplementedError(_INT4)


def _quantize_stacked(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """[L, in, out] -> (int8 [L, in, out], scales [L, out]), one layer at a
    time so the f32 temporaries stay one layer wide."""
    q = torch.empty(w.shape, dtype=torch.int8, device=w.device)
    s = torch.empty((w.shape[0], w.shape[2]), dtype=torch.float32, device=w.device)
    for i in range(w.shape[0]):
        q[i], s[i] = quantize_int8(w[i])
    return q, s


def quantize_params_int4(params: dict, keep_edge_bf16: bool = True) -> dict:
    raise NotImplementedError(_INT4)


def _leaves(tree: dict, keys: list):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, keys + [k])
        else:
            yield keys + [k], v


def _set_path(tree: dict, keys: list, value) -> None:
    for k in keys[:-1]:
        tree = tree.setdefault(k, {})
    tree[keys[-1]] = value


def quantize_params_int8(params: dict) -> dict:
    """Quantize the big DiT linears to int8 + per-channel scales, as a new
    tree: the stacked linears' weights become `weight_q` / `weight_scale`
    leaves and every other leaf is shared with `params`.  Layers 0 and L-1
    keep their bf16 weights, cloned, in `blocks_edge/{first,last}` (the
    reference's full-bf16 first/last layers; the model routes those two
    layers through them), so dropping `params` frees the bf16 stacks."""
    paths = {"/".join(keys) for keys, _ in _leaves(params, [])}
    new_tree: dict = {}
    for keys, leaf in _leaves(params, []):
        if not (any("/".join(keys).endswith(sfx) for sfx in QUANTIZABLE_SUFFIXES) and leaf.ndim == 3):
            _set_path(new_tree, keys, leaf)
            continue
        if "/".join(keys[:-1] + ["act_smooth"]) in paths:
            raise NotImplementedError("smooth-quant (act_smooth) trees are ROADMAP queue 1 item 11")
        q, s = _quantize_stacked(leaf)
        _set_path(new_tree, keys[:-1] + ["weight_q"], q)
        _set_path(new_tree, keys[:-1] + ["weight_scale"], s)
        _set_path(new_tree, ["blocks_edge", "first"] + keys[1:], leaf[0].clone())
        _set_path(new_tree, ["blocks_edge", "last"] + keys[1:], leaf[-1].clone())
    return new_tree


def act_quant_rowwise(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """[m, k] -> (int8 [m, k], f32 row scales [m]): scale amax / 127 (1 for
    an all-zero row), value round(x / scale), half to even."""
    xf = x.float()
    scale = _scale_of(xf.abs().amax(dim=1, keepdim=True))
    return torch.round(xf / scale).clamp(-127, 127).to(torch.int8), scale[:, 0]


# ---------------------------------------------------------------------------
# int8 GEMM
# ---------------------------------------------------------------------------


def _epilogue(acc: torch.Tensor, row_scale, col_scale, out_dtype):
    return (acc.float() * row_scale[:, None] * col_scale[None, :]).to(out_dtype)


def quantized_matmul_i8_reference(x_q, row_scale, w_q, col_scale, out_dtype=torch.bfloat16):
    """Plain version of K6.  The int32 product is exact; CUDA has no int32
    matmul, so on the card it runs in float64, exact while |acc| < 2**53
    (127**2 * K is below that for any K under 5e11)."""
    if x_q.device.type == "cuda":
        acc = x_q.double() @ w_q.double()
    else:
        acc = x_q.int() @ w_q.int()
    return _epilogue(acc, row_scale, col_scale, out_dtype)


def quantized_matmul_i8(
    x_q: torch.Tensor,  # [m, k] int8 (from act_quant_rowwise / rowquant_fused)
    row_scale: torch.Tensor,  # [m] f32
    w_q: torch.Tensor,  # [k, n] int8
    col_scale: torch.Tensor,  # [n] f32
    *,
    out_dtype=torch.bfloat16,
) -> torch.Tensor:
    """K6: bf16((x_q @ w_q)_int32 * row_scale[m] * col_scale[n]); the CUDA
    kernel on CUDA tensors (bf16 output, k and n multiples of 16), the
    plain version on CPU tensors."""
    if x_q.device.type == "cpu":
        return quantized_matmul_i8_reference(x_q, row_scale, w_q, col_scale, out_dtype)
    fn = "quantized_matmul_i8"
    m, k = x_q.shape
    n = w_q.shape[1]
    if out_dtype != torch.bfloat16:
        raise ValueError(f"{fn}: the kernel writes bf16, got out_dtype {out_dtype}")
    if k % 16 or n % 16:
        raise ValueError(f"{fn}: k ({k}) and n ({n}) must be multiples of 16")
    for name, t, dt, shape in (
        ("x_q", x_q, torch.int8, (m, k)),
        ("row_scale", row_scale, torch.float32, (m,)),
        ("w_q", w_q, torch.int8, (k, n)),
        ("col_scale", col_scale, torch.float32, (n,)),
    ):
        if t.device != x_q.device or t.dtype != dt or tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(
                f"{fn}: {name} must be a contiguous {dt} tensor of shape {shape} on {x_q.device}, "
                f"got {t.dtype} {tuple(t.shape)} on {t.device} (contiguous={t.is_contiguous()})"
            )
    out = torch.empty((m, n), dtype=torch.bfloat16, device=x_q.device)
    if m == 0:
        return out
    err = _lib.lib().magi_qmm_i8(
        x_q.data_ptr(), row_scale.data_ptr(), w_q.data_ptr(), col_scale.data_ptr(), out.data_ptr(), m, n, k,
        _lib.stream(x_q.device),
    )
    _lib.check(err, fn)
    quantized_matmul_i8.launches += 1
    return out


quantized_matmul_i8.launches = 0


# ---------------------------------------------------------------------------
# bf16 x int8 dequant GEMM (K7): the plain version only
# ---------------------------------------------------------------------------


def quantized_matmul_reference(x, w_q, scale):
    """x @ (w_q * scale) in f32, cast to x's dtype."""
    return (x.float() @ (w_q.float() * scale[None, :].float())).to(x.dtype)


def quantized_matmul(x: torch.Tensor, w_q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """The dequant GEMM of layers that run bf16 activations on int8 weights
    (a quantized tree without `blocks_edge`): the plain version on the CPU;
    its kernel (K7) is not ported yet."""
    if x.device.type == "cpu":
        return quantized_matmul_reference(x, w_q, scale)
    raise NotImplementedError(
        "quantized_matmul (K7, the bf16 x int8 dequant GEMM of a quantized tree without blocks_edge) is "
        "ROADMAP queue 2 K7, with the 24B w4a8 slice"
    )

"""Weight and activation quantization and the quantized GEMMs (the port of
`magi_tpu.ops.quant`).

* `quantize_int8` / `quantize_params_int8`: per-output-channel symmetric
  int8 weights with f32 scales, the JAX package's tree (`weight_q` int8
  [L, in, out] + `weight_scale` f32 [L, out] per quantized linear, and the
  bf16 first/last layers in a `blocks_edge/{first,last}` side tree), with
  the same shapes and values.  Quantized one layer at a time, so a bf16
  tree never has a whole f32 copy.
* `quantize_int4` / `unpack_int4` / `quantize_params_int4` (w4a8):
  symmetric int4 in [-7, 7] with per-output-channel scales, offset by 8
  and nibble-packed two rows to a byte (row 2i in the low nibble, 2i+1 in
  the high one), `weight_q4` uint8 [L, in/2, out] in the tree.  The model
  unpacks one layer's weights to int8 per forward with `unpack_int4`,
  plain PyTorch on every device (the JAX package leaves it to XLA), and
  runs the int8 linears on them.
* The int8 and packed weights are stored k-major: a weight that is
  logically [in, out] (the JAX layout, at every function here) lies in
  memory as [out, in], strides (1, in), and a stacked leaf [L, in, out] as
  [L, out, in].  The quantized GEMMs' tensor cores read 8-bit operands
  along k only, so the weights are laid out once where they are made
  (`quantize_*`, `unpack_int4`, `checkpoint.from_jax`); the kernels refuse
  any other layout.
* `act_quant_rowwise`: per-row dynamic int8 of an activation (plain
  PyTorch, as XLA does it in the JAX package).
* `quantized_matmul_i8` (K6): int8 x int8 -> int32 GEMM with the f32
  epilogue `acc * row_scale[m] * col_scale[n]`.
* `quantized_matmul` (K7): bf16 x times int8 weights, dequantized in the
  loop, f32 sums, `* col_scale[n]` -> bf16; the linears of layers that run
  bf16 activations on int8 weights (a quantized tree without
  `blocks_edge`).
K6 and K7 are CUDA kernels (`csrc/quant.cu`, wgmma fed by TMA from the
k-major weights) on CUDA tensors and their plain versions on CPU tensors.

A tree loaded from a released fp8 checkpoint carries `act_smooth` [L, in]
beside each smooth-quant linear (`checkpoint.loader._dequant_fp8`): its
weight is quantized smooth-folded, s[in]·W per layer, and the model divides
that linear's input by s (`models.dit.model._linears_shared`).  The bf16
edge layers of `blocks_edge` stay unfolded and carry no `act_smooth`.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from magi_tpu_torch.core.utils import nest, tree_leaves
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


def div127(t: torch.Tensor) -> torch.Tensor:
    """t / 127 as a true f32 quotient on every backend (PyTorch's CUDA
    division by a Python scalar multiplies by its reciprocal instead).  The
    divisor is filled on the device (no host copy: capturable)."""
    return t / torch.full((), 127.0, dtype=t.dtype, device=t.device)


def _scale_of(amax: torch.Tensor) -> torch.Tensor:
    return torch.where(amax == 0, torch.ones_like(amax), div127(amax))


def _weight_scale(amax: torch.Tensor, qmax: int) -> torch.Tensor:
    """amax * f32(1 / qmax), 1 where amax is 0: the JAX package's
    `amax / qmax` as XLA compiles it in its jitted tree quantization (a
    multiply by the constant's reciprocal), so the trees are equal bit for
    bit."""
    recip = torch.tensor(float(np.float32(1) / np.float32(qmax)), dtype=torch.float32, device=amax.device)
    return torch.where(amax == 0, torch.ones_like(amax), amax * recip)


def k_major(t: torch.Tensor) -> torch.Tensor:
    """`t` [..., k, n] with the same values, laid out k-major: the memory of
    a contiguous [..., n, k], seen through a transpose."""
    out = torch.empty(t.shape[:-2] + (t.shape[-1], t.shape[-2]), dtype=t.dtype, device=t.device).transpose(-1, -2)
    return out.copy_(t)


def quantize_int8(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """[in, out] -> (int8 [in, out] k-major, f32 scales [out]):
    per-output-channel symmetric quantization, round half to even."""
    wf = w.float()
    scale = _weight_scale(wf.abs().amax(dim=0), 127)
    return k_major(torch.round(wf / scale).clamp(-127, 127).to(torch.int8)), scale


def quantize_int4(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """[in, out] -> (uint8 nibble-packed [in/2, out] k-major, f32 scales
    [out]): values round(w / scale) in [-7, 7] plus 8, row 2i in the low
    nibble and row 2i+1 in the high nibble."""
    if w.shape[0] % 2:
        raise ValueError(f"quantize_int4: the input dim ({w.shape[0]}) must be even for nibble packing")
    wf = w.float()
    scale = _weight_scale(wf.abs().amax(dim=0), 7)
    q = torch.round(wf / scale).clamp(-7, 7).to(torch.int32) + 8  # [1, 15]
    return k_major((q[0::2] | (q[1::2] << 4)).to(torch.uint8)), scale


def unpack_int4(packed: torch.Tensor) -> torch.Tensor:
    """uint8 packed [..., in/2, out] -> int8 [..., in, out], k-major.  On a
    k-major leaf one contiguous pass: byte j of memory row n holds k = 2j
    (low nibble) and 2j+1 (high nibble).  A packed leaf carried as bf16
    (exact for 0..255), or laid out [in/2, out], is taken too."""
    if packed.dtype != torch.uint8:
        packed = packed.to(torch.uint8)
    pt = packed.transpose(-1, -2)  # [..., out, in/2]
    lo = (pt & 0xF).to(torch.int8) - 8
    hi = (pt >> 4).to(torch.int8) - 8
    shape = pt.shape[:-1] + (pt.shape[-1] * 2,)
    return torch.stack([lo, hi], dim=-1).reshape(shape).transpose(-1, -2)


def _quantize_stacked(w: torch.Tensor, bits: int, smooth=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """[L, in, out] -> (int8 [L, in, out], or uint8 packed [L, in/2, out]
    for int4, k-major; scales [L, out]), one layer at a time so the f32
    temporaries stay one layer wide.  With `smooth` [L, in], layer i is
    quantized smooth-folded: f32(w[i]) * smooth[i][:, None]."""
    L, k, n = w.shape
    if bits == 8:
        q = torch.empty((L, n, k), dtype=torch.int8, device=w.device).transpose(1, 2)
        one = quantize_int8
    else:
        q = torch.empty((L, n, k // 2), dtype=torch.uint8, device=w.device).transpose(1, 2)
        one = quantize_int4
    s = torch.empty((L, n), dtype=torch.float32, device=w.device)
    for i in range(L):
        q[i], s[i] = one(w[i] if smooth is None else w[i].float() * smooth[i].float()[:, None])
    return q, s


class TreeSink:
    """Collects a DiT tree leaf by leaf (`models.dit.model.init_dit_params`,
    `checkpoint.loader.convert_dit_state`, `_quantize_params`): the one
    place of the quantization policy.  With `quant_bits` (8 or 4) each
    quantizable stacked linear is quantized as it arrives, smooth-folded
    where it carries `act_smooth` (kept in the tree), and with `keep_edge`
    its layers 0 and L-1 keep their bf16 weights, unfolded, in
    `blocks_edge/{first,last}`; every other leaf is kept as it is.  So the
    full bf16 tree is never alive beside the quantized one.  `_put` keeps a
    leaf whole; `parallel.mesh.ShardSink` keeps a rank's slice of it."""

    def __init__(self, quant_bits: int = 0, keep_edge: bool = True):
        self.quant_bits, self.keep_edge = quant_bits, keep_edge
        self.flat: dict = {}

    def _put(self, path: str, full: torch.Tensor) -> None:
        self.flat[path] = full

    def leaf(self, path: str, full: torch.Tensor) -> None:
        """Keep a leaf that is not a stacked linear's weight."""
        self._put(path, full)

    def linear(self, path: str, weight: torch.Tensor, smooth=None) -> None:
        """A linear's stacked weight [L, in, out] at `path` (its node, as
        "blocks/mlp/linear_fc1"), with its `act_smooth` [L, in] if any."""
        if smooth is not None:
            self._put(path + "/act_smooth", smooth)
        if not self.quant_bits or not any((path + "/weight").endswith(sfx) for sfx in QUANTIZABLE_SUFFIXES):
            self._put(path + "/weight", weight)
            return
        q, s = _quantize_stacked(weight, self.quant_bits, smooth)
        self._put(path + ("/weight_q" if self.quant_bits == 8 else "/weight_q4"), q)
        self._put(path + "/weight_scale", s)
        del q, s
        if self.keep_edge:
            rel = path.split("/", 1)[1]
            # copies: a view would keep the whole stacked weight alive
            self._put(f"blocks_edge/first/{rel}/weight", weight[0].clone())
            self._put(f"blocks_edge/last/{rel}/weight", weight[-1].clone())

    def tree(self) -> dict:
        return nest(self.flat)


def _quantize_params(params: dict, bits: int, keep_edge_bf16: bool) -> dict:
    """The quantized tree of a full one (`TreeSink`'s policy): every leaf
    that is not quantized is shared with `params`."""
    flat = dict(tree_leaves(params))
    sink = TreeSink(bits, keep_edge_bf16)
    for path, leaf in flat.items():
        node, _, name = path.rpartition("/")
        w = flat.get(node + "/weight")
        if name == "weight" and leaf.ndim == 3:
            sink.linear(node, leaf, flat.get(node + "/act_smooth"))
        elif not (name == "act_smooth" and w is not None and w.ndim == 3):  # else it went with its linear
            sink.leaf(path, leaf)
    return sink.tree()


def quantize_params_int8(params: dict) -> dict:
    """Quantize the big DiT linears to int8 + per-channel scales, as a new
    tree.  Layers 0 and L-1 keep their bf16 weights in `blocks_edge` (the
    reference's full-bf16 first/last layers; the model routes those two
    layers through them), so dropping `params` frees the bf16 stacks."""
    return _quantize_params(params, 8, keep_edge_bf16=True)


def quantize_params_int4(params: dict, keep_edge_bf16: bool = True) -> dict:
    """Nibble-packed int4 weights (w4a8): `weight_q4` uint8 [L, in/2, out]
    + `weight_scale` [L, out] per quantized linear.  `keep_edge_bf16=False`
    drops the bf16 first/last layers: the model then runs layers 0 and L-1
    with bf16 activations on the dequantized weights (K7)."""
    return _quantize_params(params, 4, keep_edge_bf16)


def act_quant_rowwise(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """[m, k] -> (int8 [m, k], f32 row scales [m]): scale amax / 127 (1 for
    an all-zero row), value round(x / scale), half to even."""
    xf = x.float()
    scale = _scale_of(xf.abs().amax(dim=1, keepdim=True))
    return torch.round(xf / scale).clamp(-127, 127).to(torch.int8), scale[:, 0]


# ---------------------------------------------------------------------------
# the quantized GEMMs: K6 (int8 x int8) and K7 (bf16 x int8)
# ---------------------------------------------------------------------------


def _check_operands(fn: str, device, operands) -> None:
    """Raise unless each (name, tensor, dtype, shape) is a contiguous tensor
    of that dtype and shape on `device`, 16-byte aligned (the kernels load
    16 bytes at a time)."""
    for name, t, dt, shape in operands:
        if (t.device != device or t.dtype != dt or tuple(t.shape) != shape or not t.is_contiguous()
                or t.data_ptr() % 16):
            raise ValueError(
                f"{fn}: {name} must be a contiguous, 16-byte aligned {dt} tensor of shape {shape} on {device}, "
                f"got {t.dtype} {tuple(t.shape)} on {t.device} (contiguous={t.is_contiguous()})"
            )


def _check_kn(fn: str, k: int, n: int) -> None:
    if k % 16 or n % 16:
        raise ValueError(f"{fn}: k ({k}) and n ({n}) must be multiples of 16")


def _check_weight(fn: str, w_q: torch.Tensor, device, k: int, n: int) -> None:
    """Raise unless `w_q` is an int8 [k, n] weight stored k-major (strides
    (1, k)), 16-byte aligned, on `device`: the layout the kernels' tensor
    cores read.  A row-major weight is refused, never copied."""
    if w_q.device != device or w_q.dtype != torch.int8 or tuple(w_q.shape) != (k, n) or w_q.data_ptr() % 16:
        raise ValueError(f"{fn}: w_q must be a 16-byte aligned int8 tensor of shape {(k, n)} on {device}, "
                         f"got {w_q.dtype} {tuple(w_q.shape)} on {w_q.device}")
    if not w_q.transpose(0, 1).is_contiguous():
        raise ValueError(f"{fn}: w_q must be stored k-major (strides (1, {k}), as quantize_int8, quantize_params_int8 "
                         f"and unpack_int4 make it), got strides {tuple(w_q.stride())}")


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
    w_q: torch.Tensor,  # [k, n] int8, k-major
    col_scale: torch.Tensor,  # [n] f32
    *,
    out_dtype=torch.bfloat16,
) -> torch.Tensor:
    """K6: bf16((x_q @ w_q)_int32 * row_scale[m] * col_scale[n]), or the
    f32 product with `out_dtype=torch.float32` (the partial sums of a
    row-parallel linear, summed across tensor-parallel ranks before the
    cast); the CUDA kernel on CUDA tensors (k and n multiples of 16, `w_q`
    k-major), the plain version on CPU tensors (any strides)."""
    if x_q.device.type == "cpu":
        return quantized_matmul_i8_reference(x_q, row_scale, w_q, col_scale, out_dtype)
    fn = "quantized_matmul_i8"
    m, k = x_q.shape
    n = w_q.shape[1]
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"{fn}: the kernel writes bf16 or f32, got out_dtype {out_dtype}")
    _check_kn(fn, k, n)
    _check_operands(fn, x_q.device, (
        ("x_q", x_q, torch.int8, (m, k)),
        ("row_scale", row_scale, torch.float32, (m,)),
        ("col_scale", col_scale, torch.float32, (n,)),
    ))
    _check_weight(fn, w_q, x_q.device, k, n)
    out = torch.empty((m, n), dtype=out_dtype, device=x_q.device)
    if m == 0:
        return out
    err = _lib.lib().magi_qmm_i8(
        x_q.data_ptr(), row_scale.data_ptr(), w_q.data_ptr(), col_scale.data_ptr(), out.data_ptr(), m, n, k,
        int(out_dtype == torch.float32), _lib.stream(x_q.device),
    )
    _lib.check(err, fn)
    quantized_matmul_i8.launches += 1
    quantized_matmul_i8.launches_f32 += out_dtype == torch.float32
    return out


quantized_matmul_i8.launches = 0
quantized_matmul_i8.launches_f32 = 0  # of `launches`, those with the f32 epilogue


def quantized_matmul_reference(x, w_q, scale, out_dtype=None):
    """Plain version of K7, the JAX package's reference: x @ (w_q * scale)
    in f32 (the scale applied to the weight, before the sum), cast to
    `out_dtype` (x's dtype by default)."""
    return (x.float() @ (w_q.float() * scale[None, :].float())).to(out_dtype or x.dtype)


def quantized_matmul(x: torch.Tensor, w_q: torch.Tensor, scale: torch.Tensor, *, out_dtype=None) -> torch.Tensor:
    """K7: bf16(sum_k x[m, k] * w_q[k, n] in f32, times scale[n]), the
    dequant GEMM of layers that run bf16 activations on int8 weights (a
    quantized tree without `blocks_edge`), or the f32 product with
    `out_dtype=torch.float32` (a row-parallel linear's partial sums, as
    K6).  The CUDA kernel on CUDA tensors (bf16 x, k and n multiples of 16,
    `w_q` k-major), which applies the scale after the sum as the Pallas
    kernel does; the plain version on CPU tensors (any strides), which
    applies it before (the two differ by about one bf16 step)."""
    if x.device.type == "cpu":
        return quantized_matmul_reference(x, w_q, scale, out_dtype)
    fn = "quantized_matmul"
    m, k = x.shape
    n = w_q.shape[1]
    out_dtype = out_dtype or torch.bfloat16
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"{fn}: the kernel writes bf16 or f32, got out_dtype {out_dtype}")
    _check_kn(fn, k, n)
    _check_operands(fn, x.device, (
        ("x", x, torch.bfloat16, (m, k)),
        ("scale", scale, torch.float32, (n,)),
    ))
    _check_weight(fn, w_q, x.device, k, n)
    out = torch.empty((m, n), dtype=out_dtype, device=x.device)
    if m == 0:
        return out
    err = _lib.lib().magi_qmm_deq(x.data_ptr(), w_q.data_ptr(), scale.data_ptr(), out.data_ptr(), m, n, k,
                                   int(out_dtype == torch.float32), _lib.stream(x.device))
    _lib.check(err, fn)
    quantized_matmul.launches += 1
    quantized_matmul.launches_f32 += out_dtype == torch.float32
    return out


quantized_matmul.launches = 0
quantized_matmul.launches_f32 = 0  # of `launches`, those with the f32 epilogue

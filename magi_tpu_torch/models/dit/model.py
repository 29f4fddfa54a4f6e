"""VideoDiT forward on one device (the port of `magi_tpu.models.dit.model`).

* Parameters are the JAX package's tree of plain dictionaries, with the
  layers stacked on a leading [num_layers] axis; a Python loop over the
  layers replaces `lax.scan`.
* The token axis packs the batch into `n_segments` equal chunks of
  `seg_len` tokens; the unconditional CFG branch is just other kv ranges.
* fp32 islands as in the JAX package: embedders, QK LayerNorms, gating
  and post norms, final LayerNorm and linear.  Dense bf16 linears are
  plain `torch.matmul` in the parameter dtype.
* Quantized execution (a tree from `ops.quant.quantize_params_int8`, or
  the nibble-packed int4 tree of `quantize_params_int4`, whose weights are
  unpacked to int8 one layer at a time per forward): middle layers
  quantize each linear group's input per row to int8 and run int8 x int8
  GEMMs; layers 0 and L-1 run bf16 through the tree's `blocks_edge` side
  tree, or, in a tree without it, bf16 activations on the dequantized
  weights.  The row quantization runs fused with its producer (the
  pre-LayerNorm, or a gated MLP's SwiGLU) in K8 / K8s
  (`ops.act_quant.rowquant_fused`), the int8 GEMMs in K6
  (`ops.quant.quantized_matmul_i8`) and the dequant GEMMs in K7
  (`ops.quant.quantized_matmul`), always: the JAX package's switches
  between its Pallas kernels and XLA (`MAGI_QMM_IMPL`,
  `MAGI_FUSED_ACT_QUANT`) are not read here.  A tree from a released fp8
  checkpoint also carries `act_smooth` on its four smooth-quant linears:
  their inputs are divided by it inside K8 / K8s, after the producer and
  before the row quantization (a plain op before K7, or at tp > 1).
* The KV cache is one [num_layers, 2, hk, tokens, hd] buffer in the
  attention kernel's layout, updated in place: a forward that writes the
  cache writes the slice of its current chunks and reads only earlier
  tokens, so reads and writes never overlap.  With int8 attention
  (`engine_config.attn_int8` or `MAGI_ATTN_INT8=1`) it is the dict
  {kv: int8 [L, 2, hk, tokens, hd], scale: f32 [L, 2, hk, tokens]}
  written by K3q (`MAGI_ATTN_INT8_STORE=0` keeps a bf16 cache that is
  quantized every forward), and attention runs K5
  (`ops.attention_q8`).
* Attention, the k-side norm+rope+pack and the gated post norms go
  through `magi_tpu_torch.ops` (CUDA kernels on the card, their plain
  versions on the CPU).
* On a model-parallel mesh (`parallel.mesh`: one process a rank) each rank
  holds its shard of the token axis between attentions and its head shard
  inside them (Ulysses' all-to-alls, `_Ulysses`); column-parallel linears
  run the dispatch above on their column block, row-parallel ones
  (linear_proj, fc2) sum f32 partials over tp (`_row_first`,
  `_row_quant`); the post norms run on the rank's rows
  (`gate_norm_residual_sharded`); under pp the layers arrive one at a
  time from their owners (`parallel.mesh.pp_gather_layer`); the final
  LayerNorm and linear run on the rank's rows, gathered after.  The same
  kernels run on the local heads and rows with the global ranges.  That
  forward runs in pieces with the collectives between them
  (`_dit_forward_mesh`), which a captured step replays as CUDA graphs.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from magi_tpu_torch.core.config import MagiConfig, ModelConfig
from magi_tpu_torch.core.dataclasses import ForwardMeta
from magi_tpu_torch.core.graphs import PLAIN
from magi_tpu_torch.core.utils import tree_leaves
from magi_tpu_torch.models.dit.embedders import (
    ada_modulate_forward,
    final_linear_forward,
    init_embedder_params,
    softcap,
    t_embedder_forward,
    y_embedder_forward,
)
from magi_tpu_torch.models.dit.rope import default_bands, rope_3d_segments
from magi_tpu_torch.ops.act_quant import rowquant_fused, smooth_divide
from magi_tpu_torch.ops.attention import (
    apply_q_prologue,
    kv_norm_rope_pack,
    segmented_attention_two_source,
    segmented_attention_v2,
)
from magi_tpu_torch.ops.attention_q8 import (
    quantize_kv_per_token,
    segmented_attention_two_source_q8,
    segmented_attention_two_source_q8_reference,
)
from magi_tpu_torch.ops.fused_norm import gate_norm_residual, gate_norm_residual_sharded
from magi_tpu_torch.ops.quant import TreeSink, _scale_of, quantized_matmul, quantized_matmul_i8, unpack_int4
from magi_tpu_torch.parallel import comm
from magi_tpu_torch.parallel import mesh as mesh_lib


def attn_int8(config: MagiConfig) -> bool:
    """int8 attention over an int8 KV cache: `engine_config.attn_int8` or
    `MAGI_ATTN_INT8=1` (the JAX package's switch)."""
    return bool(config.engine_config.attn_int8) or os.environ.get("MAGI_ATTN_INT8", "0") == "1"


def attn_int8_store(config: MagiConfig) -> bool:
    """int8 attention with the KV cache stored int8 (the default when int8
    attention is on); `MAGI_ATTN_INT8_STORE=0` keeps a bf16 cache that is
    quantized every forward.  On the CPU the two modes give the same
    numbers; on the card the store mode quantizes k from its f32 normed row
    (K3q) and the other from the bf16 cache, so k may differ by one int8
    step."""
    return attn_int8(config) and os.environ.get("MAGI_ATTN_INT8_STORE", "1") == "1"


def layer_norm(x, params, eps: float, zero_centered: bool = False):
    """LayerNorm with optional zero-centered gamma; statistics in fp32,
    output in x's dtype."""
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    var = (xf - mean).square().mean(-1, keepdim=True)
    xn = (xf - mean) * torch.rsqrt(var + eps)
    w = params["weight"].float()
    if zero_centered:
        w = w + 1.0
    return (xn * w + params["bias"].float()).to(x.dtype)


def _dot(x, w, high_precision: bool = False):
    """Matmul in the parameter dtype (fp32 accumulation on the card), or
    in exact fp32 for the high-precision islands."""
    if high_precision:
        return x.float() @ w.float()
    return x @ w


def _dot_f32(x, w):
    """x @ w kept in f32: a bf16 product accumulated in f32 and not rounded
    (cuBLAS writes the f32 sum on the card), as the JAX package's dot with
    preferred_element_type=f32; fp32 operands as `_dot`'s high precision."""
    if x.dtype == torch.bfloat16 and x.is_cuda:
        return torch.mm(x, w, out_dtype=torch.float32)
    return x.float() @ w.float()


def _apply_pre(x, pre, eps):
    """The unfused producer of a linear group's input: None, ("ln", params)
    a shared pre-LayerNorm, or ("swiglu",) on a gated fc1 output."""
    if pre is None:
        return x
    if pre[0] == "ln":
        return layer_norm(x, pre[1], eps)
    d = x.shape[-1] // 2
    return F.silu(x[..., :d].float()).to(x.dtype) * x[..., d:]


def _unpacked(plist):
    """The linears with packed int4 `weight_q4` unpacked to int8 `weight_q`."""
    if "weight_q4" not in plist[0]:
        return plist
    return [{**{k: v for k, v in pp.items() if k != "weight_q4"}, "weight_q": unpack_int4(pp["weight_q4"])}
            for pp in plist]


def _linears_shared(x, plist, act_ok: bool, high_precision: bool = False, pre=None, eps: float = 1e-6):
    """Several linears on one shared input, the single dispatch of every
    DiT linear (the JAX package's single-device branches): bf16 `weight`,
    int8 `weight_q` + per-channel `weight_scale`, or packed int4
    `weight_q4` + `weight_scale`, unpacked to int8 here.  With int8
    weights and `act_ok` the input is quantized once per row for the whole
    group and each linear is an int8 x int8 GEMM (K6); without `act_ok` (a
    quantized tree without `blocks_edge`, edge layers) each is the bf16 x
    int8 dequant GEMM (K7).  `pre` is the group input's producer (see
    `_apply_pre`); the int8 branch runs it fused with the row quantization
    (K8, or K8s for SwiGLU), the dequant branch unfused.  A smooth-quant
    linear (`act_smooth` s, its weight quantized s·W) divides its input by
    s after the producer: in the int8 branch inside the same K8 or K8s
    launch (`smooth=`), so a smoothed fc1 takes K8 `ln` and a smoothed
    gated fc2 K8s; in the dequant branch as a plain op (`smooth_divide`)
    before K7.  The kernels run on CUDA tensors, their plain versions on
    CPU tensors.

    On a model-parallel mesh the column-parallel linears (q, qx, k, v,
    linear_kv_xattn, fc1) hold a block of output columns and run this
    dispatch on it unchanged; the row-parallel ones (linear_proj, fc2) run
    it too at tp 1, and at tp > 1 `_row_first` and `_row_quant` with
    all-reduces between them."""
    plist = _unpacked(plist)
    if "weight_q" not in plist[0]:
        x = _apply_pre(x, pre, eps)
        return tuple(_dot(x, pp["weight"], high_precision) for pp in plist)
    # smooth-quant (fp8 checkpoints): the weight is quantized s·W, so the
    # input divides by s, after its producer and before the row quantization
    smooth = plist[0].get("act_smooth")
    if smooth is not None and len(plist) != 1:
        raise ValueError("smooth-quant linears are groups of one")
    if not act_ok:
        x = _apply_pre(x, pre, eps)
        if smooth is not None:
            x = smooth_divide(x, smooth)
        return tuple(quantized_matmul(x, pp["weight_q"], pp["weight_scale"]).to(x.dtype) for pp in plist)

    mode = "plain" if pre is None else pre[0]
    lnp = pre[1] if mode == "ln" else None
    xq, rs = rowquant_fused(
        x, mode, None if lnp is None else lnp["weight"], None if lnp is None else lnp["bias"], eps=eps, smooth=smooth
    )
    return tuple(quantized_matmul_i8(xq, rs, pp["weight_q"], pp["weight_scale"], out_dtype=x.dtype) for pp in plist)


def _row_dtype(p: dict, high_precision: bool, dtype: torch.dtype) -> torch.dtype:
    """The dtype a row-parallel linear's summed output is cast to: f32 for a
    bf16 weight under high precision, else the input's."""
    return torch.float32 if high_precision and "weight_q" not in p and "weight_q4" not in p else dtype


def _row_first(x, p: dict, act_ok: bool, pre, eps: float) -> tuple:
    """A row-parallel linear at tp > 1 (the JAX package's `inner_row`) up to
    its first all-reduce: x holds the rank's block of input features (its
    producer, SwiGLU for a gated fc2, runs on it unfused, and a smooth-quant
    input divides by its slice of `act_smooth`), the weight the matching
    rows.  Returns (the f32 partial product,), never rounded to bf16
    (cuBLAS, K6 or K7 write f32), to be summed over tp; with int8
    activations (xf, its rows' |max|), the maximum to be all-reduced over
    tp before `_row_quant`."""
    (p,) = _unpacked([p])
    x = _apply_pre(x, pre, eps)
    if "weight_q" not in p:
        return (_dot_f32(x, p["weight"]),)
    if "act_smooth" in p:
        x = smooth_divide(x, p["act_smooth"])
    if not act_ok:
        return (quantized_matmul(x, p["weight_q"], p["weight_scale"], out_dtype=torch.float32),)
    xf = x.float()
    return xf, xf.abs().amax(dim=1)


def _row_quant(xf, amax, p: dict) -> torch.Tensor:
    """The int8 branch's partial product: x quantized per row against the
    row's global maximum `amax` in plain ops, then K6 with f32 out."""
    (p,) = _unpacked([p])
    scale = _scale_of(amax)
    xq = torch.round(xf / scale[:, None]).clamp(-127, 127).to(torch.int8)
    return quantized_matmul_i8(xq, scale, p["weight_q"], p["weight_scale"], out_dtype=torch.float32)


def _merge_edge(blk: dict, edge: dict) -> dict:
    """A quantized layer tree with each {weight_q, weight_scale} node
    replaced by the bf16 {weight} of the `blocks_edge` side tree; a
    smooth-quant node's `act_smooth` goes with it (the edge layers'
    weights are unfolded)."""
    out = {}
    for k, v in blk.items():
        if isinstance(v, dict):
            if "weight_q" in v or "weight_q4" in v:
                out[k] = {"weight": edge[k]["weight"]}
            else:
                out[k] = _merge_edge(v, edge.get(k, {}))
        else:
            out[k] = v
    return out


def _bias_modulate_add(x, residual, gate, post_norm_params, eps, zero_centered, n_seg, seg_len=None):
    """fp32(gate[seg] * x) -> post norm -> + residual, in one kernel pass; on
    a model-parallel mesh over the rank's rows of the token axis (K4 with
    the gate rows of the segments they touch, `gate_norm_residual_sharded`)."""
    if not mesh_lib.model_parallel_trivial():
        sh = mesh_lib.token_shard(n_seg * seg_len)
        return gate_norm_residual_sharded(
            x, residual, gate.contiguous(), post_norm_params["weight"], post_norm_params["bias"], eps=eps,
            zero_centered=zero_centered, n_seg=n_seg, seg_len=seg_len, row_start=sh.start,
        )
    return gate_norm_residual(
        x, residual, gate.contiguous(), post_norm_params["weight"], post_norm_params["bias"],
        eps=eps, zero_centered=zero_centered, n_seg=n_seg,
    )


def _q8_attention(q, kv1, kv2, r1s, r1e, r2s, r2e, *, seg_len, q_pro):
    """int8 two-source attention; each source is an {kv, scale} dict or a
    bf16 [2, hk, tok, hd] tensor quantized per token here.  K5 with the
    fused q prologue on the card; on the CPU the JAX package's CPU path
    (q normed and roped first, the dequant reference)."""
    kv1_8, sc1 = (kv1["kv"], kv1["scale"]) if isinstance(kv1, dict) else quantize_kv_per_token(kv1)
    kv2_8, sc2 = (kv2["kv"], kv2["scale"]) if isinstance(kv2, dict) else quantize_kv_per_token(kv2)
    if q.device.type == "cuda":
        return segmented_attention_two_source_q8(
            q, kv1_8, sc1, kv2_8, sc2, r1s, r1e, r2s, r2e, seg_len=seg_len, q_prologue=q_pro
        )
    return segmented_attention_two_source_q8_reference(
        apply_q_prologue(q, q_pro), kv1_8, sc1, kv2_8, sc2, r1s, r1e, r2s, r2e, seg_len=seg_len
    )


def _qkv(p: dict, x, act_quant_ok: bool, eps: float):
    """q, qx, k, v of x's rows: q/qx/k/v share the pre-LN output, so one row
    quantization covers all four."""
    lq = p["linear_qkv"]
    return _linears_shared(x, [lq["q"], lq["qx"], lq["k"], lq["v"]], act_quant_ok, pre=("ln", lq["layer_norm"]),
                           eps=eps)


def _self_attention(p: dict, cfg: ModelConfig, q, k, v, sin, cos, cache_l, meta: ForwardMeta, int8_attn: bool,
                    int8_store: bool, dtype: torch.dtype):
    """Self-attention over the cache and the current window: q, k, v [S, ·,
    hd] (every token, the heads this device runs) -> [S, heads, hd]."""
    S = meta.n_segments * meta.seg_len
    hd = cfg.kv_channels
    eps = cfg.layernorm_epsilon
    one = 1.0 if cfg.apply_layernorm_1p else 0.0
    ctn = meta.seg_len
    device = q.device

    # q-side fp32 QK-norm + rope run in the attention kernel's prologue
    q_pro = (p["q_layernorm"]["weight"].float() + one, p["q_layernorm"]["bias"].float(), sin, cos, eps)
    q = q.reshape(S, -1, hd)

    # k side: fp32 norm + rope + cast, packed into the cache layout (on the
    # card with an int8-stored cache, quantized per token in the same pass)
    kw = (p["k_layernorm"]["weight"].float() + one).contiguous()
    kb = p["k_layernorm"]["bias"].float().contiguous()
    k, v = k.reshape(S, -1, hd), v.reshape(S, -1, hd)
    if device.type == "cuda" and int8_store:
        kv8, sc = kv_norm_rope_pack(k, v, kw, kb, sin, cos, eps=eps, quantize=True)
        kv = {"kv": kv8, "scale": sc}
    else:
        kv = kv_norm_rope_pack(k, v, kw, kb, sin, cos, eps=eps, out_dtype=dtype)

    gs = meta.self_attn.kv_start
    ge = meta.self_attn.kv_end
    if meta.use_kv_cache:
        # The global ranges span cache tokens [0, start_tok) followed by the
        # current window; split them per source so the cache stays a
        # read-only buffer for the attention.  start_tok is a device scalar:
        # the write is an indexed copy at it and the split clamps against it
        # (the caller keeps the write inside the cache).
        start_tok = meta.slice_point * ctn
        if meta.update_kv_cache:
            # the distill ride-along chunk is not written
            clip = S - ctn if meta.distill_nearly_clean_chunk else S
            idx = start_tok.long() + torch.arange(clip, device=device)
            if isinstance(cache_l, dict):
                # int8-stored cache: only the written slice is quantized
                if isinstance(kv, dict):
                    kv8_w, sc_w = kv["kv"][:, :, :clip], kv["scale"][:, :, :clip]
                else:
                    kv8_w, sc_w = quantize_kv_per_token(kv[:, :, :clip])
                cache_l["kv"].index_copy_(2, idx, kv8_w)
                cache_l["scale"].index_copy_(2, idx, sc_w)
            else:
                cache_l.index_copy_(2, idx, kv[:, :, :clip].to(cache_l.dtype))
        r1s = torch.minimum(gs, start_tok)
        r1e = torch.minimum(ge, start_tok)
        r2s = torch.clamp(gs - start_tok, min=0)
        r2e = torch.clamp(ge - start_tok, min=0)
        cache_in = cache_l if isinstance(cache_l, dict) else cache_l.to(dtype)
        if int8_attn:
            return _q8_attention(q, cache_in, kv, r1s, r1e, r2s, r2e, seg_len=ctn, q_pro=q_pro)
        return segmented_attention_two_source(q, cache_in, kv, r1s, r1e, r2s, r2e, seg_len=ctn, q_prologue=q_pro)
    # no-cache forwards (the uncond CFG branch): the same two-source kernel
    # with an empty first source
    z = torch.zeros_like(gs)
    if isinstance(kv, dict):
        empty = {"kv": kv["kv"][:, :, :0], "scale": kv["scale"][:, :, :0]}
    else:
        empty = torch.zeros((2, kv.shape[1], 0, hd), dtype=kv.dtype, device=kv.device)
    if int8_attn:
        return _q8_attention(q, empty, kv, z, z, gs, ge, seg_len=ctn, q_pro=q_pro)
    return segmented_attention_two_source(q, empty, kv, z, z, gs, ge, seg_len=ctn, q_prologue=q_pro)


def _caption_kv(p: dict, y_xattn, dtype: torch.dtype, act_quant_ok: bool, hd: int):
    """The captions' kv [n_seg * L, heads, 2 * hd] (linear_kv_xattn on every
    caption token: column-parallel on a mesh, the rank's tp block)."""
    n_seg, L = y_xattn.shape[:2]
    (kv_x,) = _linears_shared(y_xattn.reshape(n_seg * L, -1).to(dtype), [p["linear_kv_xattn"]], act_quant_ok)
    return kv_x.reshape(n_seg * L, -1, 2 * hd)


def _cross_attention(p: dict, cfg: ModelConfig, qx, kv_x, meta: ForwardMeta, int8_attn: bool, dtype: torch.dtype):
    """Caption cross-attention with a norm-only q prologue and no rope: qx
    [S, heads, hd], kv_x [n_seg * L, heads, 2 * hd] -> [S, heads, hd]."""
    S = meta.n_segments * meta.seg_len
    hd = cfg.kv_channels
    eps = cfg.layernorm_epsilon
    one = 1.0 if cfg.apply_layernorm_1p else 0.0
    n_seg, ctn = meta.n_segments, meta.seg_len
    device = qx.device
    qx_pro = (
        p["q_layernorm_xattn"]["weight"].float() + one, p["q_layernorm_xattn"]["bias"].float(), None, None, eps
    )
    qx = qx.reshape(S, -1, hd)
    L = kv_x.shape[0] // n_seg
    k_x = layer_norm(kv_x[..., :hd], p["k_layernorm_xattn"], eps, cfg.apply_layernorm_1p).contiguous()
    v_x = kv_x[..., hd:]  # a view: the caption kernel loads it with TMA
    x_starts = torch.arange(n_seg, dtype=torch.int32, device=device) * L
    x_ends = x_starts + meta.y_lens.to(device=device, dtype=torch.int32)
    if int8_attn and (hd % 128 == 0 or device.type != "cuda"):
        # int8 cross-attention: the caption kv is source 1 of the int8
        # two-source kernel, source 2 is empty
        kv_cap = torch.stack([k_x.transpose(0, 1), v_x.transpose(0, 1)])
        kv8, sc = quantize_kv_per_token(kv_cap.to(dtype))
        empty = {"kv": kv8[:, :, :0], "scale": sc[:, :, :0]}
        z = torch.zeros_like(x_starts)
        return _q8_attention(qx, {"kv": kv8, "scale": sc}, empty, x_starts, x_ends, z, z, seg_len=ctn, q_pro=qx_pro)
    return segmented_attention_v2(qx, k_x, v_x, x_starts, x_ends, seg_len=ctn, q_prologue=qx_pro)


def attention_forward(
    p: dict,
    cfg: ModelConfig,
    x: torch.Tensor,  # [S, D]
    y_xattn: torch.Tensor,  # [n_seg, L, xattn_hidden] fp32
    sin: torch.Tensor,
    cos: torch.Tensor,
    cache_l,  # [2, hk, max_tok, hd] or the int8 {kv, scale} dict; updated in place
    meta: ForwardMeta,
    act_quant_ok: bool = False,
    int8_attn: bool = False,
    int8_store: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Self-attention (cache + current window) and caption cross-attention
    on one device.  Returns (core_attn_out [S, hq*hd], xattn_out [S,
    hq*hd]).  `int8_attn` runs both through int8 attention; `int8_store`
    (the cache is the int8 dict) packs the current kv to int8 with K3q on
    the card.  A model-parallel mesh runs the same parts in the pieces of
    `_mesh_layer`."""
    S = meta.n_segments * meta.seg_len
    q, qx, k, v = _qkv(p, x, act_quant_ok, cfg.layernorm_epsilon)
    core = _self_attention(p, cfg, q, k, v, sin, cos, cache_l, meta, int8_attn, int8_store, x.dtype)
    kv_x = _caption_kv(p, y_xattn, x.dtype, act_quant_ok, cfg.kv_channels)
    xattn = _cross_attention(p, cfg, qx, kv_x, meta, int8_attn, x.dtype)
    return core.reshape(S, -1), xattn.reshape(S, -1)


def _layer_tail(p: dict, cfg: ModelConfig, attn_out, x, condition, meta: ForwardMeta, act_quant_ok: bool,
                high_precision: bool):
    """A layer after its attentions (attn_out = [core | xattn]): linear_proj,
    the gated post norm + residual, the MLP and its post norm."""
    eps = cfg.layernorm_epsilon
    zc = cfg.apply_layernorm_1p
    (attn_out,) = _linears_shared(attn_out, [p["self_attention"]["linear_proj"]], act_quant_ok,
                                  high_precision=high_precision)
    attn_out = attn_out.to(x.dtype)

    gate = softcap(ada_modulate_forward(p["ada_modulate_layer"], condition), 1.0)
    gate_msa, gate_mlp = gate.chunk(2, dim=-1)
    x = _bias_modulate_add(attn_out, x, gate_msa, p["self_attn_post_norm"], eps, zc, meta.n_segments, meta.seg_len)

    residual = x
    # the LayerNorm (and SwiGLU) ride into their consumer linears as `pre`
    (h,) = _linears_shared(x, [p["mlp"]["linear_fc1"]], act_quant_ok, pre=("ln", p["mlp"]["layer_norm"]), eps=eps)
    if cfg.gated_linear_unit:
        (h,) = _linears_shared(h, [p["mlp"]["linear_fc2"]], act_quant_ok, pre=("swiglu",), eps=eps)
    else:
        h = F.gelu(h, approximate="none")
        (h,) = _linears_shared(h, [p["mlp"]["linear_fc2"]], act_quant_ok)
    return _bias_modulate_add(h, residual, gate_mlp, p["mlp_post_norm"], eps, zc, meta.n_segments, meta.seg_len)


def layer_forward(
    p: dict,
    cfg: ModelConfig,
    x: torch.Tensor,  # [S, D]
    condition: torch.Tensor,  # [n_seg, cond_hidden] fp32
    y_xattn: torch.Tensor,
    sin: torch.Tensor,
    cos: torch.Tensor,
    cache_l,
    meta: ForwardMeta,
    high_precision: bool = False,
    act_quant_ok: bool = False,
    int8_attn: bool = False,
    int8_store: bool = False,
) -> torch.Tensor:
    """One parallel-attention transformer layer on one device (a
    model-parallel mesh runs `_mesh_layer`)."""
    if not mesh_lib.model_parallel_trivial():
        raise RuntimeError("on a model-parallel mesh a layer runs in the pieces of dit_forward (_mesh_layer)")
    core, xattn = attention_forward(p["self_attention"], cfg, x, y_xattn, sin, cos, cache_l, meta, act_quant_ok,
                                    int8_attn, int8_store)
    return _layer_tail(p, cfg, torch.cat([core, xattn], dim=-1), x, condition, meta, act_quant_ok, high_precision)


def patchify(x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """[C, T, H, W] -> [T'*H'*W', C*tp*p*p]: the Conv3d stride=kernel patch
    embed, tokens in (t, h, w) order, features in (C, tp, ph, pw) order."""
    C, T, H, W = x.shape
    tp, p = cfg.t_patch_size, cfg.patch_size
    x = x.reshape(C, T // tp, tp, H // p, p, W // p, p).permute(1, 3, 5, 0, 2, 4, 6)
    return x.reshape((T // tp) * (H // p) * (W // p), C * tp * p * p)


def unpatchify(x: torch.Tensor, cfg: ModelConfig, T_patch: int, H: int, W: int) -> torch.Tensor:
    """[S, tp*p*p*C_out] -> [C_out, T, H*p, W*p], features in (pT pH pW C) order."""
    tp, p = cfg.t_patch_size, cfg.patch_size
    C = cfg.out_channels
    x = x.reshape(T_patch, H, W, tp, p, p, C).permute(6, 0, 3, 1, 4, 2, 5)
    return x.reshape(C, T_patch * tp, H * p, W * p)


def dit_prologue(params: dict, config: MagiConfig, x, t, y, caption_dropout, meta: ForwardMeta, t_offsets,
                 distill_factor=None):
    """Embedding stage in fp32.  Returns (h [S, D], condition, y_xattn, sin,
    cos).  A distilled model (`engine_config.distill`) adds the timestep
    embedding of its step size `distill_factor` (a float, or an f32 device
    scalar) to the condition."""
    mc = config.model_config
    x = x.float() * mc.x_rescale_factor
    if mc.half_channel_vae:
        x = torch.cat([x, x], dim=0)
    C, T, H, W = x.shape
    Hp, Wp = H // mc.patch_size, W // mc.patch_size
    Tp = T // mc.t_patch_size
    tokens = patchify(x, mc) @ params["x_embedder"]["weight"].float()

    sin, cos = rope_3d_segments(params["rope"]["bands"], t_offsets, Tp // meta.n_segments, Hp, Wp)
    t_emb = t_embedder_forward(params["t_embedder"], t)
    if config.engine_config.distill:
        if distill_factor is None:
            raise ValueError("a distill model's forward needs distill_factor")
        dt = torch.as_tensor(distill_factor, dtype=torch.float32, device=t.device).expand(t.shape)
        t_emb = t_emb + t_embedder_forward(params["t_embedder"], dt)
    y_xattn, y_adaln = y_embedder_forward(params["y_embedder"], y, caption_dropout)
    if y_adaln.ndim == 1:
        y_adaln = y_adaln[None, :]
    condition = (t_emb + y_adaln).float()
    return tokens.to(mc.params_dtype), condition, y_xattn, sin, cos


def _final_tokens(params: dict, config: MagiConfig, h):
    """Final LayerNorm + fp32 final linear: [S, D] -> [S, tp*p*p*C_out]."""
    mc = config.model_config
    h = layer_norm(h.float(), params["final_layernorm"], mc.layernorm_epsilon, mc.apply_layernorm_1p)
    return final_linear_forward(params["final_linear"], h)


def _unpatchify_out(config: MagiConfig, tokens, Tp: int, Hp: int, Wp: int):
    mc = config.model_config
    out = unpatchify(tokens, mc, Tp, Hp, Wp)
    if mc.half_channel_vae:
        out = out[: mc.out_channels // 2]
    return out / mc.x_rescale_factor


def dit_epilogue(params: dict, config: MagiConfig, h, Tp: int, Hp: int, Wp: int):
    """Final LayerNorm + fp32 final linear + unpatchify."""
    return _unpatchify_out(config, _final_tokens(params, config, h), Tp, Hp, Wp)


def layer_params(blocks: dict, idx: int) -> dict:
    """Layer `idx` of the stacked block tree (views, no copy)."""
    return {k: layer_params(v, idx) if isinstance(v, dict) else v[idx] for k, v in blocks.items()}


def _routed(blk: dict, edge, config: MagiConfig, idx: int) -> Tuple[dict, bool]:
    """Layer `idx`'s tree and whether it quantizes its activations, under
    the quantized tree's routing: middle layers run int8 (or int4) weights
    and int8 activations; layers 0 and L-1 run bf16 through the
    `blocks_edge` side tree (the reference's first/last-layer policy).  A
    quantized tree without `blocks_edge` runs its edge layers with bf16
    activations on the int8 weights (the dequant GEMM, K7).  bf16 trees
    ignore the routing."""
    L = config.model_config.num_layers
    if edge is None:
        return blk, 0 < idx < L - 1
    if idx in (0, L - 1):
        return _merge_edge(blk, edge["first"] if idx == 0 else edge["last"]), False
    return blk, True


def _apply_layer_routed(blk, edge, config: MagiConfig, idx: int, *args, **kwargs):
    """Layer `idx` with the quantized tree's routing (`_routed`)."""
    tree, act_ok = _routed(blk, edge, config, idx)
    return layer_forward(tree, config.model_config, *args, act_quant_ok=act_ok, **kwargs)


def dit_forward(
    params: dict,
    config: MagiConfig,
    x: torch.Tensor,  # [C, T, H, W] latent
    t: torch.Tensor,  # [n_seg] timesteps
    y: torch.Tensor,  # [n_seg, L, caption_channels]
    caption_dropout,  # bool, or bool [n_seg]
    kv_cache,  # [num_layers, 2, hk, max_tok, hd] or the int8 dict; None when unused
    meta: ForwardMeta,
    t_offsets: torch.Tensor,  # int [n_seg] temporal patch-grid offsets
    distill_factor=None,  # float or f32 device scalar (distill models)
    run=None,
    tag: str = "",
):
    """Full DiT forward.  Returns (velocity [C_out, T, H, W], kv_cache); a
    forward with `meta.update_kv_cache` has written its slice of the cache
    in place.  On a model-parallel mesh `params` and `kv_cache` are the
    rank's shards, the velocity comes back whole on every rank, and the
    forward runs in `run`'s pieces with its collectives between them
    (`_dit_forward_mesh`; `tag` names its output piece, one per forward of
    a step); on one device `run` is not read (the caller's piece holds the
    whole forward)."""
    if meta.use_kv_cache and kv_cache is None:
        raise ValueError("a forward that reads the KV cache needs one")
    if meta.use_kv_cache and isinstance(kv_cache, dict) != attn_int8_store(config):
        raise ValueError("the KV cache's form (int8 dict or bf16 tensor) does not match the int8 attention switches")
    if not mesh_lib.model_parallel_trivial():
        return _dit_forward_mesh(PLAIN if run is None else run, params, config, x, t, y, caption_dropout, kv_cache,
                                 meta, t_offsets, distill_factor, tag), kv_cache
    mc = config.model_config
    C, T, H, W = x.shape
    Hp, Wp = H // mc.patch_size, W // mc.patch_size
    Tp = T // mc.t_patch_size
    h, condition, y_xattn, sin, cos = dit_prologue(
        params, config, x, t, y, caption_dropout, meta, t_offsets, distill_factor
    )
    for idx in range(mc.num_layers):
        h = dit_layer_step(params, config, idx, h, _cache_layer(kv_cache, idx, meta), condition, y_xattn, sin, cos,
                           meta)
    return dit_epilogue(params, config, h, Tp, Hp, Wp), kv_cache


def _cache_layer(kv_cache, idx: int, meta: ForwardMeta):
    """Layer idx's slab of the cache (views; None for a forward without it)."""
    if not meta.use_kv_cache:
        return None
    if isinstance(kv_cache, dict):
        return {"kv": kv_cache["kv"][idx], "scale": kv_cache["scale"][idx]}
    return kv_cache[idx]


def dit_layer_step(params: dict, config: MagiConfig, idx: int, h: torch.Tensor, cache_l, condition, y_xattn, sin,
                   cos, meta: ForwardMeta, blk: Optional[dict] = None) -> torch.Tensor:
    """Layer `idx` of the stacked tree (edge routing included) on `cache_l`,
    that layer's cache slab ([2, hk, tokens, hd], or the int8 {kv, scale}
    dict; any strides the kernels take; None for a forward without the
    cache), which a forward with `meta.update_kv_cache` writes in place.
    The unit of the host-streamed KV cache (`sampling.transport.HostKVCache`),
    and the body of `dit_forward`'s layer loop on one device.  `blk` is the
    layer's tree when the caller has it."""
    return _apply_layer_routed(
        layer_params(params["blocks"], idx) if blk is None else blk, params.get("blocks_edge"), config, idx, h, condition, y_xattn, sin, cos,
        cache_l, meta, high_precision=config.engine_config.high_precision_matmul, int8_attn=attn_int8(config),
        int8_store=attn_int8_store(config),
    )


# ---------------------------------------------------------------------------
# the model-parallel forward, in pieces
# ---------------------------------------------------------------------------
#
# On a model-parallel mesh a forward is a chain of `run.piece`s (`core.graphs`:
# on the card each a CUDA graph of a captured step) with the collectives
# between them: prologue, per layer attn_in | a2a | attn | a2a | tail (tp 1)
# or proj_in [| max | proj_q] | sum | mlp_in [| max | mlp_q] | sum | mlp_out
# (tp > 1), with pp's layer broadcast issued before each layer, then final |
# all_gather | out_<tag>.  A collective writes into a slot (`run.slot`) that
# the next piece reads, or works in place on a piece's output; while a step
# is captured the collectives are skipped (`run.copies_live`).  Between two
# pieces only host arithmetic, views and collectives run.  Every piece
# returns new contiguous tensors, so the eager walk (`PLAIN`) and the
# replayed one feed each kernel the same layouts.


@dataclasses.dataclass(frozen=True)
class _Ulysses:
    """The host-side layout of a forward's all-to-alls on this rank: per
    member of the head group (group order) its head shard, token shard and
    tp index; this rank's tp index `t`, head shard `k_me` and token shard
    `sq`; the seq shard count `n`; the token shard's rows; the head counts
    this rank sends of each tensor (`fwd`: q, qx, k, v; `back`: core,
    xattn); and the caption kv's exchange over tp (`cap_tp_of`: the tp
    group's members' tp indices, empty when every shard of the tp group
    lies in its own block)."""

    heads_of: tuple
    seq_of: tuple
    tp_of: tuple
    t: int
    k_me: int
    sq: int
    n: int
    tp: int
    rows: int
    S: int
    hd: int
    rep: int
    fwd: tuple
    back: tuple
    cap_tokens: int
    cap_heads: int
    cap_tp_of: tuple

    @staticmethod
    def of(mesh, mc: ModelConfig, sh, cap_tokens: int) -> "_Ulysses":
        g = mesh.group("head")
        n, tp = mesh_lib.seq_shards(mesh), mesh.shape[mesh_lib.AXIS_TP]
        hq, hk = mc.num_attention_heads, mc.num_query_groups
        rep = mesh_lib.kv_replication(hq, hk, mesh)
        N = n * tp
        t, sq = mesh.coords()[mesh_lib.AXIS_TP], mesh.seq_index()
        cap_tp_of = ()
        if not all((sq * tp + tt) // n == tt for tt in range(tp)):
            cap_tp_of = tuple(mesh.coords(r)[mesh_lib.AXIS_TP] for r in mesh.group("tp").ranks)
        return _Ulysses(heads_of=tuple(mesh.head_index(r) for r in g.ranks),
                        seq_of=tuple(mesh.seq_index(r) for r in g.ranks),
                        tp_of=tuple(mesh.coords(r)[mesh_lib.AXIS_TP] for r in g.ranks), t=t,
                        k_me=mesh.head_index(), sq=sq, n=n, tp=tp, rows=sh.rows, S=sh.S, hd=mc.kv_channels, rep=rep,
                        fwd=(hq // N, hq // N, hk * rep // N, hk * rep // N), back=(hq // N, hq // N),
                        cap_tokens=cap_tokens, cap_heads=hk * rep // N, cap_tp_of=cap_tp_of)

    def fwd_splits(self) -> Tuple[list, list]:
        """(in, out) element counts of the tokens -> heads all-to-all: a
        rank sends the shards of its tp block their heads of its rows, and
        gets its shard's heads from the n ranks of the block holding it."""
        per = self.rows * sum(self.fwd) * self.hd
        return ([per if k // self.n == self.t else 0 for k in self.heads_of],
                [per if tt == self.k_me // self.n else 0 for tt in self.tp_of])

    def back_splits(self) -> Tuple[list, list]:
        per = self.rows * sum(self.back) * self.hd
        return ([per if tt == self.k_me // self.n else 0 for tt in self.tp_of],
                [per if k // self.n == self.t else 0 for k in self.heads_of])

    def cap_splits(self) -> Tuple[list, list]:
        per = self.cap_tokens * self.cap_heads * 2 * self.hd
        ks = [self.sq * self.tp + tt for tt in self.cap_tp_of]
        return ([per if k // self.n == self.t else 0 for k in ks],
                [per if tt == self.k_me // self.n else 0 for tt in self.cap_tp_of])


def _pack(pieces, like):
    """The pieces (None: nothing for that member) as one flat send buffer."""
    send = [p.reshape(-1) for p in pieces if p is not None]
    return torch.cat(send) if send else like.new_empty(0)


def _unpack(recv, sizes):
    """What came from each member (None where nothing did)."""
    parts = iter(recv.split([n for n in sizes if n]))
    return [next(parts) if n else None for n in sizes]


def _to_heads_send(ts, u: _Ulysses):
    """Ulysses' tokens -> heads send buffer, several tensors in one: each of
    `ts` [rows, H_i/tp, d] (the rank's token shard of its tp block of
    heads: the column-parallel projection's output).  Head shard k lies in
    tp block k // n, so a rank sends to the n shards of its block their
    heads of its rows."""
    n, t = u.n, u.t
    return _pack([torch.cat([x[:, (k - t * n) * h:(k - t * n + 1) * h] for x, h in zip(ts, u.fwd)], dim=1)
                  if k // n == t else None for k in u.heads_of], ts[0])


def _to_heads_recv(recv, u: _Ulysses):
    """... and what arrives: each tensor [S, H_i/N, d], every token of the
    rank's head shard (N = cp*pp*tp shards), the padding rows dropped."""
    got = _unpack(recv, u.fwd_splits()[1])
    by_seq = {sq: c for sq, c in zip(u.seq_of, got) if c is not None}
    full = torch.cat([by_seq[i].view(u.rows, sum(u.fwd), u.hd) for i in range(u.n)])[:u.S]
    return [y.contiguous() for y in full.split(list(u.fwd), dim=1)]


def _to_tokens_send(ts, u: _Ulysses):
    """The back transform's send buffer: `ts` [S, H_i/N, d] (attention
    outputs of the rank's head shard), padded to the shard grid and cut
    into the token shards of the rank's tp block."""
    x = torch.cat(ts, dim=1)
    padded = u.rows * u.n
    if padded > u.S:
        x = torch.cat([x, x.new_zeros((padded - u.S,) + tuple(x.shape[1:]))])
    return _pack([x[sq * u.rows:(sq + 1) * u.rows] if tt == u.k_me // u.n else None
                  for sq, tt in zip(u.seq_of, u.tp_of)], x)


def _to_tokens_recv(recv, u: _Ulysses):
    """... and what arrives: each tensor [rows, H_i/tp, d], the rank's token
    shard of its tp block of heads, in head order."""
    got = _unpack(recv, u.back_splits()[1])
    chunks = [c.view(u.rows, sum(u.back), u.hd)
              for _, c in sorted(((k, c) for k, c in zip(u.heads_of, got) if c is not None), key=lambda kc: kc[0])]
    offs = [sum(u.back[:i]) for i in range(len(u.back) + 1)]
    return [torch.cat([c[:, a:b] for c in chunks], dim=1) for a, b in zip(offs[:-1], offs[1:])]


def _caption_shard(kv_x, u: _Ulysses):
    """[T, H/tp, 2hd] (the rank's tp block of heads of every caption token)
    -> the rank's head shard [T, H/N, 2hd] when it lies in that block, else
    the send buffer of the tp group's exchange."""
    hs, n, t = u.cap_heads, u.n, u.t
    if not u.cap_tp_of:
        j = u.k_me - t * n
        return kv_x[:, j * hs:(j + 1) * hs].contiguous()
    return _pack([kv_x[:, (k - t * n) * hs:(k - t * n + 1) * hs] if k // n == t else None
                  for k in (u.sq * u.tp + tt for tt in u.cap_tp_of)], kv_x)


def _mesh_prologue(params, config, x, t, y, caption_dropout, meta, t_offsets, distill_factor, sh):
    """The prologue, and the rank's shard of its tokens (padded to the shard
    grid)."""
    h, condition, y_xattn, sin, cos = dit_prologue(params, config, x, t, y, caption_dropout, meta, t_offsets,
                                                   distill_factor)
    if sh.padded > sh.S:
        h = torch.cat([h, h.new_zeros((sh.padded - sh.S, h.shape[1]))])
    return tuple(v.clone(memory_format=torch.contiguous_format)
                 for v in (h[sh.start:sh.start + sh.rows], condition, y_xattn, sin, cos))


def _mesh_attn_in(p, cfg: ModelConfig, h, y_xattn, act_ok: bool, u: _Ulysses):
    """(p: the layer's self_attention tree) The column-parallel projections of the rank's rows and the captions,
    as the send buffer of the tokens -> heads all-to-all and the rank's
    caption kv (or its exchange's send buffer)."""
    q, qx, k, v = _qkv(p, h, act_ok, cfg.layernorm_epsilon)
    rows, hd = h.shape[0], cfg.kv_channels
    k, v = k.reshape(rows, -1, hd), v.reshape(rows, -1, hd)
    kv_x = _caption_kv(p, y_xattn, h.dtype, act_ok, hd)
    if u.rep > 1:
        k, v = k.repeat_interleave(u.rep, dim=1), v.repeat_interleave(u.rep, dim=1)
        kv_x = kv_x.repeat_interleave(u.rep, dim=1)
    return (_to_heads_send([q.reshape(rows, -1, hd), qx.reshape(rows, -1, hd), k, v], u),
            _caption_shard(kv_x, u))


def _mesh_attn(p, cfg: ModelConfig, recv, cap, sin, cos, cache_l, meta, u: _Ulysses, int8_attn: bool,
               int8_store: bool, dtype: torch.dtype):
    """(p: the layer's self_attention tree) Both attentions on every token of the rank's head shard (with the
    global ranges; the cache holds that shard), as the send buffer of the
    heads -> tokens all-to-all."""
    q, qx, k, v = _to_heads_recv(recv, u)
    if u.cap_tp_of:
        cap = next(c for c in _unpack(cap, u.cap_splits()[1]) if c is not None)
    kv_x = cap.view(u.cap_tokens, u.cap_heads, 2 * u.hd)
    core = _self_attention(p, cfg, q, k, v, sin, cos, cache_l, meta, int8_attn, int8_store, dtype)
    xattn = _cross_attention(p, cfg, qx, kv_x, meta, int8_attn, dtype)
    return _to_tokens_send([core.reshape(u.S, -1, u.hd), xattn.reshape(u.S, -1, u.hd)], u)


def _attn_out(recv, u: _Ulysses):
    """[core | xattn] of the rank's rows, from the heads -> tokens all-to-all."""
    core, xattn = _to_tokens_recv(recv, u)
    return torch.cat([core.reshape(u.rows, -1), xattn.reshape(u.rows, -1)], dim=-1)


def _mesh_tail(p, cfg: ModelConfig, recv, h, condition, meta, act_ok: bool, hp: bool, u: _Ulysses):
    """The rest of a layer at tp 1 (no row-parallel linear), on the rank's rows."""
    return _layer_tail(p, cfg, _attn_out(recv, u), h, condition, meta, act_ok, hp)


def _mesh_proj_in(p, recv, act_ok: bool, u: _Ulysses, eps: float):
    return _row_first(_attn_out(recv, u), p["self_attention"]["linear_proj"], act_ok, None, eps)


def _mesh_mlp_in(p, cfg: ModelConfig, part, h, condition, meta, act_ok: bool, hp: bool):
    """linear_proj's summed output cast, the gated post norm + residual, fc1,
    and fc2 up to its first all-reduce; returns (x, the MLP's gate, *fc2's
    `_row_first`)."""
    eps, zc = cfg.layernorm_epsilon, cfg.apply_layernorm_1p
    attn_out = part.to(_row_dtype(p["self_attention"]["linear_proj"], hp, h.dtype)).to(h.dtype)
    gate = softcap(ada_modulate_forward(p["ada_modulate_layer"], condition), 1.0)
    gate_msa, gate_mlp = gate.chunk(2, dim=-1)
    x = _bias_modulate_add(attn_out, h, gate_msa, p["self_attn_post_norm"], eps, zc, meta.n_segments, meta.seg_len)
    (h1,) = _linears_shared(x, [p["mlp"]["linear_fc1"]], act_ok, pre=("ln", p["mlp"]["layer_norm"]), eps=eps)
    fc2 = p["mlp"]["linear_fc2"]
    if cfg.gated_linear_unit:
        first = _row_first(h1, fc2, act_ok, ("swiglu",), eps)
    else:
        first = _row_first(F.gelu(h1, approximate="none"), fc2, act_ok, None, eps)
    return (x, gate_mlp.contiguous()) + first


def _mesh_mlp_out(p, cfg: ModelConfig, part, x, gate_mlp, meta):
    return _bias_modulate_add(part.to(x.dtype), x, gate_mlp, p["mlp_post_norm"], cfg.layernorm_epsilon,
                              cfg.apply_layernorm_1p, meta.n_segments, meta.seg_len)


def _a2a(run, name: str, x, group, splits) -> torch.Tensor:
    """An all-to-all between pieces into `run`'s slot `name` (skipped while
    `run` captures)."""
    out = run.slot(name, (sum(splits[1]),), x.dtype, x.device)
    return comm.all_to_all(x, group, splits[0], splits[1], out=out) if run.copies_live else out


def _all_reduce(run, x, group, op: str):
    return comm.all_reduce(x, group, op) if run.copies_live else x


def _row_reduce(run, name: str, first: tuple, p: dict, group):
    """A row-parallel linear's collectives after `_row_first`: with int8
    activations the row maximum, then the quantized product (piece
    `<name>_q`); then the sum of the f32 partials, in place."""
    if len(first) == 2:
        xf, amax = first
        _all_reduce(run, amax, group, "max")
        first = (run.piece(name + "_q", _row_quant, xf, amax, p),)
    return _all_reduce(run, first[0], group, "sum")


def _mesh_layer(run, p: dict, cfg: ModelConfig, h, cache_l, condition, y_xattn, sin, cos, meta, act_ok: bool,
                hp: bool, int8_attn: bool, int8_store: bool, u: _Ulysses, mesh):
    """One layer on a model-parallel mesh (see the section's comment)."""
    head = mesh.group("head")
    sa = p["self_attention"]
    send, cap = run.piece("attn_in", _mesh_attn_in, sa, cfg, h, y_xattn, act_ok, u)
    recv = _a2a(run, "heads", send, head, u.fwd_splits())
    if u.cap_tp_of:
        cap = _a2a(run, "caption", cap, mesh.group("tp"), u.cap_splits())
    back = run.piece("attn", _mesh_attn, sa, cfg, recv, cap, sin, cos, cache_l, meta, u, int8_attn, int8_store,
                     h.dtype)
    recv = _a2a(run, "tokens", back, head, u.back_splits())
    if u.tp == 1:
        return run.piece("tail", _mesh_tail, p, cfg, recv, h, condition, meta, act_ok, hp, u)
    tp = mesh.group("tp")
    eps = cfg.layernorm_epsilon
    first = run.piece("proj_in", _mesh_proj_in, p, recv, act_ok, u, eps)
    part = _row_reduce(run, "proj", first, p["self_attention"]["linear_proj"], tp)
    x, gate_mlp, *first = run.piece("mlp_in", _mesh_mlp_in, p, cfg, part, h, condition, meta, act_ok, hp)
    part = _row_reduce(run, "mlp", tuple(first), p["mlp"]["linear_fc2"], tp)
    return run.piece("mlp_out", _mesh_mlp_out, p, cfg, part, x, gate_mlp, meta)


def _mesh_out(config: MagiConfig, parts, order: tuple, S: int, Tp: int, Hp: int, Wp: int):
    """The gathered final tokens of every seq shard (`parts` [shards, rows,
    F] in group order; `order` their shard indices), in token order, the
    padding dropped, unpatchified."""
    out = torch.cat([parts[order.index(i)] for i in range(len(order))])[:S]
    return _unpatchify_out(config, out, Tp, Hp, Wp)


def _dit_forward_mesh(run, params: dict, config: MagiConfig, x, t, y, caption_dropout, kv_cache, meta: ForwardMeta,
                      t_offsets, distill_factor, tag: str):
    """`dit_forward` on a model-parallel mesh, in `run`'s pieces: between
    attentions each rank holds its shard of the token axis; under pp each
    layer arrives from its owner (`parallel.mesh.pp_gather_layer`, the next
    one's broadcast issued before this one's pieces); the final LayerNorm
    and linear run on the rank's rows, gathered after over the seq group."""
    mc = config.model_config
    C, T, H, W = x.shape
    Hp, Wp = H // mc.patch_size, W // mc.patch_size
    Tp = T // mc.t_patch_size
    mesh = mesh_lib.get_mesh()
    S = meta.n_segments * meta.seg_len
    sh = mesh_lib.token_shard(S, mesh)
    u = _Ulysses.of(mesh, mc, sh, meta.n_segments * y.shape[1])
    h, condition, y_xattn, sin, cos = run.piece("prologue", _mesh_prologue, params, config, x, t, y, caption_dropout,
                                                meta, t_offsets, distill_factor, sh)
    L = mc.num_layers
    pp = mesh.shape[mesh_lib.AXIS_PP]
    edge = params.get("blocks_edge")
    ec = config.engine_config
    flags = (ec.high_precision_matmul, attn_int8(config), attn_int8_store(config))

    def gather(i):
        # an edge layer of a tree with blocks_edge needs none of its quantized weights
        return mesh_lib.pp_gather_layer(params["blocks"], i, L, mesh, edge=edge is not None and i in (0, L - 1),
                                        run=run)

    nxt = gather(0) if pp > 1 else None
    for idx in range(L):
        if pp > 1:
            blk = nxt.wait()
            if idx + 1 < L:
                nxt = gather(idx + 1)
        else:
            blk = layer_params(params["blocks"], idx)
        tree, act_ok = _routed(blk, edge, config, idx)
        h = _mesh_layer(run, tree, mc, h, _cache_layer(kv_cache, idx, meta), condition, y_xattn, sin, cos, meta,
                        act_ok, *flags, u, mesh)
    out = run.piece("final", _final_tokens, params, config, h)
    seq = mesh.group("seq")
    if seq.size == 1:
        parts = out[None]
    else:
        parts = run.slot("gather", (seq.size,) + tuple(out.shape), out.dtype, out.device)
        if run.copies_live:
            comm.all_gather(out, seq, out=parts)
    order = tuple(mesh.seq_index(r) for r in seq.ranks)
    return run.piece("out_" + tag, _mesh_out, config, parts, order, sh.S, Tp, Hp, Wp)


# ---------------------------------------------------------------------------
# parameters and cache
# ---------------------------------------------------------------------------


def init_dit_params(config: MagiConfig, device=None, generator: Optional[torch.Generator] = None, sink=None) -> dict:
    """Random weights (the SKIP_LOAD_MODEL mode): the JAX package's key tree
    and shapes, drawn on `device` with `generator`.  Matmul weights are
    uniform with std 0.02 in the parameter dtype; norms are identity
    (zero-centered gammas are 0); biases are 0.  Each leaf goes to `sink`
    (an `ops.quant.TreeSink`, by default one that keeps the bf16 tree) as
    it is drawn and the sink's tree comes back: quantized as it arrives
    under `quant_bits`, a rank's shards with a `parallel.mesh.ShardSink`
    (the slices of the single-device tree from the same generator).  No
    more than one full stacked leaf is alive at a time."""
    mc = config.model_config
    device = torch.device(device or "cuda")
    if generator is None:
        generator = torch.Generator(device=device)
        generator.manual_seed(config.runtime_config.seed)
    D, hd, hq, hk = mc.hidden_size, mc.kv_channels, mc.num_attention_heads, mc.num_query_groups
    ch, xh, gh = mc.cond_hidden_size, mc.xattn_cond_hidden_size, mc.gate_hidden_size
    L, ffn, dtype = mc.num_layers, mc.ffn_hidden_size, mc.params_dtype
    fc1_out = 2 * ffn if mc.gated_linear_unit else ffn
    bound = 0.02 * 3.0**0.5
    sink = TreeSink() if sink is None else sink
    put = sink.leaf

    def uniform(shape, dt):
        return torch.empty(shape, dtype=dt, device=device).uniform_(-bound, bound, generator=generator)

    def lin(path, i, o, bias=False):
        sink.linear(path, uniform((L, i, o), dtype))
        if bias:
            put(path + "/bias", torch.zeros((L, o), dtype=dtype, device=device))

    def norm(path, n, dt, stacked=True, plain=False):
        shape = (L, n) if stacked else (n,)
        w = torch.zeros if mc.apply_layernorm_1p and not plain else torch.ones
        put(path + "/weight", w(shape, dtype=dt, device=device))
        put(path + "/bias", torch.zeros(shape, dtype=dt, device=device))

    a = "blocks/self_attention/"
    lin("blocks/ada_modulate_layer/proj/0", ch, 2 * gh, bias=True)
    norm(a + "linear_qkv/layer_norm", D, dtype, plain=True)
    lin(a + "linear_qkv/q", D, hq * hd)
    lin(a + "linear_qkv/qx", D, hq * hd)
    lin(a + "linear_qkv/k", D, hk * hd)
    lin(a + "linear_qkv/v", D, hk * hd)
    norm(a + "q_layernorm", hd, torch.float32)
    norm(a + "k_layernorm", hd, torch.float32)
    norm(a + "q_layernorm_xattn", hd, dtype)
    norm(a + "k_layernorm_xattn", hd, dtype)
    lin(a + "linear_kv_xattn", xh, 2 * hk * hd)
    lin(a + "linear_proj", 2 * hq * hd, D)
    norm("blocks/self_attn_post_norm", D, torch.float32)
    norm("blocks/mlp/layer_norm", D, dtype, plain=True)
    lin("blocks/mlp/linear_fc1", D, fc1_out)
    lin("blocks/mlp/linear_fc2", ffn, D)
    norm("blocks/mlp_post_norm", D, torch.float32)
    in_feat = mc.in_channels * mc.t_patch_size * mc.patch_size**2
    put("x_embedder/weight", uniform((in_feat, D), torch.float32))
    put("rope/bands", default_bands(D // hq, device=device))
    norm("final_layernorm", D, torch.float32, stacked=False)
    for path, t in tree_leaves(init_embedder_params(mc, device, generator)):
        put(path, t)
    return sink.tree()


def kv_cache_shape(config: MagiConfig, max_tokens: int) -> tuple:
    """[layers, k|v, kv_heads, tokens, head_dim]: the attention kernel's
    layout, of the rank's head shard on a mesh (kv heads replicated
    `kv_replication` times first, as the JAX package's cache carries them)."""
    mc = config.model_config
    hq, hk = mc.num_attention_heads, mc.num_query_groups
    mesh = mesh_lib.get_mesh()
    heads = hk * mesh_lib.kv_replication(hq, hk, mesh) // mesh_lib.head_shards(mesh)
    return (mc.num_layers, 2, heads, max_tokens, mc.kv_channels)


def init_kv_cache(config: MagiConfig, max_tokens: int, device, dtype=None, int8: Optional[bool] = None):
    """A zero KV cache: the int8 dict {kv: int8 [L, 2, hk, tok, hd], scale:
    f32 [L, 2, hk, tok]} when the cache is stored int8 (`int8`, by default
    `attn_int8_store(config)`), else one [L, 2, hk, tok, hd] tensor in
    `dtype` (the parameter dtype by default)."""
    shape = kv_cache_shape(config, max_tokens)
    if int8 is None:
        int8 = attn_int8_store(config)
    if int8:
        return {
            "kv": torch.zeros(shape, dtype=torch.int8, device=device),
            "scale": torch.zeros(shape[:-1], dtype=torch.float32, device=device),
        }
    return torch.zeros(shape, dtype=dtype or config.model_config.params_dtype, device=device)

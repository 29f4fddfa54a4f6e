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
  their inputs are divided by it (a plain op) before the row quantization.
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
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from magi_tpu_torch.core.config import MagiConfig, ModelConfig
from magi_tpu_torch.core.dataclasses import ForwardMeta
from magi_tpu_torch.models.dit.embedders import (
    ada_modulate_forward,
    final_linear_forward,
    init_embedder_params,
    softcap,
    t_embedder_forward,
    y_embedder_forward,
)
from magi_tpu_torch.models.dit.rope import default_bands, rope_3d_segments
from magi_tpu_torch.ops.act_quant import rowquant_fused
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
from magi_tpu_torch.ops.fused_norm import gate_norm_residual
from magi_tpu_torch.ops.quant import quantized_matmul, quantized_matmul_i8, unpack_int4


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


def _apply_pre(x, pre, eps):
    """The unfused producer of a linear group's input: None, ("ln", params)
    a shared pre-LayerNorm, or ("swiglu",) on a gated fc1 output."""
    if pre is None:
        return x
    if pre[0] == "ln":
        return layer_norm(x, pre[1], eps)
    d = x.shape[-1] // 2
    return F.silu(x[..., :d].float()).to(x.dtype) * x[..., d:]


def _smooth_divide(x, smooth):
    """x / s per input channel, the JAX package's f32(x) * (1 / s) cast back
    to x's dtype: a plain PyTorch op, one elementwise pass (the product is
    taken in f32 and rounded once as it is written in x's dtype)."""
    return torch.mul(x, 1.0 / smooth.float(), out=torch.empty(x.shape, dtype=x.dtype, device=x.device))


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
    linear (`act_smooth` s, its weight quantized s·W) runs `pre` unfused,
    divides its input by s (`_smooth_divide`), then K8 `plain` + K6 or K7:
    a smoothed gated fc2 launches no K8s.  The kernels run on CUDA tensors,
    their plain versions on CPU tensors."""
    if "weight_q4" in plist[0]:
        plist = [{**{k: v for k, v in pp.items() if k != "weight_q4"}, "weight_q": unpack_int4(pp["weight_q4"])}
                 for pp in plist]
    if "weight_q" not in plist[0]:
        x = _apply_pre(x, pre, eps)
        return tuple(_dot(x, pp["weight"], high_precision) for pp in plist)
    if "act_smooth" in plist[0]:
        # smooth-quant (fp8 checkpoints): the weight is quantized s·W, so the
        # input divides by s, after its producer and before the row
        # quantization, in both branches
        if len(plist) != 1:
            raise ValueError("smooth-quant linears are groups of one")
        x = _smooth_divide(_apply_pre(x, pre, eps), plist[0]["act_smooth"])
        pre = None
    if not act_ok:
        x = _apply_pre(x, pre, eps)
        return tuple(quantized_matmul(x, pp["weight_q"], pp["weight_scale"]).to(x.dtype) for pp in plist)

    mode = "plain" if pre is None else pre[0]
    lnp = pre[1] if mode == "ln" else None
    xq, rs = rowquant_fused(
        x, mode, None if lnp is None else lnp["weight"], None if lnp is None else lnp["bias"], eps=eps
    )
    return tuple(quantized_matmul_i8(xq, rs, pp["weight_q"], pp["weight_scale"], out_dtype=x.dtype) for pp in plist)


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


def _bias_modulate_add(x, residual, gate, post_norm_params, eps, zero_centered, n_seg):
    """fp32(gate[seg] * x) -> post norm -> + residual, in one kernel pass."""
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
    """Self-attention (cache + current window) and caption cross-attention.
    Returns (core_attn_out [S, hq*hd], xattn_out [S, hq*hd]).  `int8_attn`
    runs both through int8 attention; `int8_store` (the cache is the int8
    dict) packs the current kv to int8 with K3q on the card."""
    S, D = x.shape
    hd = cfg.kv_channels
    hq = cfg.num_attention_heads
    hk = cfg.num_query_groups
    eps = cfg.layernorm_epsilon
    one = 1.0 if cfg.apply_layernorm_1p else 0.0
    n_seg, ctn = meta.n_segments, meta.seg_len
    on_card = x.device.type == "cuda"

    # q/qx/k/v share the pre-LN output: one row quantization covers all four
    lq = p["linear_qkv"]
    q, qx, k, v = _linears_shared(
        x, [lq["q"], lq["qx"], lq["k"], lq["v"]], act_quant_ok, pre=("ln", lq["layer_norm"]), eps=eps
    )

    # q-side fp32 QK-norm + rope run in the attention kernel's prologue
    q_pro = (p["q_layernorm"]["weight"].float() + one, p["q_layernorm"]["bias"].float(), sin, cos, eps)
    q = q.reshape(S, hq, hd)

    # k side: fp32 norm + rope + cast, packed into the cache layout (on the
    # card with an int8-stored cache, quantized per token in the same pass)
    kw = (p["k_layernorm"]["weight"].float() + one).contiguous()
    kb = p["k_layernorm"]["bias"].float().contiguous()
    k, v = k.reshape(S, hk, hd), v.reshape(S, hk, hd)
    if on_card and int8_store:
        kv8, sc = kv_norm_rope_pack(k, v, kw, kb, sin, cos, eps=eps, quantize=True)
        kv = {"kv": kv8, "scale": sc}
    else:
        kv = kv_norm_rope_pack(k, v, kw, kb, sin, cos, eps=eps, out_dtype=x.dtype)

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
            idx = start_tok.long() + torch.arange(clip, device=x.device)
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
        cache_in = cache_l if isinstance(cache_l, dict) else cache_l.to(x.dtype)
        if int8_attn:
            core = _q8_attention(q, cache_in, kv, r1s, r1e, r2s, r2e, seg_len=ctn, q_pro=q_pro)
        else:
            core = segmented_attention_two_source(q, cache_in, kv, r1s, r1e, r2s, r2e, seg_len=ctn, q_prologue=q_pro)
    else:
        # no-cache forwards (the uncond CFG branch): the same two-source
        # kernel with an empty first source
        z = torch.zeros_like(gs)
        if isinstance(kv, dict):
            empty = {"kv": kv["kv"][:, :, :0], "scale": kv["scale"][:, :, :0]}
        else:
            empty = torch.zeros((2, kv.shape[1], 0, hd), dtype=kv.dtype, device=kv.device)
        if int8_attn:
            core = _q8_attention(q, empty, kv, z, z, gs, ge, seg_len=ctn, q_pro=q_pro)
        else:
            core = segmented_attention_two_source(q, empty, kv, z, z, gs, ge, seg_len=ctn, q_prologue=q_pro)
    core = core.reshape(S, hq * hd)

    # caption cross-attention: norm-only q prologue, no rope
    qx_pro = (
        p["q_layernorm_xattn"]["weight"].float() + one, p["q_layernorm_xattn"]["bias"].float(), None, None, eps
    )
    qx = qx.reshape(S, hq, hd)
    L = y_xattn.shape[1]
    y_flat = y_xattn.reshape(n_seg * L, -1).to(x.dtype)
    (kv_x,) = _linears_shared(y_flat, [p["linear_kv_xattn"]], act_quant_ok)
    kv_x = kv_x.reshape(n_seg * L, hk, 2 * hd)
    k_x = layer_norm(kv_x[..., :hd], p["k_layernorm_xattn"], eps, cfg.apply_layernorm_1p).contiguous()
    v_x = kv_x[..., hd:]  # a view: the caption kernel loads it with TMA
    x_starts = torch.arange(n_seg, dtype=torch.int32, device=x.device) * L
    x_ends = x_starts + meta.y_lens.to(device=x.device, dtype=torch.int32)
    if int8_attn and (hd % 128 == 0 or not on_card):
        # int8 cross-attention: the caption kv is source 1 of the int8
        # two-source kernel, source 2 is empty
        kv_cap = torch.stack([k_x.transpose(0, 1), v_x.transpose(0, 1)])
        kv8, sc = quantize_kv_per_token(kv_cap.to(x.dtype))
        empty = {"kv": kv8[:, :, :0], "scale": sc[:, :, :0]}
        z = torch.zeros_like(x_starts)
        xattn = _q8_attention(qx, {"kv": kv8, "scale": sc}, empty, x_starts, x_ends, z, z, seg_len=ctn, q_pro=qx_pro)
    else:
        xattn = segmented_attention_v2(qx, k_x, v_x, x_starts, x_ends, seg_len=ctn, q_prologue=qx_pro)
    return core, xattn.reshape(S, hq * hd)


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
    """One parallel-attention transformer layer."""
    eps = cfg.layernorm_epsilon
    zc = cfg.apply_layernorm_1p
    residual = x
    core, xattn = attention_forward(
        p["self_attention"], cfg, x, y_xattn, sin, cos, cache_l, meta, act_quant_ok, int8_attn, int8_store
    )
    attn_out = torch.cat([core, xattn], dim=-1)  # [S, 2*hq*hd]
    (attn_out,) = _linears_shared(
        attn_out, [p["self_attention"]["linear_proj"]], act_quant_ok, high_precision=high_precision
    )
    attn_out = attn_out.to(x.dtype)

    gate = softcap(ada_modulate_forward(p["ada_modulate_layer"], condition), 1.0)
    gate_msa, gate_mlp = gate.chunk(2, dim=-1)
    x = _bias_modulate_add(attn_out, residual, gate_msa, p["self_attn_post_norm"], eps, zc, meta.n_segments)

    residual = x
    # the LayerNorm (and SwiGLU) ride into their consumer linears as `pre`
    (h,) = _linears_shared(x, [p["mlp"]["linear_fc1"]], act_quant_ok, pre=("ln", p["mlp"]["layer_norm"]), eps=eps)
    if cfg.gated_linear_unit:
        (h,) = _linears_shared(h, [p["mlp"]["linear_fc2"]], act_quant_ok, pre=("swiglu",), eps=eps)
    else:
        h = F.gelu(h, approximate="none")
        (h,) = _linears_shared(h, [p["mlp"]["linear_fc2"]], act_quant_ok)
    return _bias_modulate_add(h, residual, gate_mlp, p["mlp_post_norm"], eps, zc, meta.n_segments)


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


def dit_epilogue(params: dict, config: MagiConfig, h, Tp: int, Hp: int, Wp: int):
    """Final LayerNorm + fp32 final linear + unpatchify."""
    mc = config.model_config
    h = layer_norm(h.float(), params["final_layernorm"], mc.layernorm_epsilon, mc.apply_layernorm_1p)
    out = unpatchify(final_linear_forward(params["final_linear"], h), mc, Tp, Hp, Wp)
    if mc.half_channel_vae:
        out = out[: mc.out_channels // 2]
    return out / mc.x_rescale_factor


def layer_params(blocks: dict, idx: int) -> dict:
    """Layer `idx` of the stacked block tree (views, no copy)."""
    return {k: layer_params(v, idx) if isinstance(v, dict) else v[idx] for k, v in blocks.items()}


def _apply_layer_routed(blk, edge, config: MagiConfig, idx: int, *args, **kwargs):
    """Layer `idx` with the quantized tree's routing: middle layers run
    int8 (or int4) weights and int8 activations; layers 0 and L-1 run bf16
    through the `blocks_edge` side tree (the reference's first/last-layer
    policy).  A quantized tree without `blocks_edge` runs its edge layers
    with bf16 activations on the int8 weights (the dequant GEMM, K7).  bf16
    trees ignore the routing."""
    L = config.model_config.num_layers
    if edge is None:
        return layer_forward(blk, config.model_config, *args, act_quant_ok=0 < idx < L - 1, **kwargs)
    if idx in (0, L - 1):
        ew = edge["first"] if idx == 0 else edge["last"]
        return layer_forward(_merge_edge(blk, ew), config.model_config, *args, act_quant_ok=False, **kwargs)
    return layer_forward(blk, config.model_config, *args, act_quant_ok=True, **kwargs)


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
):
    """Full DiT forward.  Returns (velocity [C_out, T, H, W], kv_cache); a
    forward with `meta.update_kv_cache` has written its slice of the cache
    in place."""
    mc = config.model_config
    C, T, H, W = x.shape
    Hp, Wp = H // mc.patch_size, W // mc.patch_size
    Tp = T // mc.t_patch_size
    h, condition, y_xattn, sin, cos = dit_prologue(
        params, config, x, t, y, caption_dropout, meta, t_offsets, distill_factor
    )
    if meta.use_kv_cache and kv_cache is None:
        raise ValueError("a forward that reads the KV cache needs one")
    if meta.use_kv_cache and isinstance(kv_cache, dict) != attn_int8_store(config):
        raise ValueError("the KV cache's form (int8 dict or bf16 tensor) does not match the int8 attention switches")
    for idx in range(mc.num_layers):
        if not meta.use_kv_cache:
            cache_l = None
        elif isinstance(kv_cache, dict):
            cache_l = {"kv": kv_cache["kv"][idx], "scale": kv_cache["scale"][idx]}
        else:
            cache_l = kv_cache[idx]
        h = dit_layer_step(params, config, idx, h, cache_l, condition, y_xattn, sin, cos, meta)
    return dit_epilogue(params, config, h, Tp, Hp, Wp), kv_cache


def dit_layer_step(params: dict, config: MagiConfig, idx: int, h: torch.Tensor, cache_l, condition, y_xattn, sin,
                   cos, meta: ForwardMeta) -> torch.Tensor:
    """Layer `idx` of the stacked tree (edge routing included) on `cache_l`,
    that layer's cache slab ([2, hk, tokens, hd], or the int8 {kv, scale}
    dict; any strides the kernels take; None for a forward without the
    cache), which a forward with `meta.update_kv_cache` writes in place.
    The unit of the host-streamed KV cache (`sampling.transport.HostKVCache`),
    and the body of `dit_forward`'s layer loop."""
    return _apply_layer_routed(
        layer_params(params["blocks"], idx), params.get("blocks_edge"), config, idx, h, condition, y_xattn, sin, cos,
        cache_l, meta, high_precision=config.engine_config.high_precision_matmul, int8_attn=attn_int8(config),
        int8_store=attn_int8_store(config),
    )


# ---------------------------------------------------------------------------
# parameters and cache
# ---------------------------------------------------------------------------


def init_dit_params(config: MagiConfig, device=None, generator: Optional[torch.Generator] = None) -> dict:
    """Random weights (the SKIP_LOAD_MODEL mode): the JAX package's key tree
    and shapes, drawn on `device` with `generator`.  Matmul weights are
    uniform with std 0.02 in the parameter dtype; norms are identity
    (zero-centered gammas are 0); biases are 0."""
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

    def uniform(shape, dt):
        return torch.empty(shape, dtype=dt, device=device).uniform_(-bound, bound, generator=generator)

    def lin(i, o, bias=False):
        p = {"weight": uniform((L, i, o), dtype)}
        if bias:
            p["bias"] = torch.zeros((L, o), dtype=dtype, device=device)
        return p

    def norm(n, dt, stacked=True):
        shape = (L, n) if stacked else (n,)
        w = torch.zeros if mc.apply_layernorm_1p else torch.ones
        return {"weight": w(shape, dtype=dt, device=device), "bias": torch.zeros(shape, dtype=dt, device=device)}

    def plain_norm(n, dt):
        return {"weight": torch.ones((L, n), dtype=dt, device=device), "bias": torch.zeros((L, n), dtype=dt, device=device)}

    blocks = {
        "ada_modulate_layer": {"proj": {"0": lin(ch, 2 * gh, bias=True)}},
        "self_attention": {
            "linear_qkv": {
                "layer_norm": plain_norm(D, dtype),
                "q": lin(D, hq * hd),
                "qx": lin(D, hq * hd),
                "k": lin(D, hk * hd),
                "v": lin(D, hk * hd),
            },
            "q_layernorm": norm(hd, torch.float32),
            "k_layernorm": norm(hd, torch.float32),
            "q_layernorm_xattn": norm(hd, dtype),
            "k_layernorm_xattn": norm(hd, dtype),
            "linear_kv_xattn": lin(xh, 2 * hk * hd),
            "linear_proj": lin(2 * hq * hd, D),
        },
        "self_attn_post_norm": norm(D, torch.float32),
        "mlp": {
            "layer_norm": plain_norm(D, dtype),
            "linear_fc1": lin(D, fc1_out),
            "linear_fc2": lin(ffn, D),
        },
        "mlp_post_norm": norm(D, torch.float32),
    }
    in_feat = mc.in_channels * mc.t_patch_size * mc.patch_size**2
    params = {
        "x_embedder": {"weight": uniform((in_feat, D), torch.float32)},
        "rope": {"bands": default_bands(D // hq, device=device)},
        "blocks": blocks,
        "final_layernorm": norm(D, torch.float32, stacked=False),
    }
    params.update(init_embedder_params(mc, device, generator))
    return params


def kv_cache_shape(config: MagiConfig, max_tokens: int) -> tuple:
    """[layers, k|v, kv_heads, tokens, head_dim]: the attention kernel's layout."""
    mc = config.model_config
    return (mc.num_layers, 2, mc.num_query_groups, max_tokens, mc.kv_channels)


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

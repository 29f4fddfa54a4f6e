"""VideoDiT forward on one device in bf16 (the port of
`magi_tpu.models.dit.model`).

* Parameters are the JAX package's tree of plain dictionaries, with the
  layers stacked on a leading [num_layers] axis; a Python loop over the
  layers replaces `lax.scan`.
* The token axis packs the batch into `n_segments` equal chunks of
  `seg_len` tokens; the unconditional CFG branch is just other kv ranges.
* fp32 islands as in the JAX package: embedders, QK LayerNorms, gating
  and post norms, final LayerNorm and linear.  Dense linears are plain
  `torch.matmul` in the parameter dtype.
* The KV cache is one [num_layers, 2, hk, tokens, hd] buffer in the
  attention kernel's layout, updated in place: a forward that writes the
  cache writes the slice of its current chunks and reads only earlier
  tokens, so reads and writes never overlap.
* Attention, the k-side norm+rope+pack and the gated post norms go
  through `magi_tpu_torch.ops` (CUDA kernels on the card, their plain
  versions on the CPU).
"""

from __future__ import annotations

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
from magi_tpu_torch.ops.attention import (
    kv_norm_rope_pack,
    segmented_attention_two_source,
    segmented_attention_v2,
)
from magi_tpu_torch.ops.fused_norm import gate_norm_residual


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


def _bias_modulate_add(x, residual, gate, post_norm_params, eps, zero_centered, n_seg):
    """fp32(gate[seg] * x) -> post norm -> + residual, in one kernel pass."""
    return gate_norm_residual(
        x, residual, gate.contiguous(), post_norm_params["weight"], post_norm_params["bias"],
        eps=eps, zero_centered=zero_centered, n_seg=n_seg,
    )


def attention_forward(
    p: dict,
    cfg: ModelConfig,
    x: torch.Tensor,  # [S, D]
    y_xattn: torch.Tensor,  # [n_seg, L, xattn_hidden] fp32
    sin: torch.Tensor,
    cos: torch.Tensor,
    cache_l: Optional[torch.Tensor],  # [2, hk, max_tok, hd], updated in place
    meta: ForwardMeta,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Self-attention (cache + current window) and caption cross-attention.
    Returns (core_attn_out [S, hq*hd], xattn_out [S, hq*hd])."""
    S, D = x.shape
    hd = cfg.kv_channels
    hq = cfg.num_attention_heads
    hk = cfg.num_query_groups
    eps = cfg.layernorm_epsilon
    one = 1.0 if cfg.apply_layernorm_1p else 0.0
    n_seg, ctn = meta.n_segments, meta.seg_len

    xin = layer_norm(x, p["linear_qkv"]["layer_norm"], eps)
    lq = p["linear_qkv"]
    q, qx, k, v = (_dot(xin, lq[n]["weight"]) for n in ("q", "qx", "k", "v"))

    # q-side fp32 QK-norm + rope run in the attention kernel's prologue
    q_pro = (p["q_layernorm"]["weight"].float() + one, p["q_layernorm"]["bias"].float(), sin, cos, eps)
    q = q.reshape(S, hq, hd)

    # k side: fp32 norm + rope + cast, packed into the cache layout
    kw = (p["k_layernorm"]["weight"].float() + one).contiguous()
    kb = p["k_layernorm"]["bias"].float().contiguous()
    kv = kv_norm_rope_pack(k.reshape(S, hk, hd), v.reshape(S, hk, hd), kw, kb, sin, cos, eps=eps, out_dtype=x.dtype)

    gs = meta.self_attn.kv_start
    ge = meta.self_attn.kv_end
    if meta.use_kv_cache:
        # The global ranges span cache tokens [0, start_tok) followed by the
        # current window; split them per source so the cache stays a
        # read-only buffer for the attention.
        start_tok = meta.slice_point * ctn
        if meta.update_kv_cache:
            # the distill ride-along chunk is not written
            clip = S - ctn if meta.distill_nearly_clean_chunk else S
            if start_tok + clip > cache_l.shape[2]:
                raise ValueError(f"cache write [{start_tok}, {start_tok + clip}) overflows {cache_l.shape[2]} tokens")
            cache_l[:, :, start_tok : start_tok + clip] = kv[:, :, :clip].to(cache_l.dtype)
        r1s = torch.clamp(gs, max=start_tok)
        r1e = torch.clamp(ge, max=start_tok)
        r2s = torch.clamp(gs - start_tok, min=0)
        r2e = torch.clamp(ge - start_tok, min=0)
        core = segmented_attention_two_source(
            q, cache_l.to(x.dtype), kv, r1s, r1e, r2s, r2e, seg_len=ctn, q_prologue=q_pro
        )
    else:
        # no-cache forwards (the uncond CFG branch): the same two-source
        # kernel with an empty first source
        empty = torch.zeros((2, kv.shape[1], 0, hd), dtype=kv.dtype, device=kv.device)
        z = torch.zeros_like(gs)
        core = segmented_attention_two_source(q, empty, kv, z, z, gs, ge, seg_len=ctn, q_prologue=q_pro)
    core = core.reshape(S, hq * hd)

    # caption cross-attention: norm-only q prologue, no rope
    qx_pro = (
        p["q_layernorm_xattn"]["weight"].float() + one, p["q_layernorm_xattn"]["bias"].float(), None, None, eps
    )
    qx = qx.reshape(S, hq, hd)
    L = y_xattn.shape[1]
    y_flat = y_xattn.reshape(n_seg * L, -1).to(x.dtype)
    kv_x = _dot(y_flat, p["linear_kv_xattn"]["weight"]).reshape(n_seg * L, hk, 2 * hd)
    k_x = layer_norm(kv_x[..., :hd], p["k_layernorm_xattn"], eps, cfg.apply_layernorm_1p).contiguous()
    v_x = kv_x[..., hd:].contiguous()
    x_starts = torch.arange(n_seg, dtype=torch.int32, device=x.device) * L
    x_ends = x_starts + meta.y_lens.to(device=x.device, dtype=torch.int32)
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
    cache_l: Optional[torch.Tensor],
    meta: ForwardMeta,
    high_precision: bool = False,
) -> torch.Tensor:
    """One parallel-attention transformer layer."""
    eps = cfg.layernorm_epsilon
    zc = cfg.apply_layernorm_1p
    residual = x
    core, xattn = attention_forward(p["self_attention"], cfg, x, y_xattn, sin, cos, cache_l, meta)
    attn_out = torch.cat([core, xattn], dim=-1)  # [S, 2*hq*hd]
    attn_out = _dot(attn_out, p["self_attention"]["linear_proj"]["weight"], high_precision).to(x.dtype)

    gate = softcap(ada_modulate_forward(p["ada_modulate_layer"], condition), 1.0)
    gate_msa, gate_mlp = gate.chunk(2, dim=-1)
    x = _bias_modulate_add(attn_out, residual, gate_msa, p["self_attn_post_norm"], eps, zc, meta.n_segments)

    residual = x
    h = _dot(layer_norm(x, p["mlp"]["layer_norm"], eps), p["mlp"]["linear_fc1"]["weight"])
    if cfg.gated_linear_unit:
        d = h.shape[-1] // 2
        h = F.silu(h[..., :d].float()).to(h.dtype) * h[..., d:]
    else:
        h = F.gelu(h, approximate="none")
    h = _dot(h, p["mlp"]["linear_fc2"]["weight"])
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


def dit_prologue(params: dict, config: MagiConfig, x, t, y, caption_dropout, meta: ForwardMeta, t_offsets):
    """Embedding stage in fp32.  Returns (h [S, D], condition, y_xattn, sin, cos)."""
    mc = config.model_config
    if config.engine_config.distill:
        raise NotImplementedError("distill forwards are ROADMAP queue 1 item 10 (not in this slice)")
    x = x.float() * mc.x_rescale_factor
    if mc.half_channel_vae:
        x = torch.cat([x, x], dim=0)
    C, T, H, W = x.shape
    Hp, Wp = H // mc.patch_size, W // mc.patch_size
    Tp = T // mc.t_patch_size
    tokens = patchify(x, mc) @ params["x_embedder"]["weight"].float()

    sin, cos = rope_3d_segments(params["rope"]["bands"], t_offsets, Tp // meta.n_segments, Hp, Wp)
    t_emb = t_embedder_forward(params["t_embedder"], t)
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


def dit_forward(
    params: dict,
    config: MagiConfig,
    x: torch.Tensor,  # [C, T, H, W] latent
    t: torch.Tensor,  # [n_seg] timesteps
    y: torch.Tensor,  # [n_seg, L, caption_channels]
    caption_dropout,  # bool, or bool [n_seg]
    kv_cache: Optional[torch.Tensor],  # [num_layers, 2, hk, max_tok, hd]; None when unused
    meta: ForwardMeta,
    t_offsets: torch.Tensor,  # int [n_seg] temporal patch-grid offsets
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Full DiT forward.  Returns (velocity [C_out, T, H, W], kv_cache); a
    forward with `meta.update_kv_cache` has written its slice of the cache
    in place."""
    mc = config.model_config
    C, T, H, W = x.shape
    Hp, Wp = H // mc.patch_size, W // mc.patch_size
    Tp = T // mc.t_patch_size
    h, condition, y_xattn, sin, cos = dit_prologue(params, config, x, t, y, caption_dropout, meta, t_offsets)
    if meta.use_kv_cache and kv_cache is None:
        raise ValueError("a forward that reads the KV cache needs one")
    hp = config.engine_config.high_precision_matmul
    for idx in range(mc.num_layers):
        cache_l = kv_cache[idx] if meta.use_kv_cache else None
        h = layer_forward(
            layer_params(params["blocks"], idx), mc, h, condition, y_xattn, sin, cos, cache_l, meta, hp
        )
    return dit_epilogue(params, config, h, Tp, Hp, Wp), kv_cache


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


def init_kv_cache(config: MagiConfig, max_tokens: int, device, dtype=None) -> torch.Tensor:
    return torch.zeros(kv_cache_shape(config, max_tokens), dtype=dtype or config.model_config.params_dtype,
                       device=device)

"""MAGI-1's VideoDiT forward in plain PyTorch, for the benchmark's check.

It follows the model's published description and its stated precision:
bf16 weights and a bf16 residual stream, every matmul on bf16 operands with
fp32 sums (`x @ w` in bf16), LayerNorm statistics, rotary, gating, the
timestep and caption embedders and the final projection in fp32, attention
softmax(q k^T / sqrt(d)) v by PyTorch's `scaled_dot_product_attention` on
bf16 q, k and v.  Under w8a8 (the released `fp8_quant` configs) the middle
layers' linears quantize their input per row and their weight per output
channel to int8 (scale amax / 127, round half to even), the weight folded
with the linear's `act_smooth` s and the input divided by it; layers 0 and
L-1 stay bf16.

Several forwards run together, layer by layer, so each layer's weights are
drawn (and quantized) once: `velocities(cfg, seed, device, forwards)`.  A
forward is a run of segments (`schedule.Segment`) at consecutive chunk
positions; each segment attends the chunk range its `kv` gives, which may
start at segments that only stand in for the KV cache.  Each segment takes
the request's caption or the null one for its cross-attention, and a
caption-dropout flag that picks the null table's row feeding adaLN (the
null-caption and uncond forwards of three-branch CFG set it).
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from benchmark import schedule, weights as W

NULL_TOKENS = 50  # valid tokens of the null caption


@dataclasses.dataclass
class Forward:
    """One DiT forward: latents [C, n * cw, H, W] (f32) of the segments at
    chunk positions `pos` (consecutive), their timesteps, caption choice and
    kv chunk ranges; `drop` each segment's caption dropout (all False when
    None), and `rope` the chunk positions the rotary embedding takes where
    they differ from `pos` (the uncond forward's are all 0).  With `kv_rows`
    [a, b), `velocities` keeps layer 0's keys (normed and roped) and values
    of those token rows in `kv0`, f32 [2, hk, b - a, hd] on the host, as a
    KV cache holds them."""

    x: torch.Tensor
    pos: List[int]
    t: List[float]
    text: List[bool]
    kv: List[Tuple[int, int]]
    kv_rows: Optional[Tuple[int, int]] = None
    kv0: Optional[torch.Tensor] = None
    drop: Optional[List[bool]] = None
    rope: Optional[List[int]] = None


def layer_norm(x, w, b, eps, zero_centered=False):
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    var = (xf - mean).square().mean(-1, keepdim=True)
    g = w.float() + (1.0 if zero_centered else 0.0)
    return ((xf - mean) * torch.rsqrt(var + eps)) * g + b.float()


def rotary(x, sin, cos):
    """GPT-NeoX rotary on the first 2 * rot dims of each head (f32)."""
    rot = sin.shape[-1]
    s, c = sin[:, None, :], cos[:, None, :]
    x1, x2, rest = x[..., :rot], x[..., rot : 2 * rot], x[..., 2 * rot :]
    return torch.cat([x1 * c - x2 * s, x1 * s + x2 * c, rest], dim=-1)


def rope(bands, pos: Sequence[int], tp: int, Hp: int, Wp: int, device):
    """sin, cos [n * tp * Hp * Wp, 3 * bands]: temporal positions from each
    segment's chunk position, spatial ones centred and rescaled by
    sqrt(Hp * Wp / 256)."""
    nb = bands.shape[0]
    t_pos = torch.tensor(pos, dtype=torch.float32, device=device)[:, None] * tp + torch.arange(
        tp, dtype=torch.float32, device=device)
    rescale = math.sqrt(Hp * Wp / 256)
    h_pos = torch.arange(Hp, dtype=torch.float32, device=device) - (Hp - 1) / 2
    w_pos = torch.arange(Wp, dtype=torch.float32, device=device) - (Wp - 1) / 2
    if Hp > 1:
        h_pos = h_pos / (Hp - 1) * (Hp / rescale - 1)
    if Wp > 1:
        w_pos = w_pos / (Wp - 1) * (Wp / rescale - 1)
    shape = (len(pos), tp, Hp, Wp, nb)
    p = torch.cat([(t_pos[:, :, None, None, None] * bands).expand(shape),
                   (h_pos[None, None, :, None, None] * bands).expand(shape),
                   (w_pos[None, None, None, :, None] * bands).expand(shape)], dim=-1).reshape(-1, 3 * nb)
    return torch.sin(p), torch.cos(p)


def timestep_embedding(t, dim=256):
    half = dim // 2
    freqs = torch.exp(-math.log(10000.0) * torch.arange(half, dtype=torch.float32, device=t.device) / half)
    args = t.float()[:, None] * freqs[None] * 1000.0
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


def _lin32(top, path, x):
    return x @ top[path + "/weight"].float() + top[path + "/bias"].float()


def t_embed(top, t):
    h = F.silu(_lin32(top, "t_embedder/mlp/0", timestep_embedding(t)))
    return _lin32(top, "t_embedder/mlp/2", h)


def quant_rows(x):
    """Per-row symmetric int8 of x (f32 or bf16): (q as f32, scale [rows])."""
    xf = x.float()
    amax = xf.abs().amax(-1)
    scale = torch.where(amax == 0, torch.ones_like(amax), amax / 127.0)
    return torch.round(xf / scale[:, None]).clamp(-127, 127), scale


def quant_weight(w, smooth=None):
    """Per-output-channel symmetric int8 of w [in, out] (f32(w) * s[:, None]
    when smoothed): (q as f32, scale [out])."""
    wf = w.float()
    if smooth is not None:
        wf = wf * smooth.float()[:, None]
    amax = wf.abs().amax(0)
    scale = torch.where(amax == 0, torch.ones_like(amax), amax / 127.0)
    return torch.round(wf / scale[None, :]).clamp(-127, 127), scale


class Linear:
    """A linear of one layer: bf16, or w8a8 with its int8 weight worked out
    here (and its smooth factor)."""

    def __init__(self, w, smooth=None, w8a8=False):
        self.w8a8 = w8a8
        self.smooth = smooth if w8a8 else None
        if not w8a8:
            self.w = w
            return
        q, self.scale = quant_weight(w, self.smooth)
        # int8 values are exact in bf16; on the card a bf16 product with f32
        # sums, elsewhere an f32 one: either sums the integers exactly
        self.wq = q.to(torch.bfloat16) if q.is_cuda else q

    def __call__(self, x):
        """x [M, in] -> [M, out] in x's dtype."""
        if not self.w8a8:
            return x @ self.w
        if self.smooth is not None:
            x = (x.float() / self.smooth.float()).to(x.dtype)
        xq, rs = quant_rows(x)
        if xq.is_cuda:
            acc = torch.mm(xq.to(torch.bfloat16), self.wq, out_dtype=torch.float32)
        else:
            acc = xq @ self.wq
        return (acc * rs[:, None] * self.scale[None, :]).to(x.dtype)


def attend(q, k, v, ranges, seg_len):
    """Segment i of q ([n * seg_len, hq, hd]) attends rows [a, b) of k, v
    ([*, hk, hd]); q head h reads kv head h // (hq // hk)."""
    rep = q.shape[1] // k.shape[1]
    outs = []
    for i, (a, b) in enumerate(ranges):
        qi = q[i * seg_len : (i + 1) * seg_len].transpose(0, 1)[None]
        ki = k[a:b].repeat_interleave(rep, dim=1).transpose(0, 1)[None]
        vi = v[a:b].repeat_interleave(rep, dim=1).transpose(0, 1)[None]
        o = F.scaled_dot_product_attention(qi, ki, vi)
        outs.append(o[0].transpose(0, 1))
    return torch.cat(outs, dim=0)


def patchify(x, tp, p):
    C, T, H, Wd = x.shape
    x = x.reshape(C, T // tp, tp, H // p, p, Wd // p, p).permute(1, 3, 5, 0, 2, 4, 6)
    return x.reshape((T // tp) * (H // p) * (Wd // p), C * tp * p * p)


def unpatchify(x, tp, p, C, Tp, Hp, Wp):
    x = x.reshape(Tp, Hp, Wp, tp, p, p, C).permute(6, 0, 3, 1, 4, 2, 5)
    return x.reshape(C, Tp * tp, Hp * p, Wp * p)


class _State:
    """A forward's activations between layers."""

    def __init__(self, fwd: Forward, h, cond, y_rows, sin, cos, ctn):
        self.fwd, self.h, self.cond, self.y_rows, self.sin, self.cos, self.ctn = fwd, h, cond, y_rows, sin, cos, ctn
        p0 = fwd.pos[0]
        self.ranges = [((a - p0) * ctn, (b - p0) * ctn) for a, b in fwd.kv]
        if any(a < 0 for a, _ in self.ranges) or fwd.pos != list(range(p0, p0 + len(fwd.pos))):
            raise ValueError("a segment attends a chunk the forward does not hold")


def velocities(cfg: dict, seed: int, device, forwards: List[Forward], caption: torch.Tensor, caption_len: int,
               smooth: Sequence[str] = ()) -> List[torch.Tensor]:
    """The DiT's output [C_out, n * cw, H, W] (f32) of each forward.  `cfg` is
    the run's program config dict; `caption` [L, 4096] f32 the request's
    caption embeddings, `caption_len` its valid tokens; `smooth` the linears
    that carry `act_smooth`."""
    mc, ec = cfg["model_config"], cfg["engine_config"]
    w8a8 = bool(ec.get("fp8_quant"))
    dt = W._dtype(mc["params_dtype"])
    leaves = list(W.dit_leaves(mc, tuple(smooth)))
    top = W.top_tree(leaves, seed, device)
    L, eps, zc = mc["num_layers"], mc["layernorm_epsilon"], mc["apply_layernorm_1p"]
    hd, hq, hk = mc["kv_channels"], mc["num_attention_heads"], mc["num_query_groups"]
    tp, p = mc["t_patch_size"], mc["patch_size"]
    cw = cfg["runtime_config"]["chunk_width"]
    null = top["y_embedder/null_caption_embedding"].float()
    # adaLN takes the null table's last row under caption dropout, its
    # second-to-last otherwise
    y_adaln = {False: _lin32(top, "y_embedder/y_proj_adaln/0", null[-2]),
               True: _lin32(top, "y_embedder/y_proj_adaln/0", null[-1])}
    caps = {True: (caption.float().to(device)[:caption_len], caption_len), False: (null[:NULL_TOKENS], NULL_TOKENS)}
    y_rows = {k: F.silu(_lin32(top, "y_embedder/y_proj_xattn/0", v[0])) for k, v in caps.items()}
    states = []
    for fwd in forwards:
        x = fwd.x.float().to(device) * mc["x_rescale_factor"]
        if mc["half_channel_vae"]:
            x = torch.cat([x, x], dim=0)
        _, T, H, Wd = x.shape
        Hp, Wp = H // p, Wd // p
        ctn = (cw // tp) * Hp * Wp
        h = (patchify(x, tp, p) @ top["x_embedder/weight"].float()).to(dt)
        sin, cos = rope(top["rope/bands"].float(), fwd.pos if fwd.rope is None else fwd.rope, cw // tp, Hp, Wp,
                        device)
        t = torch.tensor(fwd.t, dtype=torch.float32, device=device)
        t_emb = t_embed(top, t)
        if ec.get("distill"):
            dfac = schedule.distill_dt_factor(cfg["runtime_config"]["num_steps"])
            t_emb = t_emb + t_embed(top, torch.full_like(t, dfac))
        drop = fwd.drop or [False] * len(fwd.pos)
        states.append(_State(fwd, h, t_emb + torch.stack([y_adaln[d] for d in drop]), y_rows, sin, cos, ctn))
    for idx in range(L):
        blk = W.layer_tree(leaves, seed, device, idx, L)
        quant = w8a8 and 0 < idx < L - 1

        def lin(name):
            return Linear(blk[name + "/weight"], blk.get(name + "/act_smooth"), quant)

        a = "self_attention/"
        lins = {n: lin(a + n) for n in ("linear_qkv/q", "linear_qkv/qx", "linear_qkv/k", "linear_qkv/v",
                                          "linear_kv_xattn", "linear_proj")}
        lins.update({n: lin(n) for n in ("mlp/linear_fc1", "mlp/linear_fc2")})
        for st in states:
            st.h = _layer(blk, lins, mc, st, eps, zc, hd, hq, hk, keep_kv=idx == 0)
        del blk, lins
    outs = []
    for st in states:
        hf = layer_norm(st.h.float(), top["final_layernorm/weight"], top["final_layernorm/bias"], eps, zc)
        tok = hf @ top["final_linear/linear/weight"].float()
        _, T, H, Wd = st.fwd.x.shape
        out = unpatchify(tok, tp, p, mc["out_channels"], T // tp, H // p, Wd // p)
        if mc["half_channel_vae"]:
            out = out[: mc["out_channels"] // 2]
        outs.append(out / mc["x_rescale_factor"])
    return outs


def _post_norm(x, residual, gate, w, b, eps, zc, ctn):
    g = gate.repeat_interleave(ctn, dim=0)
    return (layer_norm(x.float() * g, w, b, eps, zc) + residual.float()).to(residual.dtype)


def _layer(blk, lins, mc, st: _State, eps, zc, hd, hq, hk, keep_kv=False):
    n, ctn = len(st.fwd.pos), st.ctn
    S = n * ctn
    a = "self_attention/"
    h = st.h
    dt = h.dtype
    ln = layer_norm(h, blk[a + "linear_qkv/layer_norm/weight"], blk[a + "linear_qkv/layer_norm/bias"], eps).to(dt)
    q, qx, k, v = (lins["linear_qkv/" + n_](ln) for n_ in ("q", "qx", "k", "v"))
    one = 1.0 if zc else 0.0
    # self-attention: q and k normed per head and roped in f32, cast to bf16
    qn = rotary(layer_norm(q.reshape(S, hq, hd), blk[a + "q_layernorm/weight"] + one, blk[a + "q_layernorm/bias"],
                           eps), st.sin, st.cos).to(dt)
    kn = rotary(layer_norm(k.reshape(S, hk, hd), blk[a + "k_layernorm/weight"] + one, blk[a + "k_layernorm/bias"],
                           eps), st.sin, st.cos).to(dt)
    core = attend(qn, kn, v.reshape(S, hk, hd), st.ranges, ctn)
    if keep_kv and st.fwd.kv_rows is not None:
        r0, r1 = st.fwd.kv_rows
        st.fwd.kv0 = torch.stack([kn[r0:r1], v.reshape(S, hk, hd)[r0:r1]]).transpose(1, 2).float().cpu()
    # caption cross-attention: q normed (no rope), the caption's k normed
    qxn = layer_norm(qx.reshape(S, hq, hd), blk[a + "q_layernorm_xattn/weight"].float() + one,
                     blk[a + "q_layernorm_xattn/bias"], eps).to(dt)
    kv_cap = {}
    for text, rows in st.y_rows.items():
        kv = lins["linear_kv_xattn"](rows.to(dt)).reshape(rows.shape[0], hk, 2 * hd)
        kx = layer_norm(kv[..., :hd], blk[a + "k_layernorm_xattn/weight"], blk[a + "k_layernorm_xattn/bias"], eps,
                        zc).to(dt)
        kv_cap[text] = (kx, kv[..., hd:])
    xattn = []
    for i, text in enumerate(st.fwd.text):
        kx, vx = kv_cap[text]
        xattn.append(attend(qxn[i * ctn : (i + 1) * ctn], kx, vx, [(0, kx.shape[0])], ctn))
    attn_out = torch.cat([core.reshape(S, hq * hd), torch.cat(xattn).reshape(S, hq * hd)], dim=-1)
    proj = lins["linear_proj"](attn_out)
    ada = F.silu(st.cond) @ blk["ada_modulate_layer/proj/0/weight"].float() + blk[
        "ada_modulate_layer/proj/0/bias"].float()
    gate = torch.tanh(ada)
    gh = gate.shape[-1] // 2
    x = _post_norm(proj, h, gate[:, :gh], blk["self_attn_post_norm/weight"], blk["self_attn_post_norm/bias"], eps,
                   zc, ctn)
    ln2 = layer_norm(x, blk["mlp/layer_norm/weight"], blk["mlp/layer_norm/bias"], eps).to(dt)
    h1 = lins["mlp/linear_fc1"](ln2)
    if mc["gated_linear_unit"]:
        d = h1.shape[-1] // 2
        h1 = F.silu(h1[:, :d].float()).to(dt) * h1[:, d:]
    else:
        h1 = F.gelu(h1.float()).to(dt)
    h2 = lins["mlp/linear_fc2"](h1)
    return _post_norm(h2, x, gate[:, gh:], blk["mlp_post_norm/weight"], blk["mlp_post_norm/bias"], eps, zc, ctn)

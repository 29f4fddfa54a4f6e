#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (`magi_tpu_torch`) on one GPU.

    python3 chip_smoke.py

Phases, each printed on its own line; any failure exits non-zero:
  1. build the CUDA kernels from `magi_tpu_torch/csrc` (build seconds);
  2. hold every kernel against its plain PyTorch version on the card at the
     shapes the t2v runs below give it, with the stated tolerance, and time
     kernel, plain version and a PyTorch library yardstick (CUDA events
     around a host loop of calls; K2, K2g, K3 and K3q, kernels of tens of
     microseconds, also as the device time of calls replayed in a CUDA
     graph, `graph_ms`), K2 also with the walk's captions (every one 50
     tokens, every one 7), K2g at the 720x720 decode's segments (timed
     only), K3 at the base 720x720 step's S = 48600 and K3q at the
     distill one's S = 60750 (checked and timed), and K1 and K2 at the
     packed forward's operands (`pack_uncond`: the window's segments, then
     uncond segments whose ranges lie in the current source past them;
     phase 12's widest step and two steps of a 144-frame walk whose window
     sits over cached chunks, taken from the sampler's own plan; K2 with
     text and null captions in one launch);
  3. tiny walks with the kernels against the same walks on the CPU in fp32
     (plain versions), same weights and noise: the 3-branch bf16 walk, the
     single-branch distill walk of an int8 tree with int8 attention, the
     same walk of a gated int4 tree without blocks_edge (K7 and K8s), the
     int8 walk on a smooth-folded tree (`act_smooth` in [0.5, 2] on the
     four smooth-quant linears, as an fp8 checkpoint loads) and the gated
     int4 walk without blocks_edge with its fc2 smoothed (the divide before
     K8 plain on K6 and K7, no K8s), and walks after a prefix video (v2v):
     the 3-branch walk, and the distill int8 walk under the K5 schemes sage
     and dq; the packed 3-branch walk (`pack_uncond`), and under the
     default kv ranges the host-streamed (`kv_offload`) 3-branch bf16 walk
     and distill int8 walk;
  4. the 4.5B base config at full width and depth (34 layers, 3072 wide,
     24/8 heads, caption 800 x 4096) through the port's CLI entry with
     random weights (SKIP_LOAD_MODEL=1) and 3-branch CFG, noise2clean kv
     ranges and window 4; only the traffic is cut (256x256, 96 frames,
     16 steps).  Every kernel of this path must launch in this run;
  5. the 4.5B distill + int8 config (example/4.5B/4.5B_distill_quant_config.json
     with engine_config.attn_int8) the same way: int8 weights and
     activations in the middle layers, the int8 KV cache, single-branch CFG with the
     nearly-clean ride-along chunk, the config's 16 steps; only the video
     is cut (256x256, 96 frames).  Every kernel of this path must launch in
     this run;
  6. the 24B distill config (example/24B/24B_distill_quant_config.json,
     48 layers, 6144 wide, 48/8 heads, gated MLP of 16384) on one device
     (cp_size 1) with quant_bits 4 and attn_int8, through the CLI entry:
     nibble-packed int4 weights (bf16 edge layers) unpacked to int8 per
     layer, int8 activations through K8 / K8s and K6, int8 attention; only
     the video is cut (720x1280 -> 256x256, 96 frames, the config's 16
     steps).  Every kernel of this path must launch in this run;
  7. the same 24B tree without blocks_edge (the JAX package's single-chip
     24B benchmark tree: edge layers on the dequant GEMM K7), walked by
     ArdfSampler.walk for 2 chunks at 256x256; K7 must launch and every
     chunk must be finite;
  8. image-to-video on the 4.5B base config (full width and depth,
     256x256, 96 frames, 16 steps, 3-branch CFG): one seeded uint8 frame
     through `encode_prefix_video` (the VAE encoder) and then
     `MagiPipeline._run`, the entry points below the image decoder.  Runs
     K1-K4, and K2g in the encoder and the decoder;
  9. video-to-video on the 4.5B distill + int8 config with int8 attention
     under MAGI_ATTN_Q8_SCHEME=sage, the same way from 32 seeded frames (8
     latent frames: one clean chunk written by the warm-up forward).  Runs
     K3q, K5 sage, K6, K8, K4 and K2g, and no other K5 scheme;
 10. image-to-video on the same config under MAGI_ATTN_Q8_SCHEME=dq.  Runs
     K5 dq and no other K5 scheme;
 11. phase 5's request on the 4.5B distill fp8 config with SKIP_LOAD_MODEL
     unset, from checkpoints written to a directory under `build/` in the
     released formats from seeded random weights, and deleted after: the
     DiT's `inference_weight.fp8.distill` at full width and depth (bf16
     edge layers, F8_E4M3 middle layers with per-tensor and smooth-quant
     scales, two shards and an index), a diffusers-format VAE of the
     shape `get_vae` makes, and an HF-layout T5 encoder at T5-XXL's width
     with 2 layers, tokenized by a stand-in (the card has no
     `transformers`).  Checks a middle layer's dequant on the card against
     the CPU's bit for bit, the T5 encode against the CPU's f32 encode,
     the video, and the launch counts against phase 5's (equal: the
     smooth-quant divide is a plain op before K8 plain); prints load
     seconds and GB/s, the step time against phase 5's, the divide's ms a
     step, the T5-XXL encode at L 800 resident and staged, and the peak
     memory;
 12. phase 4's request with `pack_uncond` (the uncond segments packed into
     the text forward: two DiT forwards a step) through the CLI entry with
     MAGI_PROFILE_DIR set: K1, K2, K3 launch 68 times a step and K4 136 (2/3
     of phase 4's), the walk's profiler trace must name K1's symbol; prints
     the step and the device peak against phase 4's;
 13. the host-streamed KV cache (`kv_offload` under the default kv
     ranges) against the resident cache, `ArdfSampler.walk` of phase 5's
     request (int8 host buffers: K3q and K5 `qk8` on streamed slabs) and
     of phase 4's (bf16: K1 and K3), the same weights and noise: latents
     and caches bit-equal, launches equal; prints the bytes copied a step
     and the link's rate, the step and the device peak of both;
 14. two requests on phase 5's config through the CLI entry, lockstep
     (`--prompts`) and interleaved (`--interleave`): twice phase 5's
     launches of every kernel; then each request of `DpBatchedSampler` and
     of `walk_many` bit-equal to its solo walk, fixed noises; prints the
     walls against two solo runs and the decode time the interleaved run
     hid;
 15. phase 4's and phase 5's requests through `ArdfSampler.walk`, eager
     (`capture=False`) and with the steps replayed from CUDA graphs, the
     same weights and noise: chunks bit-equal, launches equal kernel by
     kernel, one graph a step variant; prints the variants, graphs and
     capture seconds, the mean step, the idle share of a stage-3 step
     under torch.profiler and the device peak of each.
Phases 3-14 run as a user runs the port on the card: every denoise step
and every VAE encode and decode replayed from a CUDA graph (`core.graphs`,
captured before the walk; the capture's own launches are not counted).
Phases 8-10 check the frame count against the JAX package's for the same
request (i2v keeps its first chunk whole; v2v drops the prefix frames).
Phase 2 also checks K7 and K8s at phase 6-7's shapes, K8 at the 24B's
widths and K5 (each scheme, against the dequant reference too) and K1 at
its 48/8 heads.  Phase 6 holds a
quantization peak of about 57 GiB (the bf16 tree alive while it is
packed), so each main path starts from an emptied allocator cache.
Then the card's name and power limit, one JSON line of per-kernel results
(`launches_by_path` holds each main path's count, phases 4-15, read just
after its run; `launches` is their sum; K5's sage and dq rows come after
every other), and a last line `{"ok": true, "device": {...}}`.

TF32 is off for matmuls and convolutions (the VAE's final Conv3d would
otherwise run in TF32), so fp32 comparisons are exact-precision.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
import warnings

HERE = os.path.dirname(os.path.abspath(__file__))
CONFIG = os.path.join(HERE, "example", "4.5B", "4.5B_base_config.json")
QUANT_CONFIG = os.path.join(HERE, "example", "4.5B", "4.5B_distill_quant_config.json")
CONFIG_24B = os.path.join(HERE, "example", "24B", "24B_distill_quant_config.json")

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit)
PEAK_BF16_FLOPS = 989e12
PEAK_INT8_OPS = 1979e12
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES = 3.35e12
STEPS = 16  # denoise steps of the 4.5B base run (64 in the config)
# launches timed per kernel under 0.2 ms: a window of a few ms at least, so
# one clock change of the card does not move the mean much
SHORT_ITERS = 200


T0 = time.perf_counter()


def phase(msg: str) -> None:
    """A phase's header, with the seconds since the script started."""
    print(f"{msg} [{time.perf_counter() - T0:.1f} s]", flush=True)


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def cuda_ms(fn, iters: int) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, iters: int = 50) -> float:
    """The device time of one call of fn: `iters` calls captured in one CUDA
    graph and replayed, so no host time sits between the launches (a
    kernel of tens of microseconds can be quicker than the host's loop of
    wrapper calls).  A replay adds nothing to the wrappers' launch counts,
    which count the host's calls."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def int8_dot_library(x_q, row_scale, w_q, col_scale):
    """K6's library yardstick: `torch._int_mm` (cuBLASLt int8) and the f32
    epilogue of the plain version, cast to bf16."""
    import torch

    acc = torch._int_mm(x_q, w_q)
    return (acc.float() * row_scale[:, None] * col_scale[None, :]).to(torch.bfloat16)


def int8_dot_operand(x_q, w_q):
    """The weight `torch._int_mm` is timed on: the kernel's own k-major
    tensor where cuBLASLt takes it, else a row-major copy; and which."""
    import torch

    try:
        torch._int_mm(x_q, w_q)
        return w_q, "k-major, as the kernel's"
    except RuntimeError:
        return w_q.contiguous(), "a row-major copy (it refuses the k-major one)"


def warm_card(dev, seconds: float = 1.0) -> None:
    """Keep the card busy for a moment, so the first kernels timed do not
    run while its clocks still ramp up from idle."""
    import torch

    a = torch.randn((8192, 8192), device=dev, dtype=torch.bfloat16)
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        a @ a
        torch.cuda.synchronize()


def bound(nbytes: float, *work):
    """The least time for `nbytes` of traffic and `work` = (operations,
    peak rate) pairs, one per operand type: (ms, what bounds it)."""
    t_bytes, t_ops = nbytes / PEAK_BYTES, sum(ops / peak for ops, peak in work)
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def print_rate(name: str, ops: float, ms: float, bound_ms: float) -> None:
    """The rate an attention kernel reached (operations of both products,
    bf16 or int8, per second) beside its bound."""
    print(f"  {name}: {ops / ms / 1e9:.1f} T operations/s ({ops:.4e} in {ms:.4f} ms); bound {bound_ms:.4f} ms, "
          f"{bound_ms / ms:.1%} of it reached")


def span_tokens(starts, ends) -> int:
    """Tokens in the union of [start, end) ranges."""
    covered = set()
    for s, e in zip(starts.tolist(), ends.tolist()):
        covered.update(range(s, e))
    return len(covered)


def sdpa_ms(qn, kk, vv, valid, seg):
    """F.scaled_dot_product_attention on the same (prologue-applied) q with
    the equivalent boolean mask; token-major inputs."""
    import torch.nn.functional as F

    qb = qn.transpose(0, 1)[None]
    kb_ = kk.transpose(0, 1)[None]
    vb = vv.transpose(0, 1)[None]
    mask = valid.repeat_interleave(seg, dim=0)[None, None]
    return cuda_ms(lambda: F.scaled_dot_product_attention(qb, kb_, vb, attn_mask=mask, enable_gqa=True), 5)


# Attention tolerances.  A row attending n keys of unit-variance values has
# outputs of about n**-0.5: 0.02 to 0.04 for the self-attention's spans of
# 1536 to 7680 tokens and the VAE's 3073, so the limit must sit well below
# that for a dropped tile or a wrong range edge to show.  The errors come
# from q's bf16 rounding (after the sm_scale fold in the kernel, before it
# in the plain version) and from P's bf16 rounding for PV.  Only the
# captions of 50 and 7 tokens, whose outputs run up to about 3, take the
# loose limit (one or two bf16 ulps there).
ATTN_TOL = (4e-3, 1e-2)
SHORT_CAPTION_TOL = (2e-2, 2e-2)
# The int8 attention (qk8) against the dequant reference, which keeps q in
# bf16: q's int8 rounding (a step of amax/127 per row) moves each logit by
# about 1% of its spread, so the outputs move by about 1% as well.  The
# limit is the JAX package's own for its int8 kernel (tests/test_attention_q8.py):
# mean |error| under 4% of mean |output|.
Q8_DEQUANT_MEAN_REL = 0.04


def check_close(name, out, ref, atol, rtol):
    """Max abs error of a kernel's output against its plain version; fails
    unless |out - ref| <= atol + rtol*|ref| everywhere and out is finite."""
    import torch

    out, ref = out.float(), ref.float()
    max_err = float((out - ref).abs().max()) if out.numel() else 0.0
    rms = float(ref.square().mean().sqrt()) if ref.numel() else 0.0
    ok = bool(torch.isfinite(out).all()) and torch.allclose(out, ref, atol=atol, rtol=rtol)
    print(f"  {name}: max_abs_err {max_err:.3e}, rms of the plain output {rms:.3e} "
          f"(tolerance atol {atol} + rtol {rtol}*|ref|) {'ok' if ok else 'FAILED'}")
    if not ok:
        fail(f"{name} disagrees with its plain version")
    return max_err


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------


def kv_pack_inputs(dev, n: int, hk: int, hd: int, rot: int):
    """k, v [n, hk, hd] bf16 and sin, cos [n, rot] from a generator of
    their own (K3 and K3q at the 720x720 steps' shapes)."""
    import torch

    g = torch.Generator(device=dev)
    g.manual_seed(7)
    k, v = (torch.randn((n, hk, hd), generator=g, device=dev).bfloat16() for _ in range(2))
    ang = torch.rand((n, rot), generator=g, device=dev) * 6.28
    return k, v, torch.sin(ang), torch.cos(ang)


def packed_step_ranges(num_frames: int, stage: int, didx: int):
    """Forward A's operands of one packed step (`pack_uncond`) of phase 12's
    request (the 4.5B base config at 256x256, 16 steps) at `num_frames`:
    (n_seg, n_den, cache_sp, the global kv starts and ends of the window's
    segments and then of the uncond ones), as `_cfg3_step` builds them from
    the sampler's own plan (a one-layer sampler on the CPU; no forward)."""
    import numpy as np
    import torch

    from magi_tpu_torch.core.config import MagiConfig
    from magi_tpu_torch.sampling.transport import ArdfSampler, InferenceInput

    with open(CONFIG) as f:
        d = json.load(f)
    d["model_config"]["num_layers"] = 1
    d["runtime_config"].update(video_size_h=256, video_size_w=256, num_frames=num_frames, num_steps=STEPS)
    d["engine_config"]["pack_uncond"] = True
    cfg = MagiConfig.from_dict(d)
    rc = cfg.runtime_config
    T = num_frames // rc.temporal_downsample_factor
    n_chunks = T // rc.chunk_width
    inp = InferenceInput(caption_embs=torch.zeros(n_chunks, 1, 1), caption_lens=np.full(n_chunks, 7, np.int32),
                         null_emb=torch.zeros(1, 1), null_len=50, latent_size=(16, T, 32, 32), num_steps=STEPS,
                         chunk_num=n_chunks, has_text=True)
    s = ArdfSampler(cfg, None, inp, noise=torch.zeros(inp.latent_size), device="cpu")
    p = s._plan(stage * (STEPS // rc.window_size) + didx)
    n_seg, n_den, cache_sp = p["n_seg"], p["n_den"], p["sp"] - s.cache_base
    u = (cache_sp + n_seg + np.arange(n_den)) * s.ctn
    return (n_seg, n_den, cache_sp, s.cache_tokens, np.concatenate([p["kv_start"], u]),
            np.concatenate([p["kv_end"], u + s.ctn]))


def kernel_checks(dev):
    import torch
    import torch.nn.functional as F

    from magi_tpu_torch.ops import attention as A
    from magi_tpu_torch.ops import fused_norm as FN

    g = torch.Generator(device=dev)
    g.manual_seed(0)

    def randn(*shape, dtype=torch.bfloat16):
        return torch.randn(shape, generator=g, device=dev).to(dtype)

    # main-path shapes of the t2v run in phase 4: 4.5B widths, 256x256
    # latent 32x32 -> 16x16 patches, chunk 6 frames -> ctn 1536 tokens
    hq, hk, hd, D, rot, L = 24, 8, 128, 3072, 48, 800
    ctn, n_seg = 6 * 16 * 16, 4
    S = n_seg * ctn
    eps = 1e-6
    results = []

    # ---- K3 kv_norm_rope_pack -------------------------------------------
    def k3_bound(n):
        return bound(2 * n * hk * hd * 2 + 2 * n * rot * 4 + 2 * hd * 4 + 2 * n * hk * hd * 2,
                     (10 * n * hk * hd, PEAK_FP32_FLOPS))

    k, v = randn(S, hk, hd), randn(S, hk, hd)
    kw = 1.0 + 0.1 * randn(hd, dtype=torch.float32)
    kb = 0.1 * randn(hd, dtype=torch.float32)
    ang = torch.rand((S, rot), generator=g, device=dev) * 6.28
    sin, cos = torch.sin(ang), torch.cos(ang)
    call = lambda: A.kv_norm_rope_pack(k, v, kw, kb, sin, cos, eps=eps)
    out = call()
    ref = A.kv_norm_rope_pack_reference(k, v, kw, kb, sin, cos, eps=eps)
    err = check_close("kv_norm_rope_pack", out, ref, 1e-2, 1e-2)
    ms, g_ms = cuda_ms(call, SHORT_ITERS), graph_ms(call, SHORT_ITERS)
    plain_ms = cuda_ms(lambda: A.kv_norm_rope_pack_reference(k, v, kw, kb, sin, cos, eps=eps), 10)

    def lib_k3():
        kn = F.layer_norm(k.float(), (hd,), kw, kb, eps)
        x1, x2 = kn[..., :rot], kn[..., rot : 2 * rot]
        s_, c_ = sin[:, None], cos[:, None]
        kn = torch.cat([x1 * c_ - x2 * s_, x1 * s_ + x2 * c_, kn[..., 2 * rot :]], -1)
        return torch.stack([kn.bfloat16(), v]).transpose(1, 2).contiguous()

    lib_ms = cuda_ms(lib_k3, 10)
    bms, by = k3_bound(S)
    print(f"  kv_norm_rope_pack: a host loop of calls {ms:.4f} ms; calls replayed in a CUDA graph {g_ms:.4f} ms")
    # the base 720x720 step's shape: 4 segments of 90x90 latent patches x 6 frames
    S7 = 4 * 6 * 45 * 45
    k7, v7, sin7, cos7 = kv_pack_inputs(dev, S7, hk, hd, rot)
    call7 = lambda: A.kv_norm_rope_pack(k7, v7, kw, kb, sin7, cos7, eps=eps)
    check_close(f"kv_norm_rope_pack, S = {S7} (720x720)", call7(),
                A.kv_norm_rope_pack_reference(k7, v7, kw, kb, sin7, cos7, eps=eps), 1e-2, 1e-2)
    ms7, g_ms7 = cuda_ms(call7, 50), graph_ms(call7, 50)
    bms7, by7 = k3_bound(S7)
    print(f"  kv_norm_rope_pack, S = {S7}: a host loop of calls {ms7:.4f} ms; calls replayed in a CUDA graph "
          f"{g_ms7:.4f} ms; bound {bms7:.4f} ms by {by7}")
    results.append(dict(name="kv_norm_rope_pack", route="cuda", source="magi_tpu_torch/csrc/norm.cu",
                        replaces="magi_tpu/ops/attention.py:800", max_abs_err=err, ms=ms, plain_ms=plain_ms,
                        bound_ms=bms, bound_by=by, library_ms=lib_ms, graph_ms=g_ms,
                        base_720=dict(tokens=S7, ms=ms7, graph_ms=g_ms7, bound_ms=bms7, bound_by=by7)))
    del k7, v7, sin7, cos7

    # ---- K4 gate_norm_residual -------------------------------------------
    x, res = randn(S, D), randn(S, D)
    gate = torch.rand((n_seg, D), generator=g, device=dev) * 2 - 1
    w = 0.1 * randn(D, dtype=torch.float32)
    b = 0.1 * randn(D, dtype=torch.float32)
    kwargs = dict(eps=eps, zero_centered=True, n_seg=n_seg)
    out = FN.gate_norm_residual(x, res, gate, w, b, **kwargs)
    ref = FN.gate_norm_residual_reference(x, res, gate, w, b, **kwargs)
    err = check_close("gate_norm_residual", out, ref, 1e-2, 1e-2)
    ms = cuda_ms(lambda: FN.gate_norm_residual(x, res, gate, w, b, **kwargs), SHORT_ITERS)
    plain_ms = cuda_ms(lambda: FN.gate_norm_residual_reference(x, res, gate, w, b, **kwargs), 10)

    def lib_k4():
        xg = (x.float().view(n_seg, ctn, D) * gate[:, None]).view(S, D)
        return (F.layer_norm(xg, (D,), w + 1.0, b, eps) + res.float()).bfloat16()

    lib_ms = cuda_ms(lib_k4, 10)
    nbytes = 3 * S * D * 2 + n_seg * D * 4 + 2 * D * 4
    bms, by = bound(nbytes, (10 * S * D, PEAK_FP32_FLOPS))
    results.append(dict(name="gate_norm_residual", route="cuda", source="magi_tpu_torch/csrc/norm.cu",
                        replaces="magi_tpu/ops/fused_norm.py:70", max_abs_err=err, ms=ms, plain_ms=plain_ms,
                        bound_ms=bms, bound_by=by, library_ms=lib_ms))

    # ---- K1 segmented_attention_two_source ----------------------------------
    # step of the walk with 2 clean chunks in the cache and 4 current
    # segments whose noise2clean spans are 1, 2, 3 and 5 chunks
    q = randn(S, hq, hd)
    cache = torch.zeros((2, hk, 4 * ctn, hd), dtype=torch.bfloat16, device=dev)
    cache[:, :, : 2 * ctn] = randn(2, hk, 2 * ctn, hd)
    kv2 = A.kv_norm_rope_pack(randn(S, hk, hd), randn(S, hk, hd), kw, kb, sin, cos, eps=eps)
    sp = 2
    ge = torch.tensor([(sp + j + 1) * ctn for j in range(n_seg)], dtype=torch.int32, device=dev)
    gs = torch.clamp(ge - torch.tensor([1, 2, 3, 5], device=dev, dtype=torch.int32) * ctn, min=0)
    st = sp * ctn
    r1s, r1e = torch.clamp(gs, max=st), torch.clamp(ge, max=st)
    r2s, r2e = torch.clamp(gs - st, min=0), torch.clamp(ge - st, min=0)
    qw = 1.0 + 0.1 * randn(hd, dtype=torch.float32)
    qb = 0.1 * randn(hd, dtype=torch.float32)
    pro = (qw, qb, sin, cos, eps)
    err = 0.0
    call = lambda: A.segmented_attention_two_source(q, cache, kv2, r1s, r1e, r2s, r2e, seg_len=ctn, q_prologue=pro)
    out = call()
    qn = A.apply_q_prologue(q, pro)
    ref = A.segmented_attention_two_source_reference(qn, cache, kv2, r1s, r1e, r2s, r2e, seg_len=ctn)
    err = max(err, check_close("segmented_attention_two_source (cache + current)", out, ref, *ATTN_TOL))
    # the unconditional branch: empty source 1, self-only ranges
    empty = torch.zeros((2, hk, 0, hd), dtype=torch.bfloat16, device=dev)
    z = torch.zeros(n_seg, dtype=torch.int32, device=dev)
    us = torch.arange(n_seg, dtype=torch.int32, device=dev) * ctn
    out_u = A.segmented_attention_two_source(q, empty, kv2, z, z, us, us + ctn, seg_len=ctn, q_prologue=pro)
    ref_u = A.segmented_attention_two_source_reference(qn, empty, kv2, z, z, us, us + ctn, seg_len=ctn)
    err = max(err, check_close("segmented_attention_two_source (empty cache)", out_u, ref_u, *ATTN_TOL))
    # the packed forward A (`pack_uncond`, phase 12): the window's segments
    # over the cache, then n_den uncond segments whose ranges lie wholly in
    # the current source past the window's (source 1 empty for those rows).
    # Phase 12's widest step (4 chunks, stage 3: no cache before the
    # window) and, for 144 frames, the steps of stage 5 whose window sits
    # over 1 and 2 cached chunks (with and without the clean leading
    # chunk).  The plain version runs a segment at a time (its dense
    # scores of 9 segments would take 31 GB).
    packed_ms = {}
    for frames, stage, didx in ((96, 3, 1), (144, 5, 0), (144, 5, 1)):
        n_seg, n_den, cache_sp, cache_tok, gs_np, ge_np = packed_step_ranges(frames, stage, didx)
        n_all, st_p = n_seg + n_den, cache_sp * ctn
        gs_p, ge_p = (torch.as_tensor(a, dtype=torch.int32, device=dev) for a in (gs_np, ge_np))
        p1s, p1e = torch.clamp(gs_p, max=st_p), torch.clamp(ge_p, max=st_p)
        p2s, p2e = torch.clamp(gs_p - st_p, min=0), torch.clamp(ge_p - st_p, min=0)
        u = slice(n_seg, n_all)
        if bool((p1e[u] > p1s[u]).any()) or not bool((p2s[u] >= n_seg * ctn).all()):
            fail(f"packed step ({frames} frames, stage {stage}): an uncond range reaches the cache or the window")
        q_p = randn(n_all * ctn, hq, hd)
        ang_p = torch.rand((n_all * ctn, rot), generator=g, device=dev) * 6.28
        pro_p = (qw, qb, torch.sin(ang_p), torch.cos(ang_p), eps)
        cache_p = randn(2, hk, cache_tok, hd)  # every token set: a read past r1 would show
        kv2_p = A.kv_norm_rope_pack(randn(n_all * ctn, hk, hd), randn(n_all * ctn, hk, hd), kw, kb,
                                    pro_p[2], pro_p[3], eps=eps)
        call_p = lambda: A.segmented_attention_two_source(q_p, cache_p, kv2_p, p1s, p1e, p2s, p2e, seg_len=ctn,
                                                          q_prologue=pro_p)
        qn_p = A.apply_q_prologue(q_p, pro_p)
        ref_p = torch.cat([A.segmented_attention_two_source_reference(
            qn_p[i * ctn : (i + 1) * ctn], cache_p, kv2_p, p1s[i : i + 1], p1e[i : i + 1], p2s[i : i + 1],
            p2e[i : i + 1], seg_len=ctn) for i in range(n_all)])
        name = (f"segmented_attention_two_source (packed forward A, {frames} frames, stage {stage} step {didx}: "
                f"{n_seg} + {n_den} segments, window over {cache_sp} cached chunks)")
        err = max(err, check_close(name, call_p(), ref_p, *ATTN_TOL))
        packed_ms[f"{n_seg}+{n_den}@{cache_sp}"] = cuda_ms(call_p, 10)
        del q_p, cache_p, kv2_p, qn_p, ref_p
    print(f"  segmented_attention_two_source, packed forward A (segments + uncond @ cached chunks): "
          + ", ".join(f"{k} {v:.4f} ms" for k, v in packed_ms.items()))
    ms = cuda_ms(call, 10)
    plain_ms = cuda_ms(
        lambda: A.segmented_attention_two_source_reference(
            A.apply_q_prologue(q, pro), cache, kv2, r1s, r1e, r2s, r2e, seg_len=ctn), 2)
    L1 = cache.shape[2]
    kk = torch.cat([cache[0].transpose(0, 1), kv2[0].transpose(0, 1)])
    vv = torch.cat([cache[1].transpose(0, 1), kv2[1].transpose(0, 1)])
    col = torch.arange(kk.shape[0], device=dev)[None]
    valid = ((col >= r1s[:, None]) & (col < r1e[:, None])) | ((col >= r2s[:, None] + L1) & (col < r2e[:, None] + L1))
    lib_ms = sdpa_ms(qn, kk, vv, valid, ctn)
    attended = int(((r1e - r1s) + (r2e - r2s)).sum())
    kv_bytes = (span_tokens(r1s, r1e) + span_tokens(r2s, r2e)) * 2 * hk * hd * 2
    nbytes = 2 * S * hq * hd * 2 + kv_bytes + 2 * S * rot * 4
    bms, by = bound(nbytes, (4 * ctn * attended * hd * hq, PEAK_BF16_FLOPS))
    print_rate("segmented_attention_two_source", 4 * ctn * attended * hd * hq, ms, bms)
    results.append(dict(name="segmented_attention_two_source", route="cuda",
                        source="magi_tpu_torch/csrc/attention_tma.cu",
                        replaces="magi_tpu/ops/attention.py:1241", max_abs_err=err, ms=ms, plain_ms=plain_ms,
                        bound_ms=bms, bound_by=by, library_ms=lib_ms))

    # ---- K2 segmented_attention_v2: caption cross-attention ---------------
    kx, vx = randn(n_seg * L, hk, hd), randn(n_seg * L, hk, hd)
    xs_ = torch.arange(n_seg, dtype=torch.int32, device=dev) * L
    xe = xs_ + torch.tensor([50, 7, 800, 0], dtype=torch.int32, device=dev)  # an empty caption too
    pro_x = (qw, qb, None, None, eps)
    call = lambda: A.segmented_attention_v2(q, kx, vx, xs_, xe, seg_len=ctn, q_prologue=pro_x)
    out = call()
    qn = A.apply_q_prologue(q, pro_x)
    ref = A.segmented_attention_reference(qn, kx, vx, xs_, xe, seg_len=ctn)
    err = max(check_close("segmented_attention_v2 (captions of 50 and 7 tokens)", out[: 2 * ctn], ref[: 2 * ctn],
                          *SHORT_CAPTION_TOL),
              check_close("segmented_attention_v2 (captions of 800 and 0 tokens)", out[2 * ctn :], ref[2 * ctn :],
                          *ATTN_TOL))
    if not bool((out[3 * ctn :] == 0).all()):
        fail("segmented_attention_v2: the empty caption's segment is not 0")
    ms, g_ms = cuda_ms(call, 20), graph_ms(call)
    # the same captions through the two-source kernel with an empty cache:
    # what a single-source kernel gains over the two-source loop
    kv_cap = torch.stack([kx, vx]).transpose(1, 2).contiguous()
    empty = torch.zeros((2, hk, 0, hd), dtype=torch.bfloat16, device=dev)
    z = torch.zeros(n_seg, dtype=torch.int32, device=dev)
    via_k1 = lambda: A.segmented_attention_two_source(q, empty, kv_cap, z, z, xs_, xe, seg_len=ctn, q_prologue=pro_x)
    k1_diff = float((via_k1().float() - out.float()).abs().max())
    k1_ms, v2_ms = cuda_ms(via_k1, 20), cuda_ms(call, 20)
    print(f"  captions through the two-source kernel (empty cache): {k1_ms:.4f} ms against "
          f"segmented_attention_v2's {v2_ms:.4f} ms in the same call; max |difference| {k1_diff:.3e}")
    plain_ms = cuda_ms(lambda: A.segmented_attention_reference(
        A.apply_q_prologue(q, pro_x), kx, vx, xs_, xe, seg_len=ctn), 3)
    col = torch.arange(n_seg * L, device=dev)[None]
    lib_ms = sdpa_ms(qn, kx, vx, (col >= xs_[:, None]) & (col < xe[:, None]), ctn)

    def k2_bound(starts, ends):
        attended = int((ends - starts).sum())
        nbytes = 2 * S * hq * hd * 2 + span_tokens(starts, ends) * 2 * hk * hd * 2
        return 4 * ctn * attended * hd * hq, bound(nbytes, (4 * ctn * attended * hd * hq, PEAK_BF16_FLOPS))

    ops, (bms, by) = k2_bound(xs_, xe)
    print(f"  segmented_attention_v2: a host loop of calls {ms:.4f} ms; calls replayed in a CUDA graph {g_ms:.4f} ms")
    print_rate("segmented_attention_v2", ops, ms, bms)
    # the walk's captions: the null caption (50 tokens) and a short prompt
    # under SKIP_LOAD_MODEL (word count + 2), every segment alike
    walk = {}
    for n in (50, 7):
        xe_n = xs_ + n
        call_n = lambda xe_n=xe_n: A.segmented_attention_v2(q, kx, vx, xs_, xe_n, seg_len=ctn, q_prologue=pro_x)
        check_close(f"segmented_attention_v2 (every caption {n} tokens)", call_n(),
                    A.segmented_attention_reference(qn, kx, vx, xs_, xe_n, seg_len=ctn), *SHORT_CAPTION_TOL)
        n_ops, (n_bms, n_by) = k2_bound(xs_, xe_n)
        n_ms, n_gms = cuda_ms(call_n, 20), graph_ms(call_n)
        print_rate(f"segmented_attention_v2, every caption {n} tokens", n_ops, n_ms, n_bms)
        walk[str(n)] = dict(ms=n_ms, graph_ms=n_gms, bound_ms=n_bms, bound_by=n_by)
    # the packed forward A's captions in one launch (the 144-frame stage-5
    # step over 1 cached chunk): the clean leading chunk's null caption,
    # 4 text captions, then the 4 uncond segments' null captions
    lens_p = [50] + [7] * 4 + [50] * 4
    n_p = len(lens_p)
    q_p, kx_p, vx_p = randn(n_p * ctn, hq, hd), randn(n_p * L, hk, hd), randn(n_p * L, hk, hd)
    xs_p = torch.arange(n_p, dtype=torch.int32, device=dev) * L
    xe_p = xs_p + torch.tensor(lens_p, dtype=torch.int32, device=dev)
    qn_p = A.apply_q_prologue(q_p, pro_x)
    ref_p = torch.cat([A.segmented_attention_reference(qn_p[i * ctn : (i + 1) * ctn], kx_p, vx_p, xs_p[i : i + 1],
                                                       xe_p[i : i + 1], seg_len=ctn) for i in range(n_p)])
    err = max(err, check_close(f"segmented_attention_v2 (packed forward A: {n_p} segments, caption tokens {lens_p})",
                               A.segmented_attention_v2(q_p, kx_p, vx_p, xs_p, xe_p, seg_len=ctn, q_prologue=pro_x),
                               ref_p, *SHORT_CAPTION_TOL))
    del q_p, kx_p, vx_p, qn_p, ref_p
    results.append(dict(name="segmented_attention_v2", route="cuda", source="magi_tpu_torch/csrc/attention.cu",
                        replaces="magi_tpu/ops/attention.py:678", max_abs_err=err, ms=ms, plain_ms=plain_ms,
                        bound_ms=bms, bound_by=by, library_ms=lib_ms, graph_ms=g_ms, every_caption_tokens=walk))

    # ---- K2g segmented_attention: VAE self-attention, head_dim 64 --------
    N, B, hv, hdv = 3 * 32 * 32 + 1, 2, 16, 64  # a 3-latent-frame tile + cls, 2 tiles per chunk
    qv, kv_, vv_ = randn(B * N, hv, hdv), randn(B * N, hv, hdv), randn(B * N, hv, hdv)
    st_ = torch.arange(B, dtype=torch.int32, device=dev) * N
    call = lambda: A.segmented_attention(qv, kv_, vv_, st_, st_ + N, seg_len=N)
    out = call()
    ref = A.segmented_attention_reference(qv, kv_, vv_, st_, st_ + N, seg_len=N)
    err = check_close("segmented_attention (VAE, hd 64)", out, ref, *ATTN_TOL)
    ms, g_ms = cuda_ms(call, 20), graph_ms(call)
    plain_ms = cuda_ms(lambda: A.segmented_attention_reference(qv, kv_, vv_, st_, st_ + N, seg_len=N), 3)
    col = torch.arange(B * N, device=dev)[None]
    lib_ms = sdpa_ms(qv, kv_, vv_, (col >= st_[:, None]) & (col < st_[:, None] + N), N)

    def k2g_bound(n):
        return 4 * B * n * n * hdv * hv, bound(4 * B * n * hv * hdv * 2, (4 * B * n * n * hdv * hv, PEAK_BF16_FLOPS))

    ops, (bms, by) = k2g_bound(N)
    print(f"  segmented_attention: a host loop of calls {ms:.4f} ms; calls replayed in a CUDA graph {g_ms:.4f} ms")
    print_rate("segmented_attention", ops, ms, bms)
    # the 720x720 decode's segments (3 latent frames of 90x90 + cls), timed
    # only: the plain version's scores would need 75 GB
    N7 = 3 * 90 * 90 + 1
    q7, k7, v7 = randn(B * N7, hv, hdv), randn(B * N7, hv, hdv), randn(B * N7, hv, hdv)
    s7 = torch.arange(B, dtype=torch.int32, device=dev) * N7
    call7 = lambda: A.segmented_attention(q7, k7, v7, s7, s7 + N7, seg_len=N7)
    if not bool(torch.isfinite(call7().float()).all()):
        fail("segmented_attention at the 720x720 decode's shape is not finite")
    ops7, (bms7, by7) = k2g_bound(N7)
    ms7 = cuda_ms(call7, 5)
    print_rate(f"segmented_attention, 2 segments of {N7} tokens (720x720 decode)", ops7, ms7, bms7)
    results.append(dict(name="segmented_attention", route="cuda", source="magi_tpu_torch/csrc/attention.cu",
                        replaces="magi_tpu/ops/attention.py:307", max_abs_err=err, ms=ms, plain_ms=plain_ms,
                        bound_ms=bms, bound_by=by, library_ms=lib_ms, graph_ms=g_ms,
                        decode_720=dict(tokens=N7, ms=ms7, bound_ms=bms7, bound_by=by7)))
    for r in results:
        print(f"  {r['name']}: {r['ms']:.4f} ms (plain {r['plain_ms']:.4f}, library {r['library_ms']:.4f}, "
              f"bound {r['bound_ms']:.4f} by {r['bound_by']})")
    return results


def int8_kernel_checks(dev):
    """K3q, K5 (qk8, sage, dq), K6 and K8 at the shapes of phase 5's widest
    step: 4 denoised segments of 1536 tokens and the ride-along copy (S =
    7680), two clean chunks in an int8 cache of 6144 tokens, captions of
    800.  Returns (the rows of qk8 and the others, the rows of sage and
    dq)."""
    import torch
    import torch.nn.functional as F

    from magi_tpu_torch.ops import act_quant as AQ
    from magi_tpu_torch.ops import attention as A
    from magi_tpu_torch.ops import attention_q8 as A8
    from magi_tpu_torch.ops import quant as Q

    g = torch.Generator(device=dev)
    g.manual_seed(1)

    def randn(*shape, dtype=torch.bfloat16):
        return torch.randn(shape, generator=g, device=dev).to(dtype)

    hq, hk, hd, D, rot, L, ffn = 24, 8, 128, 3072, 48, 800, 12288
    ctn, n_seg = 6 * 16 * 16, 5
    S = n_seg * ctn
    eps = 1e-6
    results = []

    def int8_chain(v):
        """Library yardstick tail: amax, scale, round and cast in a few calls."""
        scale = v.abs().amax(-1, keepdim=True).clamp(min=1e-8) / 127.0
        return torch.round(v / scale).clamp_(-127, 127).to(torch.int8), scale

    # ---- K3q kv_norm_rope_pack(quantize=True) ------------------------------
    def k3q_bound(n):
        return bound(2 * n * hk * hd * 2 + 2 * n * rot * 4 + 2 * hd * 4 + 2 * n * hk * hd + 2 * n * hk * 4,
                     (12 * n * hk * hd, PEAK_FP32_FLOPS))

    def k3q_check(name, k, v, sin, cos):
        """The int8 values at most one step off on under 1e-3 of them and
        the scales within 1e-6 relative; returns the largest error of the
        dequantized kv."""
        q8, sc = A.kv_norm_rope_pack(k, v, kw, kb, sin, cos, eps=eps, quantize=True)
        ref8, ref_sc = A.kv_norm_rope_pack_q8_reference(k, v, kw, kb, sin, cos, eps=eps)
        torch.cuda.synchronize()
        dq = (q8.int() - ref8.int()).abs()
        share = float((dq > 0).float().mean())
        sc_rel = float(((sc - ref_sc).abs() / ref_sc).max())
        err = float((q8.float() * sc[..., None] - ref8.float() * ref_sc[..., None]).abs().max())
        ok = int(dq.max()) <= 1 and share < 1e-3 and sc_rel <= 1e-6
        print(f"  {name}: int8 values off by one step on a share {share:.3e} (limit 1e-3, none by more), "
              f"scales within {sc_rel:.3e} relative (limit 1e-6), max abs error of the dequantized kv {err:.3e} "
              f"{'ok' if ok else 'FAILED'}")
        if not ok:
            fail(f"{name} disagrees with its plain version")
        return err

    k, v = randn(S, hk, hd), randn(S, hk, hd)
    kw = 1.0 + 0.1 * randn(hd, dtype=torch.float32)
    kb = 0.1 * randn(hd, dtype=torch.float32)
    ang = torch.rand((S, rot), generator=g, device=dev) * 6.28
    sin, cos = torch.sin(ang), torch.cos(ang)
    call = lambda: A.kv_norm_rope_pack(k, v, kw, kb, sin, cos, eps=eps, quantize=True)
    err = k3q_check("kv_norm_rope_pack_q8", k, v, sin, cos)
    ms, g_ms = cuda_ms(call, SHORT_ITERS), graph_ms(call, SHORT_ITERS)
    plain_ms = cuda_ms(lambda: A.kv_norm_rope_pack_q8_reference(k, v, kw, kb, sin, cos, eps=eps), 10)

    def lib_k3q():
        kn = F.layer_norm(k.float(), (hd,), kw, kb, eps)
        x1, x2 = kn[..., :rot], kn[..., rot : 2 * rot]
        s_, c_ = sin[:, None], cos[:, None]
        kn = torch.cat([x1 * c_ - x2 * s_, x1 * s_ + x2 * c_, kn[..., 2 * rot :]], -1)
        return int8_chain(torch.stack([kn, v.float()]).transpose(1, 2))

    lib_ms = cuda_ms(lib_k3q, 10)
    bms, by = k3q_bound(S)
    print(f"  kv_norm_rope_pack_q8: a host loop of calls {ms:.4f} ms; calls replayed in a CUDA graph {g_ms:.4f} ms")
    # the distill 720x720 step's shape: 4 segments of 90x90 latent patches x
    # 6 frames and the ride-along copy
    S7 = 5 * 6 * 45 * 45
    k7, v7, sin7, cos7 = kv_pack_inputs(dev, S7, hk, hd, rot)
    k3q_check(f"kv_norm_rope_pack_q8, S = {S7} (720x720)", k7, v7, sin7, cos7)
    call7 = lambda: A.kv_norm_rope_pack(k7, v7, kw, kb, sin7, cos7, eps=eps, quantize=True)
    ms7, g_ms7 = cuda_ms(call7, 50), graph_ms(call7, 50)
    bms7, by7 = k3q_bound(S7)
    print(f"  kv_norm_rope_pack_q8, S = {S7}: a host loop of calls {ms7:.4f} ms; calls replayed in a CUDA graph "
          f"{g_ms7:.4f} ms; bound {bms7:.4f} ms by {by7}")
    results.append(dict(name="kv_norm_rope_pack_q8", route="cuda", source="magi_tpu_torch/csrc/norm.cu",
                        replaces="magi_tpu/ops/attention.py:812", max_abs_err=err, ms=ms, plain_ms=plain_ms,
                        bound_ms=bms, bound_by=by, library_ms=lib_ms, graph_ms=g_ms,
                        distill_720=dict(tokens=S7, ms=ms7, graph_ms=g_ms7, bound_ms=bms7, bound_by=by7)))
    del k7, v7, sin7, cos7

    # ---- K5 segmented_attention_two_source_q8: qk8, sage, dq ---------------
    # cache of 2 clean chunks (int8), 4 current segments whose noise2clean
    # spans are 1, 2, 3 and 5 chunks, and the ride-along copy attending itself
    q = randn(S, hq, hd)
    L1 = 4 * ctn
    cache8 = torch.zeros((2, hk, L1, hd), dtype=torch.int8, device=dev)
    cache_sc = torch.zeros((2, hk, L1), device=dev)
    cache8[:, :, : 2 * ctn], cache_sc[:, :, : 2 * ctn] = A8.quantize_kv_per_token(randn(2, hk, 2 * ctn, hd))
    kv8, kv_sc = A.kv_norm_rope_pack(randn(S, hk, hd), randn(S, hk, hd), kw, kb, sin, cos, eps=eps, quantize=True)
    sp = 2
    i32 = dict(dtype=torch.int32, device=dev)
    ge = torch.tensor([(sp + j + 1) * ctn for j in range(4)] + [(sp + 5) * ctn], **i32)
    gs = torch.clamp(ge - torch.tensor([1, 2, 3, 5, 1], **i32) * ctn, min=0)
    st = sp * ctn
    r1s, r1e = torch.clamp(gs, max=st), torch.clamp(ge, max=st)
    r2s, r2e = torch.clamp(gs - st, min=0), torch.clamp(ge - st, min=0)
    qw = 1.0 + 0.1 * randn(hd, dtype=torch.float32)
    qb = 0.1 * randn(hd, dtype=torch.float32)
    pro = (qw, qb, sin, cos, eps)
    args = (q, cache8, cache_sc, kv8, kv_sc, r1s, r1e, r2s, r2e)
    qn = A.apply_q_prologue(q, pro)
    deq = A8.segmented_attention_two_source_q8_reference(qn, *args[1:], seg_len=ctn).float()
    dq1 = (cache8.float() * cache_sc[..., None]).bfloat16()
    dq2 = (kv8.float() * kv_sc[..., None]).bfloat16()
    kk = torch.cat([dq1[0].transpose(0, 1), dq2[0].transpose(0, 1)])
    vv = torch.cat([dq1[1].transpose(0, 1), dq2[1].transpose(0, 1)])
    col = torch.arange(kk.shape[0], device=dev)[None]
    valid = ((col >= r1s[:, None]) & (col < r1e[:, None])) | ((col >= r2s[:, None] + L1) & (col < r2e[:, None] + L1))
    lib_ms = sdpa_ms(qn, kk, vv, valid, ctn)
    attended = int(((r1e - r1s) + (r2e - r2s)).sum())
    tokens = span_tokens(r1s, r1e) + span_tokens(r2s, r2e)
    nbytes = 2 * S * hq * hd * 2 + tokens * 2 * hk * (hd + 4) + 2 * S * rot * 4
    work = 2 * ctn * attended * hd * hq
    # the int8 caption cross-attention: captions as source 1, source 2 empty
    xl = torch.tensor([50, 7, 800, 0, 800], **i32)
    cap8, cap_sc = A8.quantize_kv_per_token(randn(2, hk, n_seg * L, hd))
    xs_ = torch.arange(n_seg, **i32) * L
    z = torch.zeros(n_seg, **i32)
    xargs = (q, cap8, cap_sc, cap8[:, :, :0], cap_sc[:, :, :0], xs_, xs_ + xl, z, z)
    pro_x = (qw, qb, None, None, eps)
    # each scheme against its plain version (sage and dq tiled at the
    # kernel's tile width) and the dequant reference, which does not
    # quantize q; the bound takes each product at its operand type's peak.
    # The rows of sage and dq go after every earlier kernel's.
    scheme_results = []
    for scheme, peaks in (("qk8", (PEAK_INT8_OPS, PEAK_BF16_FLOPS)), ("sage", (PEAK_INT8_OPS, PEAK_INT8_OPS)),
                          ("dq", (PEAK_BF16_FLOPS, PEAK_BF16_FLOPS))):
        name = "segmented_attention_two_source_q8" + ("" if scheme == "qk8" else f"_{scheme}")
        wrapper = getattr(A8, name)
        plain = getattr(A8, f"segmented_attention_two_source_q8_{scheme}_reference")
        call = lambda: A8.segmented_attention_two_source_q8(*args, seg_len=ctn, q_prologue=pro, scheme=scheme)
        before = wrapper.launches
        out = call()
        if wrapper.launches != before + 1:
            fail(f"{name} did not launch its kernel")
        err = check_close(f"{name} (int8 cache + current, ride-along)", out,
                          plain(*args, seg_len=ctn, q_prologue=pro), *ATTN_TOL)
        mean_rel = float((out.float() - deq).abs().mean() / deq.abs().mean())
        print(f"  {name} against the dequant reference: mean |error| / mean |output| {mean_rel:.3e}, max abs error "
              f"{float((out.float() - deq).abs().max()):.3e} (limit {Q8_DEQUANT_MEAN_REL}) "
              f"{'ok' if mean_rel < Q8_DEQUANT_MEAN_REL else 'FAILED'}")
        if mean_rel >= Q8_DEQUANT_MEAN_REL:
            fail(f"{name} strays from the dequant reference")
        ms = cuda_ms(call, 10)
        plain_ms = cuda_ms(lambda: plain(*args, seg_len=ctn, q_prologue=pro), 2)
        xcall = lambda: A8.segmented_attention_two_source_q8(*xargs, seg_len=ctn, q_prologue=pro_x, scheme=scheme)
        xout = xcall()
        xref = plain(*xargs, seg_len=ctn, q_prologue=pro_x)
        err = max(err, check_close(f"{name} (captions of 50 and 7 tokens)", xout[: 2 * ctn], xref[: 2 * ctn],
                                   *SHORT_CAPTION_TOL),
                  check_close(f"{name} (captions of 800, 0 and 800 tokens)", xout[2 * ctn :], xref[2 * ctn :],
                              *ATTN_TOL))
        print(f"  {name} on the captions: {cuda_ms(xcall, 20):.4f} ms")
        bms, by = bound(nbytes, (work, peaks[0]), (work, peaks[1]))
        print_rate(name, 2 * work, ms, bms)
        (results if scheme == "qk8" else scheme_results).append(dict(
            name=name, route="cuda",
            source="magi_tpu_torch/csrc/attention_tma.cu",
            replaces="magi_tpu/ops/attention_q8.py:631", max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bms,
            bound_by=by, library_ms=lib_ms))

    # ---- K6 quantized_matmul_i8: one middle layer's 8 GEMMs ----------------
    # (rows, k, n, launches per layer): q, qx / k, v / kv_xattn / proj / fc1 / fc2
    gemms = [(S, D, hq * hd, 2), (S, D, hk * hd, 2), (n_seg * L, D, 2 * hk * hd, 1), (S, 2 * hq * hd, D, 1),
             (S, D, ffn, 1), (S, ffn, D, 1)]
    tot = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bound_s=0.0, bytes_s=0.0)
    n_launch = sum(c for *_, c in gemms)
    for m, kk_, n, count in gemms:
        xq, rs = Q.act_quant_rowwise(randn(m, kk_))
        # k-major, as the quantized trees store it
        wq = torch.randint(-127, 128, (n, kk_), generator=g, device=dev, dtype=torch.int8).t()
        ws = torch.rand((n,), generator=g, device=dev) * 1e-3
        out = Q.quantized_matmul_i8(xq, rs, wq, ws)
        ref = Q.quantized_matmul_i8_reference(xq, rs, wq, ws)
        torch.cuda.synchronize()
        if not torch.equal(out, ref):
            fail(f"quantized_matmul_i8 [{m}x{kk_}] @ [{kk_}x{n}] is not bit-equal to its plain version")
        t = cuda_ms(lambda: Q.quantized_matmul_i8(xq, rs, wq, ws), 20)
        tp = cuda_ms(lambda: Q.quantized_matmul_i8_reference(xq, rs, wq, ws), 3)
        wl, how = int8_dot_operand(xq, wq)
        tl = cuda_ms(lambda: int8_dot_library(xq, rs, wl, ws), 20)
        del wl
        nbytes = m * kk_ + kk_ * n + 4 * (m + n) + 2 * m * n
        t_ops = 2 * m * n * kk_ / PEAK_INT8_OPS
        bms = max(t_ops, nbytes / PEAK_BYTES) * 1e3
        print(f"  quantized_matmul_i8 [{m}x{kk_}] @ [{kk_}x{n}]: bit-equal; {t:.4f} ms ({2 * m * n * kk_ / t / 1e9:.1f} "
              f"TOP/s, {bms / t:.0%} of the bound), torch._int_mm + epilogue {tl:.4f} ms on {how}, "
              f"bound {bms:.4f} ms")
        tot["ms"] += count * t
        tot["plain_ms"] += count * tp
        tot["library_ms"] += count * tl
        tot["bound_s"] += count * t_ops
        tot["bytes_s"] += count * nbytes / PEAK_BYTES
    results.append(dict(name="quantized_matmul_i8", route="cuda", source="magi_tpu_torch/csrc/quant.cu",
                        replaces="magi_tpu/ops/quant.py:199", max_abs_err=0.0, ms=tot["ms"] / n_launch,
                        plain_ms=tot["plain_ms"] / n_launch, library_ms=tot["library_ms"] / n_launch,
                        bound_ms=max(tot["bound_s"], tot["bytes_s"]) * 1e3 / n_launch,
                        bound_by="operations" if tot["bound_s"] >= tot["bytes_s"] else "bytes"))
    print(f"  quantized_matmul_i8, per launch over one layer's {n_launch}: bit-equal everywhere")

    # ---- K8 rowquant_fused: one middle layer's 5 row quantizations ---------
    rows = [("ln", S, D, 2), ("plain", n_seg * L, D, 1), ("plain", S, 2 * hq * hd, 1), ("plain", S, ffn, 1)]
    tot = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bound_s=0.0)
    n_launch = sum(c for *_, c in rows)
    for mode, m, width, count in rows:
        x = (3 * torch.randn((m, width), generator=g, device=dev)).to(torch.bfloat16)
        w, b = (1.0 + 0.1 * randn(width, dtype=torch.float32), 0.1 * randn(width, dtype=torch.float32))
        if mode == "plain":
            w = b = None
        call = lambda: AQ.rowquant_fused(x, mode, w, b, eps=eps)
        q8, sc = call()
        ref8, ref_sc = AQ.rowquant_fused_reference(x, mode, w, b, eps=eps)
        torch.cuda.synchronize()
        if not (torch.equal(q8, ref8) and torch.equal(sc, ref_sc)):
            fail(f"rowquant_fused {mode} [{m}x{width}] is not bit-equal to its plain version")

        def lib():
            v_ = x.float() if mode == "plain" else F.layer_norm(x.float(), (width,), w, b, eps).bfloat16().float()
            return int8_chain(v_)

        t, tp, tl = cuda_ms(call, SHORT_ITERS), cuda_ms(lambda: AQ.rowquant_fused_reference(x, mode, w, b, eps=eps), 5), \
            cuda_ms(lib, 20)
        nbytes = m * width * 3 + 4 * m + (8 * width if mode == "ln" else 0)
        print(f"  rowquant_fused {mode} [{m}x{width}]: bit-equal; {t:.4f} ms, plain {tp:.4f} ms, library {tl:.4f} ms, "
              f"bound {nbytes / PEAK_BYTES * 1e3:.4f} ms")
        tot["ms"] += count * t
        tot["plain_ms"] += count * tp
        tot["library_ms"] += count * tl
        tot["bound_s"] += count * nbytes / PEAK_BYTES
    results.append(dict(name="rowquant_fused", route="cuda", source="magi_tpu_torch/csrc/quant.cu",
                        replaces="magi_tpu/ops/act_quant.py:220", max_abs_err=0.0, ms=tot["ms"] / n_launch,
                        plain_ms=tot["plain_ms"] / n_launch, library_ms=tot["library_ms"] / n_launch,
                        bound_ms=tot["bound_s"] * 1e3 / n_launch, bound_by="bytes"))
    for r in results + scheme_results:
        print(f"  {r['name']}: {r['ms']:.4f} ms (plain {r['plain_ms']:.4f}, library {r['library_ms']:.4f}, "
              f"bound {r['bound_ms']:.4f} by {r['bound_by']})")
    return results, scheme_results


# K7 against its plain version: the kernel sums x * w_q in f32 and scales
# the sum; the plain version scales the weight first (the JAX package's
# reference).  The two sums differ by f32 rounding, far below the output's
# bf16 step, so they round to the same bf16 value or to neighbours: one bf16
# step is at most 2**-7 of |ref|, plus 1e-3 absolute for outputs near 0.
K7_TOL = (1e-3, 2**-7)


def w4a8_kernel_checks(dev):
    """K7 and K8s at the shapes of phases 6 and 7, the 24B's widest step
    at 256x256 (4 denoised segments of 1536 tokens and the ride-along
    copy, S = 7680; captions 5 x 800), and K5 and K8 at the 24B's widths."""
    import torch
    import torch.nn.functional as F

    from magi_tpu_torch.ops import act_quant as AQ
    from magi_tpu_torch.ops import attention as A
    from magi_tpu_torch.ops import attention_q8 as A8
    from magi_tpu_torch.ops import quant as Q

    g = torch.Generator(device=dev)
    g.manual_seed(2)

    def randn(*shape, dtype=torch.bfloat16):
        return torch.randn(shape, generator=g, device=dev).to(dtype)

    hq, hk, hd, D, rot, L, ffn = 48, 8, 128, 6144, 48, 800, 16384
    ctn, n_seg = 6 * 16 * 16, 5
    S = n_seg * ctn
    results = []

    # ---- K7 quantized_matmul: an edge layer's 8 GEMMs without blocks_edge --
    # (rows, k, n, launches per layer): q, qx / k, v / kv_xattn / proj / fc1 / fc2
    gemms = [(S, D, hq * hd, 2), (S, D, hk * hd, 2), (n_seg * L, D, 2 * hk * hd, 1), (S, 2 * hq * hd, D, 1),
             (S, D, 2 * ffn, 1), (S, ffn, D, 1)]
    tot = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, ops_s=0.0, bytes_s=0.0)
    n_launch = sum(c for *_, c in gemms)
    err = 0.0
    for m, k, n, count in gemms:
        x = randn(m, k)
        # the weights the path gives K7: int4, unpacked to int8 (k-major)
        q4, ws = Q.quantize_int4(0.02 * randn(k, n, dtype=torch.float32))
        wq = Q.unpack_int4(q4)
        del q4
        out = Q.quantized_matmul(x, wq, ws)
        ref = Q.quantized_matmul_reference(x, wq, ws)
        err = max(err, check_close(f"quantized_matmul [{m}x{k}] @ [{k}x{n}]", out, ref, *K7_TOL))
        del out, ref
        t = cuda_ms(lambda: Q.quantized_matmul(x, wq, ws), 10)
        tp = cuda_ms(lambda: Q.quantized_matmul_reference(x, wq, ws), 2)
        tl = cuda_ms(lambda: ((x @ wq.to(torch.bfloat16)).float() * ws).to(torch.bfloat16), 10)
        ops = 2 * m * n * k
        nbytes = 2 * m * k + k * n + 4 * n + 2 * m * n
        bms = max(ops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES) * 1e3
        print(f"  quantized_matmul [{m}x{k}] @ [{k}x{n}]: {t:.4f} ms ({ops / t / 1e9:.1f} TFLOP/s, {bms / t:.0%} of the "
              f"bound), plain {tp:.4f} ms, cuBLAS bf16 + cast + epilogue {tl:.4f} ms, bound {bms:.4f} ms")
        tot["ms"] += count * t
        tot["plain_ms"] += count * tp
        tot["library_ms"] += count * tl
        tot["ops_s"] += count * ops / PEAK_BF16_FLOPS
        tot["bytes_s"] += count * nbytes / PEAK_BYTES
        del x, wq, ws
    results.append(dict(name="quantized_matmul", route="cuda", source="magi_tpu_torch/csrc/quant.cu",
                        replaces="magi_tpu/ops/quant.py:106", max_abs_err=err, ms=tot["ms"] / n_launch,
                        plain_ms=tot["plain_ms"] / n_launch, library_ms=tot["library_ms"] / n_launch,
                        bound_ms=max(tot["ops_s"], tot["bytes_s"]) * 1e3 / n_launch,
                        bound_by="operations" if tot["ops_s"] >= tot["bytes_s"] else "bytes"))
    print(f"  quantized_matmul, per launch over one edge layer's {n_launch}: within the tolerance everywhere")

    # ---- K8s rowquant_fused(mode="swiglu"): a gated MLP's fc2 input --------
    x = (3 * torch.randn((S, 2 * ffn), generator=g, device=dev)).to(torch.bfloat16)
    x[7] = 0  # a zero row: scale 1, values 0
    call = lambda: AQ.rowquant_fused(x, "swiglu")
    q8, sc = call()
    ref8, ref_sc = AQ.rowquant_fused_reference(x, "swiglu")
    torch.cuda.synchronize()
    if not (torch.equal(q8, ref8) and torch.equal(sc, ref_sc)):
        fail(f"rowquant_fused swiglu [{S}x{2 * ffn}] is not bit-equal to its plain version")
    print(f"  rowquant_fused swiglu [{S}x{2 * ffn}] -> [{S}x{ffn}]: bit-equal")

    def lib_k8s():
        # nearly the plain version's chain: F.silu, the bf16 product, then
        # amax, scale, round and cast in a few calls
        p_ = (F.silu(x[:, :ffn].float()).bfloat16() * x[:, ffn:]).float()
        scale = p_.abs().amax(-1, keepdim=True).clamp(min=1e-8) / 127.0
        return torch.round(p_ / scale).clamp_(-127, 127).to(torch.int8), scale

    t, tp, tl = cuda_ms(call, 50), cuda_ms(lambda: AQ.rowquant_fused_reference(x, "swiglu"), 5), cuda_ms(lib_k8s, 10)
    nbytes = S * 2 * ffn * 2 + S * ffn + 4 * S
    results.append(dict(name="rowquant_swiglu", route="cuda", source="magi_tpu_torch/csrc/quant.cu",
                        replaces="magi_tpu/ops/act_quant.py:186", max_abs_err=0.0, ms=t, plain_ms=tp, library_ms=tl,
                        bound_ms=nbytes / PEAK_BYTES * 1e3, bound_by="bytes"))
    del x, q8, sc, ref8, ref_sc

    # ---- K8 at the 24B's widths: dynamic shared memory past 48 KB ----------
    for mode, m, width in (("ln", S, D), ("plain", S, 2 * hq * hd)):
        x = (3 * torch.randn((m, width), generator=g, device=dev)).to(torch.bfloat16)
        w, b = (1.0 + 0.1 * randn(width, dtype=torch.float32), 0.1 * randn(width, dtype=torch.float32))
        if mode == "plain":
            w = b = None
        q8, sc = AQ.rowquant_fused(x, mode, w, b)
        ref8, ref_sc = AQ.rowquant_fused_reference(x, mode, w, b)
        torch.cuda.synchronize()
        if not (torch.equal(q8, ref8) and torch.equal(sc, ref_sc)):
            fail(f"rowquant_fused {mode} [{m}x{width}] is not bit-equal to its plain version")
        print(f"  rowquant_fused {mode} [{m}x{width}] ({width * 4} bytes of shared memory a row): bit-equal, "
              f"{cuda_ms(lambda: AQ.rowquant_fused(x, mode, w, b), SHORT_ITERS):.4f} ms")

    # ---- K5 at the 24B's 48 / 8 heads (6 q heads per kv head) --------------
    q = randn(S, hq, hd)
    L1 = 4 * ctn
    eps = 1e-6
    cache8 = torch.zeros((2, hk, L1, hd), dtype=torch.int8, device=dev)
    cache_sc = torch.zeros((2, hk, L1), device=dev)
    cache8[:, :, : 2 * ctn], cache_sc[:, :, : 2 * ctn] = A8.quantize_kv_per_token(randn(2, hk, 2 * ctn, hd))
    kw = 1.0 + 0.1 * randn(hd, dtype=torch.float32)
    kb = 0.1 * randn(hd, dtype=torch.float32)
    ang = torch.rand((S, rot), generator=g, device=dev) * 6.28
    sin, cos = torch.sin(ang), torch.cos(ang)
    kv8, kv_sc = A.kv_norm_rope_pack(randn(S, hk, hd), randn(S, hk, hd), kw, kb, sin, cos, eps=eps, quantize=True)
    i32 = dict(dtype=torch.int32, device=dev)
    sp = 2
    ge = torch.tensor([(sp + j + 1) * ctn for j in range(4)] + [(sp + 5) * ctn], **i32)
    gs = torch.clamp(ge - torch.tensor([1, 2, 3, 5, 1], **i32) * ctn, min=0)
    st = sp * ctn
    r1s, r1e = torch.clamp(gs, max=st), torch.clamp(ge, max=st)
    r2s, r2e = torch.clamp(gs - st, min=0), torch.clamp(ge - st, min=0)
    pro = (1.0 + 0.1 * randn(hd, dtype=torch.float32), 0.1 * randn(hd, dtype=torch.float32), sin, cos, eps)
    args = (q, cache8, cache_sc, kv8, kv_sc, r1s, r1e, r2s, r2e)
    attended = int(((r1e - r1s) + (r2e - r2s)).sum())
    work = 2 * ctn * attended * hd * hq
    qn = A.apply_q_prologue(q, pro)
    deq = A8.segmented_attention_two_source_q8_reference(qn, *args[1:], seg_len=ctn).float()
    for scheme in A8.SCHEMES:
        call = lambda: A8.segmented_attention_two_source_q8(*args, seg_len=ctn, q_prologue=pro, scheme=scheme)
        plain = getattr(A8, f"segmented_attention_two_source_q8_{scheme}_reference")
        out = call()
        check_close(f"segmented_attention_two_source_q8 {scheme} at 48 / 8 heads", out,
                    plain(*args, seg_len=ctn, q_prologue=pro), *ATTN_TOL)
        mean_rel = float((out.float() - deq).abs().mean() / deq.abs().mean())
        print(f"  segmented_attention_two_source_q8 {scheme} at 48 / 8 heads against the dequant reference: "
              f"mean |error| / mean |output| {mean_rel:.3e} (limit {Q8_DEQUANT_MEAN_REL}) "
              f"{'ok' if mean_rel < Q8_DEQUANT_MEAN_REL else 'FAILED'}")
        if mean_rel >= Q8_DEQUANT_MEAN_REL:
            fail(f"segmented_attention_two_source_q8 {scheme} strays from the dequant reference at 48 / 8 heads")
        ms = cuda_ms(call, 10)
        print(f"  segmented_attention_two_source_q8 {scheme} at 48 / 8 heads (S {S}): {ms:.4f} ms, "
              f"{2 * work / ms / 1e9:.1f} T/s")
    # K1 at the same heads and ranges (a bf16 cache of the same values)
    cache = (cache8.float() * cache_sc[..., None]).bfloat16()
    kv2 = (kv8.float() * kv_sc[..., None]).bfloat16()
    call = lambda: A.segmented_attention_two_source(q, cache, kv2, r1s, r1e, r2s, r2e, seg_len=ctn, q_prologue=pro)
    check_close("segmented_attention_two_source at 48 / 8 heads", call(),
                A.segmented_attention_two_source_reference(qn, cache, kv2, r1s, r1e, r2s, r2e, seg_len=ctn), *ATTN_TOL)
    ms = cuda_ms(call, 10)
    print(f"  segmented_attention_two_source at 48 / 8 heads (S {S}): {ms:.4f} ms, {2 * work / ms / 1e9:.1f} T/s")
    for r in results:
        print(f"  {r['name']}: {r['ms']:.4f} ms (plain {r['plain_ms']:.4f}, library {r['library_ms']:.4f}, "
              f"bound {r['bound_ms']:.4f} by {r['bound_by']})")
    return results


# ---------------------------------------------------------------------------
# phase 3: tiny walks on the card against the CPU fp32 walks
# ---------------------------------------------------------------------------

TINY_MODEL = dict(num_layers=2, hidden_size=768, ffn_hidden_size=1536, num_attention_heads=6, num_query_groups=2,
                  caption_channels=64, caption_max_length=32)
TINY_RUNTIME = dict(num_steps=8, window_size=2, chunk_width=2, noise2clean_kvrange=[3, 2], clean_chunk_kvrange=1)


def tiny_walk_check(dev, name, config_path, tol, model=None, engine=None, quantize=None, wrappers=(), kernels=(),
                    prefix_frames=0, scheme=None, idle=(), runtime=None):
    """A model at head_dim 128 (so every kernel runs) walks 3 chunks on the
    card in bf16 and on the CPU in fp32 with the same weights and noise;
    the emitted latents must agree to `tol` relative L2 error.  `quantize`
    (a tree function of `ops.quant`) quantizes the (bf16) weights first,
    for both.  With `prefix_frames`, a seeded prefix latent of that many
    frames comes first (v2v: the chunks it covers whole are written by the
    warm-up forward) and the walk has one chunk more.  `scheme` sets
    `MAGI_ATTN_Q8_SCHEME` for the card's walk (the CPU's takes the dequant
    reference).  `runtime` overrides the tiny runtime config (the default
    kv ranges of a host-offloaded walk).  Each of `kernels` (names in
    `wrappers`) must launch in the card's walk, and none of `idle`."""
    import numpy as np
    import torch

    from magi_tpu_torch.core.config import MagiConfig
    from magi_tpu_torch.models.dit.model import init_dit_params
    from magi_tpu_torch.sampling.transport import ArdfSampler, InferenceInput

    with open(config_path) as f:
        d = json.load(f)
    d["model_config"].update(TINY_MODEL, **(model or {}))
    d["runtime_config"].update(TINY_RUNTIME, **(runtime or {}))
    d["engine_config"].update(engine or {})
    cfg_gpu = MagiConfig.from_dict(d)
    d["model_config"]["params_dtype"] = "torch.float32"
    cfg_cpu = MagiConfig.from_dict(d)
    mc = cfg_cpu.model_config
    cw = TINY_RUNTIME["chunk_width"]
    n_chunks, H, W, Lc = 3 + (prefix_frames > 0), 16, 16, mc.caption_max_length
    gen = torch.Generator(device="cpu")
    gen.manual_seed(1)
    p_bf = init_dit_params(cfg_gpu, "cpu", gen)  # bf16 values are exact in fp32
    if quantize:
        p_bf = quantize(p_bf)
    p_gpu = _map(p_bf, lambda t: t.to(dev))
    p_cpu = _map(p_bf, lambda t: t.float() if t.dtype == torch.bfloat16 else t)
    rng = np.random.default_rng(0)
    noise = torch.from_numpy(rng.normal(size=(mc.in_channels, n_chunks * cw, H, W)).astype(np.float32))
    cap = torch.from_numpy(rng.normal(size=(n_chunks, Lc, mc.caption_channels)).astype(np.float32))
    null = torch.from_numpy(rng.normal(size=(Lc, mc.caption_channels)).astype(np.float32))
    prefix = None
    if prefix_frames:
        prefix = torch.from_numpy(rng.normal(size=(mc.in_channels, prefix_frames, H, W)).astype(np.float32))
    lens = np.array([0] * (prefix_frames // cw) + [9] * (n_chunks - prefix_frames // cw), np.int32)

    def walk(cfg, params, device):
        inp = InferenceInput(
            caption_embs=cap.to(device), caption_lens=lens, null_emb=null.to(device), null_len=5,
            latent_size=(mc.in_channels, n_chunks * cw, H, W), num_steps=8, chunk_num=n_chunks, has_text=True,
            prefix_video=None if prefix is None else prefix.to(device))
        return torch.cat([c.cpu() for _, c in ArdfSampler(cfg, params, inp, noise=noise, device=device).walk()], 1)

    before = {n: wrappers[n].launches for n in list(kernels) + list(idle)}
    old_scheme = os.environ.get("MAGI_ATTN_Q8_SCHEME")
    if scheme:
        os.environ["MAGI_ATTN_Q8_SCHEME"] = scheme
    try:
        a = walk(cfg_gpu, p_gpu, dev)
    finally:
        _set_env("MAGI_ATTN_Q8_SCHEME", old_scheme)
    missing = [n for n in kernels if wrappers[n].launches == before[n]]
    if missing:
        fail(f"{name}: the card's walk launched no {missing}")
    stray = [n for n in idle if wrappers[n].launches != before[n]]
    if stray:
        fail(f"{name}: the card's walk launched {stray}")
    b = walk(cfg_cpu, p_cpu, "cpu")
    rel = float((a - b).norm() / b.norm())
    ok = bool(torch.isfinite(a).all()) and a.shape == b.shape and rel < tol
    print(f"  {name}, card (kernels, bf16) vs CPU (plain, fp32): relative L2 error {rel:.5e} "
          f"(tolerance {tol}) {'ok' if ok else 'FAILED'}")
    if not ok:
        fail(f"{name} on the card disagrees with the CPU walk")
    return rel


# The single-branch int8 walks against their fp32 CPU twins.  Beyond phase
# 3's bf16 rounding, the card quantizes q to int8 inside K5 (the CPU's
# dequant reference keeps q), K8 and K8s round their producer to bf16
# before the row quantization, and every int8 rounding of activations and
# kv that these move across a step edge carries on through the walk.
# Seen: 3.842e-03 relative L2 for the int8 walk (H100 80GB HBM3, 700 W);
# the limit keeps phase 3's 2e-2, five times that, for the int8 and the
# gated int4 walks.
TINY_QUANT_TOL = 2e-2


def _set_env(name: str, value) -> None:
    if value is None:
        os.environ.pop(name, None)
    else:
        os.environ[name] = value


def _map(tree, fn):
    return {k: _map(v, fn) if isinstance(v, dict) else fn(v) for k, v in tree.items()}


def run_main_path(dev, config: dict, stem: str, wrappers: dict, path_kernels: list) -> dict:
    """Run `config` through the CLI entry (t2v) with every launch count set
    to 0 just before and read just after; checks the video (96 frames of
    256x256, finite latents) and that every kernel of the path launched.
    Returns the launch counts and the run's stats (with its wall seconds and
    device peak)."""
    import torch

    from magi_tpu_torch.pipeline import entry

    with open(stem + ".json", "w") as f:
        json.dump(config, f)
    torch.cuda.empty_cache()  # the earlier phases' cached blocks
    torch.cuda.reset_peak_memory_stats(dev)
    for w in wrappers.values():
        w.launches = 0
    t0 = time.perf_counter()
    stats = entry.main(["--config_file", stem + ".json", "--mode", "t2v", "--prompt", "a red cube on a table",
                        "--output_path", stem + ".mp4"])
    wall = time.perf_counter() - t0
    launches = {name: w.launches for name, w in wrappers.items()}
    steps = stats["step_seconds"]
    stats.update(wall=wall, peak_gib=torch.cuda.max_memory_allocated(dev) / 2**30)
    print(f"  frames written: {stats['frames']} -> {stats['path']}")
    print(f"  denoise steps: {len(steps)}, seconds per step: mean {sum(steps) / len(steps):.4f}, "
          f"first {steps[0]:.4f}, last {steps[-1]:.4f}; VAE decode seconds per chunk: "
          f"{', '.join(f'{s:.3f}' for s in stats['decode_seconds'])}; run wall {wall:.1f} s; "
          f"peak memory {torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB")
    print(f"  launches in this run: {json.dumps(launches)}")
    print(f"  launches per denoise step: "
          f"{json.dumps({n: round(launches[n] / len(steps), 2) for n in path_kernels})}")
    print(f"  video {stats['video_shape']}, std {stats['video_std']:.2f}, latents finite: {stats['latents_finite']}")
    if stats["video_shape"] != (96, 256, 256, 3) or not os.path.exists(stats["path"]):
        fail(f"expected 96 frames of 256x256x3 written, got {stats['video_shape']} at {stats['path']}")
    if not stats["latents_finite"] or stats["video_std"] == 0:
        fail("the walk emitted non-finite latents or a constant video")
    missing = [n for n in path_kernels if launches[n] == 0]
    if missing:
        fail(f"the main path launched no {missing}")
    return launches, stats


def run_prefix_path(dev, config: dict, stem: str, wrappers: dict, path_kernels: list, *, mode: str,
                    scheme=None, idle_kernels=()) -> dict:
    """i2v (one seeded frame) or v2v (32 seeded frames) of `config`, entered
    below the file decoders: the uint8 frames go through
    `encode_prefix_video` (the VAE encoder) and then `MagiPipeline._run`,
    with every launch count set to 0 just before the encode and read just
    after the video is written; `scheme` sets `MAGI_ATTN_Q8_SCHEME` for the
    run.  Checks the frame count against the JAX package's for the same
    request (i2v emits every chunk whole; v2v drops the prefix frames), the
    latents and that every kernel of `path_kernels` launched and none of
    `idle_kernels`.  Returns the launch counts."""
    import numpy as np
    import torch

    from magi_tpu_torch.pipeline.pipeline import MagiPipeline
    from magi_tpu_torch.pipeline.video_process import encode_prefix_video

    with open(stem + ".json", "w") as f:
        json.dump(config, f)
    rc = config["runtime_config"]
    h, w, fps, cw = rc["video_size_h"], rc["video_size_w"], rc["fps"], rc["chunk_width"]
    frames = np.random.default_rng(rc["seed"]).integers(0, 256, size=(1 if mode == "i2v" else 32, h, w, 3),
                                                        dtype=np.uint8)
    old_scheme = os.environ.get("MAGI_ATTN_Q8_SCHEME")
    if scheme:
        os.environ["MAGI_ATTN_Q8_SCHEME"] = scheme
    try:
        pipeline = MagiPipeline(stem + ".json", device=dev)
        torch.cuda.empty_cache()  # the earlier phases' cached blocks
        torch.cuda.reset_peak_memory_stats(dev)
        for wr in wrappers.values():
            wr.launches = 0
        t0 = time.perf_counter()
        prefix = encode_prefix_video(frames, fps, rc["vae_pretrained"], rc["scale_factor"], dev)
        torch.cuda.synchronize()
        encode_s = time.perf_counter() - t0
        stats = pipeline._run("a red cube on a table", prefix, stem + ".mp4")
        wall = time.perf_counter() - t0
        launches = {name: wr.launches for name, wr in wrappers.items()}
    finally:
        _set_env("MAGI_ATTN_Q8_SCHEME", old_scheme)
    t_pre = prefix.shape[1]
    chunks = -(-(rc["num_frames"] // rc["temporal_downsample_factor"] + t_pre) // cw)
    want = 4 * (chunks * cw - (0 if t_pre == 1 else t_pre))
    steps = stats["step_seconds"]
    print(f"  prefix: {frames.shape[0]} frames -> latent {tuple(prefix.shape)} in {encode_s:.3f} s (VAE encode); "
          f"{chunks} chunks, {chunks - t_pre // cw} denoised")
    print(f"  frames written: {stats['frames']} (the JAX package's count for this request: {want}) -> {stats['path']}")
    print(f"  denoise steps: {len(steps)}, seconds per step: mean {sum(steps) / len(steps):.4f}, "
          f"first {steps[0]:.4f}, last {steps[-1]:.4f}; VAE decode seconds per chunk: "
          f"{', '.join(f'{s_:.3f}' for s_ in stats['decode_seconds'])}; run wall {wall:.1f} s; "
          f"peak memory {torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB")
    print(f"  launches in this run: {json.dumps(launches)}")
    print(f"  launches per denoise step: "
          f"{json.dumps({n: round(launches[n] / len(steps), 2) for n in path_kernels})}")
    print(f"  video {stats['video_shape']}, std {stats['video_std']:.2f}, latents finite: {stats['latents_finite']}")
    if stats["video_shape"] != (want, h, w, 3) or not os.path.exists(stats["path"]):
        fail(f"expected {want} frames of {h}x{w}x3 written, got {stats['video_shape']} at {stats['path']}")
    if not stats["latents_finite"] or stats["video_std"] == 0:
        fail("the walk emitted non-finite latents or a constant video")
    missing = [n for n in path_kernels if launches[n] == 0]
    if missing:
        fail(f"the {mode} path launched no {missing}")
    stray = [n for n in idle_kernels if launches[n]]
    if stray:
        fail(f"the {mode} path launched {stray}, which its scheme does not run")
    return launches


def run_noedge_walk(dev, config: dict, wrappers: dict, path_kernels: list) -> dict:
    """The 24B w4a8 tree without `blocks_edge`, as the JAX package's
    single-chip 24B benchmark builds it (`quantize_params_int4(
    keep_edge_bf16=False)`: layers 0 and L-1 run bf16 activations on the
    dequantized int4 weights), walked by `ArdfSampler.walk` with every
    launch count set to 0 just before and read just after.  Checks that
    every chunk comes out finite and that every kernel of the path
    launched.  Returns the launch counts."""
    import torch

    from magi_tpu_torch.core.config import MagiConfig
    from magi_tpu_torch.models.dit.model import init_dit_params
    from magi_tpu_torch.ops.quant import quantize_params_int4
    from magi_tpu_torch.pipeline.prompt_process import build_inference_input, get_txt_embeddings
    from magi_tpu_torch.sampling.transport import ArdfSampler

    cfg = MagiConfig.from_dict(config)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(cfg.runtime_config.seed)
    t0 = time.perf_counter()
    params = quantize_params_int4(init_dit_params(cfg, dev, gen), keep_edge_bf16=False)
    torch.cuda.synchronize()
    print(f"  int4 tree without blocks_edge in {time.perf_counter() - t0:.1f} s, "
          f"{sum(t.numel() * t.element_size() for t in _leaves(params)) / 2**30:.2f} GiB")
    emb, mask = get_txt_embeddings("a red cube on a table", cfg)
    inp = build_inference_input(cfg, params["y_embedder"]["null_caption_embedding"].float().cpu().numpy(), emb, mask,
                                dev)
    sampler = ArdfSampler(cfg, params, inp, gen, device=dev)
    for w in wrappers.values():
        w.launches = 0
    t0 = time.perf_counter()
    chunks = [(i, bool(torch.isfinite(c).all()), tuple(c.shape)) for i, c in sampler.walk()]
    wall = time.perf_counter() - t0
    launches = {name: w.launches for name, w in wrappers.items()}
    steps = sampler.step_seconds
    print(f"  chunks emitted (index, finite, shape): {chunks}")
    print(f"  denoise steps: {len(steps)}, seconds per step: mean {sum(steps) / len(steps):.4f}, first "
          f"{steps[0]:.4f}, last {steps[-1]:.4f}; walk wall {wall:.1f} s; peak memory "
          f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB")
    print(f"  launches in this run: {json.dumps(launches)}")
    print(f"  launches per denoise step: "
          f"{json.dumps({n: round(launches[n] / len(steps), 2) for n in path_kernels})}")
    if len(chunks) != inp.chunk_num or not all(ok for _, ok, _ in chunks):
        fail(f"the walk without blocks_edge emitted {chunks}, expected {inp.chunk_num} finite chunks")
    missing = [n for n in path_kernels if launches[n] == 0]
    if missing:
        fail(f"the walk without blocks_edge launched no {missing}")
    return launches


# ---------------------------------------------------------------------------
# phase 3's smooth-folded trees and phase 11: checkpoints on disk
# ---------------------------------------------------------------------------

SMOOTH_LINEARS = ("self_attention/linear_kv_xattn", "self_attention/linear_proj", "mlp/linear_fc1",
                  "mlp/linear_fc2")


def with_smooth(params: dict, linears, seed: int = 3) -> dict:
    """`params` (blocks copied, leaves shared) with an `act_smooth` [L, in]
    in [0.5, 2] beside each of `linears`, 1 on layers 0 and L-1 (as the
    loader gives the bf16 edge layers of an fp8 checkpoint)."""
    import torch

    gen = torch.Generator().manual_seed(seed)
    out = dict(params, blocks=_map(params["blocks"], lambda t: t))
    for path in linears:
        node = out["blocks"]
        for k in path.split("/"):
            node = node[k]
        s = 0.5 + 1.5 * torch.rand(node["weight"].shape[:2], generator=gen)
        s[0] = s[-1] = 1.0
        node["act_smooth"] = s.to(node["weight"].device)
    return out


FP8_MAX = 448.0
FP8_CKPT_LAYERS = 34  # the 4.5B's published depth, written whole
PROMPT = "a red cube on a table"


def write_dit_fp8_checkpoint(cfg, root: str, dev) -> int:
    """The released 4.5B distill fp8 checkpoint's layout under
    `root/inference_weight.fp8.distill`, from seeded random weights made on
    the card: layers 0 and L-1 plain bf16; the middle layers' linears
    F8_E4M3, [1, out, in], q/qx/k/v with per-tensor weight scales
    (PerTensor), kv_xattn, proj, fc1 and fc2 smooth-folded with smooth and
    input scales (PerChannel: weight = e4m3(W·s / ws), smooth_scale =
    s·input_scale); every other tensor bf16, the rotary bands f32.  Two
    shards (the globals and
    the first half of the layers, then the rest) and an index.  Returns the
    bytes written."""
    import torch

    from magi_tpu_torch.checkpoint.safetensors_io import save_file
    from magi_tpu_torch.models.dit.rope import default_bands

    mc = cfg.model_config
    D, hd, hq, hk, L = mc.hidden_size, mc.kv_channels, mc.num_attention_heads, mc.num_query_groups, mc.num_layers
    ch, xh, gh, ffn, cc = (mc.cond_hidden_size, mc.xattn_cond_hidden_size, mc.gate_hidden_size, mc.ffn_hidden_size,
                           mc.caption_channels)
    fc1 = 2 * ffn if mc.gated_linear_unit else ffn
    gen = torch.Generator(device=dev).manual_seed(11)

    def w(*shape):
        return torch.randn(shape, generator=gen, device=dev) * 0.02

    def host(key, t):
        keep = t.dtype == torch.float8_e4m3fn or key.endswith("_scale") or key == "rope.bands"
        return (t if keep else t.to(torch.bfloat16)).cpu()

    def fp8(t):
        return (t / (t.abs().max() / FP8_MAX)).clamp(-FP8_MAX, FP8_MAX).to(torch.float8_e4m3fn)[None]

    globals_ = {
        "x_embedder.weight": w(D, mc.in_channels, mc.t_patch_size, mc.patch_size, mc.patch_size),
        "t_embedder.mlp.0.weight": w(ch, 256), "t_embedder.mlp.0.bias": w(ch),
        "t_embedder.mlp.2.weight": w(ch, ch), "t_embedder.mlp.2.bias": w(ch),
        "y_embedder.y_proj_xattn.0.weight": w(xh, cc), "y_embedder.y_proj_xattn.0.bias": w(xh),
        "y_embedder.y_proj_adaln.0.weight": w(ch, cc), "y_embedder.y_proj_adaln.0.bias": w(ch),
        "y_embedder.null_caption_embedding": w(mc.caption_max_length, cc),
        "rope.bands": default_bands(hd, device=dev),
        "videodit_blocks.final_layernorm.weight": w(D), "videodit_blocks.final_layernorm.bias": w(D),
        "final_linear.linear.weight": w(mc.patch_size**2 * mc.t_patch_size * mc.out_channels, D),
    }
    wdir = os.path.join(root, "inference_weight.fp8.distill")
    os.makedirs(wdir)
    shards = [{k: host(k, v) for k, v in globals_.items()}, {}]
    for i in range(L):
        b = f"videodit_blocks.layers.{i}."
        a = b + "self_attention."
        per_tensor = {a + f"linear_qkv.{n}.weight": w(o, D) for n, o in (("q", hq * hd), ("qx", hq * hd),
                                                                           ("k", hk * hd), ("v", hk * hd))}
        per_channel = {a + "linear_kv_xattn.weight": w(2 * hk * hd, xh), a + "linear_proj.weight": w(D, 2 * hq * hd),
                       b + "mlp.linear_fc1.weight": w(fc1, D), b + "mlp.linear_fc2.weight": w(D, ffn)}
        layer = {b + "ada_modulate_layer.proj.0.weight": w(2 * gh, ch), b + "ada_modulate_layer.proj.0.bias": w(2 * gh)}
        for n in ("linear_qkv.layer_norm", "q_layernorm", "k_layernorm", "q_layernorm_xattn", "k_layernorm_xattn"):
            dim = D if n == "linear_qkv.layer_norm" else hd
            layer[a + n + ".weight"], layer[a + n + ".bias"] = w(dim), w(dim)
        for n in ("self_attn_post_norm", "mlp.layer_norm", "mlp_post_norm"):
            layer[b + n + ".weight"], layer[b + n + ".bias"] = w(D), w(D)
        if i in (0, L - 1):
            layer.update(per_tensor)
            layer.update(per_channel)
        else:
            for key, wt in per_tensor.items():
                base = key[: -len(".weight")]
                layer[key] = fp8(wt)
                layer[base + ".weight_scale"] = (wt.abs().max() / FP8_MAX).reshape(1)
                layer[base + ".input_scale"] = torch.full((wt.shape[1],), 0.01, device=dev)
            for key, wt in per_channel.items():
                base = key[: -len(".weight")]
                smooth = 0.5 + 1.5 * torch.rand(wt.shape[1], generator=gen, device=dev)
                folded = wt * smooth[None, :]
                layer[key] = fp8(folded)
                layer[base + ".weight_scale"] = (folded.abs().max() / FP8_MAX).reshape(1)
                layer[base + ".input_scale"] = torch.full((1,), 0.01, device=dev)
                layer[base + ".smooth_scale"] = (smooth * 0.01)[None]
        shards[0 if i < L // 2 else 1].update((k, host(k, v)) for k, v in layer.items())
    weight_map = {}
    for j, shard in enumerate(shards):
        name = f"model-{j + 1:05d}-of-00002.safetensors"
        save_file(shard, os.path.join(wdir, name))
        weight_map.update((k, name) for k in shard)
    with open(os.path.join(wdir, "model.safetensors.index.json"), "w") as f:
        json.dump({"weight_map": weight_map}, f)
    return sum(os.path.getsize(os.path.join(wdir, f)) for f in os.listdir(wdir))


VAE_DDCONFIG = dict(video_size=256, video_length=16, patch_size=8, patch_length=4, in_chans=3, z_chans=16,
                    embed_dim=1024, depth=16, num_heads=16)


def write_vae_checkpoint(path: str, dev) -> int:
    """A diffusers-format ViT-VAE directory (config.json with
    `_class_name: ViTVAE` and the ddconfig of the shape `get_vae` makes,
    bf16 weights in `diffusion_pytorch_model.safetensors`, the released key
    names) from the port's seeded random VAE.  Returns the bytes written."""
    import torch

    from magi_tpu_torch.checkpoint.safetensors_io import save_file
    from magi_tpu_torch.models.vae.model import VaeConfig, init_vae_params

    cfg = VaeConfig.from_ddconfig(VAE_DDCONFIG)
    tree = init_vae_params(cfg, seed=0, dtype=torch.bfloat16, device=dev)
    state = {}
    for tower in ("encoder", "decoder"):
        t, p = tree[tower], tower + "."
        for i in range(cfg.depth):
            for group, names in (("attn", ("qkv", "proj")), ("mlp", ("fc1", "fc2"))):
                for n in names:
                    for leaf, v in t["blocks"][group][n].items():
                        state[f"{p}blocks.{i}.{group}.{n}.{leaf}"] = v[i].t() if leaf == "weight" else v[i]
            for n in ("norm1", "norm2"):
                for leaf, v in t["blocks"][n].items():
                    state[f"{p}blocks.{i}.{n}.{leaf}"] = v[i]
        state[p + "pos_embed"], state[p + "cls_token"] = t["pos_embed"], t["cls_token"]
        for n in ("norm", "proj_in", "final_proj", "final_norm", "patch_embed.proj", "last_layer"):
            node = t
            for k in n.split("."):
                node = node.get(k, {})
            for leaf, v in node.items():
                linear = n in ("proj_in", "final_proj") or (n == "last_layer" and tower == "encoder")
                state[f"{p}{n}.{leaf}"] = v.t() if linear and leaf == "weight" else v
    os.makedirs(path)
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump({"_class_name": "ViTVAE", "ddconfig": VAE_DDCONFIG}, f)
    save_file(state, os.path.join(path, "diffusion_pytorch_model.safetensors"))
    return os.path.getsize(os.path.join(path, "diffusion_pytorch_model.safetensors"))


T5_HF_CONFIG = dict(vocab_size=32128, d_model=4096, d_kv=64, num_heads=64, d_ff=10240, num_layers=2,
                    relative_attention_num_buckets=32, relative_attention_max_distance=128,
                    feed_forward_proj="gated-gelu")


def random_t5_layer_state(cfg, i: int, gen, dev) -> dict:
    """Layer i of an HF T5 encoder state ([out, in] weights, bf16) drawn at
    the scales of HF's T5 initialisation, so activations have the sizes of
    a trained model's."""
    import torch

    from magi_tpu_torch.models.t5.model import _T5_LAYER_FMTS

    inner, d, f = cfg.num_heads * cfg.d_kv, cfg.d_model, cfg.d_ff
    shapes = {"q": ((inner, d), (d * cfg.d_kv) ** -0.5), "k": ((inner, d), d**-0.5), "v": ((inner, d), d**-0.5),
              "o": ((d, inner), inner**-0.5), "wi_0": ((f, d), d**-0.5), "wi_1": ((f, d), d**-0.5),
              "wo": ((d, f), f**-0.5)}
    out = {}
    for key, (fmt, _) in _T5_LAYER_FMTS.items():
        if key in shapes:
            shape, std = shapes[key]
            out[fmt.format(i)] = (torch.randn(shape, generator=gen, device=dev) * std).to(torch.bfloat16)
        else:
            out[fmt.format(i)] = torch.ones(d, dtype=torch.bfloat16, device=dev)
    return out


def random_t5_tree(cfg, dev, gen) -> dict:
    """The port's T5 tree of `cfg` on `dev` in bf16, drawn at HF's
    initialisation scales (`random_t5_layer_state` layer by layer)."""
    import torch

    from magi_tpu_torch.models.t5.model import convert_hf_t5_layer

    layers = [convert_hf_t5_layer(random_t5_layer_state(cfg, i, gen, dev).__getitem__, i)
              for i in range(cfg.num_layers)]
    return {"shared": {"weight": torch.randn((cfg.vocab_size, cfg.d_model), generator=gen, device=dev).bfloat16()},
            "rel_bias": {"weight": (torch.randn((cfg.rel_buckets, cfg.num_heads), generator=gen, device=dev)
                                    * cfg.d_model**-0.5).bfloat16()},
            "blocks": {k: torch.stack([blk[k] for blk in layers]) for k in layers[0]},
            "final_layer_norm": {"weight": torch.ones(cfg.d_model, dtype=torch.bfloat16, device=dev)}}


def write_t5_checkpoint(path: str, dev) -> int:
    """An HF-layout T5 encoder directory at T5-XXL's width (config.json and
    `model.safetensors`, bf16) with `T5_HF_CONFIG["num_layers"]` layers, from
    seeded random weights.  Returns the bytes written."""
    import torch

    from magi_tpu_torch.checkpoint.safetensors_io import save_file
    from magi_tpu_torch.models.t5.model import _REL_BIAS, T5Config

    cfg = T5Config.from_hf_config(T5_HF_CONFIG)
    gen = torch.Generator(device=dev).manual_seed(5)
    state = {"shared.weight": torch.randn((cfg.vocab_size, cfg.d_model), generator=gen, device=dev).bfloat16(),
             _REL_BIAS: (torch.randn((cfg.rel_buckets, cfg.num_heads), generator=gen, device=dev)
                         * cfg.d_model**-0.5).bfloat16(),
             "encoder.final_layer_norm.weight": torch.ones(cfg.d_model, dtype=torch.bfloat16, device=dev)}
    for i in range(cfg.num_layers):
        state.update(random_t5_layer_state(cfg, i, gen, dev))
    os.makedirs(path)
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(T5_HF_CONFIG, f)
    save_file(state, os.path.join(path, "model.safetensors"))
    return os.path.getsize(os.path.join(path, "model.safetensors"))


class StandInTokenizer:
    """Takes the place of the HF sentencepiece tokenizer (the card has no
    `transformers`): its call and output format, with ids drawn from a seed
    of the text, one per word, then EOS (1), padded with 0 to max_length."""

    def __init__(self, vocab_size: int):
        self.vocab_size = vocab_size

    def __call__(self, texts, max_length, padding="max_length", truncation=True, return_attention_mask=True,
                 add_special_tokens=True, return_tensors="np"):
        import zlib

        import numpy as np

        ids = np.zeros((len(texts), max_length), np.int64)
        for r, text in enumerate(texts):
            n = min(len(text.split()), max_length - 1)
            ids[r, :n] = np.random.default_rng(zlib.crc32(text.encode())).integers(2, self.vocab_size, n)
            ids[r, n] = 1
        return {"input_ids": ids, "attention_mask": (ids != 0).astype(np.int64)}


def t5_xxl_encode_times(dev, ids, mask, repeats: int = 3):
    """The full 24-layer T5-XXL encode at `ids`' length on seeded random
    weights in memory: seconds of a resident encode (weights on the card)
    and of a staged one (weights pinned on the host, copied over per encode
    and freed), each the mean of `repeats` after one warm-up."""
    import torch

    from magi_tpu_torch.models.t5.model import T5Config, t5_encode_staged, t5_encoder_forward

    cfg = T5Config.xxl()
    resident = random_t5_tree(cfg, dev, torch.Generator(device=dev).manual_seed(6))
    host = _map(resident, lambda t: torch.empty(t.shape, dtype=t.dtype, pin_memory=True).copy_(t))
    n_bytes = sum(t.numel() * t.element_size() for t in _leaves(host))

    def timed(fn):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(repeats):
            out = fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / repeats, out

    resident_s, a = timed(lambda: t5_encoder_forward(resident, cfg, ids, mask))
    del resident
    torch.cuda.empty_cache()
    staged_s, b = timed(lambda: t5_encode_staged(host, cfg, ids, mask, dev))
    rel = float((a.cpu().float() - b.float()).norm() / b.float().norm())
    print(f"  T5-XXL staged encode against the resident one: relative L2 {rel:.3e} (limit 1e-3)")
    if not rel < 1e-3:
        fail("the staged T5-XXL encode differs from the resident one")
    return resident_s, staged_s, n_bytes


def run_loaded_path(dev, config: dict, stem: str, wrappers: dict, path_kernels: list, launches5: dict,
                    stats5: dict) -> dict:
    """Phase 11: the distill fp8 config from checkpoints written to disk in
    the released formats (DiT fp8, VAE, T5 at XXL width with 2 layers),
    through the CLI entry with SKIP_LOAD_MODEL unset.  Checks a loaded
    middle layer's dequant on the card against the CPU's bit for bit, the
    2-layer T5 encode on the card against the CPU's f32 encode, the video
    (via `run_main_path`), and the launch counts against phase 5's (the
    same request on the same config: the smooth-quant divide replaces no
    kernel, fc1's K8 runs `plain` instead of `ln`).  Prints load seconds
    and GB/s, the step time against phase 5's, the divide's ms per step, the
    T5-XXL encode times and the peak memory.  Returns the launch counts."""
    import collections
    import resource
    import shutil

    import torch

    from magi_tpu_torch.checkpoint import loader, vae_loader
    from magi_tpu_torch.core.config import MagiConfig
    from magi_tpu_torch.models.dit import model as TM
    from magi_tpu_torch.models.t5.model import T5Embedder
    from magi_tpu_torch.ops import quant as Q
    from magi_tpu_torch.pipeline import prompt_process

    root = stem + "_ckpt"
    shutil.rmtree(root, ignore_errors=True)
    rc = config["runtime_config"]
    rc.update(load=os.path.join(root, "dit"), vae_pretrained=os.path.join(root, "vae"),
              t5_pretrained=os.path.join(root, "t5"), t5_device="auto")
    cfg = MagiConfig.from_dict(config)
    old_skip = os.environ.pop("SKIP_LOAD_MODEL", None)
    plain_divide = TM._smooth_divide
    patched = {}
    try:
        t0 = time.perf_counter()
        sizes = {"dit": write_dit_fp8_checkpoint(cfg, rc["load"], dev),
                 "vae": write_vae_checkpoint(rc["vae_pretrained"], dev),
                 "t5": write_t5_checkpoint(rc["t5_pretrained"], dev)}
        print(f"  checkpoints written in {time.perf_counter() - t0:.1f} s: " + ", ".join(
            f"{k} {v / 1e9:.3f} GB" for k, v in sizes.items()))

        # a middle layer's dequant on the card against the CPU's
        state = loader.load_state_dict(rc["load"], fp8_quant=True, distill=True)
        on_card, on_cpu = loader._dequant_fp8(state, dev), loader._dequant_fp8(state, "cpu")
        keys = [k for k in on_cpu if k.startswith("videodit_blocks.layers.1.") and (
            k.endswith(".act_smooth") or k[: -len(".weight")] + ".weight_scale" in state)]
        bad = [k for k in keys if not torch.equal(on_card[k].cpu(), on_cpu[k])]
        print(f"  layer 1's dequantized linears and act_smooth ({len(keys)} tensors), card against CPU: "
              f"{'bit-equal' if not bad else 'DIFFER ' + str(bad)}")
        if bad or len(keys) != 12:
            fail(f"the card's fp8 dequant differs from the CPU's on {bad} (of {len(keys)})")
        del state, on_card, on_cpu

        # T5: the 2-layer checkpoint staged onto the card against the CPU's f32 encode
        tok = StandInTokenizer(T5_HF_CONFIG["vocab_size"])
        L = cfg.model_config.caption_max_length
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        t5 = T5Embedder(rc["t5_pretrained"], model_max_length=L, device="auto", pipeline_device=dev, tokenizer=tok)
        t5_load_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        got, mask = t5.get_text_embeddings([PROMPT])
        staged_s = time.perf_counter() - t0
        want, _ = T5Embedder(rc["t5_pretrained"], model_max_length=L, dtype=torch.float32, device="cpu",
                             tokenizer=tok).get_text_embeddings([PROMPT])
        rel = float((got.float() - want).norm() / want.norm())
        print(f"  T5 (XXL width, 2 layers) loaded in {t5_load_s:.2f} s ({sizes['t5'] / t5_load_s / 1e9:.2f} GB/s); "
              f"staged bf16 encode at L {L} in {staged_s:.3f} s against the CPU's f32 encode: relative L2 "
              f"{rel:.3e} (tolerance {T5_TOL}) {'ok' if rel < T5_TOL else 'FAILED'}")
        if not (rel < T5_TOL and bool(torch.isfinite(got).all())):
            fail("the T5 encode on the card disagrees with the CPU's")
        ids = torch.as_tensor(tok([PROMPT], L)["input_ids"])
        resident_s, staged_xxl_s, xxl_bytes = t5_xxl_encode_times(dev, ids, mask)
        print(f"  T5-XXL (24 layers, {xxl_bytes / 1e9:.2f} GB bf16) encode at L {L}: resident "
              f"{resident_s * 1e3:.1f} ms, staged {staged_xxl_s * 1e3:.1f} ms ({xxl_bytes / staged_xxl_s / 1e9:.1f} "
              f"GB/s with the copy)")
        prompt_process._t5_cache = t5

        # the run: loads timed where the pipeline calls them, the divides recorded
        timings, divides = {}, collections.Counter()
        for mod, name in ((loader, "load_dit_params"), (vae_loader, "load_vae"), (Q, "quantize_params_int8")):
            patched[(mod, name)] = fn = getattr(mod, name)

            def wrapper(*a, _fn=fn, _name=name, **k):
                torch.cuda.synchronize()
                t = time.perf_counter()
                out = _fn(*a, **k)
                torch.cuda.synchronize()
                timings[_name] = time.perf_counter() - t
                return out

            setattr(mod, name, wrapper)

        def recording_divide(x, s):
            divides[(tuple(x.shape), x.dtype)] += 1
            return plain_divide(x, s)

        TM._smooth_divide = recording_divide
        launches, stats = run_main_path(dev, config, stem, wrappers, path_kernels)
    finally:
        TM._smooth_divide = plain_divide
        for (mod, name), fn in patched.items():
            setattr(mod, name, fn)
        prompt_process._t5_cache = None
        _set_env("SKIP_LOAD_MODEL", old_skip)
        shutil.rmtree(root, ignore_errors=True)

    print(f"  DiT fp8 load (dequant + convert on the card) {timings['load_dit_params']:.2f} s "
          f"({sizes['dit'] / timings['load_dit_params'] / 1e9:.2f} GB/s of checkpoint), smooth-folded int8 "
          f"quantization {timings['quantize_params_int8']:.2f} s; VAE load {timings['load_vae']:.2f} s "
          f"({sizes['vae'] / timings['load_vae'] / 1e9:.2f} GB/s)")
    steps, steps5 = stats["step_seconds"], stats5["step_seconds"]
    print(f"  seconds per step: mean {sum(steps) / len(steps):.4f} against phase 5's {sum(steps5) / len(steps5):.4f} "
          f"({len(steps)} and {len(steps5)} steps)")
    divide_ms, widest = 0.0, None
    for (shape, dtype), count in sorted(divides.items()):
        x = torch.randn(shape, device=dev).to(dtype)
        s_ = 0.5 + torch.rand(shape[-1], device=dev)
        ms = cuda_ms(lambda: plain_divide(x, s_), 20)
        divide_ms += count * ms
        widest = max(widest or (0, shape, ms), (shape[0] * shape[1], shape, ms))
    step_s = sum(steps) / len(steps)
    print(f"  smooth divides: {sum(divides.values())} in the run at {len(divides)} shapes (each timed alone, CUDA "
          f"events), {divide_ms / len(steps):.3f} ms per step, {divide_ms / len(steps) / 1e3 / step_s:.1%} of the "
          f"step; the largest, {widest[1]}, {widest[2]:.4f} ms")
    print(f"  peak memory: device {torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB, host "
          f"{resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20:.2f} GiB (the process's largest resident set)")
    per_step = {n: (round(launches[n] / len(steps), 2), round(launches5[n] / len(steps5), 2)) for n in wrappers
                if launches[n] or launches5[n]}
    print(f"  launches per step, this run against phase 5's: {json.dumps(per_step)}")
    if len(steps) != len(steps5) or any(launches[n] != launches5[n] for n in wrappers):
        fail("the loaded path's launch counts differ from phase 5's")
    if not divides:
        fail("the loaded path ran no smooth-quant divide")
    return launches


# The T5 encode of the 2-layer XXL-width checkpoint, bf16 on the card
# against f32 on the CPU (the same weights): bf16 rounding of the hidden
# state, the projections and the probabilities through two layers.
T5_TOL = 2e-2


# ---------------------------------------------------------------------------
# phases 12-14: packed CFG, the host-streamed KV cache, several requests
# ---------------------------------------------------------------------------

PACK_KERNELS = ["segmented_attention_two_source", "segmented_attention_v2", "kv_norm_rope_pack", "gate_norm_residual"]


def run_packed_path(dev, config: dict, stem: str, wrappers: dict, path_kernels: list, launches4: dict,
                    stats4: dict) -> dict:
    """Phase 12: phase 4's request with `pack_uncond` (two DiT forwards a
    step: the uncond segments ride in the text forward) through the CLI
    entry with MAGI_PROFILE_DIR set (via `run_main_path`).  Requires K1, K2
    and K3 to launch twice a layer a step and K4 four times (2/3 of phase
    4's), and a profiler trace of the walk that names K1's symbol.  Prints
    the launches a step, the mean step and the device peak against phase
    4's.  Returns the launch counts."""
    import shutil

    trace_dir = os.path.join(os.path.dirname(stem), "trace_packed")
    shutil.rmtree(trace_dir, ignore_errors=True)
    os.environ["MAGI_PROFILE_DIR"] = trace_dir
    try:
        launches, stats = run_main_path(dev, config, stem, wrappers, path_kernels)
    finally:
        os.environ.pop("MAGI_PROFILE_DIR")
    L = config["model_config"]["num_layers"]
    steps, steps4 = stats["step_seconds"], stats4["step_seconds"]
    per = {n: launches[n] / len(steps) for n in PACK_KERNELS}
    per4 = {n: launches4[n] / len(steps4) for n in PACK_KERNELS}
    want = {n: (4 if n == "gate_norm_residual" else 2) * L for n in PACK_KERNELS}
    print(f"  launches per step, packed {json.dumps(per)} against phase 4's {json.dumps(per4)} (want "
          f"{json.dumps(want)}, 2/3 of phase 4's)")
    if per != want or any(3 * per[n] != 2 * per4[n] for n in PACK_KERNELS):
        fail(f"the packed walk launched {per} a step, expected {want}")
    print(f"  seconds per step (traced walk): mean {sum(steps) / len(steps):.4f} against phase 4's "
          f"{sum(steps4) / len(steps4):.4f}; device peak {stats['peak_gib']:.2f} GiB against phase 4's "
          f"{stats4['peak_gib']:.2f} GiB")
    trace = os.path.join(trace_dir, "walk", "trace.json")
    if not os.path.exists(trace):
        fail(f"MAGI_PROFILE_DIR set, but no trace at {trace}")
    with open(trace) as f:
        named = "seg_attn_two_source_kernel" in f.read()
    print(f"  profiler trace {trace}: {os.path.getsize(trace) / 2**20:.1f} MiB, names seg_attn_two_source_kernel: "
          f"{named}")
    if not named:
        fail("the walk's profiler trace does not name seg_attn_two_source_kernel")
    shutil.rmtree(trace_dir, ignore_errors=True)
    return launches


def _request(cfg, dev, params, prompt: str):
    from magi_tpu_torch.pipeline.prompt_process import build_inference_input, get_txt_embeddings

    null = params["y_embedder"]["null_caption_embedding"].float().cpu().numpy()
    return build_inference_input(cfg, null, *get_txt_embeddings(prompt, cfg, dev), dev)


def _timed_walk(sampler):
    import torch

    t0 = time.perf_counter()
    chunks = [c for _, c in sampler.walk()]
    torch.cuda.synchronize()
    return chunks, time.perf_counter() - t0


def _same_bits(a, b) -> bool:
    import torch

    if isinstance(a, dict):
        return all(_same_bits(a[k], b[k]) for k in a)
    return a.shape == b.shape and a.dtype == b.dtype and torch.equal(a, b.to(a.device))


def run_offload_pair(dev, config: dict, name: str, wrappers: dict, path_kernels: list):
    """Phase 13: `config`'s request under the default kv ranges walked by
    `ArdfSampler.walk` twice, the same weights and noise: the KV cache
    resident on the device, then in pinned host memory, streamed a layer
    slab at a time (`kv_offload`).  Requires bit-equal emitted latents and
    caches (the same kernels on the same bytes), equal launch counts, and
    every kernel of `path_kernels` launched by the streamed walk.  Prints
    the bytes copied a step each way beside the link's rate (one layer's
    slab, CUDA events), the mean step and the device peak, resident against
    streamed.  Returns the streamed walk's launch counts."""
    import torch

    from magi_tpu_torch.core.config import MagiConfig
    from magi_tpu_torch.pipeline.pipeline import get_dit
    from magi_tpu_torch.sampling.transport import ArdfSampler

    d = json.loads(json.dumps(config))
    d["runtime_config"]["noise2clean_kvrange"] = []
    cfg_res = MagiConfig.from_dict(d)
    d["engine_config"]["kv_offload"] = True
    cfg_str = MagiConfig.from_dict(d)
    gen = torch.Generator(device=dev)
    gen.manual_seed(cfg_res.runtime_config.seed)
    torch.cuda.empty_cache()
    params = get_dit(cfg_res, dev, gen)
    inp = _request(cfg_res, dev, params, "a red cube on a table")
    noise = torch.randn(inp.latent_size, generator=gen, device=dev)
    runs = {}
    for mode, cfg in (("resident", cfg_res), ("streamed", cfg_str)):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        sampler = ArdfSampler(cfg, params, inp, noise=noise, device=dev)
        if sampler.host_mode != (mode == "streamed"):
            fail(f"{name}: the {mode} walk has host_mode {sampler.host_mode}")
        for w in wrappers.values():
            w.launches = 0
        chunks, wall = _timed_walk(sampler)
        runs[mode] = dict(chunks=chunks, wall=wall, peak=torch.cuda.max_memory_allocated(dev),
                          launches={n: w.launches for n, w in wrappers.items()}, steps=sampler.step_seconds)
        if mode == "resident":
            # the cache as the host buffer lies (kv token-major), kept on the
            # host: the streamed walk runs without it on the device
            c = sampler.cache
            kv, sc = (c["kv"], c["scale"]) if isinstance(c, dict) else (c, None)
            resident_cache = (kv.movedim(-2, -4).contiguous().cpu(), None if sc is None else sc.cpu())
            cache_bytes = kv.nbytes + (0 if sc is None else sc.nbytes)
            del c, kv, sc
        else:
            hc = sampler.host_cache
        del sampler
    res, st = runs["resident"], runs["streamed"]
    steps = st["steps"]
    same_latents = len(res["chunks"]) == len(st["chunks"]) and all(
        _same_bits(a, b) for a, b in zip(res["chunks"], st["chunks"]))
    same_cache = _same_bits(resident_cache[0], hc._host_kv) and (
        resident_cache[1] is None or _same_bits(resident_cache[1], hc._host_sc))
    slab_bytes = sum(t.nbytes for t in hc._slab_kv + (hc._slab_sc or []))
    src, dst = hc._host_kv[0], hc._slab_kv[0]
    h2d_ms = cuda_ms(lambda: dst.copy_(src, non_blocking=True), 10)
    d2h_ms = cuda_ms(lambda: src.copy_(dst, non_blocking=True), 10)
    h2d_rate, d2h_rate = src.nbytes / h2d_ms / 1e6, src.nbytes / d2h_ms / 1e6
    per_step_h2d, per_step_d2h = hc.h2d_bytes / len(steps), hc.d2h_bytes / len(steps)
    mean = {m: sum(r["steps"]) / len(r["steps"]) for m, r in runs.items()}
    print(f"  {name}: {len(steps)} steps, {len(st['chunks'])} chunks; latents bit-equal, resident against streamed: "
          f"{same_latents}; cache bit-equal to the host buffer: {same_cache}")
    print(f"  copies a step: H2D {per_step_h2d / 1e6:.1f} MB, D2H {per_step_d2h / 1e6:.1f} MB; the link, one layer's "
          f"slab of {src.nbytes / 1e6:.1f} MB: H2D {h2d_rate:.1f} GB/s, D2H {d2h_rate:.1f} GB/s, so "
          f"{(per_step_h2d / h2d_rate + per_step_d2h / d2h_rate) / 1e9:.4f} s of copies a step")
    print(f"  seconds per step: resident {mean['resident']:.4f}, streamed {mean['streamed']:.4f}; walk wall "
          f"{res['wall']:.2f} / {st['wall']:.2f} s; device peak resident {res['peak'] / 2**30:.2f} GiB, streamed "
          f"{st['peak'] / 2**30:.2f} GiB (the cache {cache_bytes / 2**30:.2f} GiB, two slabs "
          f"{slab_bytes / 2**30:.3f} GiB)")
    print(f"  launches per step, streamed: "
          f"{json.dumps({n: round(st['launches'][n] / len(steps), 2) for n in path_kernels})}")
    if not same_latents or not same_cache:
        fail(f"{name}: the streamed walk's latents or cache differ from the resident walk's")
    if res["launches"] != st["launches"]:
        fail(f"{name}: launches differ, resident {res['launches']} against streamed {st['launches']}")
    missing = [n for n in path_kernels if st["launches"][n] == 0]
    if missing:
        fail(f"{name}: the streamed walk launched no {missing}")
    if not all(bool(torch.isfinite(c).all()) for c in st["chunks"]):
        fail(f"{name}: the streamed walk emitted non-finite latents")
    return st["launches"]


def run_multi_paths(dev, config: dict, stem: str, wrappers: dict, path_kernels: list, launches5: dict,
                    stats5: dict):
    """Phase 14: phase 5's config with two prompts through the CLI entry,
    lockstep (`--prompts a b`) and interleaved (`--interleave`, the decode
    on a worker thread and its own stream), each with every launch count
    set to 0 just before and read just after: two videos of phase 5's
    shape each, the same in both runs (their standard deviations), and
    exactly twice phase 5's launches of every kernel.  Then,
    through the samplers with fixed noises, each request's latents of the
    lockstep walk (`DpBatchedSampler`) and of `walk_many` against a solo
    walk of that request, bit for bit.  Prints the walls against two solo
    runs and the decode time the interleaved run hid.  Returns the launch
    counts of the two runs."""
    import torch

    from magi_tpu_torch.core.config import MagiConfig
    from magi_tpu_torch.pipeline import entry
    from magi_tpu_torch.pipeline.pipeline import get_dit
    from magi_tpu_torch.sampling.batched import DpBatchedSampler
    from magi_tpu_torch.sampling.transport import ArdfSampler, walk_many

    with open(stem + ".json", "w") as f:
        json.dump(config, f)
    prompts = ["a red cube on a table", "a blue ball rolls across the grass at dusk"]
    out, walls, stds = {}, {}, {}
    for mode, flags in (("lockstep", []), ("interleaved", ["--interleave"])):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        for w in wrappers.values():
            w.launches = 0
        t0 = time.perf_counter()
        stats = entry.main(["--config_file", stem + ".json", "--mode", "t2v", "--prompts", *prompts,
                            "--output_path", f"{stem}_{mode}.mp4"] + flags)
        walls[mode] = time.perf_counter() - t0
        out[mode] = launches = {n: w.launches for n, w in wrappers.items()}
        decode = sum(sum(s["decode_seconds"]) for s in stats)
        steps = stats[0]["step_seconds"]
        print(f"  {mode}: {[s['frames'] for s in stats]} frames -> {[s['path'] for s in stats]}; run wall "
              f"{walls[mode]:.2f} s, decode {decode:.2f} s in all, {len(steps)} steps of mean "
              f"{sum(steps) / len(steps):.4f} s; peak memory {torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB")
        walls[mode + "_decode"] = decode
        stds[mode] = [s["video_std"] for s in stats]
        bad = {n: (launches[n], launches5[n]) for n in wrappers if launches[n] != 2 * launches5[n]}
        if bad:
            fail(f"{mode}: launches not twice phase 5's (this run, phase 5): {bad}")
        for s in stats:
            if s["video_shape"] != (96, 256, 256, 3) or not s["latents_finite"] or s["video_std"] == 0:
                fail(f"{mode}: expected 96 finite frames of 256x256x3, got {s['video_shape']}, "
                     f"finite {s['latents_finite']}, std {s['video_std']}")
        missing = [n for n in path_kernels if launches[n] == 0]
        if missing:
            fail(f"{mode}: the run launched no {missing}")
    if stds["lockstep"] != stds["interleaved"]:
        fail(f"the interleaved videos differ from the lockstep ones (std {stds['interleaved']} against "
             f"{stds['lockstep']}): the same requests, the same latents")
    print(f"  videos: the same for every request, lockstep and interleaved (std {stds['lockstep']})")
    print(f"  launches, each run: twice phase 5's for every kernel ({json.dumps(out['lockstep'])})")
    print(f"  wall for the two requests: lockstep {walls['lockstep']:.2f} s, interleaved {walls['interleaved']:.2f} s, "
          f"two solo runs (phase 5's wall twice) {2 * stats5['wall']:.2f} s; the interleaved run hid "
          f"{walls['lockstep'] - walls['interleaved']:.2f} s of its {walls['interleaved_decode']:.2f} s of decode")

    cfg = MagiConfig.from_dict(config)
    gen = torch.Generator(device=dev)
    gen.manual_seed(cfg.runtime_config.seed)
    torch.cuda.empty_cache()
    params = get_dit(cfg, dev, gen)
    inps = [_request(cfg, dev, params, p) for p in prompts]
    noises = [torch.randn(inp.latent_size, generator=gen, device=dev) for inp in inps]
    solo, solo_wall = [], 0.0
    for inp, n in zip(inps, noises):
        chunks, wall = _timed_walk(ArdfSampler(cfg, params, inp, noise=n, device=dev))
        solo.append(chunks)
        solo_wall += wall
    batched, batch_wall = _timed_walk(DpBatchedSampler(cfg, params, inps, noises=noises, device=dev))
    many = [[], []]
    t0 = time.perf_counter()
    for r, _, chunk in walk_many([ArdfSampler(cfg, params, inp, noise=n, device=dev) for inp, n in zip(inps, noises)]):
        many[r].append(chunk)
    torch.cuda.synchronize()
    many_wall = time.perf_counter() - t0
    same_batch = all(len(batched) == len(solo[r]) and all(_same_bits(b[r], s) for b, s in zip(batched, solo[r]))
                     for r in range(2))
    same_many = all(len(many[r]) == len(solo[r]) and all(_same_bits(m, s) for m, s in zip(many[r], solo[r]))
                    for r in range(2))
    print(f"  samplers, fixed noises: each request's latents bit-equal to its solo walk: lockstep {same_batch}, "
          f"walk_many {same_many}; walk walls (no decode): two solo {solo_wall:.2f} s, lockstep {batch_wall:.2f} s, "
          f"walk_many {many_wall:.2f} s")
    if not (same_batch and same_many):
        fail("a request's latents in a multi-request walk differ from its solo walk")
    return out["lockstep"], out["interleaved"]


# ---------------------------------------------------------------------------
# phase 15: the steps replayed from CUDA graphs against the eager walk
# ---------------------------------------------------------------------------


def _profiled_idle(fn):
    """fn() under torch.profiler: (host wall ms with a synchronise, device
    busy ms: the kernels' and copies' device time summed, idle share)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    busy = sum(getattr(e, "self_device_time_total", 0.0) for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3
    return wall, busy, max(0.0, 1 - busy / wall)


def run_capture_pair(dev, config: dict, name: str, wrappers: dict, path_kernels: list):
    """Phase 15: `config`'s request walked by `ArdfSampler` eagerly
    (`capture=False`) and with its steps replayed from CUDA graphs (the
    default), the same weights and noise, each with every launch count set
    to 0 just before and read just after.  Requires bit-equal chunks,
    launches equal kernel by kernel, and one graph a variant.  Prints the
    variants and graphs and the seconds spent capturing them, the mean step
    (the profiled step left out), the idle share of the walk's second
    stage-3 step under torch.profiler (1 - device busy / its host wall),
    and the device peak of each.  Returns the launch counts of the eager
    and the captured walk."""
    import torch

    from magi_tpu_torch.core.config import MagiConfig
    from magi_tpu_torch.pipeline.pipeline import get_dit
    from magi_tpu_torch.sampling.transport import ArdfSampler

    cfg = MagiConfig.from_dict(config)
    gen = torch.Generator(device=dev)
    gen.manual_seed(cfg.runtime_config.seed)
    torch.cuda.empty_cache()
    params = get_dit(cfg, dev, gen)
    inp = _request(cfg, dev, params, "a red cube on a table")
    noise = torch.randn(inp.latent_size, generator=gen, device=dev)
    rc = cfg.runtime_config
    target = 3 * (rc.num_steps // rc.window_size) + 1
    runs = {}
    for mode in ("eager", "captured"):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        s = ArdfSampler(cfg, params, inp, noise=noise, device=dev, capture=mode == "captured")
        for w in wrappers.values():
            w.launches = 0
        t0 = time.perf_counter()
        variants = s.warm_step_variants()
        capture_s = time.perf_counter() - t0
        s.prepare()
        chunks, prof = [], None
        for step in range(s.total_forward_steps()):
            if step == target:
                prof = _profiled_idle(lambda: chunks.append(s.timed_step(step)))
            else:
                chunks.append(s.timed_step(step))
        torch.cuda.synchronize()
        steps = [t for i, t in enumerate(s.step_seconds) if i != target]
        runs[mode] = dict(chunks=[c[1] for c in chunks if c is not None], launches={n: w.launches for n, w in
                                                                                 wrappers.items()},
                          step=sum(steps) / len(steps), prof=prof, peak=torch.cuda.max_memory_allocated(dev) / 2**30,
                          variants=variants, graphs=s.graphs, capture_s=capture_s, arena=s._arena.nbytes / 2**20,
                          n_steps=s.total_forward_steps(), breakdown=s.capture_breakdown())
        del s
    e, c = runs["eager"], runs["captured"]
    same = len(e["chunks"]) == len(c["chunks"]) > 0 and all(_same_bits(a, b) for a, b in zip(e["chunks"], c["chunks"]))
    print(f"  {name}: {len(c['chunks'])} chunks bit-equal, eager against captured: {same}; launches equal kernel by "
          f"kernel: {e['launches'] == c['launches']}")
    b = c["breakdown"]
    print(f"  captured: {c['variants']} step variants, {c['graphs']} CUDA graphs, captured in {c['capture_s']:.3f} s "
          f"(eager warm-up runs {b['warm']:.3f} s, ending the captures {b['instantiate']:.3f} s; arena "
          f"{c['arena']:.1f} MiB)")
    for mode, r in runs.items():
        wall, busy, idle = r["prof"]
        print(f"  {mode}: seconds per step mean {r['step']:.4f}; step {target} under the profiler {wall:.1f} ms, device "
              f"busy {busy:.1f} ms, idle share {idle:.3f}; device peak {r['peak']:.2f} GiB")
    print(f"  launches per step, captured: "
          f"{json.dumps({n: round(c['launches'][n] / c['n_steps'], 2) for n in path_kernels})}")
    if not same:
        fail(f"{name}: the captured walk's chunks differ from the eager walk's")
    if e["launches"] != c["launches"]:
        fail(f"{name}: launches differ, eager {e['launches']} against captured {c['launches']}")
    if c["graphs"] != c["variants"] or c["variants"] < 2:
        fail(f"{name}: {c['graphs']} graphs for {c['variants']} step variants")
    missing = [n for n in path_kernels if c["launches"][n] == 0]
    if missing:
        fail(f"{name}: the captured walk launched no {missing}")
    return e["launches"], c["launches"]


def _leaves(tree):
    for v in tree.values():
        yield from (_leaves(v) if isinstance(v, dict) else [v])


def main() -> int:
    argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter).parse_args()

    import torch

    if not torch.cuda.is_available():
        fail("no CUDA device: this smoke test runs the port on the GPU")
    sys.path.insert(0, HERE)
    try:
        import magi_tpu_torch
    except ImportError as e:
        fail(f"the port's package is not beside this script ({e})")
    if os.path.dirname(os.path.dirname(os.path.abspath(magi_tpu_torch.__file__))) != HERE:
        fail(f"magi_tpu_torch imported from {magi_tpu_torch.__file__}, not from this checkout")
    if any(m == "jax" or m.startswith("jax.") or m == "magi_tpu" or m.startswith("magi_tpu.") for m in sys.modules):
        fail("the port imported jax or magi_tpu")

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    # a NaN in a decoded video (cast to uint8 without a trace otherwise) fails the run
    warnings.filterwarnings("error", message="invalid value encountered in cast", category=RuntimeWarning)

    from magi_tpu_torch.ops import _lib
    from magi_tpu_torch.ops import act_quant as AQ
    from magi_tpu_torch.ops import attention as A
    from magi_tpu_torch.ops import attention_q8 as A8
    from magi_tpu_torch.ops import fused_norm as FN
    from magi_tpu_torch.ops import quant as Q

    phase("phase 1: build")
    t0 = time.perf_counter()
    _lib.lib()
    print(f"  built {_lib.LIB_NAME} from {', '.join(_lib.SOURCES)} in {time.perf_counter() - t0:.2f} s")
    with open(os.path.join(_lib.BUILD_DIR, "build.log")) as f:
        for line in f:
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                print("  ptxas:", line.strip().split("ptxas info    : ")[-1])

    phase("phase 2: kernels against their plain versions (CUDA events)")
    warm_card(dev)
    int8_results, scheme_results = int8_kernel_checks(dev)
    results = kernel_checks(dev) + int8_results + w4a8_kernel_checks(dev) + scheme_results

    wrappers = {
        "segmented_attention_two_source": A.segmented_attention_two_source,
        "segmented_attention_v2": A.segmented_attention_v2,
        "segmented_attention": A.segmented_attention,
        "kv_norm_rope_pack": A.kv_norm_rope_pack,
        "gate_norm_residual": FN.gate_norm_residual,
        "kv_norm_rope_pack_q8": A.kv_norm_rope_pack_q8,
        "segmented_attention_two_source_q8": A8.segmented_attention_two_source_q8,
        "quantized_matmul_i8": Q.quantized_matmul_i8,
        "rowquant_fused": AQ.rowquant_fused,
        "quantized_matmul": Q.quantized_matmul,
        "rowquant_swiglu": AQ.rowquant_swiglu,
        "segmented_attention_two_source_q8_sage": A8.segmented_attention_two_source_q8_sage,
        "segmented_attention_two_source_q8_dq": A8.segmented_attention_two_source_q8_dq,
    }

    phase("phase 3: tiny walks, card against CPU")
    tiny_walk_check(dev, "tiny 3-CFG walk", CONFIG, 2e-2)
    tiny_walk_check(dev, "tiny distill int8 1-CFG walk with int8 attention", QUANT_CONFIG, TINY_QUANT_TOL,
                    model=dict(num_layers=3), engine=dict(attn_int8=True), quantize=Q.quantize_params_int8)
    tiny_walk_check(dev, "tiny distill gated int4 1-CFG walk without blocks_edge, int8 attention", QUANT_CONFIG,
                    TINY_QUANT_TOL, model=dict(num_layers=3, gated_linear_unit=True), engine=dict(attn_int8=True),
                    quantize=lambda p: Q.quantize_params_int4(p, keep_edge_bf16=False), wrappers=wrappers,
                    kernels=["quantized_matmul", "rowquant_swiglu", "quantized_matmul_i8", "rowquant_fused"])
    # smooth-quant trees, as an fp8 checkpoint loads: the divide before K8
    # plain on K6, and on K7 in the gated int4 tree (its fc2 without K8s)
    tiny_walk_check(dev, "tiny distill int8 1-CFG walk on a smooth-folded tree, int8 attention", QUANT_CONFIG,
                    TINY_QUANT_TOL, model=dict(num_layers=3), engine=dict(attn_int8=True),
                    quantize=lambda p: Q.quantize_params_int8(with_smooth(p, SMOOTH_LINEARS)), wrappers=wrappers,
                    kernels=["quantized_matmul_i8", "rowquant_fused"])
    tiny_walk_check(dev, "tiny distill gated int4 1-CFG walk without blocks_edge, fc2 smoothed, int8 attention",
                    QUANT_CONFIG, TINY_QUANT_TOL, model=dict(num_layers=3, gated_linear_unit=True),
                    engine=dict(attn_int8=True),
                    quantize=lambda p: Q.quantize_params_int4(with_smooth(p, ["mlp/linear_fc2"]), keep_edge_bf16=False),
                    wrappers=wrappers, kernels=["quantized_matmul", "quantized_matmul_i8", "rowquant_fused"],
                    idle=["rowquant_swiglu"])
    # v2v walks: a prefix of 3 latent frames (the warm-up forward writes
    # chunk 0, chunk 1 is half pasted), one chunk more
    tiny_walk_check(dev, "tiny 3-CFG v2v walk", CONFIG, 2e-2, prefix_frames=3, wrappers=wrappers,
                    kernels=["segmented_attention_two_source", "kv_norm_rope_pack"])
    for scheme in ("sage", "dq"):
        tiny_walk_check(dev, f"tiny distill int8 1-CFG v2v walk with int8 attention ({scheme})", QUANT_CONFIG,
                        TINY_QUANT_TOL, model=dict(num_layers=3), engine=dict(attn_int8=True),
                        quantize=Q.quantize_params_int8, prefix_frames=3, scheme=scheme, wrappers=wrappers,
                        kernels=[f"segmented_attention_two_source_q8_{scheme}"])
    # packed CFG (uncond rows in K1's source 2 only), and the host-streamed
    # cache under the default kv ranges (K1 and K3, K5 qk8 and K3q on slabs)
    tiny_walk_check(dev, "tiny packed 3-CFG walk", CONFIG, 2e-2, engine=dict(pack_uncond=True), wrappers=wrappers,
                    kernels=["segmented_attention_two_source", "kv_norm_rope_pack"])
    tiny_walk_check(dev, "tiny host-offloaded 3-CFG walk, default kv ranges", CONFIG, 2e-2,
                    engine=dict(kv_offload=True), runtime=dict(noise2clean_kvrange=[]), wrappers=wrappers,
                    kernels=["segmented_attention_two_source", "kv_norm_rope_pack"])
    tiny_walk_check(dev, "tiny host-offloaded distill int8 1-CFG walk with int8 attention, default kv ranges",
                    QUANT_CONFIG, TINY_QUANT_TOL, model=dict(num_layers=3),
                    engine=dict(attn_int8=True, kv_offload=True), runtime=dict(noise2clean_kvrange=[]),
                    quantize=Q.quantize_params_int8, wrappers=wrappers,
                    kernels=["segmented_attention_two_source_q8", "kv_norm_rope_pack_q8"])

    out_dir = os.path.join(_lib.BUILD_DIR, "smoke")
    os.makedirs(out_dir, exist_ok=True)
    os.environ["SKIP_LOAD_MODEL"] = "1"

    phase(f"phase 4: 4.5B t2v through the CLI entry (256x256, 96 frames, {STEPS} steps)")
    with open(CONFIG) as f:
        d = json.load(f)
    d["runtime_config"].update(video_size_h=256, video_size_w=256, num_frames=96, num_steps=STEPS)
    base_kernels = ["segmented_attention_two_source", "segmented_attention_v2", "segmented_attention",
                    "kv_norm_rope_pack", "gate_norm_residual"]
    launches4, stats4 = run_main_path(dev, d, os.path.join(out_dir, "4.5B_base_256"), wrappers, base_kernels)

    phase("phase 5: 4.5B distill + int8 t2v with int8 attention through the CLI entry (256x256, 96 frames, "
          "the config's 16 steps)")
    with open(QUANT_CONFIG) as f:
        d = json.load(f)
    d["runtime_config"].update(video_size_h=256, video_size_w=256, num_frames=96)
    d["engine_config"]["attn_int8"] = True
    distill_kernels = ["kv_norm_rope_pack_q8", "segmented_attention_two_source_q8", "quantized_matmul_i8",
                       "rowquant_fused", "gate_norm_residual", "segmented_attention"]
    launches5, stats5 = run_main_path(dev, d, os.path.join(out_dir, "4.5B_distill_quant_256"), wrappers,
                                      distill_kernels)

    # the 24B distill config on one device: cp_size 1 (the config's 8 is its
    # multi-GPU layout), int4 weights, int8 attention
    with open(CONFIG_24B) as f:
        d = json.load(f)
    d["runtime_config"].update(video_size_h=256, video_size_w=256, num_frames=96)
    d["engine_config"].update(attn_int8=True, quant_bits=4, cp_size=1)
    w4a8_kernels = ["kv_norm_rope_pack_q8", "segmented_attention_two_source_q8", "quantized_matmul_i8",
                    "rowquant_fused", "rowquant_swiglu", "gate_norm_residual"]
    phase("phase 6: 24B distill w4a8 t2v with int8 attention through the CLI entry (48 layers, 6144 wide, "
          "256x256, 96 frames, the config's 16 steps)")
    launches6, _ = run_main_path(dev, d, os.path.join(out_dir, "24B_distill_w4a8_256"), wrappers,
                                 w4a8_kernels + ["segmented_attention"])
    phase("phase 7: the 24B w4a8 tree without blocks_edge, ArdfSampler.walk of 2 chunks (256x256)")
    d["runtime_config"]["num_frames"] = 48
    launches7 = run_noedge_walk(dev, d, wrappers, w4a8_kernels + ["quantized_matmul"])

    phase(f"phase 8: 4.5B i2v through encode_prefix_video and MagiPipeline._run (256x256, 96 frames, {STEPS} steps)")
    with open(CONFIG) as f:
        d = json.load(f)
    d["runtime_config"].update(video_size_h=256, video_size_w=256, num_frames=96, num_steps=STEPS)
    launches8 = run_prefix_path(dev, d, os.path.join(out_dir, "4.5B_base_i2v_256"), wrappers, [
        "segmented_attention_two_source", "segmented_attention_v2", "segmented_attention", "kv_norm_rope_pack",
        "gate_norm_residual"], mode="i2v")

    # the int8 paths under the other two schemes of K5: no launch of another
    q8_names = {s_: "segmented_attention_two_source_q8" + ("" if s_ == "qk8" else f"_{s_}") for s_ in A8.SCHEMES}
    int8_kernels = ["kv_norm_rope_pack_q8", "quantized_matmul_i8", "rowquant_fused", "gate_norm_residual",
                    "segmented_attention"]
    with open(QUANT_CONFIG) as f:
        d = json.load(f)
    d["runtime_config"].update(video_size_h=256, video_size_w=256, num_frames=96)
    d["engine_config"]["attn_int8"] = True
    phase("phase 9: 4.5B distill + int8 v2v from a 32-frame prefix video, int8 attention under "
          "MAGI_ATTN_Q8_SCHEME=sage (256x256, 96 frames, the config's 16 steps)")
    launches9 = run_prefix_path(dev, d, os.path.join(out_dir, "4.5B_distill_quant_v2v_sage_256"), wrappers,
                                int8_kernels + [q8_names["sage"]], mode="v2v", scheme="sage",
                                idle_kernels=[q8_names["qk8"], q8_names["dq"]])
    phase("phase 10: 4.5B distill + int8 i2v, int8 attention under MAGI_ATTN_Q8_SCHEME=dq (256x256, 96 frames, "
          "the config's 16 steps)")
    launches10 = run_prefix_path(dev, d, os.path.join(out_dir, "4.5B_distill_quant_i2v_dq_256"), wrappers,
                                 int8_kernels + [q8_names["dq"]], mode="i2v", scheme="dq",
                                 idle_kernels=[q8_names["qk8"], q8_names["sage"]])

    phase(f"phase 11: 4.5B distill fp8 t2v from checkpoints on disk through the CLI entry, SKIP_LOAD_MODEL "
          f"unset (DiT fp8 {FP8_CKPT_LAYERS} layers x 3072, VAE 1024 x 16, T5 at XXL width with 2 layers; "
          f"256x256, 96 frames, the config's 16 steps, int8 attention)")
    with open(QUANT_CONFIG) as f:
        d = json.load(f)
    d["model_config"]["num_layers"] = FP8_CKPT_LAYERS
    d["runtime_config"].update(video_size_h=256, video_size_w=256, num_frames=96)
    d["engine_config"]["attn_int8"] = True
    launches11 = run_loaded_path(dev, d, os.path.join(out_dir, "4.5B_distill_fp8_ckpt_256"), wrappers,
                                 distill_kernels, launches5, stats5)

    with open(CONFIG) as f:
        base = json.load(f)
    base["runtime_config"].update(video_size_h=256, video_size_w=256, num_frames=96, num_steps=STEPS)
    phase(f"phase 12: 4.5B base t2v with pack_uncond (2 forwards a step) through the CLI entry, MAGI_PROFILE_DIR "
          f"set (256x256, 96 frames, {STEPS} steps)")
    packed = json.loads(json.dumps(base))
    packed["engine_config"]["pack_uncond"] = True
    launches12 = run_packed_path(dev, packed, os.path.join(out_dir, "4.5B_base_packed_256"), wrappers, base_kernels,
                                 launches4, stats4)

    with open(QUANT_CONFIG) as f:
        d = json.load(f)
    d["runtime_config"].update(video_size_h=256, video_size_w=256, num_frames=96)
    d["engine_config"]["attn_int8"] = True
    phase("phase 13: host-streamed KV cache against the resident one, default kv ranges, ArdfSampler.walk "
          f"(4.5B distill + int8 with int8 attention, 16 steps; 4.5B base 3-CFG, {STEPS} steps; 256x256, 96 frames)")
    launches13q = run_offload_pair(dev, d, "distill int8 (int8 host buffers)", wrappers,
                                   ["kv_norm_rope_pack_q8", "segmented_attention_two_source_q8", "quantized_matmul_i8",
                                    "rowquant_fused", "gate_norm_residual"])
    launches13 = run_offload_pair(dev, base, "base bf16 3-CFG", wrappers,
                                  ["segmented_attention_two_source", "segmented_attention_v2", "kv_norm_rope_pack",
                                   "gate_norm_residual"])

    phase("phase 14: two requests on the 4.5B distill + int8 config through the CLI entry, lockstep (--prompts) "
          "and interleaved (--interleave), then each request against its solo walk (256x256, 96 frames)")
    launches14b, launches14m = run_multi_paths(dev, d, os.path.join(out_dir, "4.5B_distill_quant_two"), wrappers,
                                               distill_kernels, launches5, stats5)

    phase(f"phase 15: the steps replayed from CUDA graphs against the eager walk, ArdfSampler.walk of phase 4's "
          f"request ({STEPS} steps) and of phase 5's (256x256, 96 frames)")
    launches15be, launches15bc = run_capture_pair(dev, base, "4.5B base 3-CFG", wrappers,
                                                  ["segmented_attention_two_source", "segmented_attention_v2",
                                                   "kv_norm_rope_pack", "gate_norm_residual"])
    launches15de, launches15dc = run_capture_pair(dev, d, "4.5B distill + int8", wrappers,
                                                  ["kv_norm_rope_pack_q8", "segmented_attention_two_source_q8",
                                                   "quantized_matmul_i8", "rowquant_fused", "gate_norm_residual"])

    for r in results:
        r["launches_by_path"] = {"base": launches4[r["name"]], "distill_int8": launches5[r["name"]],
                                 "24b_w4a8": launches6[r["name"]], "24b_w4a8_noedge": launches7[r["name"]],
                                 "i2v_base": launches8[r["name"]], "v2v_distill_int8_sage": launches9[r["name"]],
                                 "i2v_distill_int8_dq": launches10[r["name"]],
                                 "distill_int8_fp8_ckpt": launches11[r["name"]], "base_packed": launches12[r["name"]],
                                 "distill_int8_host_offload": launches13q[r["name"]],
                                 "base_host_offload": launches13[r["name"]],
                                 "distill_int8_batch2": launches14b[r["name"]],
                                 "distill_int8_many2": launches14m[r["name"]],
                                 "base_eager": launches15be[r["name"]], "base_captured": launches15bc[r["name"]],
                                 "distill_int8_eager": launches15de[r["name"]],
                                 "distill_int8_captured": launches15dc[r["name"]]}
        r["launches"] = sum(r["launches_by_path"].values())

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    if smi.returncode != 0:
        fail(f"nvidia-smi failed: {smi.stderr}")
    phase("done")
    print(smi.stdout.strip().splitlines()[0])
    keys = ["name", "route", "source", "replaces", "launches", "launches_by_path", "max_abs_err", "ms", "plain_ms",
            "bound_ms", "bound_by", "library_ms"]
    extra = ["graph_ms", "every_caption_tokens", "decode_720", "base_720", "distill_720"]  # K2, K2g, K3, K3q
    print(json.dumps({"kernels": [{k: r[k] for k in keys + [x for x in extra if x in r]} for r in results]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (`magi_tpu_torch`) on one GPU.

    python3 chip_smoke.py

Phases, each printed on its own line; any failure exits non-zero:
  1. build the CUDA kernels from `magi_tpu_torch/csrc` (build seconds);
  2. hold every kernel against its plain PyTorch version on the card at the
     shapes the t2v run below gives it, with the stated tolerance, and time
     kernel, plain version and a PyTorch library yardstick (CUDA events);
  3. a tiny walk with the kernels against the same walk on the CPU in fp32
     (plain versions), same weights and noise;
  4. the 4.5B base config at full width and depth (34 layers, 3072 wide,
     24/8 heads, caption 800 x 4096) through the port's CLI entry with
     random weights (SKIP_LOAD_MODEL=1) and 3-branch CFG, noise2clean kv
     ranges and window 4; only the traffic is cut (256x256, 96 frames,
     16 steps).  Every kernel's launch count in this run must be > 0.
Then the card's name and power limit, one JSON line of per-kernel results,
and a last line `{"ok": true, "device": {...}}`.

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

HERE = os.path.dirname(os.path.abspath(__file__))
CONFIG = os.path.join(HERE, "example", "4.5B", "4.5B_base_config.json")

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit)
PEAK_BF16_FLOPS = 989e12
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES = 3.35e12
STEPS = 16  # denoise steps of the 4.5B run (64 in the config)


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


def bound(nbytes: float, flops: float, peak_flops: float):
    t_bytes, t_ops = nbytes / PEAK_BYTES, flops / peak_flops
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def span_tokens(starts, ends) -> int:
    """Tokens in the union of [start, end) ranges."""
    covered = set()
    for s, e in zip(starts.tolist(), ends.tolist()):
        covered.update(range(s, e))
    return len(covered)


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
    k, v = randn(S, hk, hd), randn(S, hk, hd)
    kw = 1.0 + 0.1 * randn(hd, dtype=torch.float32)
    kb = 0.1 * randn(hd, dtype=torch.float32)
    ang = torch.rand((S, rot), generator=g, device=dev) * 6.28
    sin, cos = torch.sin(ang), torch.cos(ang)
    out = A.kv_norm_rope_pack(k, v, kw, kb, sin, cos, eps=eps)
    ref = A.kv_norm_rope_pack_reference(k, v, kw, kb, sin, cos, eps=eps)
    err = check_close("kv_norm_rope_pack", out, ref, 1e-2, 1e-2)
    ms = cuda_ms(lambda: A.kv_norm_rope_pack(k, v, kw, kb, sin, cos, eps=eps), 50)
    plain_ms = cuda_ms(lambda: A.kv_norm_rope_pack_reference(k, v, kw, kb, sin, cos, eps=eps), 10)

    def lib_k3():
        kn = F.layer_norm(k.float(), (hd,), kw, kb, eps)
        x1, x2 = kn[..., :rot], kn[..., rot : 2 * rot]
        s_, c_ = sin[:, None], cos[:, None]
        kn = torch.cat([x1 * c_ - x2 * s_, x1 * s_ + x2 * c_, kn[..., 2 * rot :]], -1)
        return torch.stack([kn.bfloat16(), v]).transpose(1, 2).contiguous()

    lib_ms = cuda_ms(lib_k3, 10)
    nbytes = 2 * S * hk * hd * 2 + 2 * S * rot * 4 + 2 * hd * 4 + 2 * S * hk * hd * 2
    bms, by = bound(nbytes, 10 * S * hk * hd, PEAK_FP32_FLOPS)
    results.append(dict(name="kv_norm_rope_pack", route="cuda", source="magi_tpu_torch/csrc/norm.cu",
                        replaces="magi_tpu/ops/attention.py:800", max_abs_err=err, ms=ms, plain_ms=plain_ms,
                        bound_ms=bms, bound_by=by, library_ms=lib_ms))

    # ---- K4 gate_norm_residual -------------------------------------------
    x, res = randn(S, D), randn(S, D)
    gate = torch.rand((n_seg, D), generator=g, device=dev) * 2 - 1
    w = 0.1 * randn(D, dtype=torch.float32)
    b = 0.1 * randn(D, dtype=torch.float32)
    kwargs = dict(eps=eps, zero_centered=True, n_seg=n_seg)
    out = FN.gate_norm_residual(x, res, gate, w, b, **kwargs)
    ref = FN.gate_norm_residual_reference(x, res, gate, w, b, **kwargs)
    err = check_close("gate_norm_residual", out, ref, 1e-2, 1e-2)
    ms = cuda_ms(lambda: FN.gate_norm_residual(x, res, gate, w, b, **kwargs), 50)
    plain_ms = cuda_ms(lambda: FN.gate_norm_residual_reference(x, res, gate, w, b, **kwargs), 10)

    def lib_k4():
        xg = (x.float().view(n_seg, ctn, D) * gate[:, None]).view(S, D)
        return (F.layer_norm(xg, (D,), w + 1.0, b, eps) + res.float()).bfloat16()

    lib_ms = cuda_ms(lib_k4, 10)
    nbytes = 3 * S * D * 2 + n_seg * D * 4 + 2 * D * 4
    bms, by = bound(nbytes, 10 * S * D, PEAK_FP32_FLOPS)
    results.append(dict(name="gate_norm_residual", route="cuda", source="magi_tpu_torch/csrc/norm.cu",
                        replaces="magi_tpu/ops/fused_norm.py:70", max_abs_err=err, ms=ms, plain_ms=plain_ms,
                        bound_ms=bms, bound_by=by, library_ms=lib_ms))

    def sdpa_ms(qn, kk, vv, valid, seg):
        """F.scaled_dot_product_attention on the same (prologue-applied) q
        with the equivalent boolean mask; token-major inputs."""
        qb = qn.transpose(0, 1)[None]
        kb_ = kk.transpose(0, 1)[None]
        vb = vv.transpose(0, 1)[None]
        mask = valid.repeat_interleave(seg, dim=0)[None, None]
        return cuda_ms(lambda: F.scaled_dot_product_attention(qb, kb_, vb, attn_mask=mask, enable_gqa=True), 5)

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
    bms, by = bound(nbytes, 4 * ctn * attended * hd * hq, PEAK_BF16_FLOPS)
    results.append(dict(name="segmented_attention_two_source", route="cuda", source="magi_tpu_torch/csrc/attention.cu",
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
    ms = cuda_ms(call, 20)
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
    attended = int((xe - xs_).sum())
    nbytes = 2 * S * hq * hd * 2 + span_tokens(xs_, xe) * 2 * hk * hd * 2
    bms, by = bound(nbytes, 4 * ctn * attended * hd * hq, PEAK_BF16_FLOPS)
    results.append(dict(name="segmented_attention_v2", route="cuda", source="magi_tpu_torch/csrc/attention.cu",
                        replaces="magi_tpu/ops/attention.py:678", max_abs_err=err, ms=ms, plain_ms=plain_ms,
                        bound_ms=bms, bound_by=by, library_ms=lib_ms))

    # ---- K2g segmented_attention: VAE self-attention, head_dim 64 --------
    N, B, hv, hdv = 3 * 32 * 32 + 1, 2, 16, 64  # a 3-latent-frame tile + cls, 2 tiles per chunk
    qv, kv_, vv_ = randn(B * N, hv, hdv), randn(B * N, hv, hdv), randn(B * N, hv, hdv)
    st_ = torch.arange(B, dtype=torch.int32, device=dev) * N
    call = lambda: A.segmented_attention(qv, kv_, vv_, st_, st_ + N, seg_len=N)
    out = call()
    ref = A.segmented_attention_reference(qv, kv_, vv_, st_, st_ + N, seg_len=N)
    err = check_close("segmented_attention (VAE, hd 64)", out, ref, *ATTN_TOL)
    ms = cuda_ms(call, 20)
    plain_ms = cuda_ms(lambda: A.segmented_attention_reference(qv, kv_, vv_, st_, st_ + N, seg_len=N), 3)
    col = torch.arange(B * N, device=dev)[None]
    lib_ms = sdpa_ms(qv, kv_, vv_, (col >= st_[:, None]) & (col < st_[:, None] + N), N)
    nbytes = 4 * B * N * hv * hdv * 2
    bms, by = bound(nbytes, 4 * B * N * N * hdv * hv, PEAK_BF16_FLOPS)
    results.append(dict(name="segmented_attention", route="cuda", source="magi_tpu_torch/csrc/attention.cu",
                        replaces="magi_tpu/ops/attention.py:307", max_abs_err=err, ms=ms, plain_ms=plain_ms,
                        bound_ms=bms, bound_by=by, library_ms=lib_ms))
    for r in results:
        print(f"  {r['name']}: {r['ms']:.4f} ms (plain {r['plain_ms']:.4f}, library {r['library_ms']:.4f}, "
              f"bound {r['bound_ms']:.4f} by {r['bound_by']})")
    return results


# ---------------------------------------------------------------------------
# phase 3: tiny walk on the card against the CPU fp32 walk
# ---------------------------------------------------------------------------


def tiny_walk_check(dev):
    """A 2-layer model at head_dim 128 (so every kernel runs) walks 3 chunks
    on the card in bf16 and on the CPU in fp32 with the same weights and
    noise; the emitted latents must agree to bf16 accuracy."""
    import numpy as np
    import torch

    from magi_tpu_torch.core.config import MagiConfig
    from magi_tpu_torch.models.dit.model import init_dit_params
    from magi_tpu_torch.sampling.transport import ArdfSampler, InferenceInput

    with open(CONFIG) as f:
        d = json.load(f)
    d["model_config"].update(num_layers=2, hidden_size=768, ffn_hidden_size=1536, num_attention_heads=6,
                             num_query_groups=2, caption_channels=64, caption_max_length=32)
    d["runtime_config"].update(num_steps=8, window_size=2, chunk_width=2, noise2clean_kvrange=[3, 2],
                               clean_chunk_kvrange=1)
    cfg_gpu = MagiConfig.from_dict(d)
    d["model_config"]["params_dtype"] = "torch.float32"
    cfg_cpu = MagiConfig.from_dict(d)
    mc = cfg_cpu.model_config
    n_chunks, H, W, Lc = 3, 16, 16, mc.caption_max_length
    gen = torch.Generator(device="cpu")
    gen.manual_seed(1)
    p_bf = init_dit_params(cfg_gpu, "cpu", gen)  # bf16 values are exact in fp32
    p_gpu = _map(p_bf, lambda t: t.to(dev))
    p_cpu = _map(p_bf, lambda t: t.float())
    rng = np.random.default_rng(0)
    noise = torch.from_numpy(rng.normal(size=(mc.in_channels, n_chunks * 2, H, W)).astype(np.float32))
    cap = torch.from_numpy(rng.normal(size=(n_chunks, Lc, mc.caption_channels)).astype(np.float32))
    null = torch.from_numpy(rng.normal(size=(Lc, mc.caption_channels)).astype(np.float32))

    def walk(cfg, params, device):
        inp = InferenceInput(
            caption_embs=cap.to(device), caption_lens=np.array([9, 9, 9], np.int32), null_emb=null.to(device),
            null_len=5, latent_size=(mc.in_channels, n_chunks * 2, H, W), num_steps=8, chunk_num=n_chunks,
            has_text=True)
        return torch.cat([c.cpu() for _, c in ArdfSampler(cfg, params, inp, noise=noise, device=device).walk()], 1)

    a, b = walk(cfg_gpu, p_gpu, dev), walk(cfg_cpu, p_cpu, "cpu")
    rel = float((a - b).norm() / b.norm())
    ok = bool(torch.isfinite(a).all()) and a.shape == b.shape and rel < 2e-2
    print(f"  tiny 3-CFG walk, card (kernels, bf16) vs CPU (plain, fp32): relative L2 error {rel:.3e} "
          f"(tolerance 2e-2) {'ok' if ok else 'FAILED'}")
    if not ok:
        fail("tiny walk on the card disagrees with the CPU walk")
    return rel


def _map(tree, fn):
    return {k: _map(v, fn) if isinstance(v, dict) else fn(v) for k, v in tree.items()}


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

    from magi_tpu_torch.ops import _lib
    from magi_tpu_torch.ops import attention as A
    from magi_tpu_torch.ops import fused_norm as FN

    print("phase 1: build", flush=True)
    t0 = time.perf_counter()
    _lib.lib()
    print(f"  built {_lib.LIB_NAME} from {', '.join(_lib.SOURCES)} in {time.perf_counter() - t0:.2f} s")
    with open(os.path.join(_lib.BUILD_DIR, "build.log")) as f:
        for line in f:
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                print("  ptxas:", line.strip().split("ptxas info    : ")[-1])

    print("phase 2: kernels against their plain versions (CUDA events)", flush=True)
    results = kernel_checks(dev)

    wrappers = {
        "segmented_attention_two_source": A.segmented_attention_two_source,
        "segmented_attention_v2": A.segmented_attention_v2,
        "segmented_attention": A.segmented_attention,
        "kv_norm_rope_pack": A.kv_norm_rope_pack,
        "gate_norm_residual": FN.gate_norm_residual,
    }
    print("phase 3: tiny walk, card against CPU", flush=True)
    tiny_walk_check(dev)

    print(f"phase 4: 4.5B t2v through the CLI entry (256x256, 96 frames, {STEPS} steps)", flush=True)
    with open(CONFIG) as f:
        d = json.load(f)
    d["runtime_config"].update(video_size_h=256, video_size_w=256, num_frames=96, num_steps=STEPS)
    out_dir = os.path.join(_lib.BUILD_DIR, "smoke")
    os.makedirs(out_dir, exist_ok=True)
    cfg_path = os.path.join(out_dir, "4.5B_base_256.json")
    with open(cfg_path, "w") as f:
        json.dump(d, f)
    os.environ["SKIP_LOAD_MODEL"] = "1"
    from magi_tpu_torch.pipeline import entry

    for w in wrappers.values():
        w.launches = 0
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    stats = entry.main(["--config_file", cfg_path, "--mode", "t2v", "--prompt", "a red cube on a table",
                        "--output_path", os.path.join(out_dir, "t2v_256.mp4")])
    wall = time.perf_counter() - t0
    launches = {name: w.launches for name, w in wrappers.items()}
    steps = stats["step_seconds"]
    print(f"  frames written: {stats['frames']} -> {stats['path']}")
    print(f"  denoise steps: {len(steps)}, seconds per step: mean {sum(steps) / len(steps):.4f}, "
          f"first {steps[0]:.4f}, last {steps[-1]:.4f}; VAE decode seconds per chunk: "
          f"{', '.join(f'{s:.3f}' for s in stats['decode_seconds'])}; run wall {wall:.1f} s; "
          f"peak memory {torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB")
    print(f"  launches in this run: {json.dumps(launches)}")
    print(f"  video {stats['video_shape']}, std {stats['video_std']:.2f}, latents finite: {stats['latents_finite']}")
    if stats["video_shape"] != (96, 256, 256, 3) or not os.path.exists(stats["path"]):
        fail(f"expected 96 frames of 256x256x3 written, got {stats['video_shape']} at {stats['path']}")
    if not stats["latents_finite"] or stats["video_std"] == 0:
        fail("the walk emitted non-finite latents or a constant video")
    missing = [n for n, c in launches.items() if c == 0]
    if missing:
        fail(f"the main path launched no {missing}")
    for r in results:
        r["launches"] = launches[r["name"]]

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    if smi.returncode != 0:
        fail(f"nvidia-smi failed: {smi.stderr}")
    print(smi.stdout.strip().splitlines()[0])
    keys = ["name", "route", "source", "replaces", "launches", "max_abs_err", "ms", "plain_ms", "bound_ms",
            "bound_by", "library_ms"]
    print(json.dumps({"kernels": [{k: r[k] for k in keys} for r in results]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

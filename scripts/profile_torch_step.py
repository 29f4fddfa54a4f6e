#!/usr/bin/env python3
"""Where a denoise step of the PyTorch/CUDA port spends its time on one GPU.

    python3 scripts/profile_torch_step.py

Builds the 4.5B base config (example/4.5B/4.5B_base_config.json) at full
width and depth with random weights, then for each video size runs one
denoise step of the given ARDF stage (stage 3 is the first step with the
full window of 4 chunks) twice: once timed on the host clock with a
device synchronise (after one warm-up step), once under torch.profiler.
It prints the device time summed by kernel group (the port's hand-written
kernels one by one, cuBLAS GEMMs, the rest), the device-busy and idle
share of the step, and the attention FLOPs of the step's K1 launches with
the rate they reached.  Then one VAE decode of a chunk, the same way.
The KV cache holds zeros: timing does not depend on its values.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from collections import defaultdict

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

import numpy as np  # noqa: E402
import torch  # noqa: E402

SIZES = (256, 720)  # the smoke's size and the config's own
STAGE = 3  # ARDF stage of the profiled step: the first with the full window of 4 chunks
STEPS = 64  # the config's schedule

K1 = "K1 segmented_attention_two_source (seg_attn_two_source_kernel)"
K2 = "K2 segmented_attention_v2 (seg_attn_v2_kernel, caption)"
K2G = "K2g segmented_attention (seg_attn_grid_kernel, VAE)"
K3 = "kv_norm_rope_pack"
K4 = "gate_norm_residual"


def group_of(name: str) -> str:
    if "seg_attn_two_source_kernel" in name:
        return K1
    if "seg_attn_v2_kernel" in name:
        return K2
    if "seg_attn_grid_kernel" in name:
        return K2G
    if "kv_norm_rope_pack_kernel" in name:
        return K3
    if "gate_norm_residual_kernel" in name:
        return K4
    low = name.lower()
    if any(s in low for s in ("gemm", "nvjet", "xmma", "cutlass", "cublas", "sm90_")):
        return "cuBLAS GEMM"
    return "other (elementwise, copies, LayerNorms, conv, reductions)"


def profile(fn):
    """Device time by kernel group (ms) and the profiled wall time (ms)."""
    from torch.profiler import ProfilerActivity, profile as tprofile

    torch.cuda.synchronize()
    with tprofile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    groups = defaultdict(float)
    counts = defaultdict(int)
    for evt in prof.key_averages():
        dev_us = getattr(evt, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(evt, "self_cuda_time_total", 0.0)
        if dev_us and evt.device_type == torch.autograd.DeviceType.CUDA:
            g = group_of(evt.key)
            groups[g] += dev_us / 1e3
            counts[g] += evt.count
    return groups, counts, wall


def k1_flops(sampler, step: int) -> float:
    """FLOPs of the step's self-attention launches (QK^T and PV, 2 flops per
    MAC): two cache-reading forwards over the plan's ranges, one uncond
    forward over self-only ranges, each on every layer."""
    mc = sampler.config.model_config
    p = sampler._plan(step)
    per_layer = 4 * sampler.ctn * mc.kv_channels * mc.num_attention_heads
    cond = float(np.sum(p["kv_end"] - p["kv_start"])) * per_layer
    uncond = p["n_den"] * sampler.ctn * per_layer
    return (2 * cond + uncond) * mc.num_layers


def main() -> int:
    argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter).parse_args()
    if not torch.cuda.is_available():
        print("FAIL: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    os.environ["SKIP_LOAD_MODEL"] = "1"

    from magi_tpu_torch.core.config import MagiConfig
    from magi_tpu_torch.models.dit.model import init_dit_params
    from magi_tpu_torch.pipeline.prompt_process import build_inference_input, get_txt_embeddings
    from magi_tpu_torch.pipeline.video_process import post_chunk_process
    from magi_tpu_torch.sampling.transport import ArdfSampler

    dev = torch.device("cuda", 0)
    with open(os.path.join(HERE, "example", "4.5B", "4.5B_base_config.json")) as f:
        base = json.load(f)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    cfg0 = MagiConfig.from_dict(base)
    params = init_dit_params(cfg0, dev, gen)
    null = params["y_embedder"]["null_caption_embedding"].float().cpu().numpy()
    results = {}
    for size in SIZES:
        d = json.loads(json.dumps(base))
        d["runtime_config"].update(video_size_h=size, video_size_w=size, num_steps=STEPS)
        cfg = MagiConfig.from_dict(d)
        emb, mask = get_txt_embeddings("a red cube on a table", cfg)
        inp = build_inference_input(cfg, null, emb, mask, dev)
        sampler = ArdfSampler(cfg, params, inp, gen, device=dev)
        dpss = cfg.runtime_config.num_steps // cfg.runtime_config.window_size
        step = STAGE * dpss
        p = sampler._plan(step)
        sampler.do_step(step)  # warm-up (cuBLAS heuristics, allocator)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sampler.do_step(step + 1)
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t0) * 1e3
        groups, counts, wall = profile(lambda: sampler.do_step(step + 2))
        busy = sum(groups.values())
        flops = k1_flops(sampler, step + 2)
        k1_ms = groups.get(K1, 0.0)
        print(f"== {size}x{size}: stage {STAGE} step (n_seg {p['n_seg']}, seg_len {sampler.ctn} tokens, "
              f"{cfg.model_config.num_layers} layers, 3 forwards)")
        print(f"  step wall {step_ms:.1f} ms (host clock, synchronised, no profiler); under the profiler "
              f"{wall:.1f} ms, device busy {busy:.1f} ms, idle share {max(0.0, 1 - busy / wall):.3f}")
        for g, ms in sorted(groups.items(), key=lambda kv: -kv[1]):
            print(f"  {ms:10.2f} ms  {100 * ms / busy:5.1f}%  {counts[g]:6d} launches  {g}")
        print(f"  self-attention FLOPs of the step {flops:.3e}; K1 device time {k1_ms:.1f} ms "
              f"-> {flops / (k1_ms * 1e-3) / 1e12:.1f} TFLOP/s")
        # one VAE decode of a chunk
        chunk = torch.randn((16, 6, size // 8, size // 8), generator=gen, device=dev)
        post_chunk_process(chunk, cfg, dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        post_chunk_process(chunk, cfg, dev)
        dec_ms = (time.perf_counter() - t0) * 1e3
        vgroups, vcounts, vwall = profile(lambda: post_chunk_process(chunk, cfg, dev))
        vbusy = sum(vgroups.values())
        print(f"  VAE decode of one chunk: {dec_ms:.1f} ms wall (incl. copy to host and uint8 conversion); "
              f"device busy {vbusy:.1f} ms of {vwall:.1f} ms profiled")
        for g, ms in sorted(vgroups.items(), key=lambda kv: -kv[1]):
            print(f"  {ms:10.2f} ms  {100 * ms / vbusy:5.1f}%  {vcounts[g]:6d} launches  {g}")
        results[size] = dict(step_ms=step_ms, busy_ms=busy, profiled_ms=wall, groups=groups, decode_ms=dec_ms)
        del sampler
        torch.cuda.empty_cache()
    import subprocess

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    print(smi.stdout.strip())
    print(json.dumps({str(k): {kk: (dict(vv) if isinstance(vv, dict) else vv) for kk, vv in v.items()}
                      for k, v in results.items()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

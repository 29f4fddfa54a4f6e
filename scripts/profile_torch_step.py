#!/usr/bin/env python3
"""Where a denoise step of the PyTorch/CUDA port spends its time on one GPU.

    python3 scripts/profile_torch_step.py [--configs base,distill,distill_smooth,24b,t5,base_packed,distill_offload,
        24b_base,24b_distill,24b_w8a8] [--schemes qk8,sage,dq] [--layers N]
    python3 -m torch.distributed.run --nproc_per_node 4 scripts/profile_torch_step.py --mesh cp=2,tp=2 \
        [--configs base,distill] [--layers 4]

Builds the models at full width and depth with random weights: the 4.5B
base config (example/4.5B/4.5B_base_config.json, bf16, 3-branch CFG), the
4.5B distill + int8 config (4.5B_distill_quant_config.json with int8
attention: single-branch CFG, the same weights quantized to int8) and the
24B distill w4a8 config (example/24B/24B_distill_quant_config.json on one
device with quant_bits 4 and int8 attention: int4 weights unpacked to
int8 per layer, bf16 edge layers).  `distill_smooth` is the distill
config on a smooth-folded int8 tree, as a released fp8 checkpoint loads
(`chip_smoke.with_smooth`: `act_smooth` in [0.5, 2] on kv_xattn, proj,
fc1 and fc2, 1 on the edge layers): each smoothed linear's divide runs
inside its K8 or K8s launch, so its step runs the distill step's kernels
and nothing among "other" beside them.  `base_packed` is the base config
with `pack_uncond` (two forwards a step) at 256x256 and 720x720.
`24b_base`, `24b_distill` and `24b_w8a8` are the three released 24B files
as written on one device (`cp_size` 1, nothing else changed): bf16 3-CFG
with 32 steps, bf16 distill, and `fp8_quant` (a w8a8 tree drawn leaf by
leaf, bf16 edge layers, bf16 attention), each with `kv_offload` under its
noise2clean kv ranges (a device cache window; the video's 4 chunks never
roll it, so nothing crosses the link), at 256x256 and at the files' own
720x1280; base and distill share one bf16 tree.  Where one does not fit
on the card at a size, the script prints the peak before the failed
allocation and the tree's size, and walks the next of `FALLBACK_SIZES`
that is smaller.  `distill_offload` is
the distill config under the default kv ranges on a video of 8 chunks (192
frames), at 256x256 and 720x720, at stages 3 (no cache before the window)
and 7 (the window over 4 cached chunks, which every forward uploads), each
step once with the cache resident and once with `kv_offload` (the cache in
pinned host memory, streamed a layer slab at a time on a copy stream); the
copies' device time and bytes are printed apart from the kernels', which
alone make "device busy" and the idle share.  The int8 configs run once per K5
scheme of `--schemes` (`MAGI_ATTN_Q8_SCHEME`; default qk8).  For each and
each video size it runs
the steps of the given ARDF stage (stage 3 is the first step with the
full window of 4 chunks) twice, eager (`ArdfSampler(capture=False)`) and
replayed from CUDA graphs (the default): two steps to warm up (and
capture: the stage's first step, with the extra clean chunk, and its
second are different variants), the third timed on the host clock with a
device synchronise, the fourth under torch.profiler.  It prints the
device time summed by kernel group (the port's hand-written kernels one
by one, cuBLAS GEMMs, the rest), the device-busy time and the idle share
of the profiled step (1 - busy / its host wall under the profiler, which
adds its own host time to every launch, so an eager step's share is
larger than 1 - busy / the unprofiled step wall), the peak device memory
of the steps, and the self-attention operations of the step with the
rate its attention kernel reached.  For the 24B it also times `unpack_int4` of one layer's eight
linears (CUDA events), which the profile counts among "other".  Then, for
the base config, one VAE decode of a chunk, the same way, eager and
replayed.  The KV cache
holds zeros: timing does not depend on its values.  `t5` profiles the
24-layer T5-XXL encode of one prompt at L 800 with its weights resident
on the card (random bf16 weights at HF's initialisation scales, `chip_smoke.random_t5_tree`).
`--layers N` cuts every config to N layers (widths full).

`--mesh dp=..,pp=..,cp=..,tp=..` profiles the ranks of a mesh instead,
run under torchrun with as many processes as the mesh has ranks, every
rank on the one card (cuda:(LOCAL_RANK % device count)) and the
collectives on gloo, which moves CUDA tensors through host memory (so the
idle share is the rank's wait on its collectives, not a scaling number):
base, base_packed and distill at 256x256 only, each rank drawing its
shards from the same seed (`parallel.mesh.ShardSink`); rank 0 prints the
tables, every rank one line of its step wall, busy time and idle share.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import sys
import time
from collections import defaultdict

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

import numpy as np  # noqa: E402
import torch  # noqa: E402

SIZES = {"base": ((256, 256), (720, 720)), "distill": ((256, 256), (720, 720)),
         "distill_smooth": ((256, 256), (720, 720)),
         "24b": ((256, 256), (720, 1280)),  # the smoke's size and each config's own
         "base_packed": ((256, 256), (720, 720)), "distill_offload": ((256, 256), (720, 720)),
         "24b_base": ((256, 256), (720, 1280)), "24b_distill": ((256, 256), (720, 1280)),
         "24b_w8a8": ((256, 256), (720, 1280))}
# the released 24B files as written (cp_size 1), each config's own file
RELEASED_24B = {"24b_base": "24B/24B_base_config.json", "24b_distill": "24B/24B_distill_config.json",
                "24b_w8a8": "24B/24B_distill_quant_config.json"}
# where a released 24B config's own size does not fit on the card, the
# sizes tried next, largest first (the 720x1280 frame's 9:16, then square;
# each a multiple of 16: the VAE's 8 times the patch's 2)
FALLBACK_SIZES = ((640, 1152), (576, 1024), (480, 864), (720, 720), (480, 480))
STAGE = 3  # ARDF stage of the profiled step: the first with the full window of 4 chunks
STEPS = 64  # the config's schedule
# distill_offload: 8 chunks; stage 7's window (chunks 4-7) sits over 4 cached chunks
OFFLOAD_FRAMES, OFFLOAD_STAGES = 192, (3, 7)

K1 = "K1 segmented_attention_two_source (seg_attn_two_source_kernel)"
K2 = "K2 segmented_attention_v2 (seg_attn_v2_kernel, caption)"
K2G = "K2g segmented_attention (seg_attn_grid_kernel, VAE)"
K3 = "K3 kv_norm_rope_pack"
K3Q = "K3q kv_norm_rope_pack (int8)"
K4 = "K4 gate_norm_residual"
K5 = "K5 segmented_attention_two_source_q8 (seg_attn_q8_kernel, qk8)"
K5S = "K5 sage (seg_attn_q8_sage_kernel)"
K5D = "K5 dq (seg_attn_q8_dq_kernel)"
K5_OF = {"qk8": K5, "sage": K5S, "dq": K5D}
K6 = "K6 quantized_matmul_i8 (qmm_i8_wgmma_kernel)"
K7 = "K7 quantized_matmul (qmm_deq_wgmma_kernel)"
K8 = "K8 rowquant_fused (rowquant_kernel)"
K8S = "K8s rowquant_swiglu (swiglu_rowquant_kernel)"
COPIES = "host<->device copies (Memcpy HtoD / DtoH)"


def group_of(name: str) -> str:
    if name.startswith("Memcpy HtoD") or name.startswith("Memcpy DtoH"):
        return COPIES
    if "seg_attn_q8_sage_kernel" in name:
        return K5S
    if "seg_attn_q8_dq_kernel" in name:
        return K5D
    if "seg_attn_q8_kernel" in name:
        return K5
    if "qmm_i8_wgmma_kernel" in name:
        return K6
    if "qmm_deq_wgmma_kernel" in name:
        return K7
    if "swiglu_rowquant_kernel" in name:
        return K8S
    if "rowquant_kernel" in name:
        return K8
    if "kv_norm_rope_pack_kernel" in name and ("signed char" in name or "int8" in name):
        return K3Q
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
    """Device time by kernel group (ms), launches by group, the profiled
    wall time (ms) and device time by kernel name (ms)."""
    from torch.profiler import ProfilerActivity, profile as tprofile

    torch.cuda.synchronize()
    with tprofile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    groups = defaultdict(float)
    counts = defaultdict(int)
    by_name = defaultdict(float)
    for evt in prof.key_averages():
        dev_us = getattr(evt, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(evt, "self_cuda_time_total", 0.0)
        if dev_us and evt.device_type == torch.autograd.DeviceType.CUDA:
            g = group_of(evt.key)
            groups[g] += dev_us / 1e3
            counts[g] += evt.count
            by_name[evt.key] += dev_us / 1e3
    return groups, counts, wall, by_name


def attention_flops(sampler, step: int) -> float:
    """FLOPs (or int8 operations) of the step's self-attention launches
    (QK^T and PV, 2 per multiply-add).  3-branch CFG: two cache-reading
    forwards over the plan's ranges and one uncond forward over self-only
    ranges; single-branch: one forward over the plan's ranges, plus the
    ride-along segment attending itself.  Each on every layer."""
    mc = sampler.config.model_config
    p = sampler._plan(step)
    per_layer = 4 * sampler.ctn * mc.kv_channels * mc.num_attention_heads
    cond = float(np.sum(p["kv_end"] - p["kv_start"])) * per_layer
    if sampler.config.runtime_config.cfg_number == 1:
        return (cond + (sampler.ctn * per_layer if p["distill_nearly"] else 0.0)) * mc.num_layers
    uncond = p["n_den"] * sampler.ctn * per_layer
    return (2 * cond + uncond) * mc.num_layers


def load_config(name: str, mesh_sizes: dict = None, layers: int = 0) -> dict:
    if name in RELEASED_24B:
        with open(os.path.join(HERE, "example", RELEASED_24B[name])) as f:
            d = json.load(f)
        d["engine_config"]["cp_size"] = 1  # one device; nothing else changed
        if layers:
            d["model_config"]["num_layers"] = layers
        return d
    file = {"base": "4.5B/4.5B_base_config.json", "distill": "4.5B/4.5B_distill_quant_config.json",
            "24b": "24B/24B_distill_quant_config.json"}[name.split("_")[0]]
    with open(os.path.join(HERE, "example", file)) as f:
        d = json.load(f)
    if name.startswith("base"):
        d["runtime_config"]["num_steps"] = STEPS
        d["engine_config"]["pack_uncond"] = name == "base_packed"
    else:
        d["engine_config"]["attn_int8"] = True
    if name == "24b":
        d["engine_config"].update(quant_bits=4, cp_size=1)  # one device
    if name == "distill_offload":
        # the default ranges (every earlier chunk attended), where kv_offload
        # is the host-streamed cache; main() runs each step both ways
        d["runtime_config"].update(noise2clean_kvrange=[], num_frames=OFFLOAD_FRAMES)
    if layers:
        d["model_config"]["num_layers"] = layers
    if mesh_sizes:
        d["engine_config"].update({f"{k}_size": v for k, v in mesh_sizes.items()}, distributed_backend="gloo")
    return d


def build_params(name: str, d: dict, dev, gen, cache: dict, mesh=None) -> dict:
    """Random weights at full width and depth: the 4.5B bf16 tree (shared by
    base and distill, quantized to int8 for distill), or the 24B tree
    packed to int4 (its bf16 tree freed once packed)."""
    from magi_tpu_torch.core.config import MagiConfig
    from magi_tpu_torch.models.dit.model import init_dit_params
    from magi_tpu_torch.ops.quant import quantize_params_int4, quantize_params_int8

    if mesh is not None:  # the rank's shards, drawn leaf by leaf from the same seed on every rank
        from magi_tpu_torch.parallel.mesh import ShardSink

        cfg = MagiConfig.from_dict(d)
        sink = ShardSink(mesh, cfg.model_config.gated_linear_unit, 0 if name.startswith("base") else 8)
        return init_dit_params(cfg, dev, gen, sink=sink)
    if name == "24b":
        cache.clear()
        torch.cuda.empty_cache()
        return quantize_params_int4(init_dit_params(MagiConfig.from_dict(d), dev, gen))
    if name in RELEASED_24B:
        # 24b_base and 24b_distill share one bf16 tree; the w8a8 tree is
        # quantized leaf by leaf as it is drawn, as `get_dit` builds it
        from magi_tpu_torch.ops.quant import TreeSink

        bits = 8 if d["engine_config"]["fp8_quant"] else 0
        if ("24b", bits) not in cache:
            # the idle workspaces hold the earlier tree and its graphs
            from magi_tpu_torch.core.graphs import release_workspaces

            cache.clear()
            release_workspaces()
            gc.collect()
            torch.cuda.empty_cache()
            cache[("24b", bits)] = init_dit_params(MagiConfig.from_dict(d), dev, gen, sink=TreeSink(bits))
        return cache[("24b", bits)]
    if "bf16" not in cache:
        cache["bf16"] = init_dit_params(MagiConfig.from_dict(d), dev, gen)
    if name.startswith("base"):
        return cache["bf16"]
    if name == "distill_smooth":
        from chip_smoke import SMOOTH_LINEARS, with_smooth

        return quantize_params_int8(with_smooth(cache["bf16"], SMOOTH_LINEARS))
    if "int8" not in cache:
        cache["int8"] = quantize_params_int8(cache["bf16"])
    return cache["int8"]


def profile_t5(dev, gen, length: int = 800) -> dict:
    """The 24-layer T5-XXL encode of one prompt of `length` tokens, weights
    resident on the card: host-clock time after a warm-up, then device time
    by kernel group under the profiler."""
    from chip_smoke import random_t5_tree
    from magi_tpu_torch.models.t5.model import T5Config, t5_encoder_forward

    cfg = T5Config.xxl()
    params = random_t5_tree(cfg, dev, gen)
    L, d, f, inner = cfg.num_layers, cfg.d_model, cfg.d_ff, cfg.num_heads * cfg.d_kv
    ids = torch.randint(2, cfg.vocab_size, (1, length), generator=gen, device=dev)
    mask = torch.ones((1, length), dtype=torch.int32, device=dev)

    def encode():
        return t5_encoder_forward(params, cfg, ids, mask)

    encode()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    encode()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    groups, counts, prof_wall, by_name = profile(encode)
    busy = sum(groups.values())
    gemm_flops = 2 * length * L * (4 * d * inner + 3 * d * f)
    print(f"== t5: T5-XXL encode, {L} layers, L {length}: {wall_ms:.1f} ms (host clock, synchronised, no "
          f"profiler); under the profiler {prof_wall:.1f} ms, device busy {busy:.1f} ms, idle share "
          f"{max(0.0, 1 - busy / prof_wall):.3f}; the projections' {gemm_flops:.3e} bf16 FLOP")
    for g, ms in sorted(groups.items(), key=lambda kv: -kv[1]):
        print(f"  {ms:10.2f} ms  {100 * ms / busy:5.1f}%  {counts[g]:6d} launches  {g}")
    print("  the kernels taking the most device time:")
    for name, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:10]:
        print(f"  {ms:10.2f} ms  {name[:150]}")
    return dict(step_ms=wall_ms, busy_ms=busy, profiled_ms=prof_wall, groups=groups)


def tree_gib(params: dict) -> float:
    """The device bytes of a parameter tree, in GiB."""
    from magi_tpu_torch.core.utils import tree_leaves

    return sum(t.numel() * t.element_size() for _, t in tree_leaves(params)) / 2**30


def unpack_ms(params: dict) -> float:
    """CUDA-event time of `unpack_int4` over one middle layer's linears."""
    from magi_tpu_torch.models.dit.model import layer_params
    from magi_tpu_torch.ops.quant import unpack_int4

    blk = layer_params(params["blocks"], 1)
    leaves = []

    def walk(t):
        for k, v in t.items():
            if isinstance(v, dict):
                walk(v)
            elif k == "weight_q4":
                leaves.append(v)

    walk(blk)
    for q4 in leaves:
        unpack_int4(q4)
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(5):
        for q4 in leaves:
            unpack_int4(q4)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / 5


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--configs", default="base,distill,24b",
                    help="comma list of base, distill, distill_smooth, 24b, t5, base_packed, distill_offload, "
                         "24b_base, 24b_distill, 24b_w8a8")
    ap.add_argument("--schemes", default="qk8", help="comma list of the K5 schemes (qk8, sage, dq) of the int8 configs")
    ap.add_argument("--layers", type=int, default=0, help="cut every config to this many layers (widths full)")
    ap.add_argument("--mesh", default="", help="dp=..,pp=..,cp=..,tp=..: profile a mesh's ranks (under torchrun)")
    args = ap.parse_args()
    names, schemes = args.configs.split(","), args.schemes.split(",")
    if not torch.cuda.is_available():
        print("FAIL: no CUDA device", file=sys.stderr)
        return 1
    mesh_sizes = {k: int(v) for k, v in (kv.split("=") for kv in args.mesh.split(",") if kv)}
    mesh, rank = None, 0
    if mesh_sizes:
        from magi_tpu_torch.parallel import mesh as mesh_lib

        if set(names) - {"base", "base_packed", "distill"}:
            print("FAIL: --mesh profiles base, base_packed and distill", file=sys.stderr)
            return 1
        torch.cuda.set_device(mesh_lib.rank_device(torch.device("cuda")))
        mesh = mesh_lib.initialize_mesh(**mesh_sizes, device=mesh_lib.rank_device(torch.device("cuda")))
        rank = mesh.rank
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    os.environ["SKIP_LOAD_MODEL"] = "1"

    from magi_tpu_torch.core.config import MagiConfig
    from magi_tpu_torch.pipeline.prompt_process import build_inference_input, get_txt_embeddings
    from magi_tpu_torch.models.vae.model import ViTVAE
    from magi_tpu_torch.pipeline.video_process import f32_cthw_to_u8_thwc, get_vae, tiled_decode
    from magi_tpu_torch.sampling.transport import ArdfSampler

    dev = torch.device("cuda", torch.cuda.current_device())
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    cache: dict = {}
    results = {}
    say = print if rank == 0 else (lambda *a, **k: None)
    for name in names:
        if name == "t5":
            results["t5"] = profile_t5(dev, gen)
            continue
        base = load_config(name, mesh_sizes, args.layers)
        params = build_params(name, base, dev, gen, cache, mesh)
        null = params["y_embedder"]["null_caption_embedding"].float().cpu().numpy()
        if name == "24b":
            ums = unpack_ms(params)
            layers = base["model_config"]["num_layers"] - 2  # the edge layers run bf16 weights
            print(f"== 24b: unpack_int4 of one layer's 8 linears {ums:.3f} ms (CUDA events); x {layers} layers "
                  f"= {ums * layers:.1f} ms per forward")
        modes = [(st, off) for st in OFFLOAD_STAGES for off in (False, True)] if name == "distill_offload" \
            else [(STAGE, None)]
        runs = [(hw, sch, st, off, cap) for hw in SIZES[name][:1 if mesh is not None else None]
                for sch in (["qk8"] if name.startswith("base") or name in RELEASED_24B else schemes) for st, off in modes
                for cap in (False, True)]
        tried = set()
        while runs:
            (size_h, size_w), scheme, stage, offload, capture = runs.pop(0)
            tried.add((size_h, size_w))
            try:
                os.environ["MAGI_ATTN_Q8_SCHEME"] = scheme
                d = json.loads(json.dumps(base))
                d["runtime_config"].update(video_size_h=size_h, video_size_w=size_w)
                if offload is not None:
                    d["engine_config"]["kv_offload"] = offload
                cfg = MagiConfig.from_dict(d)
                emb, mask = get_txt_embeddings("a red cube on a table", cfg)
                inp = build_inference_input(cfg, null, emb, mask, dev)
                sampler = ArdfSampler(cfg, params, inp, gen, device=dev, capture=capture)
                dpss = cfg.runtime_config.num_steps // cfg.runtime_config.window_size
                step = stage * dpss
                torch.cuda.reset_peak_memory_stats(dev)
                t0 = time.perf_counter()
                for warm in (step, step + 1):  # warm-up (cuBLAS heuristics, allocator) and the variants' capture
                    sampler.do_step(warm)
                torch.cuda.synchronize()
                warm_s = time.perf_counter() - t0
                step += 1
                t0 = time.perf_counter()
                sampler.do_step(step + 1)
                torch.cuda.synchronize()
                step_ms = (time.perf_counter() - t0) * 1e3
                p = sampler._plan(step + 2)
                groups, counts, wall, _ = profile(lambda: sampler.do_step(step + 2))
                peak = torch.cuda.max_memory_allocated(dev) / 2**30
                copies_ms = groups.pop(COPIES, 0.0)
                busy = sum(groups.values())
                flops = attention_flops(sampler, step + 2) / (1 if mesh is None else mesh_lib.head_shards(mesh))
                bf16_attn = name.startswith("base") or name in RELEASED_24B
                attn_ms = groups.get(K1 if bf16_attn else K5_OF[scheme], 0.0)
                n_fwd = 1 if cfg.runtime_config.cfg_number == 1 else 2 if cfg.engine_config.pack_uncond else 3
                tag = "" if bf16_attn else f" K5 {scheme}"
                if offload is not None:
                    tag += f" stage {stage} {'streamed' if offload else 'resident'}"
                tag += " captured" if capture else " eager"
                say(f"== {name} {size_h}x{size_w}{tag}: stage {stage} step of {cfg.runtime_config.num_steps} "
                      f"(n_seg {p['n_seg']}{' + the ride-along' if p['distill_nearly'] else ''} over {p['sp']} cached "
                      f"chunks of {inp.chunk_num}, seg_len {sampler.ctn} tokens, {cfg.model_config.num_layers} layers, "
                      f"{n_fwd} forward{'s' if n_fwd > 1 else ''})")
                say(f"  step wall {step_ms:.1f} ms (host clock, synchronised, no profiler); under the profiler "
                      f"{wall:.1f} ms, device busy {busy:.1f} ms, idle share {max(0.0, 1 - busy / wall):.3f}; "
                      f"peak memory {peak:.2f} GiB; the two warm-up steps {warm_s:.2f} s"
                      + (f" ({sampler.graphs} CUDA graphs captured)" if capture else ""))
                for g, ms in sorted(groups.items(), key=lambda kv: -kv[1]):
                    say(f"  {ms:10.2f} ms  {100 * ms / busy:5.1f}%  {counts[g]:6d} launches  {g}")
                if name in RELEASED_24B and not sampler.host_mode:
                    say(f"  KV cache: a device window of {sampler.cache_chunks} chunks for {inp.chunk_num} "
                        f"(kv_offload {cfg.engine_config.kv_offload} under noise2clean_kvrange "
                        f"{cfg.runtime_config.noise2clean_kvrange}): 0 bytes cross the link a step; the tree "
                        f"{tree_gib(params):.2f} GiB")
                if sampler.host_mode:
                    hc = sampler.host_cache
                    say(f"  {copies_ms:10.2f} ms of {counts[COPIES]} host<->device copies on the copy stream (beside "
                          f"the kernels, not in device busy; {100 * copies_ms / wall:.1f}% of the profiled step); "
                          f"{hc.h2d_bytes / 4e6:.1f} MB up and {hc.d2h_bytes / 4e6:.1f} MB back a step (mean of the "
                          f"four steps)")
                say(f"  self-attention operations of the step {flops:.3e}; attention kernel device time {attn_ms:.1f} ms "
                      f"-> {flops / (attn_ms * 1e-3) / 1e12:.1f} T/s")
                key = f"{name} {size_h}x{size_w}{tag}"
                results[key] = dict(step_ms=step_ms, busy_ms=busy, profiled_ms=wall, peak_gib=peak, groups=groups,
                                    copies_ms=copies_ms, idle=max(0.0, 1 - busy / wall), warm_s=warm_s,
                                    graphs=sampler.graphs)
                if sampler.host_mode:
                    results[key].update(h2d_mb=sampler.host_cache.h2d_bytes / 4e6,
                                        d2h_mb=sampler.host_cache.d2h_bytes / 4e6)
                if mesh is not None:
                    print(f"[rank {rank}] {name} {size_h}x{size_w}{tag}: step wall {step_ms:.1f} ms, under the profiler "
                          f"{wall:.1f} ms, device busy {busy:.1f} ms, idle share {max(0.0, 1 - busy / wall):.3f}"
                          + (f", {sampler.graphs} graphs" if capture else ""), flush=True)
                if name == "base" and mesh is None:
                    # one VAE decode of a chunk (`decode_chunk` with the cached
                    # VAE, replayed, or an eager twin on the same weights)
                    vae = get_vae(cfg.runtime_config.vae_pretrained, dev, z_chans=16)
                    if not capture:
                        vae = ViTVAE(vae.cfg, vae.params, capture=False)
                    chunk = torch.randn((16, 6, size_h // 8, size_w // 8), generator=gen, device=dev)

                    def decode():
                        z = chunk.to(torch.bfloat16)[None] / cfg.runtime_config.scale_factor
                        video = tiled_decode(vae, z, tile_frames=cfg.runtime_config.fps // 2)
                        return f32_cthw_to_u8_thwc(video[0].float().cpu().numpy())

                    decode()
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    decode()
                    dec_ms = (time.perf_counter() - t0) * 1e3
                    vgroups, vcounts, vwall, _ = profile(decode)
                    vbusy = sum(vgroups.values())
                    print(f"  VAE decode of one chunk: {dec_ms:.1f} ms wall (incl. copy to host and uint8 conversion); "
                          f"device busy {vbusy:.1f} ms of {vwall:.1f} ms profiled"
                          + (f" ({vae.graphs} CUDA graphs)" if capture else ""))
                    for g, ms in sorted(vgroups.items(), key=lambda kv: -kv[1]):
                        print(f"  {ms:10.2f} ms  {100 * ms / vbusy:5.1f}%  {vcounts[g]:6d} launches  {g}")
                    results[key].update(decode_ms=dec_ms, decode_busy_ms=vbusy, decode_profiled_ms=vwall)
                sampler.release()  # its workspace (the cache) to the next run of the size
                del sampler
                if name in RELEASED_24B:
                    # each run of a 24B config near the card's capacity starts
                    # from the tree alone: no idle workspace, nothing cached
                    from magi_tpu_torch.core.graphs import release_workspaces

                    release_workspaces()
                    gc.collect()
                torch.cuda.empty_cache()
            except (torch.cuda.OutOfMemoryError, RuntimeError) as e:
                # a capture's failure names the allocation that failed in its message
                if name not in RELEASED_24B or "out of memory" not in str(e):
                    raise
                # the config does not fit at this size: say where the memory
                # went, then walk the next size that might
                peak, tree = torch.cuda.max_memory_allocated(dev) / 2**30, tree_gib(params)
                msg = str(e).splitlines()[0]
                del e
                sampler = None
                from magi_tpu_torch.core.graphs import release_workspaces

                release_workspaces()
                gc.collect()  # the failed step's frames held the sampler and its cache
                torch.cuda.empty_cache()
                say(f"== {name} {size_h}x{size_w}{' captured' if capture else ' eager'}: out of device memory "
                    f"(peak {peak:.2f} GiB before the failed allocation, the tree {tree:.2f} GiB): {msg}")
                results[f"{name} {size_h}x{size_w} out of memory"] = dict(peak_gib=peak, tree_gib=tree, error=msg)
                runs = [r for r in runs if r[0] != (size_h, size_w)]
                smaller = [hw for hw in FALLBACK_SIZES
                           if hw[0] * hw[1] < size_h * size_w and hw not in tried and hw not in SIZES[name]]
                if smaller:
                    runs[:0] = [(smaller[0], scheme, stage, offload, cap) for cap in (False, True)]
        del params
    import subprocess

    if rank:
        return 0
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    print(smi.stdout.strip())
    print(json.dumps({str(k): {kk: (dict(vv) if isinstance(vv, dict) else vv) for kk, vv in v.items()}
                      for k, v in results.items()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

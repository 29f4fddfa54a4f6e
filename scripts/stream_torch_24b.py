#!/usr/bin/env python3
"""The 24B distill w4a8 config on one GPU, walking a long video (16 chunks)
with the KV cache in pinned host memory: the port's counterpart of the JAX
package's `scripts/bench_stream24b.py`.

    python3 scripts/stream_torch_24b.py [--chunks 16] [--size 256] [--modes A,B,C]

The tree is `chip_smoke.py` phase 6's: `example/24B/24B_distill_quant_config.json`
on one device (`cp_size` 1) with `quant_bits` 4 and int8 attention, drawn
from a seed and packed to int4 leaf by leaf (bf16 edge layers), random
captions from a seed.  Three walks of the same request, the same noise:

  A  the default kv ranges (every chunk attends all earlier ones) with
     `kv_offload`: the whole int8 cache in pinned host memory, streamed a
     layer slab at a time (`sampling.transport.HostKVCache`);
  B  the default kv ranges, the cache resident on the card;
  C  the released noise2clean ranges with `kv_offload`: a device cache
     window of 10 chunks that rolls forward.

A must equal B bit for bit, latents and cache (the host buffer against
the resident cache); the script exits 1 otherwise.  Every step is
captured (CUDA graphs) before its walk.  For each walk it reports the
seconds a step (mean, first, the second half's mean and the mean by
window width), the device peak and, for A, the bytes the cache copies a
step each way, the link's rate each way on one layer's slab (CUDA
events) and the host buffer's size.  Progress goes to stderr; stdout gets
the card's name and power limit as `nvidia-smi` prints them, then one
JSON line.  `--device cpu --tiny` rehearses the same walks on the CPU at
a tiny width and depth (no timing is meaningful there).
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

import numpy as np  # noqa: E402
import torch  # noqa: E402

CONFIG = os.path.join(HERE, "example", "24B", "24B_distill_quant_config.json")
TINY = dict(num_layers=3, hidden_size=768, ffn_hidden_size=1536, num_attention_heads=6, num_query_groups=1,
            caption_channels=64, caption_max_length=32)


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def walk(config: dict, params, inp, noise, dev, tag: str) -> dict:
    """One walk of `config`'s request; its record, emitted latents and cache
    (the host buffer or the resident cache, on the CPU)."""
    from magi_tpu_torch.core.config import MagiConfig
    from magi_tpu_torch.sampling.transport import ArdfSampler

    cfg = MagiConfig.from_dict(config)
    on_card = dev.type == "cuda"
    if on_card:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
    s = ArdfSampler(cfg, params, inp, noise=noise, device=dev)
    mode = "host-streamed" if s.host_mode else "device window" if s.cache_chunks < s.chunk_num else "resident"
    t0 = time.perf_counter()
    s.warm_step_variants()  # every step variant captured before the walk
    s.prepare()
    capture_s = time.perf_counter() - t0
    chunks, widths = [], {}
    for step in range(s.total_forward_steps()):
        _, _, c_start, c_end, _, _ = s._status(step)
        emitted = s.timed_step(step)
        widths.setdefault(int(c_end - c_start), []).append(s.step_seconds[-1])
        if emitted is not None:
            chunks.append(emitted[1].float().cpu())
        if step % 16 == 0:
            log(f"  [{tag}] step {step + 1}/{s.total_forward_steps()} (window of {c_end - c_start}): "
                f"{s.step_seconds[-1]:.3f} s")
    times = s.step_seconds
    steady = times[len(times) // 2:]
    rec = dict(mode=mode, steps=len(times), chunks_emitted=len(chunks), cache_chunks=s.cache_chunks,
               graphs=s.graphs, capture_s=capture_s, walk_s=time.perf_counter() - t0,
               s_per_step_mean=float(np.mean(times)), s_per_step_first=times[0],
               s_per_step_second_half_mean=float(np.mean(steady)),
               s_per_step_by_window={f"w{k}": float(np.mean(v)) for k, v in sorted(widths.items())},
               peak_gib=torch.cuda.max_memory_allocated(dev) / 2**30 if on_card else None)
    if s.host_mode:
        hc = s.host_cache
        if on_card:
            torch.cuda.synchronize(dev)
        cache = {k: v.clone() for k, v in hc.buf.items()}
        rec.update(host_buffer_gib=(hc._host_kv.nbytes + hc._host_sc.nbytes) / 2**30,
                   h2d_mb_per_step=hc.h2d_bytes / len(times) / 1e6, d2h_mb_per_step=hc.d2h_bytes / len(times) / 1e6)
        if on_card:  # the link's rate each way on one layer's slab, as chip_smoke.py's phase 13 reads it
            from chip_smoke import print_copies

            with contextlib.redirect_stdout(sys.stderr):
                rec.update(print_copies(hc, len(times)))
    else:
        cache = {k: v.cpu() for k, v in s.cache.items()}
    s.release()
    log(f"[{tag}] {json.dumps(rec)}")
    return dict(rec=rec, chunks=chunks, cache=cache)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--chunks", type=int, default=16, help="chunks of the video (6 latent frames each)")
    ap.add_argument("--size", type=int, default=256, help="square frame size")
    ap.add_argument("--modes", default="A,B,C", help="comma list of A (streamed), B (resident), C (noise2clean)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--tiny", action="store_true", help="a tiny width and depth, to rehearse on the CPU")
    args = ap.parse_args()
    modes = args.modes.split(",")
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        log("FAIL: no CUDA device")
        return 1
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False

    from magi_tpu_torch.core.config import MagiConfig
    from magi_tpu_torch.core.utils import tree_leaves
    from magi_tpu_torch.models.dit.model import init_dit_params
    from magi_tpu_torch.ops.quant import TreeSink
    from magi_tpu_torch.sampling.transport import InferenceInput

    with open(CONFIG) as f:
        base = json.load(f)
    base["engine_config"].update(cp_size=1, quant_bits=4, attn_int8=True)
    base["runtime_config"].update(video_size_h=args.size, video_size_w=args.size,
                                  num_frames=args.chunks * base["runtime_config"]["chunk_width"] * 4)
    if args.tiny:
        base["model_config"].update(TINY, params_dtype="float32" if dev.type == "cpu" else "bfloat16")
    released = base["runtime_config"]["noise2clean_kvrange"]
    cfg = MagiConfig.from_dict(base)
    mc, rc = cfg.model_config, cfg.runtime_config
    gen = torch.Generator(device=dev)
    gen.manual_seed(rc.seed)
    t0 = time.perf_counter()
    params = init_dit_params(cfg, dev, gen, sink=TreeSink(4))
    tree_gib = sum(t.numel() * t.element_size() for _, t in tree_leaves(params)) / 2**30
    log(f"w4a8 tree ({mc.num_layers} layers x {mc.hidden_size}) drawn and packed in {time.perf_counter() - t0:.1f} s, "
        f"{tree_gib:.2f} GiB")
    rng = np.random.default_rng(0)
    L, n = mc.caption_max_length, args.chunks
    H = W = args.size // 8
    inp = InferenceInput(
        caption_embs=torch.from_numpy(rng.normal(size=(n, L, mc.caption_channels)).astype(np.float32)).to(dev),
        caption_lens=np.full(n, L, np.int32),
        null_emb=torch.from_numpy(rng.normal(size=(L, mc.caption_channels)).astype(np.float32)).to(dev),
        null_len=50, latent_size=(mc.in_channels // (2 if mc.half_channel_vae else 1), n * rc.chunk_width, H, W),
        num_steps=rc.num_steps, chunk_num=n, has_text=True)
    noise = torch.randn(inp.latent_size, generator=gen, device=dev)
    runs = {}
    for m, kvrange, offload in (("A", [], True), ("B", [], False), ("C", released, True)):
        if m in modes:
            d = json.loads(json.dumps(base))
            d["runtime_config"]["noise2clean_kvrange"] = kvrange
            d["engine_config"]["kv_offload"] = offload
            runs[m] = walk(d, params, inp, noise, dev, m)
    out = dict(config="24B distill w4a8, int8 attention, one device", size=f"{args.size}x{args.size}",
               chunks=n, steps_per_chunk=rc.num_steps, tokens_per_chunk=rc.chunk_width * (H // 2) * (W // 2),
               layers=mc.num_layers, tree_gib=tree_gib, runs={m: r["rec"] for m, r in runs.items()})
    ok = True
    if "A" in runs and "B" in runs:
        a, b = runs["A"], runs["B"]
        same_latents = len(a["chunks"]) == len(b["chunks"]) and all(
            torch.equal(x, y) for x, y in zip(a["chunks"], b["chunks"]))
        same_cache = all(torch.equal(a["cache"][k], b["cache"][k]) for k in b["cache"])
        out.update(a_equals_b_latents=same_latents, a_equals_b_cache=same_cache,
                   streaming_s_per_step=a["rec"]["s_per_step_mean"] - b["rec"]["s_per_step_mean"])
        ok = same_latents and same_cache
    if dev.type == "cuda":
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=60)
        print(smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "nvidia-smi failed")
        out["device"] = torch.cuda.get_device_name(dev)
    print(json.dumps(out))
    if not ok:
        log("FAIL: the streamed walk (A) is not bit-equal to the resident walk (B)")
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())

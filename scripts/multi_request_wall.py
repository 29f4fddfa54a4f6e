#!/usr/bin/env python3
"""Walls of two requests on one GPU: two solo runs, lockstep and interleaved.

    python3 scripts/multi_request_wall.py [--sizes 256,720] [--repeats 2]

Builds the 4.5B distill + int8 config (example/4.5B/4.5B_distill_quant_config.json
with int8 attention, the config's 16 steps, 96 frames) once at full width
and depth with random weights (SKIP_LOAD_MODEL=1) and, at each square
video size, times through `MagiPipeline` the same two prompts as
  solo         `run_text_to_video` of each prompt, one after the other;
  lockstep     `run_text_to_video_batch` (`--prompts`): one walk, each
               chunk decoded inline;
  interleaved  `run_text_to_video_many` (`--interleave`): the walks
               round-robin, each chunk decoded on a worker thread on its
               own CUDA stream.
The weights are built once and handed to every run, so a wall is the
prompts' embedding, the walk, the decodes and the video writes.  The modes
run in the order solo, lockstep, interleaved and then reversed, `--repeats`
times.  Prints each run's wall, its steps' and decodes' host seconds, the
card's name and power limit, and one JSON line of every run.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

import torch  # noqa: E402

PROMPTS = ["a red cube on a table", "a blue ball rolls across the grass at dusk"]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--sizes", default="256,720", help="comma list of square video sizes")
    ap.add_argument("--repeats", type=int, default=2, help="rounds of the three modes (each round reversed)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("FAIL: no CUDA device", file=sys.stderr)
        return 1
    os.environ["SKIP_LOAD_MODEL"] = "1"
    from magi_tpu_torch.pipeline import pipeline as P

    out_dir = os.path.join(HERE, "build", "multi_request_wall")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(HERE, "example", "4.5B", "4.5B_distill_quant_config.json")) as f:
        base = json.load(f)
    base["runtime_config"]["num_frames"] = 96
    base["engine_config"]["attn_int8"] = True
    params = None
    runs = []
    for size in (int(s) for s in args.sizes.split(",")):
        d = json.loads(json.dumps(base))
        d["runtime_config"].update(video_size_h=size, video_size_w=size)
        path = os.path.join(out_dir, f"distill_{size}.json")
        with open(path, "w") as f:
            json.dump(d, f)
        pipe = P.MagiPipeline(path, device="cuda")
        if params is None:
            params = P.get_dit(pipe.config, pipe.device, pipe.generator)
            P.get_dit = lambda *a, **k: params  # every run below takes these weights
        stem = os.path.join(out_dir, f"{size}")
        modes = {
            "solo": lambda: [pipe.run_text_to_video(p, f"{stem}_solo_{i}.mp4") for i, p in enumerate(PROMPTS)],
            "lockstep": lambda: pipe.run_text_to_video_batch(PROMPTS, [f"{stem}_batch_{i}.mp4" for i in range(2)]),
            "interleaved": lambda: pipe.run_text_to_video_many(PROMPTS, [f"{stem}_many_{i}.mp4" for i in range(2)]),
        }
        pipe.run_text_to_video(PROMPTS[0], f"{stem}_warm.mp4")  # warm-up: allocator, cuBLAS, the VAE
        order = list(modes)
        for rep in range(args.repeats):
            for mode in order if rep % 2 == 0 else order[::-1]:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                stats = modes[mode]()
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                # the lockstep requests share one sampler's step list
                steps = sum(stats[0]["step_seconds"]) if mode == "lockstep" else \
                    sum(sum(s["step_seconds"]) for s in stats)
                decode = sum(sum(s["decode_seconds"]) for s in stats)
                runs.append(dict(size=size, round=rep, mode=mode, wall=wall, step_seconds=steps, decode_seconds=decode,
                                 frames=[s["frames"] for s in stats]))
                print(f"{size}x{size} round {rep} {mode:11s}: wall {wall:.3f} s, steps {steps:.3f} s, decodes "
                      f"{decode:.3f} s (host seconds, both requests)", flush=True)
        del pipe
        torch.cuda.empty_cache()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    print(smi.stdout.strip())
    print(json.dumps(runs))
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""A tiny cell added beside the benchmark's own, as a later change adds one:
new configuration, traffic, limits and metric files in a copy of the
benchmark's folder and new entries in a copy of `BENCHMARK.json`.  Its
model is the 4.5B's (or the 24B's) at toy widths and three layers, so it
walks on the CPU in seconds."""

from __future__ import annotations

import copy
import json
import os
import shutil

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
TINY_MODEL = dict(num_layers=3, hidden_size=256, ffn_hidden_size=512, num_attention_heads=4, num_query_groups=2,
                  kv_channels=64, caption_channels=64, caption_max_length=64)
TINY_VAE = dict(video_size=32, video_length=8, embed_dim=256, depth=2, num_heads=4)
# fp32 weights: the program's plain versions and the reference then differ by
# f32 rounding (about 1e-6 of the update), the bf16 VAE decodes by bf16's
LIMITS = {"chunk_tail": {"tau": 1e-3, "limit": 0.01}, "cache_gap": {"limit": 1e-3}, "decode_off": {"limit": 0.01}}
EXTRA_METRIC = '''"""tiny_steps: steps in the window (a metric a later change adds)."""


def read(r):
    return float(len(r.steps))
'''


def make_root(tmp: str, base: str = "magi-4.5B-distill", dtype: str = "torch.float32", tau: float = 1e-3,
              lead_in: str = "none") -> str:
    """A checkout holding BENCHMARK.json and the benchmark's folder, with the
    tiny cell `tiny.t2v` (configuration `tiny`, its step check at `tau`, its
    traffic's `lead_in`) added; returns its root."""
    shutil.copytree(os.path.join(REPO, "benchmark"), os.path.join(tmp, "benchmark"),
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        bench = json.load(f)
    with open(os.path.join(REPO, "benchmark", "configs", base + ".json")) as f:
        conf = copy.deepcopy(json.load(f))
    conf["name"] = "tiny"
    conf["model_config"].update(TINY_MODEL, params_dtype=dtype)
    conf["vae"].update(TINY_VAE)
    files = {"configs/tiny.json": conf,
             "traffic/tiny.json": {"kind": "t2v", "loop": "closed", "clients": 1, "video_size_h": 32,
                                   "video_size_w": 48, "num_frames": 96, "caption_tokens": 8, "lead_in": lead_in},
             "limits/tiny.t2v.json": {**LIMITS, "chunk_tail": {**LIMITS["chunk_tail"], "tau": tau}}}
    for name, content in files.items():
        with open(os.path.join(tmp, "benchmark", name), "w") as f:
            json.dump(content, f)
    with open(os.path.join(tmp, "benchmark", "metrics", "tiny_steps.py"), "w") as f:
        f.write(EXTRA_METRIC)
    bench["configs"].append({"name": "tiny", "source": "toy widths of " + base, "file": "benchmark/configs/tiny.json",
                             "reduced": [], "why": "a toy cell for the CPU tests"})
    bench["workloads"].append({"name": "tiny.t2v", "config": "tiny", "traffic": "tiny", "chips": 1,
                               "why": "a toy cell for the CPU tests"})
    for m in bench["per_layer"]:
        m["workloads"].append("tiny.t2v")
    bench["per_layer"].append({"name": "tiny_steps", "unit": "steps", "better": "higher", "source": "host_clock",
                               "layer": "ARDF walk", "moves": "frames_per_s", "workloads": ["tiny.t2v"]})
    with open(os.path.join(tmp, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    return tmp

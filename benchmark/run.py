"""The benchmark of the PyTorch/CUDA port of MAGI-1 (`magi_tpu_torch`) on one H100.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1> [--control <name>]

Runs one cell of `BENCHMARK.json` from the root of a checkout and prints, as
the last line of standard output, one JSON object: `correct`, `attempted`,
`failed`, `metrics` (the cell's end-to-end metrics, or with `--trace 1` its
per-layer ones), `device`, with `--trace 1` a `breakdown`, and last the
`checks` it was judged by, each number beside its limit (also the last lines
of standard error).  It needs a CUDA device and exits with another code than
0, printing no result, without one.  `--control <name>` runs one of the
cell's controls instead (a lower-precision path of the program, under
`controls` in the configuration's file), which the check has to find not
correct.  See `benchmark/README.md`.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CACHE = os.path.join(ROOT, "build", "benchmark")
# settings the program reads from the environment that would change what a cell runs
CLEARED_PREFIXES = ("MAGI_", "PAD_")
CLEARED = ("SKIP_LOAD_MODEL", "NEG_PROMPT", "prev_chunks_scale", "SPECIAL_TOKEN_PATH", "OFFLOAD_VAE_CACHE",
           "OFFLOAD_T5_CACHE")


def _environment() -> None:
    """The program's settings cleared, and every compiler cache kept in fixed
    directories inside the checkout."""
    for k in list(os.environ):
        if k.startswith(CLEARED_PREFIXES) or k in CLEARED:
            del os.environ[k]
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCHINDUCTOR_CACHE_DIR", "inductor"),
                     ("CUDA_CACHE_PATH", "nv")):
        os.environ[var] = os.path.join(CACHE, sub)
    os.makedirs(CACHE, exist_ok=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", default=None, help="a control named in the configuration's file")
    args = ap.parse_args(argv)
    _environment()
    # the checkout's root in place of this script's directory, whose module
    # names (trace, schedule, ...) would shadow others
    sys.path[0] = ROOT
    import torch

    from benchmark import cells, harness

    cell = cells.load(args.workload, ROOT)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available", file=sys.stderr)
        return 2
    torch.set_num_threads(4)
    trace_path = os.path.join(CACHE, "trace.json")
    try:
        result = harness.run(cell, args.seed, args.seconds, bool(args.trace), "cuda:0", T_START,
                             control=args.control, trace_path=trace_path)
    finally:
        if os.path.exists(trace_path):
            os.remove(trace_path)
    bad = harness.forbidden_modules()
    if bad:
        print(f"the run loaded {bad}: the benchmark may not import them", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

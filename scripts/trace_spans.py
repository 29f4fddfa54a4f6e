"""Where a benchmark cell's idle device time lies among the program's spans.

    python3 scripts/trace_spans.py --workload <cell> --seed <n> [--seconds 40] [--out <file.json>]

Runs one traced run of a cell of `BENCHMARK.json` on the card, as
`benchmark/run.py --trace 1` does, and reports beside its per-layer metrics
the end-to-end ones measured in the traced window (`frames_per_s` with
tracing on, to hold against an untraced run of the same call).  From the
window's trace it then gives the device's idle time: in all, inside the
union of the program's `magi/` spans (and that share of the whole), inside
each span path's own union, the program spans a denoise step records, the
longest idle gaps each named by the innermost program span over it, and
the host cost of one span with no profiler and with one recording.  The
last line of standard output is one JSON object; `--out` writes it to a
file as well.  Needs a CUDA device.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import timeit  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def span_cost_us() -> dict:
    """Host microseconds of entering and leaving one `magi/step` span with
    its attributes, with no profiler and inside a CPU profiler."""
    from torch.profiler import ProfilerActivity, profile

    from magi_tpu_torch.core.profiler import span

    def one():
        with span("magi/step", req=1, step=40, variant=("cfg1", 4, False, False, True), n_den=4, extra=False,
                  q_tokens=60750, kv_tokens=243000):
            pass

    off = min(timeit.repeat(one, number=20000, repeat=5)) / 20000
    with profile(activities=[ProfilerActivity.CPU]):
        on = min(timeit.repeat(one, number=2000, repeat=3)) / 2000
    return {"off_us": off * 1e6, "on_us": on * 1e6}


def breakdown(path: str, top: int = 10) -> dict:
    """The idle device time of the trace's window by program span."""
    from benchmark import spans as S, trace as tr

    t = tr.Trace(path)
    busy = t.busy()
    window = (t.end - t.start) * 1e-6
    idle = window - sum(b - a for a, b in busy) * 1e-6
    found = S.program_spans(t)
    inside = S.idle_seconds(busy, [[(s.start, s.end) for s in found]])[0]
    paths = sorted({s.path for s in found})
    per_path = dict(zip(paths, S.idle_seconds(busy, [[(s.start, s.end) for s in found if s.path == p]
                                                     for p in paths])))
    steps = [s for s in found if s.path == "magi/step"]
    per_step = [sum(1 for s in found if st.start <= s.start and s.end <= st.end) for st in steps]
    edges = [t.start] + [x for iv in busy for x in iv] + [t.end]
    gaps = sorted(((edges[i], edges[i + 1]) for i in range(0, len(edges), 2) if edges[i + 1] > edges[i]),
                  key=lambda g: g[0] - g[1])[:top]
    named = []
    for a, b in gaps:
        over = [s for s in found if min(b, s.end) - max(a, s.start) > 0.5 * (b - a)]
        inner = min(over, key=lambda s: s.end - s.start).path if over else "outside every program span"
        named.append([f"{inner} at {(a - t.start) * 1e-6:.3f} s", (b - a) * 1e-6])
    return {"window_s": window, "idle_s": idle, "idle_in_program_spans_s": inside,
            "share_in_program_spans": inside / idle if idle > 0 else None, "idle_by_path_s": per_path,
            "spans_a_step": sum(per_step) / len(per_step) if per_step else None, "idle_gaps": named}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=40.0)
    ap.add_argument("--out", default=None, help="also write the result's JSON here")
    args = ap.parse_args(argv)
    from benchmark import run as bench_run

    bench_run._environment()
    import torch

    from benchmark import cells, harness

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    torch.set_num_threads(4)
    cell = cells.load(args.workload, ROOT)
    cell.per_layer = cell.per_layer + cell.end_to_end  # the traced window's end-to-end metrics too
    path = os.path.join(bench_run.CACHE, "trace_spans.json")
    try:
        result = harness.run(cell, args.seed, args.seconds, True, "cuda:0", T_START, trace_path=path)
        result["spans"] = breakdown(path)
    finally:
        if os.path.exists(path):
            os.remove(path)
    result["span_cost"] = span_cost_us()
    result["card"] = torch.cuda.get_device_name(0)
    line = json.dumps(result)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

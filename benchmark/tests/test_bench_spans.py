"""The program's spans in a trace (`benchmark/spans.py`) and the metrics
that read them, on a synthetic chrome trace: the name grammar, clipping to
the window, the device's idle time inside nested and overlapping spans
counted once, and each reader on a toy `Reading`, None without a trace or
without the program's spans (a program that records none)."""

import json
import os

import pytest

from benchmark import cells, harness, spans, trace as tr
from benchmark.tests.tiny import REPO

BENCH_DIR = os.path.join(REPO, "benchmark")
METRICS = ("decode_idle_ms", "decode_host_ms", "step_idle_ms", "request_idle_ms")
STEP = "variant=cfg1,4,0,0,1 n_den=4 extra=0 q_tokens=10 kv_tokens=20"

# microseconds; the window is [0, 1000]
SPANS = [
    ("bench/window", 0, 1000),
    ("bench/request", 0, 400),  # the harness's: not the program's
    ("magi/request/inputs chunks=4 caption_tokens=7", -50, 120),  # starts before the window
    ("magi/request/sampler req=0 leased=1", 110, 150),  # overlaps inputs
    ("magi/request/capture req=0 variants=3 graphs=0", 140, 400),
    ("magi/request/capture/warm variant=cfg1,4,0,0,1", 350, 390),  # nested in capture
    ("magi/step req=0 step=0 " + STEP, 450, 650),
    ("magi/step/plan", 450, 480),
    ("magi/step/replay", 480, 520),
    ("magi/step/sync", 520, 650),
    ("magi/step req=0 step=1 " + STEP, 650, 700),
    ("magi/decode frames=24 bytes=100", 700, 800),
    ("magi/decode/to_uint8", 720, 780),
    ("magi/decode frames=24 bytes=100 req=0", 850, 1200),  # ends after the window
    ("magi/decode/to_uint8", 860, 880),
    ("magi/step req=0 step=2 " + STEP, 1200, 1300),  # after the window
]
# two overlapping kernels, a copy, and a kernel past the window's end
OPS = [("kernel", "k1", 100, 200), ("kernel", "k2", 150, 300), ("gpu_memcpy", "copy", 500, 600),
       ("kernel", "k3", 900, 1100)]


def _trace(tmp_path, with_program_spans=True) -> tr.Trace:
    events = [{"ph": "X", "cat": "user_annotation", "name": n, "ts": a, "dur": b - a} for n, a, b in SPANS
              if with_program_spans or not n.startswith("magi/")]
    events += [{"ph": "X", "cat": c, "name": n, "ts": a, "dur": b - a} for c, n, a, b in OPS]
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": events}))
    return tr.Trace(str(path))


def _reading(trace) -> harness.Reading:
    return harness.Reading(cfg={}, chunk_num=4, caption_tokens=7, frames_per_chunk=24, setup_s=1.0, window_s=1e-3,
                           steps=[], chunk_steps=0, first_chunk_s=None, peak_bytes=0, decode_seconds=[],
                           capture_seconds=0.0, trace=trace)


def test_parse_splits_path_and_attributes():
    assert spans.parse("magi/step/plan") == ("magi/step/plan", {})
    assert spans.parse("magi/step req=3 variant=cfg1,4,0,1 extra=0") == (
        "magi/step", {"req": "3", "variant": "cfg1,4,0,1", "extra": "0"})
    with pytest.raises(ValueError, match="not key=value"):
        spans.parse("magi/step req")


def test_program_spans_are_clipped_to_the_window(tmp_path):
    t = _trace(tmp_path)
    steps = spans.program_spans(t, "magi/step")
    assert [(s.attrs["step"], s.start, s.end) for s in steps] == [("0", 450, 650), ("1", 650, 700)]
    decodes = spans.program_spans(t, "magi/decode")
    assert [(d.start, d.end) for d in decodes] == [(700, 800), (850, 1000)]
    assert decodes[1].attrs == {"frames": "24", "bytes": "100", "req": "0"}
    request = spans.program_spans(t, "magi/request/")
    assert [s.path for s in request] == ["magi/request/inputs", "magi/request/sampler", "magi/request/capture",
                                         "magi/request/capture/warm"]
    assert request[0].start == 0
    assert len(spans.program_spans(t)) == len(SPANS) - 3  # every magi/ span but the one after the window


def test_idle_inside_nested_and_overlapping_spans_counts_once(tmp_path):
    t = _trace(tmp_path)
    busy = t.busy()
    assert busy == [(100, 300), (500, 600), (900, 1000)]
    # [0, 150] and [140, 400] overlap, [350, 390] lies inside: their union
    # [0, 400] holds 200 us without a device operation
    request = [(s.start, s.end) for s in spans.program_spans(t, "magi/request/")]
    assert spans.idle_seconds(busy, [request]) == [pytest.approx(200e-6)]
    assert spans.union(request) == [(0, 400)]
    # each group apart; an empty group is idle for 0 s
    assert spans.idle_seconds(busy, [[(450, 650)], [(650, 700)], [(100, 300)], []]) == [
        pytest.approx(100e-6), pytest.approx(50e-6), 0.0, 0.0]


def test_readers_on_a_toy_reading(tmp_path):
    got = {m: cells.reader(BENCH_DIR, m)(_reading(_trace(tmp_path))) for m in METRICS}
    # decodes idle 100 and 50 us, their conversions 60 and 20 us; steps idle
    # 100 and 50 us; the request's set-up 200 us, counted once
    assert got == {"decode_idle_ms": pytest.approx(0.075), "decode_host_ms": pytest.approx(0.04),
                   "step_idle_ms": pytest.approx(0.075), "request_idle_ms": pytest.approx(0.2)}


@pytest.mark.parametrize("metric", METRICS)
def test_readers_find_nothing_without_a_trace_or_the_programs_spans(tmp_path, metric):
    read = cells.reader(BENCH_DIR, metric)
    assert read(_reading(None)) is None
    assert read(_reading(_trace(tmp_path, with_program_spans=False))) is None


def test_each_reader_is_a_per_layer_metric_of_both_cells():
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        bench = json.load(f)
    entries = {m["name"]: m for m in bench["per_layer"]}
    cell_names = [w["name"] for w in bench["workloads"]]
    for m in METRICS:
        assert entries[m]["source"] == "program_span" and entries[m]["unit"] == "ms"
        assert entries[m]["workloads"] == cell_names
    assert entries["request_idle_ms"]["moves"] == "first_chunk_s"

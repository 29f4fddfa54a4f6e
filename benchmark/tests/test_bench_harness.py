"""The harness: every file of BENCHMARK.json loads and each cell resolves; a
cell added with new files alone runs end to end on the CPU, is correct, and
reports the metric a new file adds; the faults a run can have make it not
correct; without a card, or without the program, a run fails and prints no
result."""

import json
import os
import re
import shutil
import subprocess
import sys
import time

import pytest
import torch

from benchmark import cells, harness
from benchmark.tests import faults, tiny

REPO = tiny.REPO
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SEED = 2**31 + 977


def _bench():
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        return json.load(f)


def test_benchmark_json_keeps_the_contract():
    b = _bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert b["paths"] == ["benchmark"] and b["command"] == ["python3", "benchmark/run.py"]
    names = [m["name"] for m in b["end_to_end"] + b["per_layer"]] + [w["name"] for w in b["workloads"]]
    names += [c["name"] for c in b["configs"]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    e2e = {m["name"]: m for m in b["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25 and all(0.01 <= m["bound"] <= 0.25 for m in e2e.values())
    cell_names = {w["name"] for w in b["workloads"]}
    for m in b["end_to_end"] + b["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert set(m.get("workloads", cell_names)) <= cell_names
    for m in b["per_layer"]:
        assert m["moves"] in e2e and m["workloads"]
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"
    for w in b["workloads"]:
        cell = cells.load(w["name"], REPO)
        assert "setup_s" in {m["name"] for m in cell.end_to_end} and len(cell.end_to_end) >= 2
        assert cell.per_layer and w["chips"] == 1 and len(w["why"]) <= 200


@pytest.mark.parametrize("workload", [w["name"] for w in _bench()["workloads"]])
def test_cell_files_load_and_resolve(workload):
    from magi_tpu_torch.core.config import MagiConfig

    cell = cells.load(workload, REPO)
    conf = {c["name"]: c for c in _bench()["configs"]}[cell.config_name]
    assert cell.config["reduced"] == conf["reduced"] and cell.config["source"] == conf["source"]
    assert cell.limits is not None, "each cell has the limits of its check"
    assert cell.config["controls"], "each configuration names its controls"
    for control in [None, *cell.config["controls"]]:
        cfg = MagiConfig.from_dict(cell.program_config(control))
        assert cfg.engine_config.world_size == 1
        assert cfg.runtime_config.num_frames == cell.traffic["num_frames"]
    for m in cell.end_to_end + cell.per_layer:
        assert callable(cells.reader(cell.bench_dir, m["name"]))


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.make_root(str(tmp_path_factory.mktemp("checkout")))


def _run(root, trace=False, control=None, seconds=0.5):
    cell = cells.load("tiny.t2v", root)
    return harness.run(cell, SEED, seconds, trace, "cpu", time.perf_counter(), control=control,
                       trace_path=os.path.join(root, "trace.json"))


def test_added_cell_runs_correct_on_the_cpu(root):
    out = _run(root)
    assert out["correct"], out["checks"]
    assert set(out["metrics"]) == {"frames_per_s", "first_chunk_s", "peak_gib", "setup_s"}
    assert out["attempted"] > 0 and out["failed"] == 0
    assert list(out)[-1] == "checks"
    traced = _run(root, trace=True)
    assert traced["correct"] and {"tiny_steps", "step_mfu", "idle_share"} <= set(traced["metrics"])
    assert traced["device"]["window_s"] > 0


@pytest.mark.parametrize("control", ["fp8_quant", "attn_int8"])
def test_control_is_not_correct(root, control):
    sound, low = _run(root), _run(root, control=control)
    assert not low["correct"]
    assert low["checks"]["chunk_tail"]["value"] > 0.5 > 100 * sound["checks"]["chunk_tail"]["value"]
    if control == "attn_int8":  # the KV cache is stored int8
        assert low["checks"]["cache_gap"]["value"] > low["checks"]["cache_gap"]["limit"] >= sound["checks"]["cache_gap"]["value"]


@pytest.mark.parametrize("fault,check", [("unchanged", "chunk_tail"), ("half", "chunk_tail"),
                                         ("one_chunk", "chunk_tail"), ("velocity", "chunk_tail"),
                                         ("frames", "decode_off")])
def test_faults_are_not_correct(root, monkeypatch, fault, check):
    """A step that leaves the state unchanged, a step that leaves out half of
    its chunks or the one that moves least, an answer altered where it is
    produced (a velocity, a decoded frame).  One card and no exchange
    between chips: that fault cannot occur in these cells."""
    from magi_tpu_torch.pipeline import video_process
    from magi_tpu_torch.sampling import transport

    orig = transport._integrate_and_store
    if fault == "frames":
        monkeypatch.setattr(video_process, "post_chunk_process",
                            faults.altered_frames(video_process.post_chunk_process))
    else:
        fake = {"unchanged": faults.unchanged, "half": faults.half(orig), "one_chunk": faults.one_chunk(orig),
                "velocity": faults.altered_velocity(orig)}[fault]
        monkeypatch.setattr(transport, "_integrate_and_store", fake)
    out = _run(root)
    assert not out["correct"]
    assert out["checks"][check]["value"] > out["checks"][check]["limit"]


def test_without_a_card_a_run_fails_and_prints_nothing():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    w = _bench()["workloads"][0]["name"]
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", w, "--seed", str(SEED), "--seconds", "1",
                          "--trace", "0"], cwd=REPO, capture_output=True, text=True, timeout=120)
    assert out.returncode != 0 and "{" not in out.stdout


def test_without_the_program_a_run_fails(tmp_path):
    root = tiny.make_root(str(tmp_path))
    assert sorted(os.listdir(root)) == ["BENCHMARK.json", "benchmark"]
    script = ("import sys, time; sys.path.insert(0, '.'); from benchmark import cells, harness; "
              "print(harness.run(cells.load('tiny.t2v', '.'), 1, 0.5, False, 'cpu', time.perf_counter()))")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", script], cwd=root, capture_output=True, text=True, timeout=120,
                         env=env)
    assert out.returncode != 0 and "correct" not in out.stdout
    assert "magi_tpu_torch" in out.stderr
    shutil.rmtree(root)


@pytest.fixture(scope="module")
def root3(tmp_path_factory):
    """The tiny cell on the 4.5B base: three-branch CFG, 64 steps, its window
    after the ramp, as the base cell's.  Its step check at tau 1e-2: the
    program's update is read back as the difference of its f32 latent state
    before and after a step, which at the 64-step grid's smallest dt (8e-5)
    rounds some 1e-3 of the update away."""
    return tiny.make_root(str(tmp_path_factory.mktemp("checkout3")), base="magi-4.5B-base", tau=1e-2,
                          lead_in="ramp")


def test_three_branch_cell_runs_correct_on_the_cpu(root3):
    """A three-branch CFG cell added with new files alone: the program walks
    its text, null-caption and uncond forwards, and the reference's three
    forwards and their combination meet it."""
    assert cells.load("tiny.t2v", root3).program_config()["runtime_config"]["cfg_number"] == 3
    out = _run(root3)
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and "first_chunk_s" in out["metrics"]
    traced = _run(root3, trace=True)
    assert traced["correct"] and {"tiny_steps", "step_mfu", "idle_share"} <= set(traced["metrics"])


@pytest.mark.parametrize("workload", [w["name"] for w in _bench()["workloads"]])
def test_lead_in_opens_the_window_in_the_steady_state(workload):
    """A traffic with the `ramp` lead-in opens the window at the step that
    writes the first clean chunk into the cache, after every step of the
    ramp and before the first that reads the cache; one without it, at the
    request's start."""
    cell = cells.load(workload, REPO)
    rc, ec = (cell.program_config()[k] for k in ("runtime_config", "engine_config"))
    chunk_num = rc["num_frames"] // (rc["temporal_downsample_factor"] * rc["chunk_width"])
    total = harness.schedule.total_steps(chunk_num, rc["num_steps"], rc["window_size"])
    lead = harness.lead_in_steps(cell.traffic, rc, ec, chunk_num, total)
    if cell.traffic.get("lead_in", "none") == "none":
        assert lead == 0
        return
    plans = [harness.schedule.plan(rc, ec, chunk_num, i) for i in range(lead + 2)]
    assert lead == rc["num_steps"] and plans[lead].extra and plans[lead + 1].cached
    assert not any(p.extra or p.cached for p in plans[:lead])
    with pytest.raises(ValueError):
        harness.lead_in_steps({"lead_in": "half"}, rc, ec, chunk_num, total)


@pytest.mark.parametrize("control", ["fp8_quant", "attn_int8"])
def test_three_branch_control_is_not_correct(root3, control):
    """The reference at w8a8 in the program's place (the program has no w8a8
    path under three-branch CFG), and the program's int8 attention."""
    sound, low = _run(root3), _run(root3, control=control)
    assert not low["correct"]
    assert low["checks"]["chunk_tail"]["value"] > 0.3 > 100 * sound["checks"]["chunk_tail"]["value"]


@pytest.mark.parametrize("fault", ["dropped_text", "unchanged", "half", "one_chunk", "velocity"])
def test_three_branch_faults_are_not_correct(root3, monkeypatch, fault):
    """The text branch dropped from the combination (the null-caption
    branch's output in its place), and the step faults of the single-branch
    cell."""
    from magi_tpu_torch.sampling import transport

    if fault == "dropped_text":
        monkeypatch.setattr(transport, "_combine3", faults.dropped_text(transport._combine3))
    else:
        orig = transport._integrate_and_store
        fake = {"unchanged": faults.unchanged, "half": faults.half(orig), "one_chunk": faults.one_chunk(orig),
                "velocity": faults.altered_velocity(orig)}[fault]
        monkeypatch.setattr(transport, "_integrate_and_store", fake)
    out = _run(root3)
    assert not out["correct"]
    assert out["checks"]["chunk_tail"]["value"] > out["checks"]["chunk_tail"]["limit"]

"""On the card, at each cell's own size: each of the cell's controls (a
lower-precision path of the program, or the reference at that precision in
the program's place), a step that leaves out one chunk's update and, in a
three-branch CFG cell, a step that drops its text branch come out not
correct, each failing a check of the denoise
steps or the KV cache by itself (not only the decode's, which every
control also fails); and the reference, against itself on inputs one bf16 step apart,
spreads as the sound runs do.  Run there with
`python -m pytest benchmark/tests -m cuda -q -s` (the readings go to
standard error)."""

import json
import time

import pytest
import torch

from benchmark import cells, harness, schedule, weights as W
from benchmark.reference import dit as ref_dit
from benchmark.tests import faults
from benchmark.tests.tiny import REPO

with open(f"{REPO}/BENCHMARK.json") as _f:
    CELLS = [w["name"] for w in json.load(_f)["workloads"]]
CONTROLS = [(w, c) for w in CELLS for c in cells.load(w, REPO).config["controls"]]
SEED = 2**31 + 4242


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return "cuda:0"


def _dit_checks_failed(out):
    """The numbers of the denoise steps and the cache, not of the decode, over their limits."""
    return [k for k, c in out["checks"].items() if k != "decode_off" and c["value"] > c["limit"]]


@pytest.mark.cuda
@pytest.mark.parametrize("workload,control", CONTROLS)
def test_control_is_not_correct_at_the_cells_size(card, workload, control):
    cell = cells.load(workload, REPO)
    out = harness.run(cell, SEED, 5.0, False, card, time.perf_counter(), control=control)
    assert out["device"]["platform"] == "gpu"
    assert not out["correct"], out["checks"]
    assert _dit_checks_failed(out), out["checks"]
    torch.cuda.empty_cache()


@pytest.mark.cuda
@pytest.mark.parametrize("workload", CELLS)
def test_dropped_chunk_is_not_correct_at_the_cells_size(card, workload, monkeypatch):
    from magi_tpu_torch.sampling import transport

    monkeypatch.setattr(transport, "_integrate_and_store", faults.one_chunk(transport._integrate_and_store))
    cell = cells.load(workload, REPO)
    out = harness.run(cell, SEED + 1, 5.0, False, card, time.perf_counter())
    assert not out["correct"], out["checks"]
    assert out["checks"]["chunk_tail"]["value"] > out["checks"]["chunk_tail"]["limit"], out["checks"]
    torch.cuda.empty_cache()


@pytest.mark.cuda
@pytest.mark.parametrize("workload", [w for w in CELLS
                                      if cells.load(w, REPO).config["runtime_config"]["cfg_number"] == 3])
def test_dropped_text_branch_is_not_correct_at_the_cells_size(card, workload, monkeypatch):
    from magi_tpu_torch.sampling import transport

    monkeypatch.setattr(transport, "_combine3", faults.dropped_text(transport._combine3))
    cell = cells.load(workload, REPO)
    out = harness.run(cell, SEED + 3, 5.0, False, card, time.perf_counter())
    assert not out["correct"], out["checks"]
    assert _dit_checks_failed(out), out["checks"]
    torch.cuda.empty_cache()


def reference_spread(cell: cells.Cell, seed: int, device) -> dict:
    """The reference against itself: each checked step's update on the
    benchmark's noise, and on the same noise with every value moved by one
    bf16 step (a relative 2**-8, its sign drawn from the seed); the step
    numbers of the second against the first, the largest over the steps."""
    cfg = cell.program_config(None)
    taus = sorted(set(harness.TAILS) | {lim["tau"] for lim in (cell.limits or {}).values() if "tau" in lim})
    rc, ec, mc = cfg["runtime_config"], cfg["engine_config"], cfg["model_config"]
    cw = rc["chunk_width"]
    chunk_num = rc["num_frames"] // (rc["temporal_downsample_factor"] * cw)
    total = schedule.total_steps(chunk_num, rc["num_steps"], rc["window_size"])
    plans = [schedule.plan(rc, ec, chunk_num, i) for i in harness.checked_steps(seed, rc, ec, chunk_num, total)]
    vae = rc["temporal_downsample_factor"], 8
    shape = (mc["out_channels"] // (2 if mc["half_channel_vae"] else 1), chunk_num * cw,
             rc["video_size_h"] // vae[1], rc["video_size_w"] // vae[1])
    noise = W.noise(seed, shape, device).cpu()
    sign = torch.randint(0, 2, shape, generator=torch.Generator().manual_seed(seed % 2**32)) * 2 - 1
    moved = noise * (1 + sign * 2.0**-8)
    tokens = int(cell.traffic["caption_tokens"])
    embs, _ = W.caption(seed, mc["caption_max_length"], mc["caption_channels"], tokens)
    fwds = [harness.reference_forwards(rc, p, x[:, p.lo * cw : p.c_end * cw], device) for p in plans
            for x in (noise, moved)]
    outs = ref_dit.velocities(cfg, seed, device, [f for fs in fwds for f in fs], torch.from_numpy(embs[0]), tokens,
                              tuple(cell.config.get("smooth_linears", ())))
    at = [0]
    for fs in fwds:
        at.append(at[-1] + len(fs))
    steps = []
    for k, p in enumerate(plans):
        d0, d1 = (harness.reference_update(rc, p, outs[at[j] : at[j + 1]]) for j in (2 * k, 2 * k + 1))
        steps.append(harness.step_numbers(d1, d0, p.n_den, taus))
        harness.log(f"spread: {cell.name} step {p.index}: " + ", ".join(f"{k} {v:.6g}" for k, v in steps[-1].items()))
    return {k: max(st[k] for st in steps) for k in steps[0]}


@pytest.mark.cuda
@pytest.mark.parametrize("workload", CELLS)
def test_reference_spreads_as_the_sound_runs(card, workload):
    """The sound runs' spread is the configuration's arithmetic, not a fault:
    the plain reference moved by one bf16 step spreads as the program
    against the reference does (PERF.md section 4 sets the two side by side;
    on the w8a8 tree int8 rounding edges flip, and the flips grow through
    the layers), and the cell's step check admits it."""
    torch.backends.cuda.matmul.allow_tf32 = False
    cell = cells.load(workload, REPO)
    spread = reference_spread(cell, SEED + 2, card)
    harness.log(f"spread: {workload}: " + json.dumps(spread))
    tail = cell.limits["chunk_tail"]
    assert spread[f"chunk_tail_{tail['tau']}"] <= tail["limit"], spread
    torch.cuda.empty_cache()


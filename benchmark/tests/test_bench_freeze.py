"""The yardstick of the single-branch cells, frozen: every step's plan of
their walks, the work of their first 40 steps and the steps their check
draws for 20 seeds equal what the code gave before it learnt three-branch
CFG (`data/frozen_walks.json`, written by that code), so the cells
measured before read as they did."""

import dataclasses
import json
import os

import pytest

from benchmark import cells, harness, schedule, work
from benchmark.tests.tiny import REPO

with open(os.path.join(os.path.dirname(os.path.abspath(__file__)), "data", "frozen_walks.json")) as _f:
    FROZEN = json.load(_f)


def _cell(workload):
    cfg = cells.load(workload, REPO).program_config(None)
    rc = cfg["runtime_config"]
    chunk_num = rc["num_frames"] // (rc["temporal_downsample_factor"] * rc["chunk_width"])
    assert chunk_num == FROZEN[workload]["chunk_num"]
    return cfg, chunk_num


def _json(x):
    return json.loads(json.dumps(x))


@pytest.mark.parametrize("workload", sorted(FROZEN))
def test_every_plan_of_the_walk_is_frozen(workload):
    cfg, chunk_num = _cell(workload)
    rc, ec = cfg["runtime_config"], cfg["engine_config"]
    plans = FROZEN[workload]["plans"]
    assert len(plans) == schedule.total_steps(chunk_num, rc["num_steps"], rc["window_size"])
    for i, want in enumerate(plans):
        got = dataclasses.asdict(schedule.plan(rc, ec, chunk_num, i))
        assert got.pop("scales") == (), i
        assert _json(got) == want, i


@pytest.mark.parametrize("workload", sorted(FROZEN))
def test_work_of_the_first_40_steps_is_frozen(workload):
    cfg, chunk_num = _cell(workload)
    tokens = int(cells.load(workload, REPO).traffic["caption_tokens"])
    got = [dataclasses.asdict(o) for o in work.window_ops(cfg, tokens, list(range(40)), chunk_num)]
    assert _json(got) == FROZEN[workload]["window_ops_40"]


@pytest.mark.parametrize("workload", sorted(FROZEN))
def test_checked_steps_are_frozen(workload):
    cfg, chunk_num = _cell(workload)
    rc, ec = cfg["runtime_config"], cfg["engine_config"]
    total = schedule.total_steps(chunk_num, rc["num_steps"], rc["window_size"])
    for seed, want in FROZEN[workload]["checked_steps"].items():
        assert harness.checked_steps(int(seed), rc, ec, chunk_num, total) == want, seed

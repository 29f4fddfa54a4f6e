"""The frozen schedule against the program's plan, and the work and byte
counts against hand counts at tiny shapes."""

import dataclasses
import json
import os

import numpy as np
import pytest

from benchmark import harness, schedule, work
from benchmark.tests.tiny import REPO


def _released(name):
    with open(os.path.join(REPO, "benchmark", "configs", name + ".json")) as f:
        return json.load(f)


@pytest.mark.parametrize("chunks", [1, 2, 5, 9])
def test_plan_matches_the_program(chunks):
    """Every step of a walk: the same windows, timesteps, kv ranges, dt and
    ride-along as `ArdfSampler._plan`, on the released runtime config."""
    from magi_tpu_torch.core.config import MagiConfig
    from magi_tpu_torch.sampling.transport import ArdfSampler

    conf = _released("magi-4.5B-distill")
    cfg = {k: conf[k] for k in ("model_config", "runtime_config", "engine_config")}
    sampler = ArdfSampler.__new__(ArdfSampler)
    sampler.config = MagiConfig.from_dict(cfg)
    sampler.chunk_num, sampler.window, sampler.num_steps = chunks, 4, 16
    sampler.chunk_offset, sampler.prefix_len, sampler.ctn = 0, 0, 7
    sampler.t_total = schedule.init_t(16)
    rc, ec = cfg["runtime_config"], cfg["engine_config"]
    assert schedule.total_steps(chunks, 16, 4) == 4 * (chunks + 3)
    for i in range(schedule.total_steps(chunks, 16, 4)):
        p, q = ArdfSampler._plan(sampler, i), schedule.plan(rc, ec, chunks, i)
        assert (q.c_start, q.c_end, q.sp, q.extra, q.nearly) == (p["c_start"], p["c_end"], p["sp"], p["extra"],
                                                                   p["distill_nearly"])
        n_seg = p["n_seg"]
        assert [s.t for s in q.segments[:n_seg]] == list(p["tvec"])
        assert [(a * 7, b * 7) for a, b in (s.kv for s in q.segments[:n_seg])] == list(
            zip(p["kv_start"].tolist(), p["kv_end"].tolist()))
        np.testing.assert_array_equal(np.asarray(q.dt, np.float32), p["dt"])
        assert len(q.segments) == n_seg + int(q.nearly)


@pytest.mark.parametrize("chunks", [1, 2, 5])
def test_three_branch_plan_matches_the_program(chunks):
    """Every step of a three-branch walk (the released 4.5B base): the same
    windows, timesteps, kv ranges and dt as `ArdfSampler._plan`, no
    ride-along, each denoised chunk's scales as `ArdfSampler._cfg_scales`,
    the null-caption forward over the text forward's segments, and the
    uncond forward over the denoised chunks alone, self-only, at rope
    position 0."""
    from magi_tpu_torch.core.config import MagiConfig
    from magi_tpu_torch.sampling.transport import ArdfSampler

    conf = _released("magi-4.5B-base")
    cfg = {k: conf[k] for k in ("model_config", "runtime_config", "engine_config")}
    sampler = ArdfSampler.__new__(ArdfSampler)
    sampler.config = MagiConfig.from_dict(cfg)
    sampler.chunk_num, sampler.window, sampler.num_steps = chunks, 4, 64
    sampler.chunk_offset, sampler.prefix_len, sampler.ctn = 0, 0, 7
    sampler.t_total = schedule.init_t(64)
    rc, ec = cfg["runtime_config"], cfg["engine_config"]
    assert schedule.total_steps(chunks, 64, 4) == 16 * (chunks + 3)
    seen = set()
    for i in range(schedule.total_steps(chunks, 64, 4)):
        p, q = ArdfSampler._plan(sampler, i), schedule.plan(rc, ec, chunks, i)
        assert (q.c_start, q.c_end, q.sp, q.extra, q.nearly) == (p["c_start"], p["c_end"], p["sp"], p["extra"], False)
        assert not p["distill_nearly"] and len(q.segments) == p["n_seg"]
        assert [s.t for s in q.segments] == list(p["tvec"])
        assert [(a * 7, b * 7) for a, b in (s.kv for s in q.segments)] == list(
            zip(p["kv_start"].tolist(), p["kv_end"].tolist()))
        np.testing.assert_array_equal(np.asarray(q.dt, np.float32), p["dt"])
        ps, ts = ArdfSampler._cfg_scales(sampler, p["tvec_padded"][-p["n_den"]:])
        assert q.scales == tuple(zip(ps.tolist(), ts.tolist()))
        seen |= set(q.scales)
        null, uncond = q.forwards[1][0], q.forwards[2][0]
        assert [(s.src, s.pos, s.t, s.kv) for s in null] == [(s.src, s.pos, s.t, s.kv) for s in q.segments]
        assert not any(s.text for s in null)
        den = q.segments[int(q.extra):]
        assert [(s.src, s.t) for s in uncond] == [(s.src, s.t) for s in den]
        assert [(s.pos, s.kv, s.text) for s in uncond] == [(0, (j, j + 1), False) for j in range(q.n_den)]
        assert [fw[1:] for fw in q.forwards] == [(False, False), (True, True), (True, False)]
    # the released table's two pairs both occur
    assert seen == {(1.5, 7.5), (1.0, 0.0)}


def test_sd3_schedule():
    t = schedule.init_t(16)
    assert t[0] == 0 and t[-1] == np.float32(1.0) and np.all(np.diff(t) > 0)
    # x**2 shifted by 3: x / 3 / (1 - 2x / 3)
    x = (8 / 16) ** 2
    assert t[8] == pytest.approx(x / 3 / (1 - 2 * x / 3), rel=1e-6)


def _geo(w8a8=False, gated=False):
    mc = dict(hidden_size=8, kv_channels=2, num_attention_heads=2, num_query_groups=1, num_layers=3,
              ffn_hidden_size=16, gated_linear_unit=gated, in_channels=4, out_channels=4, t_patch_size=1,
              patch_size=2, caption_channels=5)
    return work.Geometry(ctn=3, caption_rows=4, caption_tokens=2, null_tokens=1, mc=mc, w8a8=w8a8)


def test_work_of_a_one_chunk_step_by_hand():
    rc = _released("magi-4.5B-distill")["runtime_config"]
    ec = _released("magi-4.5B-distill")["engine_config"]
    step = schedule.plan(rc, ec, 4, 0)  # one segment attending itself
    assert [s.kv for s in step.segments] == [(0, 1)]
    ops = {(o.kind, o.precision): o for o in work.step_ops(_geo(), step)}
    L = 3
    # self-attention: 3 x 3 pairs, 4 ops a pair per head and dim, 2 heads x 2 dims
    sa = ops[("self_attention", "bf16")]
    assert sa.ops == 4 * 2 * 2 * 9 * L
    # q and out 3 tokens x 2 heads x 2 dims, k and v 3 tokens x 1 head x 2 dims, bf16
    assert sa.nbytes == 2 * (2 * 12 + 2 * 6) * L
    assert sa.bound_s == pytest.approx(L * max(4 * 2 * 2 * 9 / 989e12, 2 * 36 / 3.35e12))
    # cross-attention over the 2 caption tokens
    assert ops[("cross_attention", "bf16")].ops == 4 * 2 * 2 * 3 * 2 * L
    # linears of one layer: q, qx (8 x 4), k, v (8 x 2), kv_xattn on 4 caption rows (8 x 4),
    # proj (8 x 8), fc1 (8 x 16), fc2 (16 x 8)
    per_layer = 2 * (3 * 8 * (4 + 4 + 2 + 2) + 4 * 8 * 4 + 3 * 8 * 8 + 3 * 8 * 16 + 3 * 16 * 8)
    assert ops[("linear", "bf16")].ops == per_layer * L
    assert ("linear", "int8") not in ops


def test_int8_linears_are_the_middle_layers():
    rc = _released("magi-24B-distill-w8a8")["runtime_config"]
    ec = _released("magi-24B-distill-w8a8")["engine_config"]
    step = schedule.plan(rc, ec, 4, 0)
    ops = {(o.kind, o.precision): o for o in work.step_ops(_geo(w8a8=True, gated=True), step)}
    i8, bf = ops[("linear", "int8")], ops[("linear", "bf16")]
    assert bf.ops == 2 * i8.ops  # two bf16 edge layers, one int8 middle layer
    # a gated MLP's fc1 is 8 x 32
    per_layer = 2 * (3 * 8 * 12 + 4 * 8 * 4 + 3 * 8 * 8 + 3 * 8 * 32 + 3 * 16 * 8)
    assert i8.ops == per_layer  # L - 2 = 1 middle layer
    # the fc2 group: a bf16 input 3 x 16 read once, an int8 weight 16 x 8, a bf16 output 3 x 8
    assert work._linear_group(3, 16, [8], "int8", 1)[1] == 3 * 16 * 2 + 16 * 8 + 3 * 8 * 2


def test_roofline_bound_is_the_larger():
    assert work.bound(989e12, 0, "bf16") == pytest.approx(1.0)
    assert work.bound(0, 3.35e12, "int8") == pytest.approx(1.0)
    assert work.bound(1979e12, 3.35e12 / 2, "int8") == pytest.approx(1.0)


def test_checked_steps_cover_each_kind():
    conf = _released("magi-4.5B-distill")
    rc, ec = conf["runtime_config"], conf["engine_config"]
    for seed in (1, 2**31 + 5, 12345):
        steps = harness.checked_steps(seed, rc, ec, 20, schedule.total_steps(20, 16, 4))
        plans = [schedule.plan(rc, ec, 20, i) for i in steps]
        assert steps[0] == 0 and len(steps) == 4 and max(steps) < 24
        assert any(p.extra for p in plans) and any(p.cached for p in plans)
        assert any(p.n_den == 4 and not p.extra and not p.cached for p in plans)


def _base_cfg(pack_uncond=False):
    conf = _released("magi-4.5B-base")
    cfg = {k: json.loads(json.dumps(conf[k])) for k in ("model_config", "runtime_config", "engine_config")}
    cfg["runtime_config"].update(video_size_h=352, video_size_w=640, num_frames=960)
    cfg["engine_config"]["pack_uncond"] = pack_uncond
    return cfg


def test_three_branch_work_is_the_same_with_pack_uncond():
    """The count follows the three forwards the arithmetic needs, whether
    the program packs the uncond segments into the text forward or not."""
    runs = [work.window_ops(_base_cfg(pack), 64, list(range(0, 150, 7)), 40) for pack in (False, True)]
    assert [dataclasses.asdict(o) for o in runs[0]] == [dataclasses.asdict(o) for o in runs[1]]


def test_three_branch_step_counts_its_three_forwards_by_hand():
    """A full-window step with a cached chunk: the text and null-caption
    forwards over the window (their caption tokens the request's and the
    null one's), and the uncond forward over the denoised chunks alone,
    each attending itself; a single-branch count of each forward's
    segments adds up to the step's."""
    rc = _released("magi-4.5B-base")["runtime_config"]
    ec = _released("magi-4.5B-base")["engine_config"]
    step = next(p for p in (schedule.plan(rc, ec, 8, i) for i in range(200)) if p.cached and p.n_den == 4)
    geo = _geo()
    ops = {(o.kind, o.precision): o for o in work.step_ops(geo, step)}
    one = [{(o.kind, o.precision): o for o in work.step_ops(geo, dataclasses.replace(
        step, segments=segs, scales=()))} for segs, _, _ in step.forwards]
    for key, op in ops.items():
        assert op.ops == pytest.approx(sum(o[key].ops for o in one))
        assert op.nbytes == pytest.approx(sum(o[key].nbytes for o in one))
    n_win, L, ctn = len(step.segments), 3, geo.ctn
    pairs = 2 * sum(b - a for a, b in (s.kv for s in step.segments)) + step.n_den
    assert ops[("self_attention", "bf16")].ops == 4 * 2 * 2 * pairs * ctn * ctn * L
    cap = sum(2 if s.text else 1 for s in step.segments) + n_win * 1 + step.n_den * 1
    assert ops[("cross_attention", "bf16")].ops == 4 * 2 * 2 * ctn * cap * L
    tokens = (2 * n_win + step.n_den) * ctn
    per_token = 2 * (8 * (4 + 4 + 2 + 2) + 8 * 8 + 8 * 16 + 16 * 8)
    cap_rows = (2 * n_win + step.n_den) * 4
    assert ops[("linear", "bf16")].ops == (tokens * per_token + cap_rows * 2 * 8 * 4) * L


def test_checked_steps_hold_both_scales_under_three_branch_cfg():
    """The four kinds of checked step, and under three-branch CFG a step
    whose denoised chunks take both of the released scale pairs."""
    conf = _released("magi-4.5B-base")
    rc, ec = conf["runtime_config"], conf["engine_config"]
    for seed in (1, 2**31 + 5, 12345, 77):
        steps = harness.checked_steps(seed, rc, ec, 40, schedule.total_steps(40, 64, 4))
        plans = [schedule.plan(rc, ec, 40, i) for i in steps]
        assert steps[0] == 0 and max(steps) < 6 * 16
        assert any(p.extra for p in plans) and any(p.cached for p in plans)
        assert any(p.n_den == 4 and not p.extra and not p.cached for p in plans)
        assert any({(1.5, 7.5), (1.0, 0.0)} <= set(p.scales) for p in plans)

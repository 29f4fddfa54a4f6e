"""The released 24B base (`benchmark/configs/magi-24B-base.json`) shrunk to
toy widths, on the CPU: the keys that pick its path are kept (48:8 heads as
6:1, the gated MLP, `x_rescale_factor` 0.1, three-branch CFG, 32 steps in
windows of 4, `kv_offload` under the noise2clean ranges [5, 4, 3, 2], so a
10-chunk cache window on the device), the widths are toy ones in fp32, and
the weights are the benchmark's (`benchmark/weights.py`).  An 11-chunk walk
runs eagerly (`capture=False`) inside a CPU profiler, with the uncond
forward apart and packed into the text forward:

- (a) its updates at step 0, at the first clean chunk's cache write and
  the first read of it, at a step whose chunks take different guidance
  scales, and at the first steps after the cache window rolls (a write,
  then a read), and the keys and values those two writes put into the
  cache, against the benchmark's plain reference (`benchmark/reference/
  dit.py`) recomputed from the walk's own frames before each step;
- (b) each step's `magi/step` span carries the forwards it runs and its
  self-attention's query-key token pairs, as the benchmark's frozen
  schedule and work counts give them;
- (c) the configuration file keeps the released file's sections, but for
  the keys it lists in `reduced`."""

import json
import os

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from benchmark import harness, schedule, spans, weights as W, work
from benchmark.reference import dit as ref_dit
from magi_tpu_torch.core.config import MagiConfig
from magi_tpu_torch.pipeline.prompt_process import build_inference_input
from magi_tpu_torch.sampling.transport import ArdfSampler
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONF = os.path.join(REPO, "benchmark", "configs", "magi-24B-base.json")
RELEASED = os.path.join(REPO, "example", "24B", "24B_base_config.json")
SECTIONS = ("model_config", "runtime_config", "engine_config")
# toy widths, 6:1 query heads to kv groups as the released 48:8 keeps 6:1
TOY = dict(num_layers=2, hidden_size=192, ffn_hidden_size=256, num_attention_heads=6, num_query_groups=1,
           kv_channels=32, caption_channels=64, caption_max_length=64, params_dtype="torch.float32")
# 11 chunks of 6 latent frames at 4x6 (36 tokens a chunk): the 10-chunk
# cache window rolls once, at stage 10
REQUEST = dict(num_frames=264, video_size_h=32, video_size_w=48)
SEED = 2**31 + 2222
TOKENS = 9
DEVICE = torch.device("cpu")
# what each checked step is, from the frozen schedule; the cache window
# holds max(noise2clean) + window + 1 chunks
KINDS = ("step0", "cache_write", "cache_read", "mixed_scales", "roll_write", "roll_read")
# fp32 on both sides: the port's plain kernels and the reference sum in
# other orders, about 1e-6 of a forward's output; x_rescale_factor 0.1
# scales the output by 10 and the guidance (text scale 7.5) weighs the
# branches' difference, so a chunk's update may differ by 1e-5 of its
# norm.  A dropped or misplaced cache chunk, a wrong guidance scale or a
# stale rolled slot moves it by more than 1e-2.
UPDATE_GAP = 1e-4
# the cache holds layer 0's keys and values as written: f32 rounding only
CACHE_GAP = 1e-5


def _config() -> dict:
    with open(CONF) as f:
        conf = json.load(f)
    cfg = {k: conf[k] for k in SECTIONS}
    cfg["model_config"].update(TOY)
    cfg["runtime_config"].update(REQUEST)
    return cfg


def _checked(rc: dict, ec: dict, chunk_num: int, total: int) -> dict:
    """Step index of each kind in `KINDS`, from the frozen schedule."""
    plans = [schedule.plan(rc, ec, chunk_num, i) for i in range(total)]
    window = max(rc["noise2clean_kvrange"]) + rc["window_size"] + 1
    rolled = [p.sp + len(p.segments) > window for p in plans]
    first = lambda pred: next(p.index for p in plans if pred(p))  # noqa: E731
    out = dict(step0=0, cache_write=first(lambda p: p.extra), cache_read=first(lambda p: p.cached and not p.extra),
               mixed_scales=first(lambda p: len(set(p.scales)) > 1),
               roll_write=first(lambda p: rolled[p.index] and p.extra),
               roll_read=first(lambda p: rolled[p.index] and p.cached and not p.extra))
    assert out["roll_read"] > out["roll_write"] > out["cache_read"] > out["cache_write"]
    return out


@pytest.fixture(scope="module", params=[False, True], ids=["apart", "packed"])
def walk(request, tmp_path_factory):
    """The toy walk (uncond apart or packed), traced; the frames before and
    after each checked step, the cache rows each checked write put there,
    its `magi/step` spans and the reference's forwards of those steps."""
    threads = torch.get_num_threads()  # this module-scoped fixture runs before `one_torch_thread`
    torch.set_num_threads(1)
    try:
        yield _walk(request.param, tmp_path_factory)
    finally:
        torch.set_num_threads(threads)


def _walk(pack: bool, tmp_path_factory) -> dict:
    cfg = _config()
    cfg["engine_config"]["pack_uncond"] = pack
    config = MagiConfig.from_dict(cfg)
    rc, ec, mc = cfg["runtime_config"], cfg["engine_config"], cfg["model_config"]
    params = harness.build_dit(cfg, config, SEED, DEVICE, ())
    embs, mask = W.caption(SEED, mc["caption_max_length"], mc["caption_channels"], TOKENS)
    null = params["y_embedder"]["null_caption_embedding"].float().numpy()
    inp = build_inference_input(config, null, embs, mask, DEVICE)
    noise = W.noise(SEED, tuple(inp.latent_size), DEVICE)
    chunk_num, cw = inp.chunk_num, rc["chunk_width"]
    path = tmp_path_factory.mktemp("trace") / "walk.json"
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        sampler = ArdfSampler(config, params, inp, noise=noise, device=DEVICE, capture=False)
        total, ctn = sampler.total_forward_steps(), sampler.ctn
        checked = _checked(rc, ec, chunk_num, total)
        plans = {i: schedule.plan(rc, ec, chunk_num, i) for i in checked.values()}
        frames, cache, bases = {}, {}, {}
        for step in range(total):
            p = plans.get(step)
            if p is not None:
                before = sampler.xs[:, p.lo * cw : p.c_end * cw].clone()
            sampler.timed_step(step)
            if p is None:
                continue
            frames[step] = (before, sampler.xs[:, p.c_start * cw : p.c_end * cw].clone())
            bases[step] = sampler.cache_base
            if p.extra:
                slot = p.sp - sampler.cache_base
                # a copy: on the CPU in f32 `cache_rows` returns a view, which later writes overwrite
                cache[step] = harness.cache_rows(sampler.cache, slot * ctn, (slot + 1) * ctn).clone()
    prof.export_chrome_trace(str(path))
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    steps = [spans.parse(e["name"])[1] for e in events
             if e.get("ph") == "X" and e.get("cat") == "user_annotation" and e["name"].startswith("magi/step ")]
    assert chunk_num == 11 and ctn == 36 and sampler.cache_chunks == 10

    # the reference: each checked step's forwards on the frames the walk held before it
    fwds, at = [], {}
    for i, p in sorted(plans.items()):
        fs = harness.reference_forwards(rc, p, frames[i][0], DEVICE)
        if p.extra:
            writer = next(f for f, (_, _, writes) in zip(fs, p.forwards) if writes)
            writer.kv_rows = (len(p.cached) * ctn, (len(p.cached) + 1) * ctn)
        at[i] = (len(fwds), fs)
        fwds += fs
    outs = ref_dit.velocities(cfg, SEED, DEVICE, fwds, torch.from_numpy(embs[0]), TOKENS)
    ref = {i: (harness.reference_update(rc, plans[i], outs[k : k + len(fs)]),
               next((f.kv0 for f in fs if f.kv0 is not None), None)) for i, (k, fs) in at.items()}
    return dict(cfg=cfg, pack=pack, checked=checked, plans=plans, frames=frames, cache=cache, bases=bases,
                steps=steps, ref=ref, total=total, chunk_num=chunk_num, ctn=ctn)


@pytest.mark.parametrize("kind", KINDS)
def test_toy_24b_base_walk_matches_the_reference(walk, kind):
    i = walk["checked"][kind]
    p = walk["plans"][i]
    cw = walk["cfg"]["runtime_config"]["chunk_width"]
    before, after = walk["frames"][i]
    d_prog = after - before[:, (p.c_start - p.lo) * cw :]
    d_ref = walk["ref"][i][0]
    nums = harness.step_numbers(d_prog, d_ref, p.n_den, ())
    assert nums["chunk_gap"] <= UPDATE_GAP, (kind, i, nums)
    if kind == "mixed_scales":
        assert len(set(p.scales)) > 1
    if kind.startswith("roll"):  # the window has rolled: the write lands in a rolled slot, the read goes through it
        assert walk["bases"][i] > 0 and bool(p.cached) == (kind == "roll_read")
    else:
        assert walk["bases"][i] == 0


@pytest.mark.parametrize("kind", ["cache_write", "roll_write"])
def test_toy_24b_base_cache_write_matches_the_reference(walk, kind):
    i = walk["checked"][kind]
    prog, kv0 = walk["cache"][i], walk["ref"][i][1]
    assert prog.shape == kv0.shape == (2, 1, walk["ctn"], 32)
    assert harness._rel(prog, kv0) <= CACHE_GAP, (kind, i)


def test_toy_24b_base_step_spans_carry_the_benchmarks_counts(walk):
    """`forwards`: three a step, two with the uncond forward packed into the
    text forward; `attn_pairs`: `work.step_ops`'s self-attention operations
    over 4 hq hd L (they count every forward's pairs, packed or not), and
    the frozen schedule's segments alike."""
    cfg, ctn = walk["cfg"], walk["ctn"]
    rc, ec, mc = cfg["runtime_config"], cfg["engine_config"], cfg["model_config"]
    geo = work.Geometry.of(cfg, TOKENS)
    assert geo.ctn == ctn
    per_pair = 4.0 * mc["num_attention_heads"] * mc["kv_channels"] * mc["num_layers"]
    assert [int(s["step"]) for s in walk["steps"]] == list(range(walk["total"]))
    for s in walk["steps"]:
        p = schedule.plan(rc, ec, walk["chunk_num"], int(s["step"]))
        assert int(s["forwards"]) == len(p.forwards) - int(walk["pack"]) == (2 if walk["pack"] else 3)
        (attn,) = [op for op in work.step_ops(geo, p) if op.kind == "self_attention"]
        pairs = sum(b - a for f, _, _ in p.forwards for a, b in (g.kv for g in f)) * ctn * ctn
        assert int(s["attn_pairs"]) == pairs == attn.ops / per_pair


@pytest.mark.parametrize("section", SECTIONS)
def test_24b_base_configuration_keeps_the_released_sections(section):
    with open(CONF) as f:
        conf = json.load(f)
    with open(RELEASED) as f:
        released = json.load(f)
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        entry = {c["name"]: c for c in json.load(f)["configs"]}[conf["name"]]
    assert entry["file"] == "benchmark/configs/magi-24B-base.json" and entry["source"] == conf["source"]
    assert entry["reduced"] == conf["reduced"] == ["cp_size", "num_frames", "video_size_h", "video_size_w"]
    ours, theirs = conf[section], released[section]
    assert set(ours) == set(theirs)
    changed = {k for k in ours if ours[k] != theirs[k]}
    assert changed <= set(conf["reduced"]), changed
    if section == "engine_config":
        assert changed == {"cp_size"} and ours["cp_size"] == 1 and theirs["cp_size"] == 4

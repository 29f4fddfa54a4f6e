"""The program's spans (`core.profiler.span`) on the CPU: tiny walks with
their step callables built and replayed as the card's are (`core.graphs`'s
`StandIn`) inside a `torch.profiler` of CPU activity, read back from the
exported chrome trace.  Each step is one `magi/step` span with its `plan`,
`replay` and `sync` children, carrying the counts the benchmark's frozen
schedule (`benchmark.schedule.plan`) gives for that step; each decode one
`magi/decode` span with its three parts; the request's set-up spans are
there, tied to the steps and decodes by their `req`.  Without a profiler a
span is the one shared no-op and formats nothing.  A `MAGI_PROFILE_DIR`
trace of a pipeline request holds the same spans."""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from benchmark import schedule
from magi_tpu_torch.core import graphs as G
from magi_tpu_torch.core import profiler as P
from magi_tpu_torch.core.config import MagiConfig
from magi_tpu_torch.models.dit.model import init_dit_params
from magi_tpu_torch.models.vae.model import VaeConfig, ViTVAE, init_vae_params
from magi_tpu_torch.pipeline import video_process
from magi_tpu_torch.pipeline.prompt_process import build_inference_input
from magi_tpu_torch.sampling.transport import ArdfSampler
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = {"distill_cfg1": "4.5B_distill_config.json", "base_cfg3": "4.5B_base_config.json"}
CAPTION_TOKENS = 7


def _config_dict(name: str) -> dict:
    """A released 4.5B config at tiny width: 4 chunks of 6 latent frames at
    8x8 (96 tokens a chunk), 4 steps in windows of 2, noise2clean ranges."""
    with open(os.path.join(REPO, "example", "4.5B", name)) as f:
        d = json.load(f)
    d["model_config"].update(num_layers=2, hidden_size=64, ffn_hidden_size=128, num_attention_heads=4,
                             num_query_groups=2, kv_channels=16, params_dtype="float32", caption_channels=32,
                             caption_max_length=32, in_channels=16, out_channels=16)
    d["runtime_config"].update(num_frames=96, video_size_h=64, video_size_w=64, num_steps=4, window_size=2,
                               noise2clean_kvrange=[2, 1])
    return d


@pytest.fixture
def tiny_vae(monkeypatch):
    """A tiny ViT-VAE where `get_vae` finds the config's VAE (`z_chans`
    16), so the decodes run in milliseconds."""
    def install(cfg: MagiConfig):
        vc = VaeConfig(video_size=64, video_length=16, patch_size=8, patch_length=4, in_chans=3, z_chans=16,
                       embed_dim=32, depth=1, num_heads=2, use_final_proj=True)
        vae = ViTVAE(vc, init_vae_params(vc, seed=0, dtype=torch.bfloat16, device="cpu"))
        monkeypatch.setitem(video_process._vae_cache, (cfg.runtime_config.vae_pretrained, "cpu", 16), vae)

    return install


@pytest.fixture
def stand_in(monkeypatch):
    """Step callables built and replayed as on the card, in an empty pool."""
    monkeypatch.setattr(G, "CPU_STAND_IN", True)
    # the resident step's piece is handed the host's cache slot, which only
    # the streamed step's copies read: the loose stand-in replays it
    monkeypatch.setattr(G.StandIn, "strict", False)
    G.release_workspaces()
    yield
    G.release_workspaces()


def _magi_spans(path) -> list:
    """(path, attrs, start, end, thread) of the trace's `magi/` spans, in order."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    out = []
    for e in events:
        if e.get("ph") == "X" and e.get("cat") == "user_annotation" and e["name"].startswith("magi/"):
            head, *pairs = e["name"].split(" ")
            attrs = dict(p.split("=", 1) for p in pairs)
            out.append((head, attrs, float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["tid"]))
    return sorted(out, key=lambda s: s[2])


def _inside(child, parent) -> bool:
    return child[4] == parent[4] and parent[2] <= child[2] and child[3] <= parent[3]


def _of(spans, path) -> list:
    return [s for s in spans if s[0] == path]


def _request(cfg, params):
    rng = np.random.default_rng(5)
    mc = cfg.model_config
    embs = rng.normal(size=(1, mc.caption_max_length, mc.caption_channels)).astype(np.float32)
    mask = np.zeros((1, mc.caption_max_length), np.int32)
    mask[0, :CAPTION_TOKENS] = 1
    null = params["y_embedder"]["null_caption_embedding"].float().numpy()
    return build_inference_input(cfg, null, embs, mask, "cpu")


def _traced_walk(cfg, params, path):
    """A request from its inputs to its last decode inside a CPU profiler,
    its chrome trace exported to `path`; (sampler, decoded chunks)."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        inp = _request(cfg, params)
        sampler = ArdfSampler(cfg, params, inp, noise=torch.zeros(inp.latent_size), device="cpu")
        frames = [video_process.post_chunk_process(c, cfg, torch.device("cpu"), req=sampler.req)
                  for _, c in sampler.walk()]
    prof.export_chrome_trace(str(path))
    return sampler, frames


def _frozen_plan(cfg: MagiConfig, chunks: int, step: int) -> schedule.Step:
    """The benchmark's frozen plan of the step.  It walks single-branch CFG
    only; a 3-branch step's window forward has the same segments with no
    ride-along, so it is planned as a single-branch step whose ride-along
    threshold no timestep reaches."""
    rc, ec = dataclasses.asdict(cfg.runtime_config), dataclasses.asdict(cfg.engine_config)
    if rc["cfg_number"] == 3:
        rc["cfg_number"], ec["distill_nearly_clean_chunk_threshold"] = 1, 2.0
    return schedule.plan(rc, ec, chunks, step)


@pytest.mark.parametrize("case", sorted(CONFIGS))
def test_walk_spans_nest_and_carry_the_frozen_schedules_counts(case, stand_in, tiny_vae, tmp_path):
    cfg = MagiConfig.from_dict(_config_dict(CONFIGS[case]))
    tiny_vae(cfg)
    params = init_dit_params(cfg, torch.device("cpu"), torch.Generator().manual_seed(0))
    sampler, frames = _traced_walk(cfg, params, tmp_path / "first.json")
    spans = _magi_spans(tmp_path / "first.json")
    req = str(sampler.req)
    total, chunks, ctn = sampler.total_forward_steps(), sampler.chunk_num, sampler.ctn
    assert chunks == 4 and ctn == 96 and len(frames) == chunks

    # each step: one span, its three parts inside it, the frozen plan's counts
    steps = _of(spans, "magi/step")
    assert [int(s[1]["step"]) for s in steps] == list(range(total))
    for s in steps:
        i = int(s[1]["step"])
        for part in ("magi/step/plan", "magi/step/replay", "magi/step/sync"):
            assert len([c for c in _of(spans, part) if _inside(c, s)]) == 1, (i, part)
        q = _frozen_plan(cfg, chunks, i)
        assert s[1]["req"] == req
        assert s[1]["variant"].startswith("cfg1," if case == "distill_cfg1" else "cfg3,")
        assert (int(s[1]["n_den"]), int(s[1]["extra"])) == (q.n_den, int(q.extra))
        assert int(s[1]["q_tokens"]) == len(q.segments) * ctn
        assert int(s[1]["kv_tokens"]) == sum(b - a for a, b in (g.kv for g in q.segments)) * ctn
    assert len(_of(spans, "magi/step/replay")) == total
    if case == "distill_cfg1":  # the ride-along segment counted on some steps, not all
        nearly = [_frozen_plan(cfg, chunks, i).nearly for i in range(total)]
        assert any(nearly) and not all(nearly)

    # each decode: its frames and bytes, its three parts inside it
    decodes = _of(spans, "magi/decode")
    assert len(decodes) == chunks
    for d, out in zip(decodes, frames):
        assert (d[1]["req"], int(d[1]["frames"]), int(d[1]["bytes"])) == (req, out.shape[0], out.nbytes)
        for part in ("magi/decode/vae", "magi/decode/to_host", "magi/decode/to_uint8"):
            assert len([c for c in _of(spans, part) if _inside(c, d)]) == 1, part
        host = next(c for c in _of(spans, "magi/decode/to_host") if _inside(c, d))
        assert int(host[1]["bytes"]) == out.size * 4  # the f32 frames copied to the host

    # the request's set-up, before its first step
    first = steps[0][2]
    (inputs,) = _of(spans, "magi/request/inputs")
    assert inputs[1] == {"chunks": str(chunks), "caption_tokens": str(CAPTION_TOKENS)} and inputs[3] <= first
    (made,) = _of(spans, "magi/request/sampler")
    assert made[1] == {"req": req, "leased": "0"}
    (cap,) = _of(spans, "magi/request/capture")
    variants = sampler.step_variants()
    assert cap[1] == {"req": req, "variants": str(len(variants)), "graphs": str(len(variants))}
    for part in ("magi/request/capture/warm", "magi/request/capture/graph"):
        got = [c for c in _of(spans, part) if _inside(c, cap)]
        assert sorted(c[1]["variant"] for c in got) == sorted(P.span_name("x", {"v": v})[4:] for v in variants)
    (prep,) = _of(spans, "magi/request/prepare")
    assert prep[1] == {"req": req} and prep[3] <= first

    # a second request of the same shapes takes the idle workspace and captures nothing
    again, _ = _traced_walk(cfg, params, tmp_path / "second.json")
    spans = _magi_spans(tmp_path / "second.json")
    assert again.req != sampler.req
    assert _of(spans, "magi/request/sampler")[0][1] == {"req": str(again.req), "leased": "1"}
    assert _of(spans, "magi/request/capture")[0][1]["graphs"] == "0"
    assert not _of(spans, "magi/request/capture/graph")


def test_span_name_grammar():
    assert P.span_name("magi/step", {}) == "magi/step"
    name = P.span_name("magi/step", dict(req=3, variant=("cfg1", 4, False, True), extra=True, note="a b\tc",
                                         skipped=None))
    assert name == "magi/step req=3 variant=cfg1,4,0,1 extra=1 note=abc"
    head, *pairs = name.split(" ")
    assert head == "magi/step" and all(p.count("=") == 1 for p in pairs)


def test_span_without_a_profiler_is_the_shared_no_op():
    class Loud:
        def __str__(self):
            raise AssertionError("formatted without a profiler")

    assert not torch.autograd._profiler_enabled()
    a, b = P.span("magi/step", step=Loud()), P.span("magi/decode")
    assert a is b is P.NO_SPAN
    with a:
        pass
    with profile(activities=[ProfilerActivity.CPU]):
        on = P.span("magi/step", step=1)
        assert on is not P.NO_SPAN
        with on:
            pass


def test_profile_dir_trace_of_a_request_holds_the_spans(stand_in, tiny_vae, tmp_path, monkeypatch):
    from magi_tpu_torch.pipeline.pipeline import MagiPipeline

    monkeypatch.setenv("SKIP_LOAD_MODEL", "1")
    monkeypatch.setenv("MAGI_PROFILE_DIR", str(tmp_path / "traces"))
    path = tmp_path / "tiny.json"
    path.write_text(json.dumps(_config_dict(CONFIGS["distill_cfg1"])))
    pipe = MagiPipeline(str(path), device="cpu")
    tiny_vae(pipe.config)
    stats = pipe.run_text_to_video("a red cube", str(tmp_path / "out.mp4"))
    spans = _magi_spans(tmp_path / "traces" / "walk" / "trace.json")
    reqs = {s[1]["req"] for s in spans if "req" in s[1]}
    assert len(reqs) == 1
    for part in ("magi/request/inputs", "magi/request/sampler", "magi/request/capture", "magi/request/prepare"):
        assert len(_of(spans, part)) == 1, part
    assert len(_of(spans, "magi/step")) == len(stats["step_seconds"])
    assert len(_of(spans, "magi/decode")) == len(stats["decode_seconds"]) == 4

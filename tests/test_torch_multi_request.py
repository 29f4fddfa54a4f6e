"""Several requests in the port against magi_tpu: the lockstep
`DpBatchedSampler` (one device; the JAX package's dp mesh is not ported),
`walk_many`'s round-robin, `check_lockstep`'s messages, and the pipeline's
`run_text_to_video_batch` / `run_text_to_video_many` and `--prompts` on the
CPU.

Tolerances: each request of the port's lockstep walk against the same
request of JAX's lockstep walk and against the port's solo walk of it at
1e-4 absolute and relative (the walk tolerance of `test_torch_walk.py`;
with int8 attention JAX is held at the int8 walk limit, 1e-3 relative L2
per chunk); `walk_many` against solo walks at 1e-5."""

import dataclasses
import json
import os

import jax
import numpy as np
import pytest
import torch

from magi_tpu.models.dit.model import init_dit_params
from magi_tpu.sampling.batched import DpBatchedSampler as JaxBatched
from magi_tpu_torch.sampling.batched import DpBatchedSampler
from magi_tpu_torch.sampling.transport import ArdfSampler, walk_many
from tests.test_torch_dit import torch_config
from tests.test_torch_walk import _tiny_json, make_inputs, port_params, port_walk
from tests.tiny import tiny_config
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)

SLIDING = dict(runtime={"noise2clean_kvrange": [1, 1], "clean_chunk_kvrange": 1}, engine={"kv_offload": True})
DISTILL = dict(engine={"distill": True}, runtime={"cfg_number": 1, "num_steps": 4, "window_size": 2})

CASES = {
    # t2v, one request with text and one without
    "t2v_mixed_text_null_text": ({}, 2, 0, (True, False)),
    "prefix_video": ({}, 2, 2, (True, True)),
    "distill_cfg1": (DISTILL, 2, 0, (True, True)),
    # a cache window of 1 + 1 + 1 = 3 chunks for 4: the stacked cache rolls on axis 4
    "sliding_cache_roll": (dict(SLIDING, runtime={"noise2clean_kvrange": [1], "clean_chunk_kvrange": 1, "num_steps": 4,
                                                  "window_size": 1}), 4, 0, (True, True)),
    "int8_stored_cache": ({}, 2, 0, (True, True)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_batched_matches_jax_and_solo_walks(case, monkeypatch):
    overrides, chunk_num, t_pre, texts = CASES[case]
    int8 = case.startswith("int8")
    if int8:
        monkeypatch.setenv("MAGI_ATTN_INT8", "1")
    cfg = tiny_config(**overrides)
    params = init_dit_params(jax.random.PRNGKey(0), cfg)
    pairs = [make_inputs(cfg, chunk_num, seed=10 + r, prefix_frames=t_pre, has_text=t) for r, t in enumerate(texts)]
    js = JaxBatched(cfg, params, [j for j, _ in pairs], [jax.random.PRNGKey(20 + r) for r in range(len(pairs))])
    noises = np.array(js.xs)
    want = [np.asarray(c) for _, c in js.walk()]

    tcfg, tparams = torch_config(cfg), port_params(params)
    ts = DpBatchedSampler(tcfg, tparams, [t for _, t in pairs], noises=[torch.from_numpy(n) for n in noises],
                          device="cpu")
    if int8:
        assert isinstance(ts.cache, dict) and ts.cache["kv"].dtype == torch.int8 and ts.cache["kv"].ndim == 6
    got = [c.numpy() for _, c in ts.walk()]
    assert len(got) == len(want) == chunk_num - t_pre // cfg.runtime_config.chunk_width
    assert ts.cache_base == js.cache_base
    if case.startswith("sliding"):
        assert ts.cache_base > 0
    for a, b in zip(got, want):
        assert a.shape == b.shape and a.shape[0] == len(pairs)
        if int8:
            assert np.linalg.norm(a - b) / np.linalg.norm(b) < 1e-3
        else:
            np.testing.assert_allclose(a, b, atol=1e-4, rtol=1e-4)
    for r, (_, tinp) in enumerate(pairs):
        _, solo = port_walk(tcfg, tparams, tinp, noises[r])
        for a, b in zip(got, solo):
            np.testing.assert_allclose(a[r], b, atol=1e-4, rtol=1e-4)


def test_batched_refuses_the_host_streamed_cache():
    """`kv_offload` under the default kv ranges has no lockstep batch (JAX's
    lockstep sampler has no host mode either): the sampler refuses it and
    names the interleaved path, and under noise2clean ranges (the sliding
    device window) it is accepted."""
    cfg = tiny_config(engine={"kv_offload": True})
    tcfg, tparams = torch_config(cfg), port_params(init_dit_params(jax.random.PRNGKey(0), cfg))
    inps = [make_inputs(cfg, 2, seed=s)[1] for s in (50, 51)]
    gens = [torch.Generator().manual_seed(60 + r) for r in range(2)]
    with pytest.raises(ValueError, match="interleaved"):
        DpBatchedSampler(tcfg, tparams, inps, gens, device="cpu")
    tcfg.runtime_config.noise2clean_kvrange = [1, 1]
    ts = DpBatchedSampler(tcfg, tparams, inps, gens, device="cpu")
    assert not ts.host_mode and ts.cache.shape[0] == 2


def test_walk_many_matches_solo_walks():
    cfg = tiny_config()
    tcfg, tparams = torch_config(cfg), port_params(init_dit_params(jax.random.PRNGKey(0), cfg))
    inps = [make_inputs(cfg, 2, seed=s)[1] for s in (30, 31)]
    noises = [np.random.default_rng(40 + r).normal(size=inps[r].latent_size).astype(np.float32) for r in range(2)]
    solo = [port_walk(tcfg, tparams, inp, n)[1] for inp, n in zip(inps, noises)]
    samplers = [ArdfSampler(tcfg, tparams, inp, noise=torch.from_numpy(n), device="cpu")
                for inp, n in zip(inps, noises)]
    many = {0: [], 1: []}
    order = []
    for ridx, cidx, chunk in walk_many(samplers):
        assert cidx == len(many[ridx])
        many[ridx].append(chunk.numpy())
        order.append(ridx)
    assert order == [0, 1, 0, 1]  # round-robin: each request's chunk in turn
    for r in (0, 1):
        assert len(many[r]) == 2 and len(samplers[r].step_seconds) == samplers[r].total_forward_steps()
        for a, b in zip(many[r], solo[r]):
            np.testing.assert_allclose(a, b, atol=1e-5, rtol=1e-5)


def _mismatches(inp):
    """(field, value) pairs that break lockstep with `inp`, one at a time."""
    C, T, H, W = inp.latent_size
    return [("latent_size", (C, T, H, W + 2)), ("num_steps", inp.num_steps * 2), ("chunk_num", inp.chunk_num + 1),
            ("prev_chunks_scale", 0.5), ("prefix_video", "prefix"), ("null_len", inp.null_len + 1)]


def test_check_lockstep_gives_jax_messages():
    cfg = tiny_config()
    jbase, tbase = make_inputs(cfg, 2, seed=0)
    jpre, tpre = make_inputs(cfg, 2, seed=0, prefix_frames=2)
    assert DpBatchedSampler.check_lockstep(tbase, make_inputs(cfg, 2, seed=1)[1]) is None
    for field, value in _mismatches(tbase):
        if field == "prefix_video":
            j2, t2 = jpre, tpre
        else:
            j2, t2 = dataclasses.replace(jbase, **{field: value}), dataclasses.replace(tbase, **{field: value})
        want = JaxBatched.check_lockstep(jbase, j2)
        assert want is not None and DpBatchedSampler.check_lockstep(tbase, t2) == want
    with pytest.raises(ValueError, match="chunk_num differs"):
        DpBatchedSampler(torch_config(cfg), port_params(init_dit_params(jax.random.PRNGKey(0), cfg)),
                         [tbase, dataclasses.replace(tbase, chunk_num=3)], [torch.Generator()] * 2, device="cpu")


# ---------------------------------------------------------------------------
# the pipeline and the CLI
# ---------------------------------------------------------------------------


def _check_videos(stats, paths, mode):
    assert len(stats) == len(paths) and all(s["path"].startswith(p) for s, p in zip(stats, paths))
    for s in stats:
        # 2 chunks of 6 latent frames, 4x temporal: the JAX pipeline's count for this config
        assert s["frames"] == 48 and s["latents_finite"] and s["video_std"] > 0 and s["mode"] == mode
        assert os.path.getsize(s["path"]) > 0 and s["wall_seconds"] > 0
        assert len(s["step_seconds"]) == 2 * (2 + 2 - 1) and len(s["decode_seconds"]) == 2


def test_pipeline_runs_several_prompts_on_the_cpu(tmp_path, monkeypatch):
    """`--prompts` through the CLI entry with `--device cpu`: lockstep
    (default output paths `stem_i.ext`) and `--interleave` (explicit ones);
    the two requests differ."""
    monkeypatch.setenv("SKIP_LOAD_MODEL", "1")
    from magi_tpu_torch.pipeline import entry

    cfg = _tiny_json(tmp_path)
    base = ["--config_file", cfg, "--mode", "t2v", "--device", "cpu", "--prompts", "a red cube", "a blue ball"]
    stats = entry.main(base + ["--output_path", str(tmp_path / "out.mp4")])
    _check_videos(stats, [str(tmp_path / "out_0.mp4"), str(tmp_path / "out_1.mp4")], "lockstep")
    assert stats[0]["video_std"] != stats[1]["video_std"]
    paths = [str(tmp_path / "a.mp4"), str(tmp_path / "b.mp4")]
    many = entry.main(base + ["--interleave", "--output_paths", *paths])
    _check_videos(many, paths, "interleaved")
    # the same seeds: each request's video does not depend on the mode
    for a, b in zip(stats, many):
        assert a["video_std"] == pytest.approx(b["video_std"], rel=1e-4)
    with pytest.raises(SystemExit):  # --prompts is t2v only
        entry.main(["--config_file", cfg, "--mode", "i2v", "--image_path", "x.png", "--device", "cpu",
                    "--prompts", "a", "b"])


def test_batch_falls_back_to_interleaved_only_on_a_lockstep_mismatch(tmp_path, monkeypatch):
    monkeypatch.setenv("SKIP_LOAD_MODEL", "1")
    from magi_tpu_torch.pipeline import pipeline as P

    pipe = P.MagiPipeline(_tiny_json(tmp_path), device="cpu")
    build = P.build_inference_input
    calls = []

    def second_differs(*args, **kwargs):
        inp = build(*args, **kwargs)
        calls.append(inp)
        return dataclasses.replace(inp, prev_chunks_scale=0.5) if len(calls) == 2 else inp

    monkeypatch.setattr(P, "build_inference_input", second_differs)
    paths = [str(tmp_path / "x.mp4"), str(tmp_path / "y.mp4")]
    _check_videos(pipe.run_text_to_video_batch(["a red cube", "a blue ball"], paths), paths, "interleaved")

    # any other failure of the lockstep sampler propagates
    monkeypatch.setattr(P, "build_inference_input", build)

    def broken(*args, **kwargs):
        raise ValueError("not a lockstep mismatch")

    monkeypatch.setattr(P.DpBatchedSampler, "__init__", broken)
    with pytest.raises(ValueError, match="not a lockstep mismatch"):
        pipe.run_text_to_video_batch(["a red cube", "a blue ball"], paths)


def test_walk_trace_is_written_only_when_asked(tmp_path, monkeypatch):
    from magi_tpu_torch.core.profiler import maybe_trace

    monkeypatch.delenv("MAGI_PROFILE_DIR", raising=False)
    with maybe_trace("walk", torch.device("cpu")):
        torch.ones(4).sum()
    assert not any(tmp_path.iterdir())
    monkeypatch.setenv("MAGI_PROFILE_DIR", str(tmp_path))
    with maybe_trace("walk_many", torch.device("cpu")):
        torch.ones(4).sum()
    trace = tmp_path / "walk_many" / "trace.json"
    assert json.loads(trace.read_text())["traceEvents"]

"""The port's ARDF walk and pipeline against magi_tpu's: a tiny 3-CFG
ArdfSampler walk emits the same chunks from the same noise and weights
(default kv ranges, noise2clean ranges, and the sliding cache window of
kv_offload under noise2clean), so do walks after a prefix video (an i2v
walk of one prefix frame; a v2v walk whose prefix covers a chunk and a
half, with the warm-up forward and the sliding window), the prompt
assembly is the same with and without a prefix, and the CLI writes a
video in each mode with `--device cpu`.  The packed walk (`pack_uncond`:
the uncond segments in the text forward) follows JAX's packed walk at the
walk tolerance in three cases and the port's 3-forward walk at 1e-5.

Tolerance for the walk: 1e-4 absolute and relative (8 steps of 3 fp32
forwards each, in another summation order).

The distill walk on an int8 tree with int8 attention (single-branch CFG,
the ride-along chunk, the int8 KV cache and its sliding window) follows the JAX package's step by step, but an int8 value on a
rounding edge can take the other value when the fp32 sums come out in
another order (see `test_torch_dit.py`), and the walk carries such steps
on.  Each emitted chunk is held to a relative L2 error of 1e-3 against the
JAX package's (3.8e-5 seen at most; 1.3e-5 for the gated int4 walk without
edge layers, whose edge layers run the dequant GEMM's plain version)."""

import json
import os

import jax
import numpy as np
import pytest
import torch

from magi_tpu.models.dit.model import init_dit_params
from magi_tpu.ops.quant import quantize_params_int4, quantize_params_int8
from magi_tpu.pipeline import prompt_process as jpp
from magi_tpu.sampling.transport import ArdfSampler as JaxSampler
from magi_tpu.sampling.transport import InferenceInput as JaxInput
from magi_tpu_torch.checkpoint.from_jax import dit_params_from_jax
from magi_tpu_torch.pipeline import prompt_process as tpp
from magi_tpu_torch.sampling.transport import ArdfSampler, InferenceInput
from tests.test_torch_dit import torch_config
from tests.tiny import tiny_config
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)

H = W = 8
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

WALKS = {
    "default_ranges": ({}, 3),
    "noise2clean": ({"runtime": {"noise2clean_kvrange": [3, 3, 2, 2], "clean_chunk_kvrange": 1}}, 3),
    # window of 1 + 2 + 1 = 4 cache chunks for 5 chunks: the cache rolls
    "sliding_cache": ({"runtime": {"noise2clean_kvrange": [1, 1], "clean_chunk_kvrange": 1},
                       "engine": {"kv_offload": True}}, 5),
}


@pytest.mark.parametrize("case", sorted(WALKS))
def test_walk_emits_same_chunks(case):
    overrides, chunk_num = WALKS[case]
    cfg = tiny_config(**overrides)
    mc, rc = cfg.model_config, cfg.runtime_config
    rng = np.random.default_rng(0)
    L = mc.caption_max_length
    cap = rng.normal(size=(chunk_num, L, mc.caption_channels)).astype(np.float32)
    null = rng.normal(size=(L, mc.caption_channels)).astype(np.float32)
    lens = np.array([L // 2, 3, L][:chunk_num] + [7] * max(0, chunk_num - 3), np.int32)
    latent = (mc.in_channels, chunk_num * rc.chunk_width, H, W)
    params = init_dit_params(jax.random.PRNGKey(0), cfg)

    jinp = JaxInput(caption_embs=jax.numpy.asarray(cap), caption_lens=lens, null_emb=jax.numpy.asarray(null),
                    null_len=8, latent_size=latent, num_steps=rc.num_steps, chunk_num=chunk_num, has_text=True)
    jsampler = JaxSampler(cfg, params, jinp, jax.random.PRNGKey(7))
    noise = np.array(jsampler.xs)
    want = list(jsampler.walk())

    tinp = InferenceInput(caption_embs=torch.from_numpy(cap), caption_lens=lens, null_emb=torch.from_numpy(null),
                          null_len=8, latent_size=latent, num_steps=rc.num_steps, chunk_num=chunk_num, has_text=True)
    tsampler = ArdfSampler(torch_config(cfg), dit_params_from_jax(jax.tree.map(np.asarray, params)), tinp,
                           noise=torch.from_numpy(noise), device="cpu")
    got = list(tsampler.walk())
    assert [i for i, _ in got] == [i for i, _ in want] == list(range(chunk_num))
    for (_, a), (_, b) in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-4, rtol=1e-4)
    assert tsampler.cache_base == jsampler.cache_base
    assert len(tsampler.step_seconds) == tsampler.total_forward_steps()


DISTILL_WALKS = {
    # a cache window of 1 + 2 + 1 = 4 chunks for 5: the int8 dict rolls
    "distill_int8_sliding": ({"runtime": {"noise2clean_kvrange": [1, 1], "clean_chunk_kvrange": 1},
                              "engine": {"kv_offload": True}}, 5, quantize_params_int8),
    # the 24B's single-device tree at tiny width: gated MLP, int4 weights,
    # no bf16 edge layers (they run the dequant GEMM)
    "distill_int4_gated_noedge": ({"model": {"gated_linear_unit": True},
                                   "runtime": {"noise2clean_kvrange": [2, 1], "clean_chunk_kvrange": 1},
                                   "engine": {"kv_offload": True}}, 3,
                                  lambda p: quantize_params_int4(p, keep_edge_bf16=False)),
}


@pytest.mark.parametrize("case", sorted(DISTILL_WALKS))
def test_distill_int8_walk_emits_same_chunks(case, monkeypatch):
    """A distill walk of a quantized tree with int8 attention (the walk of
    the 4.5B distill + int8 path, and of the 24B w4a8 path)."""
    monkeypatch.setenv("MAGI_ATTN_INT8", "1")
    overrides, chunk_num, quantize = DISTILL_WALKS[case]
    engine = dict(distill=True, fp8_quant=True, **overrides.get("engine", {}))
    cfg = tiny_config(model={"num_layers": 3, **overrides.get("model", {})},
                      runtime={"cfg_number": 1, **overrides.get("runtime", {})}, engine=engine)
    mc, rc = cfg.model_config, cfg.runtime_config
    rng = np.random.default_rng(1)
    L = mc.caption_max_length
    cap = rng.normal(size=(chunk_num, L, mc.caption_channels)).astype(np.float32)
    null = rng.normal(size=(L, mc.caption_channels)).astype(np.float32)
    lens = np.array([L // 2, 3, L, 7, 9][:chunk_num], np.int32)
    latent = (mc.in_channels, chunk_num * rc.chunk_width, H, W)
    params = quantize(init_dit_params(jax.random.PRNGKey(0), cfg))

    jinp = JaxInput(caption_embs=jax.numpy.asarray(cap), caption_lens=lens, null_emb=jax.numpy.asarray(null),
                    null_len=8, latent_size=latent, num_steps=rc.num_steps, chunk_num=chunk_num, has_text=True)
    jsampler = JaxSampler(cfg, params, jinp, jax.random.PRNGKey(7))
    noise = np.array(jsampler.xs)
    want = list(jsampler.walk())

    tinp = InferenceInput(caption_embs=torch.from_numpy(cap), caption_lens=lens, null_emb=torch.from_numpy(null),
                          null_len=8, latent_size=latent, num_steps=rc.num_steps, chunk_num=chunk_num, has_text=True)
    tsampler = ArdfSampler(torch_config(cfg), dit_params_from_jax(jax.tree.map(np.asarray, params)), tinp,
                           noise=torch.from_numpy(noise), device="cpu")
    assert ("blocks_edge" in tsampler.params) == ("noedge" not in case)
    plans = [tsampler._plan(s) for s in range(tsampler.total_forward_steps())]
    assert any(p["distill_nearly"] for p in plans) and not all(p["distill_nearly"] for p in plans)
    assert isinstance(tsampler.cache, dict) and tsampler.cache["kv"].dtype == torch.int8
    got = list(tsampler.walk())
    assert [i for i, _ in got] == [i for i, _ in want] == list(range(chunk_num))
    for (_, a), (_, b) in zip(got, want):
        b = np.asarray(b)
        assert np.linalg.norm(a.numpy() - b) / np.linalg.norm(b) < 1e-3
    assert tsampler.cache_base == jsampler.cache_base
    if case.endswith("sliding"):
        assert tsampler.cache_base > 0


PREFIX_WALKS = {
    # i2v on the 3-CFG config: a one-frame prefix, chunk 0 emitted whole
    "i2v_3cfg": (dict(runtime={"noise2clean_kvrange": [3, 2], "clean_chunk_kvrange": 1}), 1, 3, None),
    # v2v on the distill int8 config with int8 attention: a prefix of 3
    # latent frames (chunk_offset 1, half of chunk 1 pasted), the warm-up
    # forward, and a cache window of 1 + 2 + 1 = 4 chunks for 5 that rolls
    "v2v_distill_int8_sliding": (dict(model={"num_layers": 3},
                                      runtime={"cfg_number": 1, "noise2clean_kvrange": [1, 1],
                                               "clean_chunk_kvrange": 1},
                                      engine={"distill": True, "fp8_quant": True, "kv_offload": True}),
                                 3, 5, quantize_params_int8),
}


@pytest.mark.parametrize("case", sorted(PREFIX_WALKS))
def test_prefix_walk_emits_same_chunks(case, monkeypatch):
    overrides, t_pre, chunk_num, quantize = PREFIX_WALKS[case]
    if quantize is not None:
        monkeypatch.setenv("MAGI_ATTN_INT8", "1")
    cfg = tiny_config(**overrides)
    mc, rc = cfg.model_config, cfg.runtime_config
    rng = np.random.default_rng(2)
    L = mc.caption_max_length
    cap = rng.normal(size=(chunk_num, L, mc.caption_channels)).astype(np.float32)
    null = rng.normal(size=(L, mc.caption_channels)).astype(np.float32)
    prefix = rng.normal(size=(mc.in_channels, t_pre, H, W)).astype(np.float32)
    offset = t_pre // rc.chunk_width
    lens = np.array([0] * offset + [L // 2, 3, L, 7, 9][: chunk_num - offset], np.int32)
    latent = (mc.in_channels, chunk_num * rc.chunk_width, H, W)
    params = init_dit_params(jax.random.PRNGKey(0), cfg)
    if quantize is not None:
        params = quantize(params)

    jinp = JaxInput(caption_embs=jax.numpy.asarray(cap), caption_lens=lens, null_emb=jax.numpy.asarray(null),
                    null_len=8, latent_size=latent, num_steps=rc.num_steps, chunk_num=chunk_num, has_text=True,
                    prefix_video=jax.numpy.asarray(prefix))
    jsampler = JaxSampler(cfg, params, jinp, jax.random.PRNGKey(7))
    noise = np.array(jsampler.xs)
    want = list(jsampler.walk())

    tinp = InferenceInput(caption_embs=torch.from_numpy(cap), caption_lens=lens, null_emb=torch.from_numpy(null),
                          null_len=8, latent_size=latent, num_steps=rc.num_steps, chunk_num=chunk_num, has_text=True,
                          prefix_video=torch.from_numpy(prefix))
    tsampler = ArdfSampler(torch_config(cfg), dit_params_from_jax(jax.tree.map(np.asarray, params)), tinp,
                           noise=torch.from_numpy(noise), device="cpu")
    assert tsampler.chunk_offset == jsampler.chunk_offset == offset
    assert tsampler.cache_chunks == jsampler.cache_chunks
    got = list(tsampler.walk())
    assert [i for i, _ in got] == [i for i, _ in want] == list(range(chunk_num - offset))
    for (_, a), (_, b) in zip(got, want):
        b = np.asarray(b)
        assert a.shape == b.shape
        if quantize is None:
            np.testing.assert_allclose(a.numpy(), b, atol=1e-4, rtol=1e-4)
        else:
            assert np.linalg.norm(a.numpy() - b) / np.linalg.norm(b) < 1e-3
    # i2v keeps chunk 0 whole; v2v drops the prefix frames of chunk 1
    frames = [a.shape[1] for _, a in got]
    assert sum(frames) == chunk_num * rc.chunk_width - (0 if t_pre == 1 else t_pre)
    assert tsampler.cache_base == jsampler.cache_base
    if quantize is not None:
        assert tsampler.cache_base > 0 and any(tsampler._plan(s)["distill_nearly"]
                                               for s in range(tsampler.total_forward_steps()))


def _tiny_json(tmp_path, name="4.5B/4.5B_base_config.json", model=None, **engine):
    with open(os.path.join(REPO, "example", name)) as f:
        d = json.load(f)
    d["model_config"].update(num_layers=2, hidden_size=64, ffn_hidden_size=128, num_attention_heads=4,
                             num_query_groups=2, kv_channels=16, params_dtype="float32", caption_channels=32,
                             caption_max_length=32, in_channels=16, out_channels=16)
    d["model_config"].update(model or {})
    d["runtime_config"].update(num_frames=48, video_size_h=64, video_size_w=64, num_steps=4, window_size=2,
                               noise2clean_kvrange=[2, 1])
    d["engine_config"].update(engine)
    path = tmp_path / "tiny.json"
    path.write_text(json.dumps(d))
    return str(path)


def test_prompt_assembly_matches(tmp_path, monkeypatch):
    monkeypatch.setenv("SKIP_LOAD_MODEL", "1")
    from magi_tpu.core.config import MagiConfig as JaxConfig
    from magi_tpu_torch.core.config import MagiConfig

    path = _tiny_json(tmp_path)
    jcfg, tcfg = JaxConfig.from_json(path), MagiConfig.from_json(path)
    jemb, jmask = jpp.get_txt_embeddings("a red cube on a table", jcfg)
    temb, tmask = tpp.get_txt_embeddings("a red cube on a table", tcfg)
    np.testing.assert_array_equal(temb, jemb)
    np.testing.assert_array_equal(tmask, jmask)
    null = np.random.default_rng(0).normal(size=(32, 32)).astype(np.float32)
    j = jpp.build_inference_input(jcfg, null, jemb, jmask, None)
    t = tpp.build_inference_input(tcfg, null, temb, tmask, "cpu")
    np.testing.assert_array_equal(t.caption_embs.numpy(), np.asarray(j.caption_embs))
    np.testing.assert_array_equal(t.null_emb.numpy(), np.asarray(j.null_emb))
    for f in ("caption_lens", "null_len", "latent_size", "num_steps", "chunk_num", "has_text", "prev_chunks_scale"):
        np.testing.assert_array_equal(getattr(t, f), getattr(j, f))
    assert t.prefix_video is None


@pytest.mark.parametrize("t_pre", [1, 8])
def test_prompt_assembly_with_prefix_matches(tmp_path, monkeypatch, t_pre):
    """With a prefix latent of 1 (i2v) or 8 (v2v) frames: the chunks it
    covers whole take the null caption with 0 valid tokens, the rest the
    text, and the chunk count covers the prefix and the new frames."""
    monkeypatch.setenv("SKIP_LOAD_MODEL", "1")
    monkeypatch.setenv("PAD_DURATION", "1")  # a special token that depends on the chunk count
    from magi_tpu.core.config import MagiConfig as JaxConfig
    from magi_tpu_torch.core.config import MagiConfig

    path = _tiny_json(tmp_path)
    jcfg, tcfg = JaxConfig.from_json(path), MagiConfig.from_json(path)
    emb, mask = tpp.get_txt_embeddings("a red cube on a table", tcfg)
    rng = np.random.default_rng(t_pre)
    null = rng.normal(size=(32, 32)).astype(np.float32)
    prefix = rng.normal(size=(16, t_pre, 8, 8)).astype(np.float32)
    j = jpp.build_inference_input(jcfg, null, emb, mask, jax.numpy.asarray(prefix))
    t = tpp.build_inference_input(tcfg, null, emb, mask, "cpu", torch.from_numpy(prefix))
    np.testing.assert_array_equal(t.caption_embs.numpy(), np.asarray(j.caption_embs))
    np.testing.assert_array_equal(t.prefix_video.numpy(), np.asarray(j.prefix_video))
    for f in ("caption_lens", "null_len", "latent_size", "num_steps", "chunk_num", "has_text"):
        np.testing.assert_array_equal(getattr(t, f), getattr(j, f))
    cw = tcfg.runtime_config.chunk_width
    assert t.chunk_num == -(-(12 + t_pre) // cw) and (t.caption_lens == 0).sum() == t_pre // cw


def test_pipeline_writes_a_video_on_the_cpu(tmp_path, monkeypatch):
    monkeypatch.setenv("SKIP_LOAD_MODEL", "1")
    from magi_tpu_torch.pipeline import entry

    out = str(tmp_path / "out.mp4")
    stats = entry.main(["--config_file", _tiny_json(tmp_path), "--mode", "t2v", "--prompt", "a red cube",
                        "--output_path", out, "--device", "cpu"])
    assert stats["frames"] == 48  # 2 chunks of 6 latent frames, 4x temporal
    assert os.path.getsize(stats["path"]) > 0
    assert len(stats["step_seconds"]) == 2 * (2 + 2 - 1)  # dpss * (chunks + window - 1)
    with pytest.raises(SystemExit):  # i2v needs --image_path
        entry.main(["--config_file", _tiny_json(tmp_path), "--mode", "i2v", "--prompt", "x", "--device", "cpu"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            entry.main(["--config_file", _tiny_json(tmp_path), "--mode", "t2v", "--prompt", "x"])


def test_quant_pipeline_writes_a_video_on_the_cpu(tmp_path, monkeypatch):
    """The distill + int8 config with int8 attention through the CLI entry
    on the CPU (plain versions): int8 tree, int8 KV cache, single-branch
    CFG; then the same with int4 weights (`MAGI_INT4=1`)."""
    monkeypatch.setenv("SKIP_LOAD_MODEL", "1")
    from magi_tpu_torch.pipeline import entry

    path = _tiny_json(tmp_path, "4.5B/4.5B_distill_quant_config.json", attn_int8=True)
    for int4 in ("0", "1"):
        monkeypatch.setenv("MAGI_INT4", int4)
        stats = entry.main(["--config_file", path, "--mode", "t2v", "--prompt", "a red cube",
                            "--output_path", str(tmp_path / f"q{int4}.mp4"), "--device", "cpu"])
        assert stats["frames"] == 48 and stats["latents_finite"] and stats["video_std"] > 0
        assert len(stats["step_seconds"]) == 2 * (2 + 2 - 1)


def test_24b_w4a8_pipeline_writes_a_video_on_the_cpu(tmp_path, monkeypatch):
    """The 24B distill config at tiny width through the CLI entry on the
    CPU: `quant_bits: 4` (int4 weights, bf16 edge layers), gated MLP, int8
    attention, the half-channel VAE, one device (`cp_size` 1)."""
    monkeypatch.setenv("SKIP_LOAD_MODEL", "1")
    from magi_tpu_torch.pipeline import entry

    # 32 DiT channels: the 16-channel latent, doubled for the half-channel VAE
    path = _tiny_json(tmp_path, "24B/24B_distill_quant_config.json", model=dict(in_channels=32, out_channels=32),
                      attn_int8=True, quant_bits=4, cp_size=1)
    stats = entry.main(["--config_file", path, "--mode", "t2v", "--prompt", "a red cube",
                        "--output_path", str(tmp_path / "q.mp4"), "--device", "cpu"])
    assert stats["frames"] == 48 and stats["latents_finite"] and stats["video_std"] > 0
    assert len(stats["step_seconds"]) == 2 * (2 + 2 - 1)


def test_prefix_pipelines_write_videos_on_the_cpu(tmp_path, monkeypatch):
    """`--mode i2v` on the base config and `--mode v2v` on the distill int8
    config (int8 attention, scheme sage) through the CLI entry on the CPU,
    from a PNG and an mp4 written here.  The tiny config asks for 12 latent
    frames in chunks of 6: i2v adds the image's one latent frame (3 chunks,
    chunk 0 emitted whole: 18 latent frames, 72 frames); v2v the 8 latent
    frames of the video's first 32 frames (4 chunks, chunk 0 clean, chunk
    1 without its 2 prefix frames: 16 latent frames, 64 frames)."""
    import cv2
    from PIL import Image

    monkeypatch.setenv("SKIP_LOAD_MODEL", "1")
    from magi_tpu_torch.pipeline import entry

    rng = np.random.default_rng(0)
    img = str(tmp_path / "first.png")
    Image.fromarray(rng.integers(0, 256, size=(48, 80, 3), dtype=np.uint8)).save(img)
    vid = str(tmp_path / "prefix.mp4")
    vw = cv2.VideoWriter(vid, cv2.VideoWriter_fourcc(*"mp4v"), 24, (64, 64))
    for _ in range(40):
        vw.write(rng.integers(0, 256, size=(64, 64, 3), dtype=np.uint8))
    vw.release()
    stats = entry.main(["--config_file", _tiny_json(tmp_path), "--mode", "i2v", "--prompt", "a red cube",
                        "--image_path", img, "--output_path", str(tmp_path / "i2v.mp4"), "--device", "cpu"])
    assert stats["frames"] == 72 and stats["latents_finite"] and os.path.getsize(stats["path"]) > 0
    assert len(stats["step_seconds"]) == 2 * (3 + 2 - 1)
    monkeypatch.setenv("MAGI_ATTN_Q8_SCHEME", "sage")
    path = _tiny_json(tmp_path, "4.5B/4.5B_distill_quant_config.json", attn_int8=True)
    stats = entry.main(["--config_file", path, "--mode", "v2v", "--prompt", "a red cube", "--prefix_video_path", vid,
                        "--output_path", str(tmp_path / "v2v.mp4"), "--device", "cpu"])
    assert stats["frames"] == 64 and stats["latents_finite"] and stats["video_std"] > 0
    assert len(stats["step_seconds"]) == 2 * (4 + 2 - 1 - 1)


# ---------------------------------------------------------------------------
# helpers shared with test_torch_offload.py and test_torch_multi_request.py
# ---------------------------------------------------------------------------

NULL_SEED = 99  # every request's null caption slab (a model's, shared by a batch)


def make_inputs(cfg, chunk_num, seed=0, prefix_frames=0, has_text=True):
    """One request's numpy-seeded inputs for both packages: (JAX input, port input)."""
    mc, rc = cfg.model_config, cfg.runtime_config
    rng = np.random.default_rng(seed)
    L = mc.caption_max_length
    cap = rng.normal(size=(chunk_num, L, mc.caption_channels)).astype(np.float32)
    null = np.random.default_rng(NULL_SEED).normal(size=(L, mc.caption_channels)).astype(np.float32)
    prefix = None
    if prefix_frames:
        prefix = rng.normal(size=(mc.in_channels, prefix_frames, H, W)).astype(np.float32)
    offset = prefix_frames // rc.chunk_width
    lens = np.array([0] * offset + [L // 2, 3, L, 7, 9, 5, 11, 13][: chunk_num - offset], np.int32)
    common = dict(caption_lens=lens, null_len=8, latent_size=(mc.in_channels, chunk_num * rc.chunk_width, H, W),
                  num_steps=rc.num_steps, chunk_num=chunk_num, has_text=has_text)
    jinp = JaxInput(caption_embs=jax.numpy.asarray(cap), null_emb=jax.numpy.asarray(null),
                    prefix_video=None if prefix is None else jax.numpy.asarray(prefix), **common)
    tinp = InferenceInput(caption_embs=torch.from_numpy(cap), null_emb=torch.from_numpy(null),
                          prefix_video=None if prefix is None else torch.from_numpy(prefix), **common)
    return jinp, tinp


def port_params(params):
    return dit_params_from_jax(jax.tree.map(np.asarray, params))


def jax_walk(cfg, params, jinp, key=7):
    """(sampler, its initial noise, emitted chunks as numpy) of JAX's walk."""
    s = JaxSampler(cfg, params, jinp, jax.random.PRNGKey(key))
    noise = np.array(s.xs)
    return s, noise, [np.asarray(c) for _, c in s.walk()]


def port_walk(tcfg, tparams, tinp, noise):
    """(sampler, emitted chunks as numpy) of the port's walk on the CPU."""
    s = ArdfSampler(tcfg, tparams, tinp, noise=torch.from_numpy(noise), device="cpu")
    return s, [c.numpy() for _, c in s.walk()]


PACKED_WALKS = {
    "default_ranges": (dict(engine={"pack_uncond": True}), 2, 0),
    # a cache window of 1 + 2 + 1 = 4 chunks for 5: cache_sp trails sp
    "sliding_cache": (dict(runtime={"noise2clean_kvrange": [1, 1], "clean_chunk_kvrange": 1},
                           engine={"kv_offload": True, "pack_uncond": True}), 5, 0),
    # a prefix of 3 latent frames: chunk 0 written by the warm-up, chunk 1 half pasted
    "v2v_prefix": (dict(runtime={"noise2clean_kvrange": [3, 2], "clean_chunk_kvrange": 1},
                        engine={"pack_uncond": True}), 3, 3),
}


@pytest.mark.parametrize("case", sorted(PACKED_WALKS))
def test_packed_walk_emits_same_chunks(case):
    """`pack_uncond`: the uncond segments ride in the text forward (two
    forwards a step).  The port's packed walk against JAX's at the walk
    tolerance (1e-4), and against the port's own 3-forward walk at 1e-5
    (JAX's `test_packed_uncond_matches_unpacked`)."""
    overrides, chunk_num, t_pre = PACKED_WALKS[case]
    cfg = tiny_config(**overrides)
    params = init_dit_params(jax.random.PRNGKey(0), cfg)
    jinp, tinp = make_inputs(cfg, chunk_num, seed=3, prefix_frames=t_pre)
    js, noise, want = jax_walk(cfg, params, jinp)
    tcfg = torch_config(cfg)
    assert tcfg.engine_config.pack_uncond
    ts, got = port_walk(tcfg, port_params(params), tinp, noise)
    assert len(got) == len(want) == chunk_num - t_pre // cfg.runtime_config.chunk_width
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, atol=1e-4, rtol=1e-4)
    assert ts.cache_base == js.cache_base
    if case == "sliding_cache":
        assert ts.cache_base > 0
    tcfg.engine_config.pack_uncond = False
    _, unpacked = port_walk(tcfg, port_params(params), tinp, noise)
    for a, b in zip(got, unpacked):
        np.testing.assert_allclose(a, b, atol=1e-5, rtol=1e-5)


def test_packed_forward_splits_uncond_ranges_into_the_current_source(monkeypatch):
    """In the packed forward the uncond segments' ranges lie past the
    window's segments: their cache range (source 1) is empty and their
    current range (source 2) is their own tokens, also when the sliding
    cache puts cache_sp below sp."""
    from magi_tpu_torch.models.dit import model as M

    cfg = tiny_config(runtime={"noise2clean_kvrange": [1, 1], "clean_chunk_kvrange": 1},
                      engine={"kv_offload": True, "pack_uncond": True})
    _, tinp = make_inputs(cfg, 5, seed=3)
    ts = ArdfSampler(torch_config(cfg), port_params(init_dit_params(jax.random.PRNGKey(0), cfg)), tinp,
                     device="cpu")
    seen = []
    plain = M.segmented_attention_two_source

    def spy(q, kv1, kv2, r1s, r1e, r2s, r2e, *, seg_len, q_prologue):
        seen.append((q.shape[0] // seg_len, r1s.clone(), r1e.clone(), r2s.clone(), r2e.clone(), seg_len))
        return plain(q, kv1, kv2, r1s, r1e, r2s, r2e, seg_len=seg_len, q_prologue=q_prologue)

    monkeypatch.setattr(M, "segmented_attention_two_source", spy)
    checked = 0
    for step in range(ts.total_forward_steps()):
        p = ts._plan(step)
        seen.clear()
        ts.do_step(step)
        n_seg, n_den = p["n_seg"], p["n_den"]
        packed = [s for s in seen if s[0] == n_seg + n_den]
        assert len(packed) == cfg.model_config.num_layers  # forward A, once a layer
        for n, r1s, r1e, r2s, r2e, ctn in packed:
            u = slice(n_seg, n_seg + n_den)
            assert (r1s[u] == r1e[u]).all()
            np.testing.assert_array_equal(r2s[u].numpy(), (n_seg + np.arange(n_den)) * ctn)
            np.testing.assert_array_equal(r2e[u].numpy(), (n_seg + np.arange(n_den) + 1) * ctn)
        checked += ts.cache_base > 0
    assert checked > 0  # steps under a rolled window (cache_sp < sp) were checked


def test_successive_requests_on_one_pipeline_give_equal_videos(tmp_path, monkeypatch):
    """Two `run_text_to_video` calls on one pipeline (random weights) give
    equal videos, as two calls of the JAX pipeline do: each request draws
    its weights and noise from the seed again.  The first call's video is
    the one a generator seeded once gives when it draws the weights and
    then the noise, as the first request drew them before."""
    monkeypatch.setenv("SKIP_LOAD_MODEL", "1")
    import magi_tpu.pipeline.pipeline as JP
    from magi_tpu_torch.core.config import MagiConfig
    from magi_tpu_torch.core.utils import set_random_seed
    from magi_tpu_torch.pipeline import pipeline as P
    from magi_tpu_torch.pipeline.video_process import post_chunk_process

    path = _tiny_json(tmp_path)
    saved = {"jax": [], "torch": []}
    for name, mod in (("jax", JP), ("torch", P)):
        monkeypatch.setattr(mod, "save_video_to_disk", lambda video, p, fps, name=name: saved[name].append(
            np.array(video)) or p)
    jpipe = JP.MagiPipeline(path)
    pipe = P.MagiPipeline(path, device="cpu")
    for i in range(2):
        jpipe.run_text_to_video("a red cube", str(tmp_path / f"j{i}.mp4"))
        pipe.run_text_to_video("a red cube", str(tmp_path / f"t{i}.mp4"))
    for name in ("jax", "torch"):
        a, b = saved[name]
        assert a.shape[0] == 48 and a.std() > 0 and np.array_equal(a, b), name

    cfg = MagiConfig.from_json(path)
    gen = set_random_seed(cfg.runtime_config.seed, "cpu")
    dev = torch.device("cpu")
    params = P.get_dit(cfg, dev, gen)
    inp = tpp.build_inference_input(cfg, params["y_embedder"]["null_caption_embedding"].float().numpy(),
                                    *tpp.get_txt_embeddings("a red cube", cfg, dev), dev)
    s = ArdfSampler(cfg, params, inp, gen, device=dev)
    first = np.concatenate([post_chunk_process(c, cfg, dev) for _, c in s.walk()], axis=0)
    np.testing.assert_array_equal(saved["torch"][0], first)

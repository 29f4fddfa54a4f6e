"""The port's ARDF walk and pipeline against magi_tpu's: a tiny 3-CFG
ArdfSampler walk emits the same chunks from the same noise and weights
(default kv ranges, noise2clean ranges, and the sliding cache window of
kv_offload under noise2clean), the prompt assembly is the same, and
MagiPipeline.run_text_to_video(device="cpu") writes a video.

Tolerance for the walk: 1e-4 absolute and relative (8 steps of 3 fp32
forwards each, in another summation order)."""

import json
import os

import jax
import numpy as np
import pytest
import torch

from magi_tpu.models.dit.model import init_dit_params
from magi_tpu.pipeline import prompt_process as jpp
from magi_tpu.sampling.transport import ArdfSampler as JaxSampler
from magi_tpu.sampling.transport import InferenceInput as JaxInput
from magi_tpu_torch.checkpoint.from_jax import dit_params_from_jax
from magi_tpu_torch.pipeline import prompt_process as tpp
from magi_tpu_torch.sampling.transport import ArdfSampler, InferenceInput
from tests.test_torch_dit import torch_config
from tests.tiny import tiny_config

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


def _tiny_json(tmp_path):
    with open(os.path.join(REPO, "example", "4.5B", "4.5B_base_config.json")) as f:
        d = json.load(f)
    d["model_config"].update(num_layers=2, hidden_size=64, ffn_hidden_size=128, num_attention_heads=4,
                             num_query_groups=2, kv_channels=16, params_dtype="float32", caption_channels=32,
                             caption_max_length=32, in_channels=16, out_channels=16)
    d["runtime_config"].update(num_frames=48, video_size_h=64, video_size_w=64, num_steps=4, window_size=2,
                               noise2clean_kvrange=[2, 1])
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


def test_pipeline_writes_a_video_on_the_cpu(tmp_path, monkeypatch):
    monkeypatch.setenv("SKIP_LOAD_MODEL", "1")
    from magi_tpu_torch.pipeline import entry

    out = str(tmp_path / "out.mp4")
    stats = entry.main(["--config_file", _tiny_json(tmp_path), "--mode", "t2v", "--prompt", "a red cube",
                        "--output_path", out, "--device", "cpu"])
    assert stats["frames"] == 48  # 2 chunks of 6 latent frames, 4x temporal
    assert os.path.getsize(stats["path"]) > 0
    assert len(stats["step_seconds"]) == 2 * (2 + 2 - 1)  # dpss * (chunks + window - 1)
    with pytest.raises(NotImplementedError, match="item 10"):
        entry.main(["--config_file", _tiny_json(tmp_path), "--mode", "i2v", "--prompt", "x", "--device", "cpu"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            entry.main(["--config_file", _tiny_json(tmp_path), "--mode", "t2v", "--prompt", "x"])

"""The port's load path as a whole against magi_tpu's, on the CPU: a tiny
distill fp8 DiT checkpoint (the released `inference_weight.fp8.distill`
layout: bf16 edge layers, F8_E4M3 middle layer with per-tensor and
smooth-quant scales), a diffusers-format VAE and an HF-layout T5 encoder on
disk, run through `entry.main` with SKIP_LOAD_MODEL unset: T5 encode,
fp8 dequant with the smooth-quant factors, the smooth-folded int8 tree,
int8 attention, VAE decode.  The JAX package runs the same request from
the same files (its DiT copy holds the fp8 values as f32: its numpy reader
holds no fp8) through its own loaders and walk; the port's walk takes the
JAX walk's noise.

Tolerance: each emitted chunk within 1e-3 relative L2 of the JAX
package's, the int8 walks' limit (`tests/test_torch_walk.py`; seen
2.7e-4); the frame count equal."""

import json
import os

import jax
import numpy as np
import torch

from magi_tpu.core.config import MagiConfig as JaxConfig
from magi_tpu.models.t5.model import T5Config as JaxT5Config
from magi_tpu.models.vae import model as JV
from magi_tpu.pipeline import pipeline as jpipe
from magi_tpu.pipeline import prompt_process as jpp
from magi_tpu.pipeline import video_process as jvp
from magi_tpu.sampling.transport import ArdfSampler as JaxSampler
from magi_tpu_torch.pipeline import entry
from magi_tpu_torch.pipeline import pipeline as tpipe
from magi_tpu_torch.pipeline import prompt_process as tpp
from tests.test_t5 import _fake_hf_checkpoint
from tests.test_torch_checkpoint import write_fp8_pair
from tests.test_torch_t5 import StubTokenizer
from tests.test_torch_vae import vae_state_dict
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PROMPT = "A red cube on a wooden table"


def _write_configs(tmp_path):
    with open(os.path.join(REPO, "example", "4.5B", "4.5B_distill_quant_config.json")) as f:
        d = json.load(f)
    d["model_config"].update(num_layers=3, hidden_size=64, ffn_hidden_size=128, num_attention_heads=4,
                             num_query_groups=2, kv_channels=16, params_dtype="float32", caption_channels=32,
                             caption_max_length=32, in_channels=16, out_channels=16)
    d["runtime_config"].update(num_frames=48, video_size_h=64, video_size_w=64, num_steps=4, window_size=2,
                               noise2clean_kvrange=[2, 1], t5_device="auto", vae_pretrained=str(tmp_path / "vae"),
                               t5_pretrained=str(tmp_path / "t5"))
    d["engine_config"]["attn_int8"] = True
    paths = {}
    for sub in ("jax", "torch"):
        d["runtime_config"]["load"] = str(tmp_path / sub)
        paths[sub] = str(tmp_path / f"{sub}.json")
        with open(paths[sub], "w") as f:
            json.dump(d, f)
    return paths


def _write_vae(path):
    from safetensors.numpy import save_file

    dd = dict(video_size=64, video_length=16, patch_size=8, patch_length=4, in_chans=3, z_chans=16, embed_dim=64,
              depth=2, num_heads=4, use_final_proj=True)
    os.makedirs(path)
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump({"_class_name": "ViTVAE", "ddconfig": dd}, f)
    cfg = JV.VaeConfig.from_ddconfig(dd)
    save_file(vae_state_dict(jax.tree.map(np.asarray, JV.init_vae_params(cfg, seed=2)), cfg),
              os.path.join(path, "diffusion_pytorch_model.safetensors"))


def test_loaded_distill_fp8_pipeline_matches_jax(tmp_path, monkeypatch):
    import transformers

    monkeypatch.delenv("SKIP_LOAD_MODEL", raising=False)
    monkeypatch.setenv("MAGI_ATTN_INT8", "1")
    monkeypatch.setattr(transformers.AutoTokenizer, "from_pretrained", lambda *a, **k: StubTokenizer(64))
    monkeypatch.setattr(jpp, "_t5_cache", None)
    monkeypatch.setattr(tpp, "_t5_cache", None)
    paths = _write_configs(tmp_path)
    jcfg = JaxConfig.from_json(paths["jax"])
    write_fp8_pair(tmp_path, jcfg, seed=4, subdir="inference_weight.fp8.distill")
    os.makedirs(tmp_path / "t5")
    _fake_hf_checkpoint(tmp_path / "t5", JaxT5Config(vocab_size=64, d_model=32, d_kv=8, num_heads=4, d_ff=64,
                                                     num_layers=2, rel_buckets=8, rel_max_distance=16),
                        np.random.default_rng(5))
    _write_vae(str(tmp_path / "vae"))

    # the JAX package: its loaders (T5, fp8 DiT + smooth fold, VAE) and walk
    emb, mask = jpp.get_txt_embeddings(PROMPT, jcfg)
    params = jpipe.get_dit(jcfg)
    assert "act_smooth" in params["blocks"]["mlp"]["linear_fc2"] and "weight_q" in params["blocks"]["mlp"]["linear_fc2"]
    null = np.asarray(params["y_embedder"]["null_caption_embedding"], np.float32)
    jsampler = JaxSampler(jcfg, params, jpp.build_inference_input(jcfg, null, emb, mask, None), jax.random.PRNGKey(3))
    noise = torch.from_numpy(np.array(jsampler.xs))
    want = list(jsampler.walk())
    want_frames = sum(jvp.post_chunk_process(c, jcfg).shape[0] for _, c in want)

    # the port through its CLI, its walk on the JAX walk's noise
    got = []

    class Sampler(tpipe.ArdfSampler):
        def __init__(self, config, params, inp, generator=None, *, device=None):
            assert "act_smooth" in params["blocks"]["mlp"]["linear_fc2"]
            assert params["blocks"]["mlp"]["linear_fc2"]["weight_q"].stride()[1] == 1  # folded, k-major
            super().__init__(config, params, inp, noise=noise, device=device)

        def walk(self):
            for i, chunk in super().walk():
                got.append((i, chunk.clone()))
                yield i, chunk

    monkeypatch.setattr(tpipe, "ArdfSampler", Sampler)
    stats = entry.main(["--config_file", paths["torch"], "--mode", "t2v", "--prompt", PROMPT,
                        "--output_path", str(tmp_path / "out.mp4"), "--device", "cpu"])
    assert tpp._t5_cache is not None and tpp._t5_cache.device == torch.device("cpu")
    assert [i for i, _ in got] == [i for i, _ in want] == [0, 1]
    for (_, a), (_, b) in zip(got, want):
        b = np.asarray(b)
        assert np.linalg.norm(a.numpy() - b) / np.linalg.norm(b) < 1e-3
    assert stats["frames"] == want_frames == 48 and stats["latents_finite"] and stats["video_std"] > 0

"""Every released config under `example/` (the 4.5B base, distill and
distill_quant files, the 24B base, distill and distill_quant files), read
from its file and shrunk, walked by the port and by the JAX package on the
same seeded numpy inputs, then run through the port's CLI entry on the CPU.

The shrink cuts width and depth and keeps what picks a code path: the q to
kv head ratio (6 for the 24B, 3 for the 4.5B), `gated_linear_unit`, the
half-channel VAE's 32 DiT channels, `x_rescale_factor`, `cfg_number`,
`distill`, `shortcut_mode`, `fp8_quant` (a w8a8 tree with full-precision
edge layers and full-precision attention: no `attn_int8` in any file),
`kv_offload`, the noise2clean kv ranges, the window, the chunk width and the
config's steps.  Widths: head_dim 16, two kv heads, hidden = heads x 16,
FFN 128, captions of 32 x 32; three layers (a middle layer between the two
edge layers); fp32.  `cp_size` is 1 (the 24B files ask for 4 or 8 ranks).

Tolerances: the fp32 walks 1e-4 absolute and relative, as
`test_torch_walk.py`'s; the int8 walks (the distill_quant files) 1e-3
relative L2 a chunk, as the whole int8 forwards of `ROADMAP.md` §3, but
5e-3 for the 24B's: its output is divided by its `x_rescale_factor` of
0.1, and an int8 value on a rounding edge that flips moves it ten times as
far (the JAX walk itself moves by 1.7e-3 relative L2 when its noise moves
by 1e-7 relative; the port's walk is 1.8e-3 from it, the 4.5B's 1.6e-5
and 8e-5 at a factor of 1).  The
walks take the timestep embedding's frequency table from the JAX package
(XLA's `exp`): PyTorch's `exp` differs from XLA's by an ulp on some of the
128 frequencies, and a distilled model embeds its step factor 8 (arguments
up to 8000 radians), where an ulp of a frequency moves an argument by up
to 5e-4.  The 24B's `x_rescale_factor` of 0.1 multiplies the output by 10,
and its fp32 distill walk then misses 1e-4 on the port's own table (2e-4
absolute);
`test_distill_step_embedding_differs_by_exp_ulps` holds that difference."""

import dataclasses
import json
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from magi_tpu.core.config import MagiConfig as JaxConfig
from magi_tpu.models.dit import embedders as JE
from magi_tpu.models.dit.model import init_dit_params
from magi_tpu.ops.quant import quantize_params_int8
from magi_tpu_torch.models.dit import embedders as TE
from tests.test_torch_dit import torch_config
from tests.test_torch_walk import jax_walk, make_inputs, port_params, port_walk
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RELEASED = ["4.5B/4.5B_base_config.json", "4.5B/4.5B_distill_config.json", "4.5B/4.5B_distill_quant_config.json",
            "24B/24B_base_config.json", "24B/24B_distill_config.json", "24B/24B_distill_quant_config.json"]
HD, HK = 16, 2


def released(name: str) -> dict:
    with open(os.path.join(REPO, "example", name)) as f:
        return json.load(f)


def shrunk(name: str) -> dict:
    """The released file at a tiny width and depth (module docstring), one
    device, the video left as written."""
    d = released(name)
    mc = d["model_config"]
    hq = HK * mc["num_attention_heads"] // mc["num_query_groups"]
    mc.update(num_layers=3, hidden_size=hq * HD, ffn_hidden_size=128, num_attention_heads=hq, num_query_groups=HK,
              kv_channels=HD, caption_channels=32, caption_max_length=32, params_dtype="float32")
    d["engine_config"]["cp_size"] = 1
    return d


def jax_freqs(half: int, max_period: float = 10000.0) -> torch.Tensor:
    """The timestep embedding's frequency table as the JAX package computes it."""
    return torch.from_numpy(np.array(jnp.exp(-math.log(max_period) * jnp.arange(half, dtype=jnp.float32) / half)))


def embedding_on_jax_freqs(t: torch.Tensor, dim: int, max_period: float = 10000.0, rescale: float = 1000.0):
    """`TE.timestep_embedding` with the JAX package's frequency table."""
    args = t.float()[:, None] * jax_freqs(dim // 2, max_period)[None] * rescale
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


def test_distill_step_embedding_differs_by_exp_ulps():
    """The port's frequency table is within an ulp of JAX's; on the step
    factor 8 of a distilled model the embeddings then differ by about 2e-5
    relative, and on JAX's table they agree to cos and sin's rounding."""
    half = 128
    ours = -math.log(10000.0) * torch.arange(half, dtype=torch.float32) / half
    ours = torch.exp(ours)
    theirs = jax_freqs(half)
    ulps = (ours.view(torch.int32) - theirs.view(torch.int32)).abs()
    assert int(ulps.max()) <= 1
    dt = np.full(3, 8.0, np.float32)
    want = np.asarray(JE.timestep_embedding(jnp.asarray(dt), 2 * half))

    def rel(got):
        return float(np.linalg.norm(got.numpy() - want) / np.linalg.norm(want))

    assert rel(TE.timestep_embedding(torch.from_numpy(dt), 2 * half)) < 5e-5
    assert rel(embedding_on_jax_freqs(torch.from_numpy(dt), 2 * half)) < 1e-6


def test_the_shrink_keeps_what_picks_the_path():
    """Each shrunk file differs from its release only in widths, depth,
    dtype and `cp_size`."""
    kept = ("gated_linear_unit", "half_channel_vae", "in_channels", "out_channels", "x_rescale_factor")
    for name in RELEASED:
        rel, tiny = released(name), shrunk(name)
        rm, tm = rel["model_config"], tiny["model_config"]
        assert rm["num_attention_heads"] * tm["num_query_groups"] == tm["num_attention_heads"] * rm["num_query_groups"]
        assert all(rm[k] == tm[k] for k in kept)
        assert tiny["runtime_config"] == rel["runtime_config"]
        assert {k: v for k, v in tiny["engine_config"].items() if k != "cp_size"} == \
            {k: v for k, v in rel["engine_config"].items() if k != "cp_size"}


@pytest.mark.parametrize("name", RELEASED)
def test_released_config_walk_matches_jax(name, monkeypatch):
    """Three chunks of 8x8 latents walked by both packages from the same
    noise, weights and captions; the int8 tree of an `fp8_quant` file is
    JAX's `quantize_params_int8` of the fp32 draw (bf16 attention)."""
    for var in ("MAGI_ATTN_INT8", "MAGI_INT8", "MAGI_INT4", "MAGI_ATTN_Q8_SCHEME"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setattr(TE, "timestep_embedding", embedding_on_jax_freqs)
    cfg = JaxConfig.from_dict(shrunk(name))
    ec = cfg.engine_config
    params = init_dit_params(jax.random.PRNGKey(0), cfg)
    if ec.fp8_quant:
        params = quantize_params_int8(params)
    # the half-channel VAE's latent has half the DiT's channels (the
    # prologue doubles it), as `build_inference_input` gives it
    mc = cfg.model_config
    latent = mc.in_channels // 2 if mc.half_channel_vae else mc.in_channels
    jinp, tinp = make_inputs(dataclasses.replace(cfg, model_config=dataclasses.replace(mc, in_channels=latent)), 3,
                             seed=4)
    js, noise, want = jax_walk(cfg, params, jinp)
    tcfg = torch_config(cfg)
    ts, got = port_walk(tcfg, port_params(params), tinp, noise)
    assert not ts.host_mode and ts.cache_chunks == js.cache_chunks == 3
    assert ("blocks_edge" in ts.params) == ec.fp8_quant
    assert len(got) == len(want) == 3
    for a, b in zip(got, want):
        assert a.shape == b.shape
        if ec.fp8_quant:
            assert np.linalg.norm(a - b) / np.linalg.norm(b) < (1e-3 if mc.x_rescale_factor == 1 else 5e-3)
        else:
            np.testing.assert_allclose(a, b, atol=1e-4, rtol=1e-4)
    rc = cfg.runtime_config
    assert len(ts.step_seconds) == rc.num_steps // rc.window_size * (3 + rc.window_size - 1)


@pytest.mark.parametrize("name", RELEASED)
def test_released_config_writes_a_video_on_the_cpu(name, tmp_path, monkeypatch):
    """The shrunk file through the CLI entry with `--device cpu` (random
    weights, the plain versions of every kernel): 48 frames of 64x64, two
    chunks, the config's steps."""
    for var in ("MAGI_ATTN_INT8", "MAGI_INT8", "MAGI_INT4", "MAGI_ATTN_Q8_SCHEME"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setenv("SKIP_LOAD_MODEL", "1")
    from magi_tpu_torch.pipeline import entry

    d = shrunk(name)
    d["runtime_config"].update(num_frames=48, video_size_h=64, video_size_w=64)
    path = tmp_path / "config.json"
    path.write_text(json.dumps(d))
    stats = entry.main(["--config_file", str(path), "--mode", "t2v", "--prompt", "a red cube",
                        "--output_path", str(tmp_path / "out.mp4"), "--device", "cpu"])
    rc = d["runtime_config"]
    assert stats["frames"] == 48 and stats["latents_finite"] and stats["video_std"] > 0
    assert len(stats["step_seconds"]) == rc["num_steps"] // rc["window_size"] * (2 + rc["window_size"] - 1)

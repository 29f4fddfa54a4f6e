"""The port's host-streamed KV cache (`kv_offload` under the default kv
ranges) against magi_tpu's: the cache lives in host memory, `cache` is
None, and every forward that touches it streams one layer slab at a time
(`HostKVCache`, `_streamed_forward`, `dit_layer_step`).

Tolerances: the streamed walk against JAX's streamed walk at the walk
tolerance of `test_torch_walk.py` (1e-4 absolute and relative), against
the port's resident walk at 1e-5 (the same operations on the same values),
and the host buffer against JAX's `HostKVCache.buf` at 1e-4.  With the
int8-stored cache the streamed walk is bit-equal to the resident one and
held to JAX's int8 streamed walk at the int8 walk limit, 1e-3 relative L2
per chunk (and its host buffer, dequantized, likewise)."""

import jax
import numpy as np
import pytest
import torch

from magi_tpu.models.dit.model import init_dit_params
from tests.test_torch_dit import torch_config
from tests.test_torch_walk import jax_walk, make_inputs, port_params, port_walk
from tests.tiny import tiny_config
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)

DISTILL = {"engine": {"distill": True}, "runtime": {"cfg_number": 1, "num_steps": 4, "window_size": 2}}

CASES = {
    "cfg3_t2v": ({}, 2, 0),
    "cfg3_v2v_prefix": ({}, 2, 2),
    "cfg1_distill": (DISTILL, 2, 0),
    # the attended span and the host cache grow chunk by chunk
    "cfg1_long_horizon": (DISTILL, 8, 0),
}


def _offload_config(overrides):
    cfg = tiny_config(**overrides)
    cfg.engine_config.kv_offload = True
    assert not cfg.runtime_config.noise2clean_kvrange  # the default ranges
    return cfg


@pytest.mark.parametrize("case", sorted(CASES))
def test_streamed_walk_matches_jax_and_the_resident_walk(case):
    overrides, chunk_num, t_pre = CASES[case]
    cfg = _offload_config(overrides)
    params = init_dit_params(jax.random.PRNGKey(0), cfg)
    jinp, tinp = make_inputs(cfg, chunk_num, seed=5, prefix_frames=t_pre)
    js, noise, want = jax_walk(cfg, params, jinp)
    assert js.host_mode
    tcfg, tparams = torch_config(cfg), port_params(params)
    ts, got = port_walk(tcfg, tparams, tinp, noise)
    assert ts.host_mode and ts.cache is None
    assert len(got) == len(want) == chunk_num - t_pre // cfg.runtime_config.chunk_width
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, atol=1e-4, rtol=1e-4)
    buf = ts.host_cache.buf
    assert tuple(buf.shape) == js.host_cache.buf.shape and np.abs(buf.numpy()).max() > 0
    np.testing.assert_allclose(buf.numpy(), js.host_cache.buf, atol=1e-4, rtol=1e-4)
    # the same walk with the cache resident on the device
    tcfg.engine_config.kv_offload = False
    rs, resident = port_walk(tcfg, tparams, tinp, noise)
    assert not rs.host_mode
    for a, b in zip(got, resident):
        np.testing.assert_allclose(a, b, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(buf.numpy(), rs.cache.numpy(), atol=1e-5, rtol=1e-5)


def _dequant(buf):
    return np.asarray(buf["kv"], np.float32) * np.asarray(buf["scale"])[..., None]


def test_streamed_int8_walk_matches(monkeypatch):
    """The int8-stored cache in host memory ({kv int8, scale f32}): the
    streamed walk equals the resident one bit for bit, and follows JAX's
    int8 streamed walk to 1e-3 relative L2."""
    monkeypatch.setenv("MAGI_ATTN_INT8", "1")
    cfg = _offload_config({})
    params = init_dit_params(jax.random.PRNGKey(0), cfg)
    jinp, tinp = make_inputs(cfg, 2, seed=6)
    js, noise, want = jax_walk(cfg, params, jinp)
    assert isinstance(js.host_cache.buf, dict)
    tcfg, tparams = torch_config(cfg), port_params(params)
    ts, got = port_walk(tcfg, tparams, tinp, noise)
    buf = ts.host_cache.buf
    assert isinstance(buf, dict) and buf["kv"].dtype == torch.int8 and ts.cache is None
    for a, b in zip(got, want):
        assert np.linalg.norm(a - b) / np.linalg.norm(b) < 1e-3
    jd, td = _dequant(js.host_cache.buf), _dequant({k: v.numpy() for k, v in buf.items()})
    assert np.abs(td).max() > 0 and np.linalg.norm(td - jd) / np.linalg.norm(jd) < 1e-3
    tcfg.engine_config.kv_offload = False
    rs, resident = port_walk(tcfg, tparams, tinp, noise)
    for a, b in zip(got, resident):
        np.testing.assert_array_equal(a, b)
    for k in ("kv", "scale"):
        np.testing.assert_array_equal(buf[k].numpy(), rs.cache[k].numpy())


def test_host_cache_streams_only_the_tokens_read_and_written():
    """A forward uploads cache tokens [0, slice_point * ctn) of each layer
    and writes back only the tokens it wrote; the rest of the host buffer
    is untouched."""
    from magi_tpu_torch.sampling.transport import HostKVCache

    cfg = torch_config(tiny_config())
    hc = HostKVCache(cfg, 64, torch.device("cpu"))
    L = hc.num_layers
    hc.buf.copy_(torch.arange(hc.buf.numel(), dtype=torch.float32).reshape(hc.buf.shape))
    before = hc.buf.clone()
    hc.begin(16)
    for l in range(L):
        slab = hc.fetch(l)
        np.testing.assert_array_equal(slab[:, :, :16].numpy(), before[l, :, :, :16].numpy())
        slab[:, :, 16:40] = -1.0
        hc.release(l, 16, 40)
    after = hc.buf
    assert (after[:, :, :, 16:40] == -1).all()
    np.testing.assert_array_equal(after[:, :, :, :16].numpy(), before[:, :, :, :16].numpy())
    np.testing.assert_array_equal(after[:, :, :, 40:].numpy(), before[:, :, :, 40:].numpy())
    per_token = hc.buf[0, :, :, 0].numel() * 4
    assert hc.h2d_bytes == L * 16 * per_token and hc.d2h_bytes == L * 24 * per_token

"""The port's native IO runtime (`magi_tpu_torch.runtime_native`, the same
`runtime/magi_io.cpp` built into the port's own directory) against the
JAX package's bindings on the same bytes and arrays: the zstd round trip,
a mixed plain / `.zst` read, bf16 both ways bit for bit, frame packing
native against the fallback; and the port's loader through the native
route against its Python route on a seeded two-shard checkpoint (a plain
shard and a `.zst` one), bit for bit; the build's directory keyed by
host."""

import os

import numpy as np
import pytest
import torch

from magi_tpu import runtime_native as jrn
from magi_tpu_torch import runtime_native as trn
from magi_tpu_torch.checkpoint import loader as TL
from tests.test_checkpoint import make_reference_state, write_checkpoint
from tests.test_torch_dit import torch_config
from tests.tiny import tiny_config
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)


@pytest.fixture(scope="module")
def native_libs():
    """Both libraries; a missing toolchain is a failure here, where g++
    and libzstd are installed."""
    assert trn.get_lib() is not None and jrn.get_lib() is not None
    assert os.path.dirname(trn.lib_path()) != jrn._runtime_dir()
    assert os.path.dirname(os.path.dirname(trn.lib_path())) == trn.BUILD_DIR
    assert trn.BUILD_DIR.endswith(os.path.join("build", "magi_tpu_torch", "runtime"))


def _fallback(monkeypatch):
    monkeypatch.setenv("MAGI_DISABLE_NATIVE", "1")


def test_build_is_keyed_by_host(native_libs, monkeypatch):
    """A library built on one host is never loaded on another: its
    directory changes with the host name and with what `-march=native`
    expands to there."""
    real_run = trn.subprocess.run
    here = trn.lib_path()

    def keyed(node=None, march=None):
        def run(cmd, **kw):
            out = real_run(cmd, **kw)
            out.stderr = out.stderr.replace(b" -march=", f" {march} -march=".encode())
            return out

        trn.lib_path.cache_clear()
        try:
            with monkeypatch.context() as m:
                if node is not None:
                    m.setattr(trn.platform, "node", lambda: node)
                if march is not None:
                    m.setattr(trn.subprocess, "run", run)
                return trn.lib_path()
        finally:
            trn.lib_path.cache_clear()

    assert keyed() == here
    assert keyed(node="another-host") != here
    assert keyed(march="-mno-avx512f") != here
    assert trn.lib_path() == here


def test_zstd_roundtrip(native_libs, monkeypatch):
    import zstandard

    data = np.random.default_rng(0).integers(0, 255, 200_000, np.uint8).tobytes()
    comp = zstandard.ZstdCompressor().compress(data)
    assert trn.zstd_decompress(comp) == jrn.zstd_decompress(comp) == data
    _fallback(monkeypatch)
    assert trn.zstd_decompress(comp) == data


def test_read_files_mixed(native_libs, tmp_path, monkeypatch):
    import zstandard

    raw = np.random.default_rng(1).integers(0, 255, 50_000, np.uint8).tobytes()
    p1 = tmp_path / "a.bin"
    p1.write_bytes(raw)
    p2 = tmp_path / "b.bin.zst"
    p2.write_bytes(zstandard.ZstdCompressor().compress(raw))
    paths = [str(p1), str(p2)]
    got = trn.read_files(paths)
    assert got == jrn.read_files(paths) == [raw, raw]
    assert [a.tobytes() for a in trn.read_arrays(paths)] == got
    _fallback(monkeypatch)
    assert trn.read_files(paths) == got


def test_bf16_conversion_both_ways_bit_for_bit(native_libs, monkeypatch):
    x = np.random.default_rng(2).normal(size=4096).astype(np.float32)
    x[:4] = [0.0, -0.0, 1e-40, 3.0e38]  # zero signs, a subnormal, rounding toward the top
    got = trn.f32_to_bf16(x)
    assert got.dtype == torch.bfloat16
    want = jrn.f32_to_bf16(x)
    np.testing.assert_array_equal(got.view(torch.int16).numpy().view(np.uint16), want.view(np.uint16))
    back = trn.bf16_to_f32(got)
    np.testing.assert_array_equal(back, jrn.bf16_to_f32(want.view(np.uint16)))
    np.testing.assert_array_equal(trn.bf16_to_f32(got.view(torch.int16).numpy().view(np.uint16)), back)
    _fallback(monkeypatch)  # torch's bf16 rounding and the shift, the same bits
    np.testing.assert_array_equal(trn.f32_to_bf16(x).view(torch.int16).numpy(), got.view(torch.int16).numpy())
    np.testing.assert_array_equal(trn.bf16_to_f32(got), back)


def test_frame_pack_native_against_fallback(native_libs, monkeypatch):
    frames = np.random.default_rng(3).integers(0, 255, (3, 6, 8, 3), np.uint8)
    f_native = trn.u8_thwc_to_f32_cthw(frames)
    np.testing.assert_array_equal(f_native, jrn.u8_thwc_to_f32_cthw(frames))
    back = trn.f32_cthw_to_u8_thwc(f_native)
    np.testing.assert_array_equal(back, frames)
    np.testing.assert_array_equal(back, jrn.f32_cthw_to_u8_thwc(f_native))
    _fallback(monkeypatch)
    f_py = trn.u8_thwc_to_f32_cthw(frames)
    np.testing.assert_allclose(f_native, f_py, atol=1e-6)
    np.testing.assert_array_equal(trn.f32_cthw_to_u8_thwc(f_py), frames)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        out.update(_flat(v, f"{prefix}{k}/") if isinstance(v, dict) else {prefix + k: v})
    return out


def test_loader_native_route_equals_python_route(native_libs, tmp_path, monkeypatch):
    """A seeded checkpoint of two shards, the second zstd-compressed: the
    state and the converted tree read by the native runtime equal those
    the Python reader maps, bit for bit."""
    cfg = tiny_config()
    write_checkpoint(tmp_path, make_reference_state(cfg, np.random.default_rng(7)))
    native = TL.load_state_dict(str(tmp_path))
    assert TL.last_read["route"] == "native" and TL.last_read["bytes"] > 0
    with monkeypatch.context() as m:
        _fallback(m)
        python = TL.load_state_dict(str(tmp_path))
    assert TL.last_read["route"] == "python"
    assert sorted(native) == sorted(python) and len(native) > 10
    for k in python:
        assert native[k].dtype == python[k].dtype and torch.equal(native[k], python[k]), k
    tcfg = torch_config(cfg)
    tcfg.runtime_config.load = str(tmp_path)
    trees = [_flat(TL.load_dit_params(tcfg, "cpu"))]
    assert TL.last_read["route"] == "native"
    with monkeypatch.context() as m:
        _fallback(m)
        trees.append(_flat(TL.load_dit_params(tcfg, "cpu")))
    assert TL.last_read["route"] == "python"
    assert sorted(trees[0]) == sorted(trees[1])
    for k, v in trees[1].items():
        assert torch.equal(trees[0][k], v), k

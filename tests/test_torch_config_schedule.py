"""magi_tpu_torch core/config and sampling/{schedule,kv_ranges} against
magi_tpu: every example config loads to the same field values, and the
numpy schedules and kv ranges are equal (exact)."""

import dataclasses
import glob
import os

import numpy as np
import pytest
import torch

from magi_tpu.core.config import MagiConfig as JaxConfig
from magi_tpu.sampling import kv_ranges as jkvr
from magi_tpu.sampling import schedule as jsched
from magi_tpu_torch.core.config import MagiConfig
from magi_tpu_torch.core.utils import resolve_device
from magi_tpu_torch.sampling import kv_ranges as tkvr
from magi_tpu_torch.sampling import schedule as tsched

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = sorted(glob.glob(os.path.join(REPO, "example", "*", "*.json")))


def _fields(cfg):
    out = {}
    for part in ("model_config", "runtime_config", "engine_config"):
        d = dataclasses.asdict(getattr(cfg, part))
        if "params_dtype" in d:  # jnp dtype or torch dtype -> "bfloat16" etc.
            dt = d["params_dtype"]
            d["params_dtype"] = str(dt).replace("torch.", "") if isinstance(dt, torch.dtype) else np.dtype(dt).name
        out[part] = d
    return out


@pytest.mark.parametrize("path", CONFIGS, ids=[os.path.relpath(p, REPO) for p in CONFIGS])
def test_example_config_loads_to_same_fields(path):
    assert _fields(MagiConfig.from_json(path)) == _fields(JaxConfig.from_json(path))


def test_dtype_and_json_round_trip(tmp_path):
    cfg = MagiConfig.from_json(os.path.join(REPO, "example", "4.5B", "4.5B_base_config.json"))
    assert cfg.model_config.params_dtype is torch.bfloat16
    out = tmp_path / "c.json"
    cfg.to_json(str(out))
    assert _fields(MagiConfig.from_json(str(out))) == _fields(cfg)


def test_entry_points_need_cuda_unless_cpu_is_asked():
    assert resolve_device("cpu") == torch.device("cpu")
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default resolves to it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device()


@pytest.mark.parametrize("num_steps", [4, 8, 12, 16, 24, 64])
@pytest.mark.parametrize("mode", ["8,16,16", "16,16,8", ""])
def test_schedules_equal(num_steps, mode):
    np.testing.assert_array_equal(tsched.init_t(num_steps, mode), jsched.init_t(num_steps, mode))
    np.testing.assert_array_equal(tsched.init_interval(num_steps, mode), jsched.init_interval(num_steps, mode))
    for chunk_num, window, offset in [(4, 4, 0), (8, 4, 2), (3, 2, 0)]:
        assert tsched.generate_sequences(chunk_num, window, offset) == jsched.generate_sequences(
            chunk_num, window, offset)
    t = jsched.init_t(num_steps, mode)
    dpss = max(num_steps // 4, 1)
    for args in [(0, 4, 0), (1, 3, dpss - 1)]:
        np.testing.assert_array_equal(
            tsched.get_timestep(t, dpss, *args, clean_t=0.9999), jsched.get_timestep(t, dpss, *args, clean_t=0.9999))
        assert tsched.denoise_step_of_each_chunk(dpss, *args, num_steps=num_steps) == \
            jsched.denoise_step_of_each_chunk(dpss, *args, num_steps=num_steps)
    assert tsched.distill_dt_factor(num_steps, 2.0) == jsched.distill_dt_factor(num_steps, 2.0)


@pytest.mark.parametrize("n2c,clean", [([], -1), ([5, 4, 3, 2], 1), ([3, 3, 2, 2], -1)])
def test_kv_ranges_equal(n2c, clean):
    rc = MagiConfig.from_json(os.path.join(REPO, "example", "4.5B", "4.5B_base_config.json")).runtime_config
    rc = dataclasses.replace(rc, noise2clean_kvrange=n2c, clean_chunk_kvrange=clean)
    ctn = 1536
    for sp, steps in [(0, [0, 16, 32, 48]), (2, [64, 5, 21]), (1, [63])]:
        got = tkvr.denoising_kvrange(rc, sp, len(steps), steps, 64, ctn)
        want = jkvr.denoising_kvrange(rc, sp, len(steps), steps, 64, ctn)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
    for n in (1, 3, 9):
        for a, b in zip(tkvr.prefix_kvrange(rc, n, ctn), jkvr.prefix_kvrange(rc, n, ctn)):
            np.testing.assert_array_equal(a, b)
        for a, b in zip(tkvr.self_only_kvrange(n, ctn), jkvr.self_only_kvrange(n, ctn)):
            np.testing.assert_array_equal(a, b)

"""magi_tpu_torch.checkpoint (the safetensors reader, the DiT loader with
the fp8 dequant) against the `safetensors` package and magi_tpu's loader
on the same files, on the CPU.

The reader returns what the `safetensors` package reads, bit for bit, for
every dtype it takes, from plain and zstd-compressed shards.  The loader
runs on an fp8 checkpoint in the released layout (`tests/test_checkpoint.py`'s
`make_reference_state` / `make_fp8_state`): the port's copy is written with
real F8_E4M3 weights, the JAX package's as their f32 values (its numpy
reader holds no fp8), and the two give the same dequantized state and the
same converted tree, bit for bit: the port takes the same f32 operations in
the same order and casts once."""

import json
import os

import jax
import ml_dtypes
import numpy as np
import pytest
import torch

from magi_tpu.checkpoint import loader as JL
from magi_tpu_torch.checkpoint import loader as TL
from magi_tpu_torch.checkpoint import safetensors_io as SIO
from tests.test_checkpoint import make_fp8_state, make_reference_state, write_checkpoint
from tests.test_torch_dit import torch_config
from tests.tiny import tiny_config
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)

DTYPES = {
    "F32": torch.float32, "F16": torch.float16, "BF16": torch.bfloat16, "F8_E4M3": torch.float8_e4m3fn,
    "I8": torch.int8, "U8": torch.uint8, "I32": torch.int32,
}


def _random(dtype, shape, gen):
    if dtype.is_floating_point:
        return (torch.randn(shape, generator=gen) * 3).to(dtype)
    info = torch.iinfo(dtype)
    return torch.randint(max(info.min, -1000), min(info.max, 1000) + 1, shape, generator=gen).to(dtype)


def _bits(t: torch.Tensor) -> np.ndarray:
    return t.contiguous().view(torch.uint8).numpy() if t.element_size() == 1 else t.contiguous().view(
        {2: torch.int16, 4: torch.int32}[t.element_size()]).numpy()


@pytest.mark.parametrize("name", sorted(DTYPES))
def test_reader_and_writer_match_safetensors(tmp_path, name):
    """Each dtype beside tensors of other widths and odd sizes (so offsets
    are not all aligned), read against the package's reader, and the
    port's writer read back by the package."""
    import safetensors.torch as st

    gen = torch.Generator().manual_seed(len(name))
    tensors = {"x": _random(DTYPES[name], (3, 5, 7), gen), "odd": torch.arange(3, dtype=torch.uint8),
               "empty": torch.zeros((0, 4), dtype=DTYPES[name]), "wide": _random(torch.float32, (9,), gen),
               "scalar": _random(DTYPES[name], (), gen)}
    st.save_file(tensors, str(tmp_path / "pkg.safetensors"))
    want = st.load_file(str(tmp_path / "pkg.safetensors"))
    got = SIO.load_file(str(tmp_path / "pkg.safetensors"))
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
        np.testing.assert_array_equal(_bits(got[k]), _bits(want[k]), err_msg=k)
    SIO.save_file(tensors, str(tmp_path / "port.safetensors"), metadata={"format": "pt"})
    back = st.load_file(str(tmp_path / "port.safetensors"))
    for k in tensors:
        np.testing.assert_array_equal(_bits(back[k]), _bits(tensors[k]), err_msg=k)


def test_reader_zst_and_refusals(tmp_path, monkeypatch):
    """A `.zst` shard decompresses through zstandard; without zstandard it
    raises naming the module; a dtype outside the list is refused."""
    import safetensors.torch as st
    import zstandard

    tensors = {"a": torch.randn(4, 6).bfloat16(), "b": torch.arange(10, dtype=torch.int32)}
    path = tmp_path / "m.safetensors.zst"
    path.write_bytes(zstandard.ZstdCompressor().compress(st.save(tensors)))
    got = SIO.load_file(str(path))
    for k in tensors:
        assert torch.equal(got[k], tensors[k])
    monkeypatch.setitem(__import__("sys").modules, "zstandard", None)
    with pytest.raises(ImportError, match="zstandard"):
        SIO.load_file(str(path))
    st.save_file({"d": torch.zeros(3, dtype=torch.float64)}, str(tmp_path / "f64.safetensors"))
    with pytest.raises(ValueError, match="F64"):
        SIO.load_file(str(tmp_path / "f64.safetensors"))
    with pytest.raises(ValueError, match="dtype"):
        SIO.save_file({"d": torch.zeros(3, dtype=torch.float64)}, str(tmp_path / "x.safetensors"))


@pytest.mark.parametrize("listing", ["index", "directory"])
def test_load_state_dict_matches(tmp_path, listing):
    """Two shards (the second zstd-compressed), found through the index or
    by listing the directory: the same tensors as the JAX package reads."""
    cfg = tiny_config()
    state = make_reference_state(cfg, np.random.default_rng(0))
    write_checkpoint(tmp_path, state)
    if listing == "directory":
        (tmp_path / "inference_weight" / "model.safetensors.index.json").unlink()
    want = JL.load_state_dict(str(tmp_path))
    got = TL.load_state_dict(str(tmp_path))
    assert sorted(got) == sorted(want) == sorted(state)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)


def test_missing_and_variant_dirs_raise(tmp_path):
    with pytest.raises(FileNotFoundError, match="weight dir not found"):
        TL.load_state_dict(str(tmp_path))
    (tmp_path / "inference_weight.fp8.distill").mkdir(parents=True)
    with pytest.raises(FileNotFoundError, match="no safetensors shards"):
        TL.load_state_dict(str(tmp_path), fp8_quant=True, distill=True)
    with pytest.raises(FileNotFoundError, match="weight dir not found"):
        TL.load_state_dict(str(tmp_path), fp8_quant=True)


def test_resident_dit_rebuilt_when_its_checkpoint_changes(tmp_path, monkeypatch):
    """`pipeline.get_dit` keeps the tree resident on the card for later
    requests of an equal key.  It reads the checkpoint again once a shard is
    rewritten at the same path, builds again under SKIP_LOAD_MODEL when the
    draw's generator state differs, and after `release_workspaces()`.
    Checked without a card: the builds are counted, not run."""
    from safetensors.numpy import save_file

    from magi_tpu_torch.core.graphs import release_workspaces
    from magi_tpu_torch.pipeline import pipeline as P

    cfg = tiny_config()
    write_checkpoint(tmp_path, make_reference_state(cfg, np.random.default_rng(0)))
    tcfg = torch_config(cfg)
    tcfg.runtime_config.load = str(tmp_path)
    built = []
    monkeypatch.setattr(P, "_build_dit", lambda *args: built.append({"tree": len(built)}) or built[-1])
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *args: None)
    monkeypatch.delenv("SKIP_LOAD_MODEL", raising=False)
    card, gen = torch.device("cuda", 0), torch.Generator()
    release_workspaces()
    try:
        first = P.get_dit(tcfg, card, gen)
        assert P.get_dit(tcfg, card, gen) is first and len(built) == 1
        shard = tmp_path / "inference_weight" / "model-00001.safetensors"
        mtime = shard.stat().st_mtime_ns
        index = json.loads((shard.parent / "model.safetensors.index.json").read_text())["weight_map"]
        other = make_reference_state(cfg, np.random.default_rng(1))
        save_file({k: v for k, v in other.items() if index[k] == shard.name}, str(shard))
        os.utime(shard, ns=(mtime + 10**9, mtime + 10**9))  # written a second later
        second = P.get_dit(tcfg, card, gen)
        assert second is not first and len(built) == 2
        assert P.get_dit(tcfg, card, gen) is second and len(built) == 2
        release_workspaces()
        assert P.get_dit(tcfg, card, gen) is not second and len(built) == 3

        monkeypatch.setenv("SKIP_LOAD_MODEL", "1")
        drawn = P.get_dit(tcfg, card, gen.manual_seed(0))
        assert P.get_dit(tcfg, card, gen.manual_seed(0)) is drawn and len(built) == 4
        assert P.get_dit(tcfg, card, gen.manual_seed(1)) is not drawn and len(built) == 5
    finally:
        release_workspaces()


def write_fp8_pair(tmp_path, cfg, seed=3, subdir="inference_weight.fp8"):
    """The fp8 checkpoint of `cfg` in the variant subdir `subdir` twice: the
    JAX package's copy under `jax/` as f32 values, the port's under
    `torch/` with F8_E4M3 weights (the released dtype), two shards and an
    index each.  Returns (jax dir, torch dir, fp8 state)."""
    rng = np.random.default_rng(seed)
    fp8 = make_fp8_state(cfg, rng, make_reference_state(cfg, rng))
    keys = sorted(fp8)
    half = len(keys) // 2
    for sub, to_file in (("jax", lambda v: torch.from_numpy(np.asarray(v, np.float32))),
                         ("torch", lambda v: (torch.from_numpy(v.view(np.uint8)).view(torch.float8_e4m3fn)
                                              if v.dtype == ml_dtypes.float8_e4m3fn else torch.from_numpy(v)))):
        wdir = tmp_path / sub / subdir
        wdir.mkdir(parents=True)
        weight_map = {}
        for j, part in enumerate((keys[:half], keys[half:])):
            fn = f"model-0000{j + 1}-of-00002.safetensors"
            SIO.save_file({k: to_file(fp8[k]) for k in part}, str(wdir / fn))
            weight_map.update({k: fn for k in part})
        (wdir / "model.safetensors.index.json").write_text(json.dumps({"weight_map": weight_map}))
    return tmp_path / "jax", tmp_path / "torch", fp8


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        out.update(_flat(v, f"{prefix}{k}/") if isinstance(v, dict) else {prefix + k: v})
    return out


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fp8_dequant_and_convert_match_jax(tmp_path, dtype):
    """load_state_dict -> _dequant_fp8 -> convert_dit_state (and
    load_dit_params) against the JAX package's on the same checkpoint:
    every dequantized tensor, `act_smooth` and converted leaf bit-equal,
    the stacked weights [L, in, out] contiguous in the parameter dtype."""
    cfg = tiny_config(model={"num_layers": 4, "params_dtype": jax.numpy.dtype(dtype)}, runtime={"cfg_number": 1},
                      engine={"fp8_quant": True})
    jdir, tdir, fp8 = write_fp8_pair(tmp_path, cfg)
    tstate = TL.load_state_dict(str(tdir), fp8_quant=True)
    assert tstate["videodit_blocks.layers.1.mlp.linear_fc2.weight"].dtype == torch.float8_e4m3fn
    jdeq = JL._dequant_fp8(JL.load_state_dict(str(jdir), fp8_quant=True))
    tdeq = TL._dequant_fp8(tstate, "cpu")
    assert sorted(tdeq) == sorted(jdeq)
    assert any(k.endswith(".act_smooth") for k in tdeq) and not any(k.endswith("_scale") for k in tdeq)
    for k in jdeq:
        np.testing.assert_array_equal(tdeq[k].float().numpy(), np.asarray(jdeq[k], np.float32), err_msg=k)

    tcfg = torch_config(cfg)
    jtree = _flat(jax.tree.map(np.asarray, JL.convert_dit_state(jdeq, cfg)))
    for got_tree in (TL.convert_dit_state(tdeq, tcfg, "cpu"), _with_root(tcfg, tdir)):
        got = _flat(got_tree)
        assert sorted(got) == sorted(jtree)
        for k, w in jtree.items():
            g = got[k]
            assert tuple(g.shape) == w.shape and str(g.dtype).replace("torch.", "") == str(w.dtype), k
            assert g.is_contiguous(), k
            np.testing.assert_array_equal(g.float().numpy(), w.astype(np.float32), err_msg=k)
    sm = got["blocks/mlp/linear_fc2/act_smooth"]
    assert sm.dtype == torch.float32 and (sm[0] == 1).all() and (sm[-1] == 1).all() and not (sm[1] == 1).all()


def _with_root(tcfg, tdir):
    tcfg.runtime_config.load = str(tdir)
    return TL.load_dit_params(tcfg, "cpu")


def test_act_smooth_permuted_with_linear_proj(tmp_path):
    """linear_proj's act_smooth takes the TP8 fold of its weight rows: the
    port's (x / s) @ W on the un-interleaved activation equals the
    reference's runtime order, interleave(x) / s_ref @ W_ref, and the fold
    equals the JAX package's."""
    rng = np.random.default_rng(5)
    wl = rng.normal(size=(3, 64, 16)).astype(np.float32)
    np.testing.assert_array_equal(TL._fold_tp8_interleave(torch.from_numpy(wl)).numpy(),
                                  JL._fold_tp8_interleave(wl))
    cfg = tiny_config(model={"num_layers": 3}, runtime={"cfg_number": 1}, engine={"fp8_quant": True})
    _, tdir, fp8 = write_fp8_pair(tmp_path, cfg, seed=11)
    tcfg = torch_config(cfg)
    tcfg.runtime_config.load = str(tdir)
    params = TL.load_dit_params(tcfg, "cpu")
    node = params["blocks"]["self_attention"]["linear_proj"]
    base = "videodit_blocks.layers.1.self_attention.linear_proj"
    s_ref = fp8[base + ".smooth_scale"].reshape(-1) / fp8[base + ".input_scale"].reshape(-1)[0]
    w_ref = np.asarray(fp8[base + ".weight"][0], np.float32).T  # [in, out], smooth-folded as stored
    x = rng.normal(size=(6, w_ref.shape[0])).astype(np.float32)
    x_il = x.reshape(6, 2, 8, -1).transpose(0, 2, 1, 3).reshape(6, -1)
    want = (x_il / s_ref) @ w_ref
    s, w = node["act_smooth"][1].numpy(), node["weight"][1].numpy()
    got = (x / s) @ (w * s[:, None])  # the folded weight times s: the stored fp8 values
    np.testing.assert_allclose(got, want * float(fp8[base + ".weight_scale"][0]), rtol=1e-4, atol=1e-5)

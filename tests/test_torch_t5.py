"""magi_tpu_torch.models.t5 (the T5 v1.1 encoder, its HF-state converter,
the embedder with its disk-slab offload, the caption cleaning) against
magi_tpu.models.t5 on the same weights, files and text, on the CPU.

Tolerance: the f32 forwards agree to 1e-5 absolute and relative (matmuls
and softmax in another summation order); the converted trees are equal;
the cleaned captions are equal byte for byte."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from magi_tpu.models.t5 import model as JT
from magi_tpu_torch.checkpoint.from_jax import t5_params_from_jax
from magi_tpu_torch.models.t5 import model as TT
from tests.test_t5 import _GOLDEN_CAPTIONS, _fake_hf_checkpoint
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)

TOL = dict(atol=1e-5, rtol=1e-5)
CFG = dict(vocab_size=50, d_model=16, d_kv=4, num_heads=4, d_ff=32, num_layers=4, rel_buckets=8, rel_max_distance=16)


class StubTokenizer:
    """The HF tokenizer's call and output format (ids then EOS 1, padded
    with 0 to max_length, numpy arrays), ids taken from the words' bytes."""

    def __init__(self, vocab_size: int):
        self.vocab_size = vocab_size

    def __call__(self, texts, max_length, padding, truncation, return_attention_mask, add_special_tokens,
                 return_tensors):
        ids = np.zeros((len(texts), max_length), np.int64)
        mask = np.zeros((len(texts), max_length), np.int64)
        for r, text in enumerate(texts):
            toks = [2 + sum(w.encode()) % (self.vocab_size - 2) for w in text.split()][: max_length - 1] + [1]
            ids[r, : len(toks)] = toks
            mask[r, : len(toks)] = 1
        return {"input_ids": ids, "attention_mask": mask}


def _cfgs(**overrides):
    return JT.T5Config(**{**CFG, **overrides}), TT.T5Config(**{**CFG, **overrides})


def test_forward_matches():
    """t5_encoder_forward on init_t5_params weights (the same numbers in
    both packages), a padded batch of two."""
    jcfg, tcfg = _cfgs()
    jparams = JT.init_t5_params(jcfg, seed=4)
    tparams = TT.init_t5_params(tcfg, seed=4)
    for a, b in zip(jax.tree.leaves(jax.tree.map(np.asarray, jparams)), jax.tree.leaves(tparams)):
        np.testing.assert_array_equal(b.numpy(), a)
    tparams = t5_params_from_jax(jax.tree.map(np.asarray, jparams))
    ids = np.array([[5, 9, 13, 2, 1, 0, 0], [7, 7, 7, 7, 7, 7, 1]], np.int32)
    mask = (np.arange(7)[None] < np.array([[5], [7]])).astype(np.int32)
    want = np.asarray(JT.t5_encoder_forward(jparams, jcfg, jnp.asarray(ids), jnp.asarray(mask)))
    got = TT.t5_encoder_forward(tparams, tcfg, torch.from_numpy(ids), torch.from_numpy(mask))
    assert got.dtype == torch.float32 and tuple(got.shape) == (2, 7, 16)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    np.testing.assert_array_equal(TT.position_bias_table(20, tcfg), JT.position_bias_table(20, jcfg))


def test_forward_matches_hf_torch():
    """The port's encoder against HF's T5EncoderModel on its own weights."""
    transformers = pytest.importorskip("transformers")
    hf_cfg = transformers.T5Config(vocab_size=100, d_model=32, d_kv=8, num_heads=4, d_ff=64, num_layers=3,
                                   feed_forward_proj="gated-gelu", dropout_rate=0.0,
                                   relative_attention_num_buckets=8, relative_attention_max_distance=16)
    torch.manual_seed(0)
    model = transformers.T5EncoderModel(hf_cfg).eval()
    ids = torch.tensor([[5, 9, 13, 2, 0, 0], [7, 7, 7, 7, 7, 1]])
    mask = torch.tensor([[1, 1, 1, 1, 0, 0], [1, 1, 1, 1, 1, 1]])
    with torch.no_grad():
        want = model(input_ids=ids, attention_mask=mask).last_hidden_state
    cfg = TT.T5Config.from_hf_config(hf_cfg.to_dict())
    got = TT.t5_encoder_forward(TT.convert_hf_t5_state(dict(model.state_dict()), cfg, torch.float32), cfg, ids, mask)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=2e-4, rtol=2e-4)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_convert_hf_state_matches(tmp_path, dtype):
    """`convert_hf_t5_state` of `tests/test_t5.py`'s fake HF checkpoint,
    and the embedder's load of the same directory, equal to the JAX
    package's."""
    from safetensors.numpy import load_file

    jcfg, tcfg = _cfgs()
    _fake_hf_checkpoint(tmp_path, jcfg, np.random.default_rng(3))
    state = load_file(str(tmp_path / "model.safetensors"))
    want = jax.tree.map(np.asarray, JT.convert_hf_t5_state(state, jcfg, dtype=jnp.dtype(dtype)))
    got = TT.convert_hf_t5_state({k: torch.from_numpy(v) for k, v in state.items()}, tcfg, getattr(torch, dtype))
    emb = TT.T5Embedder(str(tmp_path), dtype=getattr(torch, dtype), tokenizer=StubTokenizer(50))
    assert emb.config == tcfg and emb.device == torch.device("cpu")
    for tree in (got, emb.params):
        flat_w = jax.tree_util.tree_flatten_with_path(want)[0]
        flat_g = jax.tree_util.tree_flatten_with_path(tree)[0]
        assert [p for p, _ in flat_w] == [p for p, _ in flat_g]
        for (path, w), (_, g) in zip(flat_w, flat_g):
            assert str(g.dtype).replace("torch.", "") == str(w.dtype), path
            np.testing.assert_array_equal(g.float().numpy(), w.astype(np.float32), err_msg=str(path))


@pytest.mark.parametrize("n_off", [2, 4])
def test_offload_blocks_streaming_equality(tmp_path, monkeypatch, n_off):
    """Trailing layers in disk slabs (the port's safetensors files), read one
    at a time per encode: the same output as the in-memory forward and as
    the JAX package's embedder, through `get_text_embeddings` with a
    stand-in tokenizer."""
    import transformers

    jcfg, _ = _cfgs()
    _fake_hf_checkpoint(tmp_path, jcfg, np.random.default_rng(3))
    monkeypatch.setattr(transformers.AutoTokenizer, "from_pretrained", lambda *a, **k: StubTokenizer(50))
    full = TT.T5Embedder(str(tmp_path), dtype=torch.float32, model_max_length=8)
    off = TT.T5Embedder(str(tmp_path), dtype=torch.float32, model_max_length=8, offload_blocks=n_off)
    assert off.n_resident == jcfg.num_layers - n_off
    assert ("blocks" in off.params) == bool(off.n_resident)
    import os

    assert len([f for f in os.listdir(off._store.slab_dir) if f.endswith(".safetensors")]) == n_off
    jemb = JT.T5Embedder(str(tmp_path), dtype=jnp.float32, model_max_length=8)
    want, wmask = jemb.get_text_embeddings(["A red cube on a table"])
    for emb in (full, off):
        got, mask = emb.get_text_embeddings(["A red cube on a table"])
        np.testing.assert_array_equal(mask.numpy(), np.asarray(wmask))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    # a second embedder reuses the slabs written by the first
    again = TT.T5Embedder(str(tmp_path), dtype=torch.float32, model_max_length=8, offload_blocks=n_off)
    np.testing.assert_array_equal(again.get_text_embeddings(["A red cube"])[0].numpy(),
                                  off.get_text_embeddings(["A red cube"])[0].numpy())


def test_device_resolution(tmp_path):
    """t5_device "cpu" encodes on the host; any other value stages onto the
    pipeline's device and never falls back to the CPU for want of a card;
    the disk-slab offload is for host encodes only."""
    jcfg, _ = _cfgs()
    _fake_hf_checkpoint(tmp_path, jcfg, np.random.default_rng(3))
    tok = StubTokenizer(50)
    host = TT.T5Embedder(str(tmp_path), dtype=torch.float32, tokenizer=tok)
    staged = TT.T5Embedder(str(tmp_path), dtype=torch.float32, tokenizer=tok, device="auto", pipeline_device="cpu")
    assert host.device == staged.device == torch.device("cpu")
    np.testing.assert_array_equal(host.get_text_embeddings(["x y"])[0].numpy(),
                                  staged.get_text_embeddings(["x y"])[0].numpy())
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            TT.T5Embedder(str(tmp_path), tokenizer=tok, device="auto")
    with pytest.raises(ValueError, match="offload_blocks"):
        TT.T5Embedder(str(tmp_path), tokenizer=tok, device="auto", pipeline_device="meta", offload_blocks=2)


CORPORA = {
    "golden": _GOLDEN_CAPTIONS,
    # the inputs of tests/test_t5.py::test_clean_caption
    "basic": ["Hello <person> visit https://example.com NOW!!", "a   b  c", "MiXeD CaSe"],
}


@pytest.mark.parametrize("corpus", sorted(CORPORA))
def test_clean_caption_byte_equal(corpus):
    for text in CORPORA[corpus]:
        assert TT.clean_caption(text) == JT.clean_caption(text), text
        assert TT.text_preprocessing(text) == JT.text_preprocessing(text), text
        assert TT.text_preprocessing(text, enabled=False) == JT.text_preprocessing(text, enabled=False), text
        assert TT.basic_clean(text) == JT.basic_clean(text), text

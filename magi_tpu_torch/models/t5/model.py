"""T5 v1.1 encoder and the text-embedding front end (the port of
`magi_tpu.models.t5.model`).

* The encoder is plain PyTorch on the JAX package's parameter tree (linear
  weights [in, out], the layers stacked on a leading axis) and a Python
  loop over the layers; attention scores are taken in f32, as the JAX
  package asks of its einsum.
* `T5Embedder` loads the HF-layout directory (`config.json`, weights in
  `*.safetensors` or `pytorch_model*.bin`, the tokenizer).  The tokenizer
  is `transformers.AutoTokenizer`, imported when an embedder is made, so
  the port imports without `transformers`.
* Caption cleaning is the JAX package's, byte for byte; `ftfy` and `bs4`
  are used when they import.
"""

from __future__ import annotations

import dataclasses
import functools
import glob
import html
import json
import os
import re
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from magi_tpu_torch.checkpoint.safetensors_io import load_file, save_file
from magi_tpu_torch.core.utils import resolve_device


@dataclasses.dataclass(frozen=True)
class T5Config:
    vocab_size: int = 32128
    d_model: int = 4096
    d_kv: int = 64
    num_heads: int = 64
    d_ff: int = 10240
    num_layers: int = 24
    rel_buckets: int = 32
    rel_max_distance: int = 128
    layer_norm_epsilon: float = 1e-6

    @classmethod
    def xxl(cls) -> "T5Config":
        return cls()

    @classmethod
    def from_hf_config(cls, d: dict) -> "T5Config":
        return cls(
            vocab_size=d.get("vocab_size", 32128),
            d_model=d["d_model"],
            d_kv=d["d_kv"],
            num_heads=d["num_heads"],
            d_ff=d["d_ff"],
            num_layers=d["num_layers"],
            rel_buckets=d.get("relative_attention_num_buckets", 32),
            rel_max_distance=d.get("relative_attention_max_distance", 128),
            layer_norm_epsilon=d.get("layer_norm_epsilon", 1e-6),
        )


def _rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.float()
    var = xf.square().mean(-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(x.dtype) * weight.to(x.dtype)


def relative_position_bucket(rel_pos: np.ndarray, num_buckets: int, max_distance: int) -> np.ndarray:
    """Bidirectional T5 bucketing (HF `_relative_position_bucket`)."""
    ret = np.zeros_like(rel_pos)
    num_buckets //= 2
    ret += (rel_pos > 0).astype(np.int64) * num_buckets
    n = np.abs(rel_pos)
    max_exact = num_buckets // 2
    is_small = n < max_exact
    large = max_exact + (
        np.log(np.maximum(n, 1) / max_exact) / np.log(max_distance / max_exact) * (num_buckets - max_exact)
    ).astype(np.int64)
    large = np.minimum(large, num_buckets - 1)
    ret += np.where(is_small, n, large)
    return ret


def position_bias_table(seq_len: int, cfg: T5Config) -> np.ndarray:
    """[seq, seq] bucket indices of the shared relative bias."""
    ctx = np.arange(seq_len)[:, None]
    mem = np.arange(seq_len)[None, :]
    return relative_position_bucket(mem - ctx, cfg.rel_buckets, cfg.rel_max_distance)


@functools.lru_cache(maxsize=8)
def _bucket_table(seq_len: int, cfg: T5Config) -> torch.Tensor:
    """`position_bias_table` as a host tensor, made once per length (a few
    tens of ms of numpy at L 800); read only."""
    return torch.from_numpy(position_bias_table(seq_len, cfg))


def _t5_prologue(params: dict, cfg: T5Config, input_ids: torch.Tensor, attn_mask: torch.Tensor):
    """Embedding lookup and the [B, heads, L, L] masked relative-position
    bias (f32, contiguous: every layer adds it to its scores)."""
    dev = params["shared"]["weight"].device
    input_ids, attn_mask = input_ids.to(dev), attn_mask.to(dev)
    h = params["shared"]["weight"][input_ids.long()]
    buckets = _bucket_table(input_ids.shape[1], cfg).to(dev)
    bias = params["rel_bias"]["weight"][buckets].permute(2, 0, 1).float().contiguous()[None]  # [1, heads, L, L]
    neg = (1.0 - attn_mask.float())[:, None, None, :] * -1e9
    return h, bias + neg


def _t5_block(blk: dict, cfg: T5Config, x: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """One encoder block: pre-RMSNorm self-attention (no 1/sqrt(d): T5
    folds it into its weights) and the gated-GELU FFN of v1.1."""
    B, L = x.shape[0], x.shape[1]
    hn = _rms_norm(x, blk["ln1"], cfg.layer_norm_epsilon)
    q = (hn @ blk["q"]).reshape(B, L, cfg.num_heads, cfg.d_kv)
    k = (hn @ blk["k"]).reshape(B, L, cfg.num_heads, cfg.d_kv)
    v = (hn @ blk["v"]).reshape(B, L, cfg.num_heads, cfg.d_kv)
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) + bias
    probs = torch.softmax(scores, dim=-1).to(x.dtype)
    attn = torch.einsum("bhqk,bkhd->bqhd", probs, v).reshape(B, L, -1)
    x = x + attn @ blk["o"]
    hn = _rms_norm(x, blk["ln2"], cfg.layer_norm_epsilon)
    g = F.gelu(hn @ blk["wi_0"], approximate="tanh")
    return x + (g * (hn @ blk["wi_1"])) @ blk["wo"]


def _layer(blocks: dict, i: int) -> dict:
    return {k: v[i] for k, v in blocks.items()}


def t5_encoder_forward(params: dict, cfg: T5Config, input_ids: torch.Tensor, attn_mask: torch.Tensor) -> torch.Tensor:
    """[B, L] ids and mask -> [B, L, d_model] last hidden state, on the
    parameters' device and in their dtype."""
    h, bias = _t5_prologue(params, cfg, input_ids, attn_mask)
    for i in range(params["blocks"]["q"].shape[0]):
        h = _t5_block(_layer(params["blocks"], i), cfg, h, bias)
    return _rms_norm(h, params["final_layer_norm"]["weight"], cfg.layer_norm_epsilon)


def init_t5_params(cfg: T5Config, seed: int = 0, dtype=torch.float32, device="cpu") -> dict:
    """Random weights, the JAX package's `init_t5_params` numbers (numpy
    normal * 0.02, norms 1)."""
    rng = np.random.default_rng(seed)
    Lr = cfg.num_layers

    def w(*shape, stacked=True):
        s = (Lr,) + shape if stacked else shape
        return torch.from_numpy(rng.standard_normal(s, dtype=np.float32) * 0.02).to(device=device, dtype=dtype)

    def ones(*shape):
        return torch.ones(shape, dtype=dtype, device=device)

    inner = cfg.num_heads * cfg.d_kv
    return {
        "shared": {"weight": w(cfg.vocab_size, cfg.d_model, stacked=False)},
        "rel_bias": {"weight": w(cfg.rel_buckets, cfg.num_heads, stacked=False)},
        "blocks": {
            "ln1": ones(Lr, cfg.d_model),
            "q": w(cfg.d_model, inner),
            "k": w(cfg.d_model, inner),
            "v": w(cfg.d_model, inner),
            "o": w(inner, cfg.d_model),
            "ln2": ones(Lr, cfg.d_model),
            "wi_0": w(cfg.d_model, cfg.d_ff),
            "wi_1": w(cfg.d_model, cfg.d_ff),
            "wo": w(cfg.d_ff, cfg.d_model),
        },
        "final_layer_norm": {"weight": ones(cfg.d_model)},
    }


# per-layer HF key formats: our key -> (HF format, transposed)
_T5_LAYER_FMTS = {
    "ln1": ("encoder.block.{}.layer.0.layer_norm.weight", False),
    "q": ("encoder.block.{}.layer.0.SelfAttention.q.weight", True),
    "k": ("encoder.block.{}.layer.0.SelfAttention.k.weight", True),
    "v": ("encoder.block.{}.layer.0.SelfAttention.v.weight", True),
    "o": ("encoder.block.{}.layer.0.SelfAttention.o.weight", True),
    "ln2": ("encoder.block.{}.layer.1.layer_norm.weight", False),
    "wi_0": ("encoder.block.{}.layer.1.DenseReluDense.wi_0.weight", True),
    "wi_1": ("encoder.block.{}.layer.1.DenseReluDense.wi_1.weight", True),
    "wo": ("encoder.block.{}.layer.1.DenseReluDense.wo.weight", True),
}
_REL_BIAS = "encoder.block.0.layer.0.SelfAttention.relative_attention_bias.weight"


def _cast(t: torch.Tensor, dtype, transpose: bool = False) -> torch.Tensor:
    """A leaf in `dtype`, cast through f32, owning its memory."""
    t = t.float()
    return (t.t() if transpose else t).to(dtype, copy=True).contiguous()


def convert_hf_t5_layer(getter, i: int, dtype=torch.bfloat16) -> dict:
    """Encoder layer `i` through `getter(hf_key) -> tensor` (a lazy
    checkpoint), without the whole state dict."""
    return {ours: _cast(getter(fmt.format(i)), dtype, transpose) for ours, (fmt, transpose) in _T5_LAYER_FMTS.items()}


def convert_hf_t5_state(state: dict, cfg: T5Config, dtype=torch.bfloat16) -> dict:
    """A T5EncoderModel state dict (HF key names) -> the port's tree,
    weights transposed to [in, out] and the layers stacked, in `dtype`."""
    layers = [convert_hf_t5_layer(state.__getitem__, i, dtype) for i in range(cfg.num_layers)]
    return {
        "shared": {"weight": _cast(state["shared.weight"], dtype)},
        "rel_bias": {"weight": _cast(state[_REL_BIAS], dtype)},
        "blocks": {k: torch.stack([blk[k] for blk in layers]) for k in _T5_LAYER_FMTS},
        "final_layer_norm": {"weight": _cast(state["encoder.final_layer_norm.weight"], dtype)},
    }


class T5BlockStore:
    """Converted encoder layers on disk, one safetensors file a layer (the
    low-host-RAM mode: trailing layers are written once, converted and in
    the target dtype, then read one at a time per encode)."""

    def __init__(self, slab_dir: str, dtype):
        self.slab_dir = slab_dir
        self.dtype = dtype

    def path(self, i: int) -> str:
        return os.path.join(self.slab_dir, f"block_{i:02d}.safetensors")

    def write(self, i: int, blk: dict) -> None:
        os.makedirs(self.slab_dir, exist_ok=True)
        save_file(blk, self.path(i))

    def load(self, i: int) -> dict:
        return {k: v.clone() for k, v in load_file(self.path(i)).items()}


# ---------------------------------------------------------------------------
# caption cleaning: the rules and their order are the released checkpoints'
# training-time cleaning, kept byte for byte
# ---------------------------------------------------------------------------

_BAD_PUNCT = re.compile(r"[#®•©™&@·º½¾¿¡§~\)\(\]\[\}\{\|\\/\*]{1,}")

# CJK unicode blocks, 31C0-31EF strokes .. 4E00-9FFF unified ideographs
_CJK_BLOCKS = (
    r"[\u31c0-\u31ef]+",
    r"[\u31f0-\u31ff]+",
    r"[\u3200-\u32ff]+",
    r"[\u3300-\u33ff]+",
    r"[\u3400-\u4dbf]+",
    r"[\u4dc0-\u4dff]+",
    r"[\u4e00-\u9fff]+",
)

# every dash codepoint -> "-"
_DASHES = (
    r"[\u002D\u058A\u05BE\u1400\u1806\u2010-\u2015\u2E17\u2E1A\u2E3A"
    r"\u2E3B\u2E40\u301C\u3030\u30A0\uFE31\uFE32\uFE58\uFE63\uFF0D]+"
)


def basic_clean(text: str) -> str:
    """ftfy's repair where it imports (identity on well-formed input), two
    rounds of html unescaping, strip."""
    try:
        import ftfy

        text = ftfy.fix_text(text)
    except ImportError:
        pass
    text = html.unescape(html.unescape(text))
    return text.strip()


def clean_caption(caption: str) -> str:
    """The caption cleaning pipeline, every rule in order."""
    import urllib.parse as ul

    caption = str(caption)
    caption = ul.unquote_plus(caption)
    caption = caption.strip().lower()
    caption = re.sub("<person>", "person", caption)
    # urls (two passes: https?: and www: forms)
    caption = re.sub(
        r"\b((?:https?:(?:\/{1,3}|[a-zA-Z0-9%])|[a-zA-Z0-9.\-]+[.](?:com|co|ru|net|org|edu|gov|it)[\w/-]*\b\/?(?!@)))",
        "",
        caption,
    )
    caption = re.sub(
        r"\b((?:www:(?:\/{1,3}|[a-zA-Z0-9%])|[a-zA-Z0-9.\-]+[.](?:com|co|ru|net|org|edu|gov|it)[\w/-]*\b\/?(?!@)))",
        "",
        caption,
    )
    # html
    try:
        from bs4 import BeautifulSoup

        caption = BeautifulSoup(caption, features="html.parser").text
    except ImportError:
        caption = re.sub(r"<[^>]+>", "", caption)
    # @<nickname>
    caption = re.sub(r"@[\w\d]+\b", "", caption)
    # CJK unicode blocks
    for block in _CJK_BLOCKS:
        caption = re.sub(block, "", caption)
    # all dash variants -> "-"; quotes to one standard
    caption = re.sub(_DASHES, "-", caption)
    caption = re.sub(r"[`´«»“”¨]", '"', caption)
    caption = re.sub(r"[‘’]", "'", caption)
    # html entities left after unescape
    caption = re.sub(r"&quot;?", "", caption)
    caption = re.sub(r"&amp", "", caption)
    # ip addresses
    caption = re.sub(r"\d{1,3}\.\d{1,3}\.\d{1,3}\.\d{1,3}", " ", caption)
    # article ids at end
    caption = re.sub(r"\d:\d\d\s+$", "", caption)
    # literal \n
    caption = re.sub(r"\\n", " ", caption)
    # "#123", "#12345..", bare long digit runs, filenames
    caption = re.sub(r"#\d{1,3}\b", "", caption)
    caption = re.sub(r"#\d{5,}\b", "", caption)
    caption = re.sub(r"\b\d{6,}\b", "", caption)
    caption = re.sub(r"[\S]+\.(?:png|jpg|jpeg|bmp|webp|eps|pdf|apk|mp4)", "", caption)
    # repeated quotes/dots, bad punctuation, " . "
    caption = re.sub(r"[\"\']{2,}", r'"', caption)
    caption = re.sub(r"[\.]{2,}", r" ", caption)
    caption = _BAD_PUNCT.sub(r" ", caption)
    caption = re.sub(r"\s+\.\s+", r" ", caption)
    # this-is-my-cute-cat / this_is_my_cute_cat
    regex2 = re.compile(r"(?:\-|\_)")
    if len(re.findall(regex2, caption)) > 3:
        caption = re.sub(regex2, " ", caption)
    caption = basic_clean(caption)
    # alphanumeric id tokens (jc6640 / jc6640vc / 6640vc231)
    caption = re.sub(r"\b[a-zA-Z]{1,3}\d{3,15}\b", "", caption)
    caption = re.sub(r"\b[a-zA-Z]+\d+[a-zA-Z]+\b", "", caption)
    caption = re.sub(r"\b\d+[a-zA-Z]+\d+\b", "", caption)
    # commerce boilerplate
    caption = re.sub(r"(worldwide\s+)?(free\s+)?shipping", "", caption)
    caption = re.sub(r"(free\s)?download(\sfree)?", "", caption)
    caption = re.sub(r"\bclick\b\s(?:for|on)\s\w+", "", caption)
    caption = re.sub(r"\b(?:png|jpg|jpeg|bmp|webp|eps|pdf|apk|mp4)(\simage[s]?)?", "", caption)
    caption = re.sub(r"\bpage\s+\d+\b", "", caption)
    caption = re.sub(r"\b\d*[a-zA-Z]+\d+[a-zA-Z]+\d+[a-zA-Z\d]*\b", r" ", caption)  # j2d1a2a...
    # dimensions 123x456 (and the cyrillic х and ×)
    caption = re.sub(r"\b\d+\.?\d*[xх×]\d+\.?\d*\b", "", caption)
    # punctuation spacing, whitespace collapse
    caption = re.sub(r"\b\s+\:\s+", r": ", caption)
    caption = re.sub(r"(\D[,\./])\b", r"\1 ", caption)
    caption = re.sub(r"\s+", " ", caption)
    caption = re.sub(r"^[\"\']([\w\W]+)[\"\']$", r"\1", caption)
    caption = re.sub(r"^[\'\_,\-\:;]", r"", caption)
    caption = re.sub(r"[\'\_,\-\:\-\+]$", r"", caption)
    caption = re.sub(r"^\.\S+$", "", caption)
    return caption.strip()


def text_preprocessing(text: str, enabled: bool = True) -> str:
    if enabled:
        return clean_caption(clean_caption(text))
    return text.lower().strip()


# ---------------------------------------------------------------------------
# the embedder
# ---------------------------------------------------------------------------


def _tree_to(tree: dict, device, non_blocking: bool = False) -> dict:
    return {k: _tree_to(v, device, non_blocking) if isinstance(v, dict) else v.to(device, non_blocking=non_blocking)
            for k, v in tree.items()}


def t5_encode_staged(host_params: dict, cfg: T5Config, input_ids, attn_mask, device) -> torch.Tensor:
    """The encode of a host-resident tree on `device`: the weights are
    copied over (asynchronously from pinned memory), used and freed, and
    the hidden state comes back to the host; the device holds nothing of
    T5 after the call."""
    dev_params = _tree_to(host_params, device, non_blocking=True)
    embs = t5_encoder_forward(dev_params, cfg, input_ids, attn_mask).cpu()
    del dev_params
    return embs


def _tree_to_pinned(tree: dict) -> dict:
    return {k: _tree_to_pinned(v) if isinstance(v, dict) else v.pin_memory() for k, v in tree.items()}


def _checkpoint_getter(path: str):
    """getter(hf_key) -> tensor over the HF-layout weights under
    `path`: `*.safetensors` (mapped, read as used), else
    `pytorch_model*.bin`.  Encoder-only checkpoints may lack the
    "encoder." prefix; the getter takes the prefixed names either way."""
    st_files = sorted(glob.glob(os.path.join(path, "*.safetensors")))
    state: dict = {}
    if st_files:
        for f in st_files:
            state.update(load_file(f))
    else:
        bins = sorted(glob.glob(os.path.join(path, "pytorch_model*.bin")))
        if not bins:
            raise FileNotFoundError(f"no T5 weights found under {path}")
        for b in bins:
            state.update(torch.load(b, map_location="cpu", weights_only=True))
    has_prefix = any(k.startswith("encoder.") for k in state)

    def getter(name: str) -> torch.Tensor:
        if not has_prefix and name.startswith("encoder."):
            name = name[len("encoder."):]
        return state[name]

    return getter


class T5Embedder:
    """The text encoder of the pipeline: tokenizer and T5-XXL encoder
    weights from a local HF-layout directory (`runtime_config.t5_pretrained`).

    `device` is `runtime_config.t5_device`: "cpu" encodes on the host.
    Any other value ("auto" included) stages onto `pipeline_device`, the
    device the pipeline runs on: the weights stay cached on the host
    (pinned when that device is a card), are copied over for each encode
    and freed after it, so T5 holds no device memory while the DiT walks.
    `offload_blocks` (or MAGI_T5_OFFLOAD_BLOCKS) keeps that many trailing
    layers in disk slabs read one at a time per encode (a low-host-RAM
    mode, host encodes only).  `tokenizer` replaces
    `transformers.AutoTokenizer.from_pretrained(cache_dir)`."""

    available_models = ["t5-v1_1-xxl"]

    def __init__(
        self,
        cache_dir: str,
        model_max_length: int = 120,
        dtype=torch.bfloat16,
        use_text_preprocessing: bool = True,
        device: str = "cpu",
        offload_blocks: int = 0,
        pipeline_device=None,
        tokenizer=None,
    ):
        if tokenizer is None:
            from transformers import AutoTokenizer

            tokenizer = AutoTokenizer.from_pretrained(cache_dir)
        self.tokenizer = tokenizer
        self.model_max_length = model_max_length
        self.use_text_preprocessing = use_text_preprocessing
        with open(os.path.join(cache_dir, "config.json")) as f:
            self.config = T5Config.from_hf_config(json.load(f))
        self.device = torch.device("cpu") if device == "cpu" else resolve_device(pipeline_device)
        if not offload_blocks:
            offload_blocks = int(os.environ.get("MAGI_T5_OFFLOAD_BLOCKS", "0"))
        self.n_offload = min(int(offload_blocks), self.config.num_layers)
        self.n_resident = self.config.num_layers - self.n_offload
        self._store = None
        if self.n_offload and self.device.type != "cpu":
            raise ValueError("offload_blocks targets low-RAM CPU hosts; with a device the staged encode already "
                             "bounds its memory")
        getter = _checkpoint_getter(cache_dir)
        self.params = self._load_params(getter, cache_dir, dtype)
        if self.device.type == "cuda":
            self.params = _tree_to_pinned(self.params)

    def _load_params(self, getter, path: str, dtype) -> dict:
        """The host tree: the first n_resident layers stacked in memory; the
        trailing n_offload converted one at a time into disk slabs (written
        once, reused by later runs).  Peak host memory: the resident tree
        and one f32 layer."""
        cfg = self.config
        if self.n_offload:
            name = str(dtype).replace("torch.", "")
            self._store = T5BlockStore(os.path.join(path, f"torch_block_slabs_{name}"), dtype)
            for i in range(self.n_resident, cfg.num_layers):
                if not os.path.exists(self._store.path(i)):
                    self._store.write(i, convert_hf_t5_layer(getter, i, dtype))
        params = {
            "shared": {"weight": _cast(getter("shared.weight"), dtype)},
            "rel_bias": {"weight": _cast(getter(_REL_BIAS), dtype)},
            "final_layer_norm": {"weight": _cast(getter("encoder.final_layer_norm.weight"), dtype)},
        }
        if self.n_resident:
            layers = [convert_hf_t5_layer(getter, i, dtype) for i in range(self.n_resident)]
            params["blocks"] = {k: torch.stack([blk[k] for blk in layers]) for k in _T5_LAYER_FMTS}
        return params

    def get_text_embeddings(self, texts) -> Tuple[torch.Tensor, torch.Tensor]:
        """texts -> (embeddings [B, L, d_model] on the host, mask [B, L])."""
        texts = [text_preprocessing(t, self.use_text_preprocessing) for t in texts]
        tok = self.tokenizer(
            texts,
            max_length=self.model_max_length,
            padding="max_length",
            truncation=True,
            return_attention_mask=True,
            add_special_tokens=True,
            return_tensors="np",
        )
        ids = torch.as_tensor(np.asarray(tok["input_ids"]), dtype=torch.int32)
        mask = torch.as_tensor(np.asarray(tok["attention_mask"]), dtype=torch.int32)
        return self._encode_ids(ids, mask), mask

    def _encode_ids(self, ids: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        if self._store is not None:
            return self._encode_offload(ids, mask)
        if self.device.type == "cpu":
            return t5_encoder_forward(self.params, self.config, ids, mask)
        return t5_encode_staged(self.params, self.config, ids, mask, self.device)

    def _encode_offload(self, ids: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        """Host encode streaming the offloaded layers: resident layers from
        the stacked tree, the rest read from their slabs one at a time and
        dropped after use."""
        p = self.params
        h, bias = _t5_prologue(p, self.config, ids, mask)
        for i in range(self.config.num_layers):
            blk = _layer(p["blocks"], i) if i < self.n_resident else self._store.load(i)
            h = _t5_block(blk, self.config, h, bias)
            del blk
        return _rms_norm(h, p["final_layer_norm"]["weight"], self.config.layer_norm_epsilon)


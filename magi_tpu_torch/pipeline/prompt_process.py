"""Prompt processing: special conditioning tokens, T5 text embeddings and
the assembly of per-chunk captions into an InferenceInput (the port of
`magi_tpu.pipeline.prompt_process`)."""

from __future__ import annotations

import math
import os
import zlib
from typing import List, Optional, Tuple

import numpy as np
import torch

from magi_tpu_torch.core.config import MagiConfig
from magi_tpu_torch.core.logger import magi_logger, print_rank_0
from magi_tpu_torch.core.profiler import span
from magi_tpu_torch.core.utils import env_is_true
from magi_tpu_torch.sampling.transport import InferenceInput

_SPECIAL_TOKENS: Optional[dict] = None


def _load_special_tokens() -> dict:
    global _SPECIAL_TOKENS
    if _SPECIAL_TOKENS is not None:
        return _SPECIAL_TOKENS
    path = os.getenv("SPECIAL_TOKEN_PATH", "example/assets/special_tokens.npz")
    tokens = {}
    if os.path.exists(path):
        raw = np.load(path)
        other = raw["other_tokens"].astype(np.float32)
        tokens = {
            "CAPTION_TOKEN": raw["caption_token"].astype(np.float32),
            "LOGO_TOKEN": raw["logo_token"].astype(np.float32),
            "TRANS_TOKEN": other[0:1],
            "HQ_TOKEN": other[1:2],
            "STATIC_FIRST_FRAMES_TOKEN": other[2:3],
            "DYNAMIC_FIRST_FRAMES_TOKEN": other[3:4],
            "BORDERNESS_TOKEN": other[4:5],
            "THREE_D_MODEL_TOKEN": other[15:16],
            "TWO_D_ANIME_TOKEN": other[16:17],
        }
        for i in range(8):
            tokens[f"DURATION_TOKEN_{i + 1}"] = other[7 + i : 8 + i]
    else:
        magi_logger.warning(f"SPECIAL_TOKEN_PATH {path} not found; special-token padding disabled")
    _SPECIAL_TOKENS = tokens
    return tokens


def get_special_token_keys() -> List[str]:
    keys = []
    for flag, key in (
        ("PAD_STATIC", "STATIC_FIRST_FRAMES_TOKEN"),
        ("PAD_DYNAMIC", "DYNAMIC_FIRST_FRAMES_TOKEN"),
        ("PAD_BORDERNESS", "BORDERNESS_TOKEN"),
        ("PAD_HQ", "HQ_TOKEN"),
        ("PAD_THREE_D_MODEL", "THREE_D_MODEL_TOKEN"),
        ("PAD_TWO_D_ANIME", "TWO_D_ANIME_TOKEN"),
        ("PAD_DURATION", "DURATION_TOKEN"),
    ):
        if env_is_true(flag):
            keys.append(key)
    return keys


def get_negative_special_token_keys() -> Optional[List[str]]:
    if env_is_true("NEG_PROMPT"):
        return ["CAPTION_TOKEN", "LOGO_TOKEN", "TRANS_TOKEN", "BORDERNESS_TOKEN"]
    return None


def _pad_one(token: np.ndarray, embs: np.ndarray, lens: Optional[np.ndarray], max_len: int):
    """Prepend the token rows to every chunk, clip to max_len."""
    n, L, C = embs.shape
    tok = np.broadcast_to(token.reshape(1, -1, C), (n, token.shape[0], C))
    embs = np.concatenate([tok, embs], axis=1)[:, :max_len]
    if lens is not None:
        lens = np.minimum(lens + token.shape[0], max_len)
    return embs, lens


def pad_special_token(keys: List[str], embs: np.ndarray, lens: Optional[np.ndarray], max_len: int):
    """embs [n_chunks, L, C]; lens the per-chunk valid prefix lengths."""
    tokens = _load_special_tokens()
    if not keys or not tokens:
        return embs, lens
    n = embs.shape[0]
    for key in keys:
        if key == "DURATION_TOKEN":
            # DURATION_TOKEN_k == k chunks remaining
            rows, row_lens = [], []
            for i in range(n):
                tok = tokens[f"DURATION_TOKEN_{min(n - i - 1, 7) + 1}"]
                e, l = _pad_one(tok, embs[i : i + 1], None if lens is None else lens[i : i + 1], max_len)
                rows.append(e)
                row_lens.append(l)
            embs = np.concatenate(rows, axis=0)
            if lens is not None:
                lens = np.concatenate(row_lens, axis=0)
        elif key in tokens:
            embs, lens = _pad_one(tokens[key], embs, lens, max_len)
    return embs, lens


_t5_cache = None


def _t5(cache_dir: str, max_len: int, t5_device: str = "cpu", pipeline_device=None):
    """The T5 embedder of `cache_dir`, kept for later prompts unless
    OFFLOAD_T5_CACHE=true."""
    global _t5_cache
    if _t5_cache is None:
        from magi_tpu_torch.models.t5.model import T5Embedder

        embedder = T5Embedder(cache_dir=cache_dir, model_max_length=max_len, device=t5_device,
                              pipeline_device=pipeline_device)
        if os.environ.get("OFFLOAD_T5_CACHE") == "true":
            return embedder
        _t5_cache = embedder
    return _t5_cache


def get_txt_embeddings(prompt: str, config: MagiConfig, device=None) -> Tuple[np.ndarray, np.ndarray]:
    """prompt -> (caption_embs [1, L, C] fp32, mask [1, L]): the T5 encoder
    of `runtime_config.t5_pretrained`, on the host or staged onto `device`
    (the pipeline's) as `runtime_config.t5_device` says.  Under
    SKIP_LOAD_MODEL: deterministic pseudo-embeddings seeded by the prompt
    text (the same numbers as the JAX package's)."""
    L = config.model_config.caption_max_length
    if not env_is_true("SKIP_LOAD_MODEL"):
        print_rank_0("Precompute validation prompt embeddings")
        rc = config.runtime_config
        t5 = _t5(rc.t5_pretrained, L, rc.t5_device, device)
        embs, mask = t5.get_text_embeddings([prompt])
        return embs.float().numpy(), mask.numpy().astype(np.int32)
    print_rank_0("SKIP_LOAD_MODEL set: pseudo text embeddings")
    rng = np.random.default_rng(zlib.crc32(prompt.encode()))
    embs = rng.normal(size=(1, L, config.model_config.caption_channels)).astype(np.float32)
    n_tok = min(max(len(prompt.split()), 1) + 2, L)
    mask = np.zeros((1, L), np.int32)
    mask[0, :n_tok] = 1
    return embs, mask


NULL_TOKEN_LENGTH = 50


def build_inference_input(
    config: MagiConfig,
    null_caption_embedding: np.ndarray,  # [caption_max_length, C] from the DiT
    caption_embs: np.ndarray,  # [1, L0, C]
    emb_masks: np.ndarray,  # [1, L0]
    device,
    prefix_video: Optional[torch.Tensor] = None,  # latent [C, T_pre, H', W'] (i2v / v2v)
) -> InferenceInput:
    """Per-chunk captions (special tokens applied), the null slab and the
    latent size of a request.  With a prefix video the whole chunks it
    covers come first, clean, with the null caption and 0 valid tokens,
    and the chunks to denoise cover the video's frames after the prefix.
    Span `magi/request/inputs` with the chunks and the caption's tokens."""
    mc, rc = config.model_config, config.runtime_config
    max_len = mc.caption_max_length
    latent_frames = rc.num_frames // rc.temporal_downsample_factor
    clean_chunk_num = 0
    if prefix_video is not None:
        clean_chunk_num = prefix_video.shape[1] // rc.chunk_width
        chunk_num = math.ceil((latent_frames + prefix_video.shape[1]) / rc.chunk_width)
    else:
        chunk_num = math.ceil(latent_frames / rc.chunk_width)
    n_denoise = chunk_num - clean_chunk_num

    with span("magi/request/inputs", chunks=chunk_num, caption_tokens=int(emb_masks.sum())):
        cap = np.repeat(caption_embs.astype(np.float32), n_denoise, axis=0)  # [n_den, L0, C]
        if cap.shape[1] < max_len:
            cap = np.pad(cap, ((0, 0), (0, max_len - cap.shape[1]), (0, 0)))
        cap = cap[:, :max_len]
        lens = np.full(n_denoise, int(emb_masks.sum()), np.int64)
        cap, lens = pad_special_token(get_special_token_keys(), cap, lens, max_len)
        print_rank_0(f"special_token = {get_special_token_keys()}")
        if clean_chunk_num:
            null_row = null_caption_embedding.astype(np.float32)[None]
            cap = np.concatenate([np.repeat(null_row, clean_chunk_num, axis=0), cap], axis=0)
            lens = np.concatenate([np.zeros(clean_chunk_num, np.int64), lens])

        null_emb = null_caption_embedding.astype(np.float32)
        neg_keys = get_negative_special_token_keys()
        if neg_keys:
            null_emb = pad_special_token(neg_keys, null_emb[None], None, max_len)[0][0]

        in_channels = 16 if mc.half_channel_vae else mc.in_channels
        return InferenceInput(
            caption_embs=torch.as_tensor(np.ascontiguousarray(cap), device=device),
            caption_lens=lens.astype(np.int32),
            null_emb=torch.as_tensor(np.ascontiguousarray(null_emb), device=device),
            null_len=NULL_TOKEN_LENGTH,
            latent_size=(in_channels, chunk_num * rc.chunk_width, rc.video_size_h // 8, rc.video_size_w // 8),
            num_steps=rc.num_steps,
            chunk_num=chunk_num,
            has_text=bool(emb_masks.sum() != 0),
            prefix_video=None if prefix_video is None else torch.as_tensor(prefix_video, device=device),
            prev_chunks_scale=float(os.getenv("prev_chunks_scale", 0.7)),
        )

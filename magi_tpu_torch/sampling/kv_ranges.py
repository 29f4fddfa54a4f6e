"""KV-range builders for the block-causal ARDF attention
(ref: video_generate.py:371-527, dit_model.py:92-101).

All ranges are (start, end) token offsets into the attention KV view
(`[0, (slice_point + n_segments) * ctn)`), chunk granularity × ctn tokens.
batch_size is always 1 (the reference asserts the same on every CP path).
A copy of `magi_tpu.sampling.kv_ranges` (pure numpy).
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np


def default_kvrange(slice_point: int, n_denoise: int, ctn: int) -> Tuple[np.ndarray, np.ndarray]:
    """Chunk j attends everything up to and including itself
    (ref: generate_default_kvrange, video_generate.py:454-465)."""
    ends = (slice_point + 1 + np.arange(n_denoise, dtype=np.int64)) * ctn
    starts = np.zeros(n_denoise, dtype=np.int64)
    return starts.astype(np.int32), ends.astype(np.int32)


def noise2clean_kvrange(
    slice_point: int,
    n_denoise: int,
    noise2clean: List[int],
    clean_chunk_kvrange: int,
    steps_of_chunks: List[int],
    num_steps: int,
    ctn: int,
) -> Tuple[np.ndarray, np.ndarray]:
    """Noisier chunks attend a shorter sliding window of previous chunks
    (ref: generate_noise2clean_kvrange, video_generate.py:467-508)."""
    assert len(steps_of_chunks) == n_denoise
    assert len(noise2clean) > 0
    if clean_chunk_kvrange == -1:
        clean_chunk_kvrange = noise2clean[-1]
    assert num_steps % len(noise2clean) == 0
    dpss = num_steps // len(noise2clean)

    starts, ends = [], []
    for j, cur_step in enumerate(steps_of_chunks):
        if cur_step == num_steps:
            span = clean_chunk_kvrange
        else:
            span = noise2clean[cur_step // dpss]
        k_end = slice_point + j + 1
        k_start = max(0, k_end - span)
        starts.append(k_start * ctn)
        ends.append(k_end * ctn)
    return np.asarray(starts, np.int32), np.asarray(ends, np.int32)


def denoising_kvrange(
    runtime_config,
    slice_point: int,
    n_denoise: int,
    steps_of_chunks: List[int],
    num_steps: int,
    ctn: int,
) -> Tuple[np.ndarray, np.ndarray]:
    """Dispatch default vs noise2clean (ref: video_generate.py:510-527)."""
    n2c = runtime_config.noise2clean_kvrange
    if not n2c:
        return default_kvrange(slice_point, n_denoise, ctn)
    return noise2clean_kvrange(
        slice_point, n_denoise, n2c, runtime_config.clean_chunk_kvrange, steps_of_chunks, num_steps, ctn
    )


def prefix_kvrange(runtime_config, range_num: int, ctn: int) -> Tuple[np.ndarray, np.ndarray]:
    """Sliding window for prefix-video cache warmup
    (ref: generate_kvrange_for_prefix_video, video_generate.py:371-387)."""
    if runtime_config.clean_chunk_kvrange != -1:
        prev = runtime_config.clean_chunk_kvrange
    elif runtime_config.noise2clean_kvrange:
        prev = runtime_config.noise2clean_kvrange[-1]
    else:
        prev = 8
    ends = np.arange(1, range_num + 1, dtype=np.int64)
    starts = np.clip(ends - prev, 0, None)
    return (starts * ctn).astype(np.int32), (ends * ctn).astype(np.int32)


def self_only_kvrange(n_seg: int, ctn: int) -> Tuple[np.ndarray, np.ndarray]:
    """Each segment attends itself only — the unconditional CFG branch
    (ref: generate_kv_range_for_uncondition, dit_model.py:92-101)."""
    starts = np.arange(n_seg, dtype=np.int64) * ctn
    return starts.astype(np.int32), (starts + ctn).astype(np.int32)

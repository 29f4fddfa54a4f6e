"""ARDF window scheduling and timestep schedules
(ref: inference/pipeline/video_generate.py:139-234, 316-358).

Pure numpy — tiny host-side computations that feed the device steps
(a copy of `magi_tpu.sampling.schedule`).  Worked examples (ref comments video_generate.py:139-161):

  chunk_num=8, window=4:
    clip_start: [0,0,0,0,1,2,3,4,5,6,7]
    clip_end  : [1,2,3,4,5,6,7,8,8,8,8]
    t_start   : [0,0,0,0,0,0,0,0,1,2,3]
    t_end     : [1,2,3,4,4,4,4,4,4,4,4]
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np


def generate_sequences(chunk_num: int, window_size: int, chunk_offset: int):
    """Per-stage chunk windows and noise-level bands
    (ref: video_generate.py:164-180)."""
    start_index = chunk_offset
    end_index = chunk_num + window_size - 1

    clip_start = [max(chunk_offset, i - window_size + 1) for i in range(start_index, end_index)]
    clip_end = [min(chunk_num, i + 1) for i in range(start_index, end_index)]
    t_start = [max(0, i - chunk_num + 1) for i in range(start_index, end_index)]
    t_end = [
        min(window_size, i - chunk_offset + 1) if i - chunk_offset < window_size else window_size
        for i in range(start_index, end_index)
    ]
    return clip_start, clip_end, t_start, t_end


def _sd3_time_shift(x: np.ndarray, shift: float) -> np.ndarray:
    assert shift >= 1.0, "shift should >=1"
    shift_inv = 1.0 / shift
    return shift_inv * x / (1 + (shift_inv - 1) * x)


def init_t(
    num_steps: int,
    shortcut_mode: str = "",
    t_schedule_config: Optional[Dict] = None,
) -> np.ndarray:
    """Timestep schedule, 0=noise -> 1=clean (ref: video_generate.py:183-222).
    Returns [num_steps + 1] float32."""
    t_schedule_config = t_schedule_config or {}
    if num_steps == 12:
        # shortcut-distilled 12-step grid built from a 4-stage base
        base_t = np.linspace(0, 1, 4 + 1, dtype=np.float64) / 4
        accu = np.linspace(0, 1, 4 + 1, dtype=np.float64)
        if shortcut_mode == "16,16,8":
            base_t = base_t[:3]
        else:
            base_t = np.concatenate([base_t[:1], base_t[2:4]])
        t = np.concatenate([base_t + a for a in accu])[: num_steps + 1]
    else:
        t = np.linspace(0, 1, num_steps + 1, dtype=np.float64)

    func = t_schedule_config.get("tSchedulerFunc", "sd3")
    if func == "sd3":
        t = t**2
        t = _sd3_time_shift(t, t_schedule_config.get("shift", 3.0))
    elif func == "square":
        t = t**2
    elif func == "piecewise":
        mask = t < 0.875
        t = np.where(mask, t * (0.5 / 0.875), 0.5 + (t - 0.875) * (0.5 / (1 - 0.875)))
    # else identity
    return t.astype(np.float32)


def init_interval(num_steps: int, shortcut_mode: str = "") -> np.ndarray:
    """Shortcut step-interval pattern (ref: video_generate.py:225-234)."""
    base = np.ones(num_steps, dtype=np.float32)
    if num_steps % 3 == 0:
        rep = num_steps // 3
        if shortcut_mode == "16,16,8":
            base = np.asarray([1, 1, 2] * rep, dtype=np.float32)
        else:
            base = np.asarray([2, 1, 1] * rep, dtype=np.float32)
    return base


def timestep_indices(dpss: int, t_start: int, t_end: int, denoise_idx: int) -> List[int]:
    """Per-chunk t indices, most-denoised chunk first
    (ref: get_timestep, video_generate.py:323-341)."""
    idx = [i * dpss + denoise_idx for i in range(t_start, t_end)]
    idx.reverse()
    return idx


def get_timestep(
    t_total: np.ndarray, dpss: int, t_start: int, t_end: int, denoise_idx: int, clean_t: Optional[float] = None
) -> np.ndarray:
    ts = t_total[timestep_indices(dpss, t_start, t_end, denoise_idx)]
    if clean_t is not None:
        ts = np.concatenate([np.asarray([clean_t], np.float32), ts])
    return ts.astype(np.float32)


def denoise_step_of_each_chunk(
    dpss: int, t_start: int, t_end: int, denoise_idx: int, num_steps: Optional[int] = None
) -> List[int]:
    """(ref: video_generate.py:343-358); num_steps prepended for the clean chunk."""
    steps = [i * dpss + denoise_idx for i in range(t_start, t_end)]
    steps.reverse()
    if num_steps is not None:
        steps = [num_steps] + steps
    return steps


def distill_dt_factor(num_steps: int, distill_interval: float) -> float:
    """Additive distill Δt embedding scale (ref: dit_model.py:176-185)."""
    distill_dt_scalar = 2.0
    if num_steps == 12:
        base_chunk_step = 4.0
        return base_chunk_step / float(distill_interval) * distill_dt_scalar
    return num_steps / 4.0 * distill_dt_scalar

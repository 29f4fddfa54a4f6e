"""The ARDF walk's schedule, frozen for the benchmark: which chunks a denoise
step covers, at which timesteps, over which kv ranges, and with which
segments its forwards run (one under single-branch CFG; three under
three-branch CFG, with each denoised chunk's guidance scales).  The work
counts (`benchmark.work`) and the plain reference (`benchmark.reference`)
read it; nothing here imports the program.  It is a copy of the program's
plain numpy arithmetic (`sampling/schedule.py`, `sampling/kv_ranges.py` and
the text-to-video part of `ArdfSampler._plan` and `ArdfSampler._cfg_scales`),
kept here so that a change to the program cannot move the yardstick.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np


def generate_sequences(chunk_num: int, window_size: int) -> Tuple[list, list, list, list]:
    """Per stage: first and end chunk of the window, and its noise-level band."""
    end_index = chunk_num + window_size - 1
    clip_start = [max(0, i - window_size + 1) for i in range(end_index)]
    clip_end = [min(chunk_num, i + 1) for i in range(end_index)]
    t_start = [max(0, i - chunk_num + 1) for i in range(end_index)]
    t_end = [min(window_size, i + 1) for i in range(end_index)]
    return clip_start, clip_end, t_start, t_end


def init_t(num_steps: int) -> np.ndarray:
    """The sd3-shifted (shift 3) square schedule, 0 = noise -> 1 = clean: [num_steps + 1] f32."""
    if num_steps == 12:
        raise NotImplementedError("the 12-step shortcut grid is not in the benchmark's cells")
    t = np.linspace(0, 1, num_steps + 1, dtype=np.float64) ** 2
    shift_inv = 1.0 / 3.0
    t = shift_inv * t / (1 + (shift_inv - 1) * t)
    return t.astype(np.float32)


def get_timestep(t_total: np.ndarray, dpss: int, t_start: int, t_end: int, didx: int,
                 clean_t: Optional[float] = None) -> np.ndarray:
    idx = [i * dpss + didx for i in range(t_start, t_end)][::-1]
    ts = t_total[idx]
    if clean_t is not None:
        ts = np.concatenate([np.asarray([clean_t], np.float32), ts])
    return ts.astype(np.float32)


def denoise_steps_of_chunks(dpss: int, t_start: int, t_end: int, didx: int, num_steps: Optional[int]) -> List[int]:
    steps = [i * dpss + didx for i in range(t_start, t_end)][::-1]
    return ([num_steps] if num_steps is not None else []) + steps


def distill_dt_factor(num_steps: int) -> float:
    """The distill model's step-size embedding input (num_steps != 12)."""
    return num_steps / 4.0 * 2.0


def cfg_scales(rc: dict, t: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Each chunk's (prev_chunk_scale, text_scale), looked up by its timestep
    in `cfg_t_range` (the range's edges moved down by 1e-7)."""
    rng = np.asarray(rc["cfg_t_range"], np.float32) - 1e-7
    idx = np.searchsorted(rng, np.asarray(t, np.float32)) - 1
    if idx.min() < 0 or idx.max() >= len(rc["prev_chunk_scales"]):
        raise ValueError(f"timesteps {t} fall outside cfg_t_range {rc['cfg_t_range']}")
    return np.asarray(rc["prev_chunk_scales"], np.float32)[idx], np.asarray(rc["text_scales"], np.float32)[idx]


def kv_chunk_ranges(noise2clean: List[int], clean_chunk_kvrange: int, sp: int, steps_of_chunks: List[int],
                    num_steps: int) -> List[Tuple[int, int]]:
    """Segment j of a window at chunk `sp` attends chunks [start, end): the
    noise2clean ranges (noisier chunks see fewer earlier chunks), or every
    earlier chunk without them."""
    out = []
    for j, cur in enumerate(steps_of_chunks):
        end = sp + j + 1
        if not noise2clean:
            out.append((0, end))
            continue
        dpss = num_steps // len(noise2clean)
        clean = noise2clean[-1] if clean_chunk_kvrange == -1 else clean_chunk_kvrange
        span = clean if cur == num_steps else noise2clean[cur // dpss]
        out.append((max(0, end - span), end))
    return out


@dataclasses.dataclass(frozen=True)
class Segment:
    """One segment of a step's forward: the latent chunk it reads (`src`), its
    position on the time axis (`pos`, in chunks: rope offset and kv token
    base), its timestep, whether it takes the request's caption or the null
    one, and the chunk range [kv[0], kv[1]) its self-attention reads."""

    src: int
    pos: int
    t: float
    text: bool
    kv: Tuple[int, int]


@dataclasses.dataclass(frozen=True)
class Step:
    """A denoise step of a text-to-video walk: the chunks it denoises [c_start,
    c_end), its forward's segments (the window, the leading clean chunk when
    `extra`, the ride-along copy when `nearly`), the Euler step of each
    denoised chunk, and the chunks whose keys and values it reads from the
    cache (written by an earlier step).

    Under three-branch CFG `segments` are the text forward's (1), and
    `scales` holds each denoised chunk's (prev_chunk_scale, text_scale) p
    and s: its velocity is (1 - p) u + (p - s) c2 + s c1 from the outputs
    c1, c2, u of the step's three `forwards`.  `scales` is empty under
    single-branch CFG."""

    index: int
    c_start: int
    c_end: int
    sp: int
    extra: bool
    nearly: bool
    segments: Tuple[Segment, ...]
    dt: Tuple[float, ...]
    cached: Tuple[int, ...]
    scales: Tuple[Tuple[float, float], ...] = ()

    @property
    def n_den(self) -> int:
        return self.c_end - self.c_start

    @property
    def lo(self) -> int:
        """The first chunk the step reads: its window's, or a cached one."""
        return min(self.cached + (self.sp,))

    @property
    def forwards(self) -> Tuple[Tuple[Tuple[Segment, ...], bool, bool], ...]:
        """The step's forwards, each its segments, its caption dropout
        (which null-caption row feeds adaLN) and whether it writes the
        cache.  Under three-branch CFG: (1) text, `segments`; (2) the same
        segments under the null caption, which writes the cache; (3)
        uncond, the denoised chunks alone, each at rope position 0 and
        attending only itself (its `kv` the slot it fills in that forward,
        counted from 0), reading no cache."""
        if not self.scales:
            return ((self.segments, False, True),)
        null = tuple(dataclasses.replace(s, text=False) for s in self.segments)
        uncond = tuple(Segment(src=s.src, pos=0, t=s.t, text=False, kv=(j, j + 1))
                       for j, s in enumerate(self.segments[int(self.extra):]))
        return ((self.segments, False, False), (null, True, True), (uncond, True, False))


def total_steps(chunk_num: int, num_steps: int, window: int) -> int:
    return num_steps // window * (chunk_num + window - 1)


def plan(rc: dict, ec: dict, chunk_num: int, step: int) -> Step:
    """Step `step` of a single-branch (cfg_number 1) or three-branch
    (cfg_number 3) text-to-video walk of `chunk_num` chunks under the
    runtime and engine config dicts."""
    if rc["cfg_number"] not in (1, 3):
        raise NotImplementedError(f"cfg_number {rc['cfg_number']}: the benchmark walks single- or three-branch CFG")
    cfg3 = rc["cfg_number"] == 3
    num_steps, window = rc["num_steps"], rc["window_size"]
    dpss = num_steps // window
    stage, didx = divmod(step, dpss)
    cs, ce, ts, te = (s[stage] for s in generate_sequences(chunk_num, window))
    extra = cs > 0 and didx == 0
    sp = cs - int(extra)
    t_total = init_t(num_steps)
    tvec = get_timestep(t_total, dpss, ts, te, didx, clean_t=rc["clean_t"] if extra else None)
    soc = denoise_steps_of_chunks(dpss, ts, te, didx, num_steps if extra else None)
    ranges = kv_chunk_ranges(rc["noise2clean_kvrange"], rc["clean_chunk_kvrange"], sp, soc, num_steps)
    dt = get_timestep(t_total, dpss, ts, te, didx + 1) - get_timestep(t_total, dpss, ts, te, didx)
    # the ride-along copy is the single-branch walk's alone
    nearly = not cfg3 and float(tvec[int(extra)]) > ec["distill_nearly_clean_chunk_threshold"]
    segs = [Segment(src=sp + j, pos=sp + j, t=float(tvec[j]), text=not (extra and j == 0), kv=ranges[j])
            for j in range(len(tvec))]
    if nearly:
        # the first denoised chunk again, text only, attending itself alone,
        # at the position after the window; never written to the cache
        first = segs[int(extra)]
        pos = sp + len(segs)
        segs.append(Segment(src=first.src, pos=pos, t=first.t, text=True, kv=(pos, pos + 1)))
    lo = min(s.kv[0] for s in segs)
    scales = ()
    if cfg3:
        ps, ts = cfg_scales(rc, tvec[int(extra):])
        scales = tuple((float(a), float(b)) for a, b in zip(ps, ts))
    return Step(index=step, c_start=cs, c_end=ce, sp=sp, extra=extra, nearly=nearly, segments=tuple(segs),
                dt=tuple(float(x) for x in dt.astype(np.float32)), cached=tuple(range(lo, sp)), scales=scales)

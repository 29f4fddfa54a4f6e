"""ARDF sample transport: the chunk-wise autoregressive denoising walk (the
port of `magi_tpu.sampling.transport`, main path).

The host loop does the scheduling arithmetic (windows, timesteps, kv
ranges, CFG scales: small numpy); each denoise step runs the three CFG
forwards of the DiT eagerly on the device, combines them, Euler-integrates
and writes the window back into the latent state in place.

This slice covers the 3-branch CFG walk without packing
(`pack_uncond = False`), with the KV cache in device memory, including
the sliding cache window that `kv_offload` selects under noise2clean kv
ranges.  Prefix video (i2v/v2v), the single-branch distill/quant step and
host KV offload are later slices and raise `NotImplementedError`.
"""

from __future__ import annotations

import dataclasses
import time
from collections import Counter
from typing import Generator, Optional, Tuple

import numpy as np
import torch

from magi_tpu_torch.core.config import MagiConfig
from magi_tpu_torch.core.dataclasses import ForwardMeta, SegmentAttnSpec
from magi_tpu_torch.core.utils import resolve_device, round_up
from magi_tpu_torch.models.dit.model import dit_forward, init_kv_cache
from magi_tpu_torch.sampling import kv_ranges as kvr
from magi_tpu_torch.sampling import schedule as sched


@dataclasses.dataclass
class InferenceInput:
    """Pre-assembled conditioning for one generation request."""

    caption_embs: torch.Tensor  # [n_chunks, L, caption_channels] text per chunk
    caption_lens: np.ndarray  # [n_chunks] valid caption tokens (prefix mask)
    null_emb: torch.Tensor  # [L, caption_channels] negative caption slab
    null_len: int  # valid tokens of the null slab
    latent_size: Tuple[int, int, int, int]  # (C, T, H, W)
    num_steps: int
    chunk_num: int
    has_text: bool  # False -> even the text branch uses null captions
    prefix_video: Optional[torch.Tensor] = None  # [C, T_pre, H, W] latent
    prev_chunks_scale: float = 0.7


def _meta(n_seg, ctn, HP, WP, slice_point, kv_start, kv_end, y_lens, *, update, use_cache, device,
          extra=False, distill_nearly=False) -> ForwardMeta:
    def i32(a):
        return torch.as_tensor(np.asarray(a, np.int32), device=device)

    return ForwardMeta(
        n_segments=n_seg,
        seg_len=ctn,
        H=HP,
        W=WP,
        T_total=0,
        update_kv_cache=update,
        use_kv_cache=use_cache,
        distill_nearly_clean_chunk=distill_nearly,
        fwd_extra_1st_chunk=extra,
        slice_point=int(slice_point),
        self_attn=SegmentAttnSpec(kv_start=i32(kv_start), kv_end=i32(kv_end)),
        y_lens=i32(y_lens),
    )


class ArdfSampler:
    """Drives chunk-wise autoregressive denoising for one request.

    `noise` (optional, [C, T, H, W]) replaces the initial latent noise that
    `generator` would draw, so a test can give this walk and the JAX
    package's the same start."""

    def __init__(self, config: MagiConfig, params, inp: InferenceInput, generator: Optional[torch.Generator] = None,
                 *, noise: Optional[torch.Tensor] = None, device=None):
        self.config = config
        self.params = params
        self.inp = inp
        self.device = resolve_device(device)
        mc, rc, ec = config.model_config, config.runtime_config, config.engine_config
        if rc.cfg_number != 3:
            raise NotImplementedError("the single-branch (distill/quant) walk is ROADMAP queue 1 item 10")
        if ec.pack_uncond:
            raise NotImplementedError("pack_uncond (2-forward CFG) is not ported; this slice runs 3 forwards")
        if inp.prefix_video is not None:
            raise NotImplementedError("prefix video (i2v/v2v) is ROADMAP queue 1 item 10")
        if ec.kv_offload and not rc.noise2clean_kvrange:
            raise NotImplementedError("host KV offload is ROADMAP queue 1 item 13")

        C, T, H, W = inp.latent_size
        self.cw = rc.chunk_width
        self.window = rc.window_size
        self.HP, self.WP = H // mc.patch_size, W // mc.patch_size
        self.chunk_patches = self.cw // mc.t_patch_size
        self.ctn = self.chunk_patches * self.HP * self.WP
        self.num_steps = inp.num_steps
        self.chunk_num = inp.chunk_num
        self.L = inp.caption_embs.shape[1]

        self.t_total = sched.init_t(inp.num_steps, shortcut_mode=ec.shortcut_mode)

        if noise is not None:
            if tuple(noise.shape) != tuple(inp.latent_size):
                raise ValueError(f"noise shape {tuple(noise.shape)} != latent size {inp.latent_size}")
            self.xs = noise.to(device=self.device, dtype=torch.float32).clone()
        else:
            self.xs = torch.randn(inp.latent_size, generator=generator, device=self.device, dtype=torch.float32)

        # noise2clean kv ranges bound the attended span, so kv_offload keeps
        # a sliding cache window that rolls forward (O(1) memory in length)
        if ec.kv_offload:
            span = max(rc.noise2clean_kvrange)
            if rc.clean_chunk_kvrange != -1:
                span = max(span, rc.clean_chunk_kvrange)
            self.cache_chunks = min(self.chunk_num, span + self.window + 1)
        else:
            self.cache_chunks = self.chunk_num
        self.cache_base = 0  # chunk index of cache slot 0
        self.counts: Counter = Counter()
        self.cache = init_kv_cache(config, round_up(self.cache_chunks * self.ctn, 1024), self.device)
        self.chunk_offset = 0
        self.step_seconds: list = []  # host wall time of each denoise step, device work included

        dev = self.device
        self._null_emb = inp.null_emb.to(dev)
        if inp.has_text:
            self._text_embs = inp.caption_embs.to(dev)
        else:
            self._text_embs = self._null_emb[None].expand(inp.caption_embs.shape).contiguous()
        cl = np.asarray(inp.caption_lens, np.int32)
        self._lens_eff = cl if inp.has_text else np.full_like(cl, inp.null_len)

    # ----- per-step host arithmetic -------------------------------------

    def _status(self, step: int):
        dpss = self.num_steps // self.window
        stage, didx = divmod(step, dpss)
        cs_s, ce_s, ts_s, te_s = sched.generate_sequences(self.chunk_num, self.window, self.chunk_offset)
        return dpss, didx, cs_s[stage], ce_s[stage], ts_s[stage], te_s[stage]

    def total_forward_steps(self) -> int:
        dpss = self.num_steps // self.window
        return dpss * (self.chunk_num + self.window - 1 - self.chunk_offset)

    def _cfg_scales(self, cfg_t: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """Per-chunk CFG scales via t-range lookup."""
        rc = self.config.runtime_config
        rng = np.asarray(rc.cfg_t_range, np.float32) - 1e-7
        idx = np.searchsorted(rng, cfg_t) - 1
        if idx.min() < 0 or idx.max() >= len(rc.prev_chunk_scales):
            raise ValueError(f"timesteps {cfg_t} fall outside cfg_t_range {rc.cfg_t_range}")
        return (
            np.asarray(rc.prev_chunk_scales, np.float32)[idx],
            np.asarray(rc.text_scales, np.float32)[idx],
        )

    # ----- the walk -------------------------------------------------------

    def walk(self) -> Generator[Tuple[int, torch.Tensor], None, None]:
        """Yields (chunk_idx, clean latent [C, cw, H, W] on the device) as
        chunks finish."""
        for step in range(self.total_forward_steps()):
            t0 = time.perf_counter()
            emitted = self.do_step(step)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            self.step_seconds.append(time.perf_counter() - t0)
            if emitted is not None:
                yield emitted

    def _plan(self, step: int) -> dict:
        """Pure host arithmetic for one step: schedule, ranges, flags."""
        rc = self.config.runtime_config
        dpss, didx, c_start, c_end, t_start, t_end = self._status(step)
        n_den = c_end - c_start
        extra = bool(c_start > self.chunk_offset and didx == 0)
        sp = c_start - int(extra)
        n_seg = n_den + int(extra)

        tvec = sched.get_timestep(
            self.t_total, dpss, t_start, t_end, didx, clean_t=rc.clean_t if extra else None
        )
        steps_of_chunks = sched.denoise_step_of_each_chunk(
            dpss, t_start, t_end, didx, num_steps=self.num_steps if extra else None
        )
        kv_start, kv_end = kvr.denoising_kvrange(rc, sp, n_seg, steps_of_chunks, self.num_steps, self.ctn)
        t_before = sched.get_timestep(self.t_total, dpss, t_start, t_end, didx)
        t_after = sched.get_timestep(self.t_total, dpss, t_start, t_end, didx + 1)
        dt = (t_after - t_before).astype(np.float32)
        return dict(
            didx=didx, c_start=c_start, c_end=c_end, n_den=n_den, extra=extra, sp=sp, n_seg=n_seg,
            tvec=tvec, kv_start=kv_start, kv_end=kv_end, dt=dt, y_lens_win=self._lens_eff[c_start:c_end],
        )

    def do_step(self, step: int) -> Optional[Tuple[int, torch.Tensor]]:
        """Run one denoise step; returns (chunk_idx, latent) if a chunk finished."""
        p = self._plan(step)
        c_start, c_end, n_den, extra, sp, n_seg = (
            p["c_start"], p["c_end"], p["n_den"], p["extra"], p["sp"], p["n_seg"]
        )

        # slide the cache window forward if this step would overflow it
        new_base = max(0, sp + n_seg - self.cache_chunks)
        if new_base > self.cache_base:
            shift = new_base - self.cache_base
            self.cache = torch.roll(self.cache, -shift * self.ctn, dims=3)
            self.cache_base = new_base
        kv_start_r = p["kv_start"] - self.cache_base * self.ctn
        kv_end_r = p["kv_end"] - self.cache_base * self.ctn
        if kv_start_r.min() < 0:
            raise RuntimeError(
                f"kv range {p['kv_start'].min()} fell behind the sliding cache window (base {self.cache_base})"
            )

        ps, ts_ = self._cfg_scales(p["tvec"][-n_den:])
        self.xs, self.cache = _cfg3_step(
            self.config, self.params, self.xs, self.cache, sp, sp - self.cache_base, self._text_embs,
            p["y_lens_win"], self._null_emb, self.inp.null_len, p["tvec"], kv_start_r, kv_end_r, p["dt"],
            ps, ts_, n_den=n_den, extra=extra,
        )

        for ci in range(c_start, c_end):
            self.counts[ci] += 1
        if self.counts[c_start] == self.num_steps:
            return c_start - self.chunk_offset, self._emit(c_start)
        return None

    def _emit(self, chunk_idx: int) -> torch.Tensor:
        lo, hi = chunk_idx * self.cw, (chunk_idx + 1) * self.cw
        return self.xs[:, lo:hi].clone()


# ---------------------------------------------------------------------------
# device steps
# ---------------------------------------------------------------------------


def _slice_window(xs, sp, n_seg, cw):
    return xs[:, sp * cw : (sp + n_seg) * cw]


def _build_y(caption_embs, null_emb, null_len, y_lens_win, sp, extra, n_den):
    """Per-segment captions: an optional leading clean chunk gets the null caption."""
    c_start = sp + (1 if extra else 0)
    y_win = caption_embs[c_start : c_start + n_den]
    if extra:
        return (torch.cat([null_emb[None], y_win], dim=0),
                np.concatenate([np.asarray([null_len], np.int32), y_lens_win]).astype(np.int32))
    return y_win, np.asarray(y_lens_win, np.int32)


def _integrate_and_store(xs, x_chunk_den, velocity, dt, c_start, cw, n_den):
    """Per-chunk Euler step x += v*dt, written back into the latent state (in place)."""
    C, Tw, H, W = x_chunk_den.shape
    v = velocity.reshape(C, n_den, cw, H, W)
    x = x_chunk_den.reshape(C, n_den, cw, H, W) + v * dt[None, :, None, None, None]
    xs[:, c_start * cw : c_start * cw + Tw] = x.reshape(C, Tw, H, W)
    return xs


def _cfg3_step(config, params, xs, cache, sp, cache_sp, caption_embs, y_lens_win, null_emb, null_len, tvec,
               kv_start, kv_end, dt, ps, ts_, *, n_den: int, extra: bool):
    """One denoise step with 3-branch CFG: (1) text + previous chunks,
    (3) unconditional (self-only ranges, fresh positions, no cache),
    (2) null caption + previous chunks, which writes the cache."""
    mc, rc = config.model_config, config.runtime_config
    dev = xs.device
    cw = rc.chunk_width
    n_seg = n_den + int(extra)
    HP = xs.shape[2] // mc.patch_size
    WP = xs.shape[3] // mc.patch_size
    chunk_patches = cw // mc.t_patch_size
    ctn = chunk_patches * HP * WP
    L = caption_embs.shape[1]

    x_chunk = _slice_window(xs, sp, n_seg, cw)
    t_vec = torch.as_tensor(tvec, dtype=torch.float32, device=dev)
    y_text, lens_text = _build_y(caption_embs, null_emb, null_len, y_lens_win, sp, extra, n_den)
    y_null = null_emb[None].expand(n_seg, L, null_emb.shape[-1])
    lens_null = np.full((n_seg,), null_len, np.int32)
    t_off = (sp + torch.arange(n_seg, dtype=torch.int32, device=dev)) * chunk_patches
    dw = n_den * cw

    def meta(n, slice_point, ks, ke, lens, update, use_cache):
        return _meta(n, ctn, HP, WP, slice_point, ks, ke, lens, update=update, use_cache=use_cache,
                     device=dev, extra=extra and use_cache)

    # branch 1: conditioned on previous chunks + text, no cache write
    v1, _ = dit_forward(params, config, x_chunk, t_vec, y_text, False, cache,
                        meta(n_seg, cache_sp, kv_start, kv_end, lens_text, False, True), t_off)
    # branch 3: unconditional
    u_start, u_end = kvr.self_only_kvrange(n_den, ctn)
    v3, _ = dit_forward(params, config, x_chunk[:, -dw:], t_vec[-n_den:], y_null[:n_den], True, None,
                        meta(n_den, 0, u_start, u_end, lens_null[:n_den], False, False),
                        torch.zeros(n_den, dtype=torch.int32, device=dev))
    # branch 2: conditioned on previous chunks, null caption; writes the cache
    v2, cache = dit_forward(params, config, x_chunk, t_vec, y_null, True, cache,
                            meta(n_seg, cache_sp, kv_start, kv_end, lens_null, True, True), t_off)

    def per_chunk(o):
        return o.reshape(o.shape[0], n_den, cw, *o.shape[2:])

    c1 = per_chunk(v1[:, -dw:])
    c2 = per_chunk(v2[:, -dw:])
    u = per_chunk(v3)
    scale_p = torch.as_tensor(ps, device=dev)[None, :, None, None, None]
    scale_t = torch.as_tensor(ts_, device=dev)[None, :, None, None, None]
    velocity = (1 - scale_p) * u + (scale_p - scale_t) * c2 + scale_t * c1
    velocity = velocity.reshape(velocity.shape[0], dw, *velocity.shape[3:])
    dt_t = torch.as_tensor(dt, dtype=torch.float32, device=dev)
    xs = _integrate_and_store(xs, x_chunk[:, -dw:], velocity, dt_t, sp + int(extra), cw, n_den)
    return xs, cache

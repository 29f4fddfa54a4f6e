"""ARDF sample transport: the chunk-wise autoregressive denoising walk (the
port of `magi_tpu.sampling.transport`).

The host loop does the scheduling arithmetic (windows, timesteps, kv
ranges, CFG scales: small numpy); each denoise step runs the CFG forwards
of the DiT eagerly on the device, combines them, Euler-integrates and
writes the window back into the latent state in place.

It covers the 3-branch CFG walk, with three forwards a step or, under
`engine_config.pack_uncond`, two (the uncond segments packed into the
text forward), and the single-branch (distill / quantized) walk with its
nearly-clean ride-along chunk.  The KV cache lives in device memory (the
bf16 tensor, or the int8 {kv, scale} dict of int8 attention), with a
sliding cache window when `kv_offload` is set under noise2clean kv ranges;
`kv_offload` under the default kv ranges keeps the whole cache in pinned
host memory instead (`HostKVCache`) and streams one layer's slab at a
time to the device around `dit_layer_step`.  A prefix video (i2v, v2v) is
pasted over the window's frames it covers at every step, the chunks it
covers whole run as clean (t = 1), and those chunks' KV is written into
the cache by one warm-up forward before the first step.  `walk_many`
round-robins several requests step by step; `sampling.batched` walks them
in lockstep.
"""

from __future__ import annotations

import dataclasses
import functools
import time
from collections import Counter, deque
from typing import Callable, Generator, Optional, Sequence, Tuple

import numpy as np
import torch

from magi_tpu_torch.core.config import MagiConfig
from magi_tpu_torch.core.dataclasses import ForwardMeta, SegmentAttnSpec
from magi_tpu_torch.core.utils import resolve_device, round_up
from magi_tpu_torch.models.dit.model import (
    attn_int8_store,
    dit_epilogue,
    dit_forward,
    dit_layer_step,
    dit_prologue,
    init_kv_cache,
    kv_cache_shape,
)
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


# A cache-touching DiT forward of one request: (x, t, y, caption_dropout,
# meta, t_offsets, distill_factor=None) -> velocity.  The resident cache's
# is `dit_forward` on it; the host-streamed cache's is
# `ArdfSampler._streamed_forward`.
Forward = Callable[..., torch.Tensor]


def _resident_forward(params, config: MagiConfig, cache) -> Forward:
    def forward(x, t, y, caption_dropout, meta, t_offsets, distill_factor=None):
        return dit_forward(params, config, x, t, y, caption_dropout, cache, meta, t_offsets,
                           distill_factor=distill_factor)[0]

    return forward


def _leaf_map(tree, fn):
    return {k: fn(v) for k, v in tree.items()} if isinstance(tree, dict) else fn(tree)


class ArdfSampler:
    """Drives chunk-wise autoregressive denoising for one request.

    `noise` (optional, [C, T, H, W]) replaces the initial latent noise that
    `generator` would draw, so a test can give this walk and the JAX
    package's the same start."""

    # token axis of the cache leaves ([L, 2, hk, tok, hd], scale [L, 2, hk, tok])
    _token_axis = 3

    def __init__(self, config: MagiConfig, params, inp: InferenceInput, generator: Optional[torch.Generator] = None,
                 *, noise: Optional[torch.Tensor] = None, device=None):
        self.config = config
        self.params = params
        self.inp = inp
        self.device = resolve_device(device)
        mc, rc, ec = config.model_config, config.runtime_config, config.engine_config
        if rc.cfg_number not in (1, 3):
            raise NotImplementedError(f"cfg_number={rc.cfg_number}")

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
        self.interval = sched.init_interval(inp.num_steps, shortcut_mode=ec.shortcut_mode)

        if noise is not None:
            if tuple(noise.shape) != tuple(inp.latent_size):
                raise ValueError(f"noise shape {tuple(noise.shape)} != latent size {inp.latent_size}")
            self.xs = noise.to(device=self.device, dtype=torch.float32).clone()
        else:
            self.xs = torch.randn(inp.latent_size, generator=generator, device=self.device, dtype=torch.float32)

        # KV memory, two regimes under kv_offload: noise2clean kv ranges
        # bound the attended span, so the device keeps a sliding cache
        # window that rolls forward (O(1) memory in length; it holds at
        # least the prefix chunks the warm-up writes); the default ranges
        # attend every earlier chunk, so the whole cache lives in host
        # memory and streams to the device one layer at a time (host mode)
        offset_chunks = 0 if inp.prefix_video is None else inp.prefix_video.shape[1] // self.cw
        self.host_mode = bool(ec.kv_offload and not rc.noise2clean_kvrange)
        if ec.kv_offload and rc.noise2clean_kvrange:
            span = max(rc.noise2clean_kvrange)
            if rc.clean_chunk_kvrange != -1:
                span = max(span, rc.clean_chunk_kvrange)
            self.cache_chunks = min(self.chunk_num, max(span + self.window + 1, offset_chunks))
        else:
            self.cache_chunks = self.chunk_num
        self.cache_base = 0  # chunk index of cache slot 0
        self.counts: Counter = Counter()
        self.cache_tokens = round_up(self.cache_chunks * self.ctn, 1024)
        if self.host_mode:
            self.cache = None
            self.host_cache = HostKVCache(config, self.cache_tokens, self.device)
        else:
            self.cache = init_kv_cache(config, self.cache_tokens, self.device)
            self.host_cache = None
        # the prefix video's latent, zero-padded to the chunk grid
        self.chunk_offset = offset_chunks
        self.prefix_buf, self.prefix_len = None, 0
        if inp.prefix_video is not None:
            self.prefix_buf = self._padded_prefix(inp.prefix_video)
            self.prefix_len = int(inp.prefix_video.shape[1])
        self._warmed = False
        self.step_seconds: list = []  # host wall time of each denoise step, device work included

        dev = self.device
        self._null_emb = inp.null_emb.to(dev)
        self._text_embs, self._lens_eff = self._captions(inp)

    def _padded_prefix(self, prefix_video: torch.Tensor) -> torch.Tensor:
        pv = prefix_video.to(device=self.device, dtype=torch.float32)
        return torch.nn.functional.pad(pv, (0, 0, 0, 0, 0, self.chunk_num * self.cw - pv.shape[1]))

    def _captions(self, inp: InferenceInput) -> Tuple[torch.Tensor, np.ndarray]:
        """The text branch's caption slabs on the device and their valid
        lengths: the null caption's when the request has no text."""
        cl = np.asarray(inp.caption_lens, np.int32)
        if inp.has_text:
            return inp.caption_embs.to(self.device), cl
        null = inp.null_emb.to(self.device)
        return null[None].expand(inp.caption_embs.shape).contiguous(), np.full_like(cl, inp.null_len)

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
        """Yields (chunk_idx, clean latent [C, <=cw, H, W] on the device) as
        chunks finish; chunk_idx counts from the first chunk after the
        prefix chunks."""
        self.prepare()
        for step in range(self.total_forward_steps()):
            emitted = self.timed_step(step)
            if emitted is not None:
                yield emitted

    def timed_step(self, step: int) -> Optional[Tuple[int, torch.Tensor]]:
        """`do_step`, then wait for the current stream's work (other streams,
        such as a decode worker's, run on) and log the host seconds."""
        t0 = time.perf_counter()
        emitted = self.do_step(step)
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()
        self.step_seconds.append(time.perf_counter() - t0)
        return emitted

    def prepare(self) -> None:
        """Write the prefix chunks' KV into the cache, once."""
        if self.chunk_offset > 0 and not self._warmed:
            self._run_prefix_warmup()
            self._warmed = True

    def _forward(self, cache) -> Forward:
        """The cache-touching forward of a request whose cache is `cache`: a
        `HostKVCache` in host mode, else the device cache."""
        if self.host_mode:
            return functools.partial(self._streamed_forward, cache)
        return _resident_forward(self.params, self.config, cache)

    def _request_cache(self, r: int):
        return self.host_cache if self.host_mode else self.cache

    def _warmup_args(self):
        rc, ec = self.config.runtime_config, self.config.engine_config
        n = self.chunk_offset
        kv_s, kv_e = kvr.prefix_kvrange(rc, n, self.ctn)
        dfac = sched.distill_dt_factor(self.num_steps, float(self.interval[0])) if ec.distill else None
        return (self._null_emb, self.inp.null_len, kv_s, kv_e, rc.clean_t, dfac), n

    def _run_prefix_warmup(self) -> None:
        """One forward of the clean prefix chunks that writes their KV into
        the cache."""
        args, n = self._warmup_args()
        _prefix_warmup_step(self.config, self._forward(self._request_cache(0)), self.prefix_buf[:, : n * self.cw],
                            *args, n_chunks=n)

    def _plan(self, step: int) -> dict:
        """Pure host arithmetic for one step: schedule, ranges, flags."""
        rc, ec = self.config.runtime_config, self.config.engine_config
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
        # the chunks of the window that the prefix covers whole run clean
        use_prefix = self.prefix_len > 0
        tvec_padded = tvec.copy()
        if use_prefix:
            tvec_padded[: max(self.prefix_len - sp * self.cw, 0) // self.cw] = 1.0
        # single-branch walk: the first denoised chunk, once nearly clean,
        # rides along as a text-only copy
        distill_nearly = (rc.cfg_number == 1
                          and float(tvec_padded[int(extra)]) > ec.distill_nearly_clean_chunk_threshold)
        return dict(
            didx=didx, c_start=c_start, c_end=c_end, n_den=n_den, extra=extra, sp=sp, n_seg=n_seg,
            tvec=tvec, tvec_padded=tvec_padded, kv_start=kv_start, kv_end=kv_end, dt=dt,
            use_prefix=use_prefix, distill_nearly=distill_nearly,
        )

    def do_step(self, step: int) -> Optional[Tuple[int, torch.Tensor]]:
        """Run one denoise step; returns (chunk_idx, latent) if a chunk finished."""
        p = self._plan(step)
        c_start, c_end, sp, n_seg = p["c_start"], p["c_end"], p["sp"], p["n_seg"]

        # slide the cache window forward if this step would overflow it
        new_base = max(0, sp + n_seg - self.cache_chunks)
        if new_base > self.cache_base:
            shift = (new_base - self.cache_base) * self.ctn
            self.cache = _leaf_map(self.cache, lambda c: torch.roll(c, -shift, dims=self._token_axis))
            self.cache_base = new_base
        kv_start_r = p["kv_start"] - self.cache_base * self.ctn
        kv_end_r = p["kv_end"] - self.cache_base * self.ctn
        if kv_start_r.min() < 0:
            raise RuntimeError(
                f"kv range {p['kv_start'].min()} fell behind the sliding cache window (base {self.cache_base})"
            )
        self._step_requests(p, kv_start_r, kv_end_r)

        for ci in range(c_start, c_end):
            self.counts[ci] += 1
        if self.counts[c_start] == self.num_steps:
            chunk = self._emit(c_start)
            if chunk is not None:
                return c_start - self.chunk_offset, chunk
        return None

    def _step_requests(self, p: dict, kv_start_r, kv_end_r) -> None:
        self._request_step(p, kv_start_r, kv_end_r, self.xs, self._forward(self._request_cache(0)), self._text_embs,
                           self._lens_eff, self.prefix_buf)

    def _request_step(self, p: dict, kv_start_r, kv_end_r, xs, forward: Forward, text_embs, lens_eff,
                      prefix_buf) -> None:
        """One request's denoise step on its state (`xs` and the cache behind
        `forward` are written in place)."""
        ec = self.config.engine_config
        n_den, extra, sp = p["n_den"], p["extra"], p["sp"]
        common = (self.config, self.params, forward, xs, sp, sp - self.cache_base, text_embs,
                  lens_eff[p["c_start"]:p["c_end"]], self._null_emb, self.inp.null_len, p["tvec"], kv_start_r,
                  kv_end_r, p["dt"])
        if self.config.runtime_config.cfg_number == 3:
            ps, ts_ = self._cfg_scales(p["tvec_padded"][-n_den:])
            # the streamed step never packs (as the JAX package's)
            _cfg3_step(*common, ps, ts_, prefix_buf, self.prefix_len, n_den=n_den, extra=extra,
                       use_prefix=p["use_prefix"], pack=ec.pack_uncond and not self.host_mode)
        else:
            dfac = sched.distill_dt_factor(self.num_steps, float(self.interval[p["didx"]])) if ec.distill else None
            _cfg1_step(*common, dfac, self.inp.prev_chunks_scale, prefix_buf, self.prefix_len, n_den=n_den,
                       extra=extra, use_prefix=p["use_prefix"], distill_nearly=p["distill_nearly"])

    def _streamed_forward(self, hc: HostKVCache, x, t, y, caption_dropout, meta: ForwardMeta, t_offsets,
                          distill_factor=None):
        """`dit_forward` with the layer loop here: each layer runs on its
        cache slab as `hc` streams it in (the next layer's upload issued
        before this layer's compute) and, in a forward that writes the
        cache, back out (only the written token range).  No host sync in the
        loop."""
        mc = self.config.model_config
        C, T, H, W = x.shape
        h, condition, y_xattn, sin, cos = dit_prologue(
            self.params, self.config, x, t, y, caption_dropout, meta, t_offsets, distill_factor
        )
        start_tok = meta.slice_point * meta.seg_len
        written = 0
        if meta.update_kv_cache:
            # the distill ride-along chunk is not written
            written = (meta.n_segments - int(meta.distill_nearly_clean_chunk)) * meta.seg_len
        hc.begin(start_tok)
        for idx in range(mc.num_layers):
            cache_l = hc.fetch(idx)
            h = dit_layer_step(self.params, self.config, idx, h, cache_l, condition, y_xattn, sin, cos, meta)
            hc.release(idx, start_tok, start_tok + written)
        return dit_epilogue(self.params, self.config, h, T // mc.t_patch_size, H // mc.patch_size,
                            W // mc.patch_size)

    def _emit(self, chunk_idx: int) -> Optional[torch.Tensor]:
        """The chunk's latent frames after the prefix (None when the prefix
        covers it); an i2v walk (a one-frame prefix) keeps chunk 0 whole.  A
        copy: the next step writes the latent state in place."""
        lo, hi = chunk_idx * self.cw, (chunk_idx + 1) * self.cw
        if self.prefix_len > 0:
            if hi <= self.prefix_len:
                return None
            lo = 0 if chunk_idx == 0 and self.prefix_len == 1 else max(lo, self.prefix_len)
        return self.xs[..., lo:hi, :, :].clone()


# ---------------------------------------------------------------------------
# the host-streamed KV cache
# ---------------------------------------------------------------------------


class HostKVCache:
    """The whole KV cache in host memory, pinned when the device is a card
    (video length bounded by host RAM, not device memory), streamed to the
    device one layer slab at a time through two device slabs.

    `buf` is the cache as the resident one holds it: [L, 2, hk, tok, hd] in
    the parameter dtype, or the dict {kv: int8 [L, 2, hk, tok, hd], scale:
    f32 [L, 2, hk, tok]} when the cache is stored int8.  In memory kv is
    token-major ([L, tok, 2, hk, hd]), so a token range of a layer is one
    contiguous block each way; the slabs are views in the same order, which
    the attention kernels read through their strides.  Scales (small, and
    read with contiguous tokens) move whole.

    On the card one copy stream carries every copy.  A forward calls
    `begin(read_tokens)` (the cache tokens it reads: [0, read_tokens)), then
    for each layer `fetch(l)`, which issues layer l+1's upload into the
    other slab and makes the current stream wait for layer l's by an event,
    and after the layer's compute `release(l, lo, hi)`, which records the
    slab's event and sends the written tokens [lo, hi) back.  The copy
    stream waits on that event before either the write-back or the next
    upload into the slab, and keeps them in issue order, so a write-back
    precedes any later upload of its layer and a slab is never overwritten
    before its write-back is done.  Nothing in the loop waits on the host.
    `buf` holds the last step's writes once the device has synchronized.
    On the CPU the same calls are plain copies."""

    def __init__(self, config: MagiConfig, max_tokens: int, device: torch.device):
        L, two, hk, tok, hd = kv_cache_shape(config, max_tokens)
        self.device = device
        self.num_layers = L
        pin = device.type == "cuda"
        int8 = attn_int8_store(config)
        dtype = torch.int8 if int8 else config.model_config.params_dtype
        self._host_kv = torch.zeros((L, tok, two, hk, hd), dtype=dtype, pin_memory=pin)
        self._host_sc = torch.zeros((L, two, hk, tok), dtype=torch.float32, pin_memory=pin) if int8 else None
        self._slab_kv = [torch.zeros((tok, two, hk, hd), dtype=dtype, device=device) for _ in range(2)]
        self._slab_sc = ([torch.zeros((two, hk, tok), dtype=torch.float32, device=device) for _ in range(2)]
                         if int8 else None)
        self._read = 0
        self.h2d_bytes = 0  # bytes uploaded and written back since construction
        self.d2h_bytes = 0
        if pin:
            self._copy = torch.cuda.Stream(device)
            self._loaded = [torch.cuda.Event(), torch.cuda.Event()]
            self._free = [torch.cuda.Event(), torch.cuda.Event()]
            # the allocator keeps a freed slab until the copy stream is done with it
            for t in self._slab_kv + (self._slab_sc or []):
                t.record_stream(self._copy)

    @staticmethod
    def _logical(kv: torch.Tensor) -> torch.Tensor:
        return kv.movedim(-4, -2)  # [.., tok, 2, hk, hd] -> [.., 2, hk, tok, hd]

    @property
    def buf(self):
        kv = self._logical(self._host_kv)
        return kv if self._host_sc is None else {"kv": kv, "scale": self._host_sc}

    def _slab(self, s: int):
        kv = self._logical(self._slab_kv[s])
        return kv if self._slab_sc is None else {"kv": kv, "scale": self._slab_sc[s]}

    def _upload(self, l: int) -> None:
        s, n = l % 2, self._read
        self._slab_kv[s][:n].copy_(self._host_kv[l, :n], non_blocking=True)
        self.h2d_bytes += self._host_kv[l, :n].nbytes
        if self._slab_sc is not None:
            self._slab_sc[s].copy_(self._host_sc[l], non_blocking=True)
            self.h2d_bytes += self._host_sc[l].nbytes

    def _write_back(self, l: int, lo: int, hi: int) -> None:
        s = l % 2
        self._host_kv[l, lo:hi].copy_(self._slab_kv[s][lo:hi], non_blocking=True)
        self.d2h_bytes += self._host_kv[l, lo:hi].nbytes
        if self._slab_sc is not None:
            self._host_sc[l].copy_(self._slab_sc[s], non_blocking=True)
            self.d2h_bytes += self._host_sc[l].nbytes

    def _issue_upload(self, l: int) -> None:
        if self.device.type != "cuda":
            self._upload(l)
            return
        s = l % 2
        self._copy.wait_event(self._free[s])
        with torch.cuda.stream(self._copy):
            self._upload(l)
        self._loaded[s].record(self._copy)

    def begin(self, read_tokens: int) -> None:
        """Start a forward that reads cache tokens [0, read_tokens): issue
        layer 0's upload."""
        self._read = read_tokens
        self._issue_upload(0)

    def fetch(self, l: int):
        """Layer l's slab (the cache layout's views), ready for the current
        stream; layer l+1's upload is issued first."""
        if l + 1 < self.num_layers:
            self._issue_upload(l + 1)
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).wait_event(self._loaded[l % 2])
        return self._slab(l % 2)

    def release(self, l: int, lo: int, hi: int) -> None:
        """Layer l's compute is issued: write tokens [lo, hi) of its slab
        back to the host (none when lo == hi) and free the slab."""
        if self.device.type != "cuda":
            if hi > lo:
                self._write_back(l, lo, hi)
            return
        s = l % 2
        self._free[s].record(torch.cuda.current_stream(self.device))
        if hi > lo:
            self._copy.wait_event(self._free[s])
            with torch.cuda.stream(self._copy):
                self._write_back(l, lo, hi)


# ---------------------------------------------------------------------------
# several requests
# ---------------------------------------------------------------------------


def walk_many(samplers: Sequence[ArdfSampler]) -> Generator[Tuple[int, int, torch.Tensor], None, None]:
    """Round-robin several requests through their denoise steps, one step
    of each in turn, yielding (request_idx, chunk_idx, latent on the
    device) as chunks finish.  Each step waits only for its own stream
    (`ArdfSampler.timed_step`), so a consumer's decode on another stream
    overlaps the next steps."""
    queue = deque()
    for idx, s in enumerate(samplers):
        s.prepare()
        queue.append((idx, 0))
    while queue:
        idx, step = queue.popleft()
        s = samplers[idx]
        emitted = s.timed_step(step)
        if emitted is not None:
            yield (idx,) + emitted
        if step + 1 < s.total_forward_steps():
            queue.append((idx, step + 1))


# ---------------------------------------------------------------------------
# device steps
# ---------------------------------------------------------------------------


def _slice_window(xs, sp, n_seg, cw):
    return xs[:, sp * cw : (sp + n_seg) * cw]


def _apply_prefix(x_chunk, tvec, prefix_buf, prefix_len, sp, cw, n_seg):
    """The prefix video's latents pasted over the window's frames they
    cover; the chunks they cover whole get t = 1 (clean).  Returns a new
    window (x_chunk, a view of the latent state, is not written) and tvec."""
    C, Tw, H, W = x_chunk.shape
    start_f = sp * cw
    covered = (start_f + torch.arange(Tw, device=x_chunk.device) < prefix_len)[None, :, None, None]
    x_chunk = torch.where(covered, prefix_buf[:, start_f : start_f + Tw], x_chunk)
    tvec = np.where(np.arange(n_seg) < max(prefix_len - start_f, 0) // cw, 1.0, tvec).astype(tvec.dtype)
    return x_chunk, tvec


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


def _cfg3_step(config, params, forward: Forward, xs, sp, cache_sp, caption_embs, y_lens_win, null_emb, null_len,
               tvec, kv_start, kv_end, dt, ps, ts_, prefix_buf, prefix_len, *, n_den: int, extra: bool,
               use_prefix: bool, pack: bool):
    """One denoise step with 3-branch CFG: (1) text + previous chunks,
    (3) unconditional (self-only ranges, fresh positions, no cache),
    (2) null caption + previous chunks, which writes the cache.  `pack`
    runs (1) and (3) as one forward: the uncond segments follow the
    window's with null captions, their own caption dropout, temporal
    offsets from 0 and ranges over their own tokens, which lie past the
    window's in the current source."""
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
    if use_prefix:
        x_chunk, tvec = _apply_prefix(x_chunk, tvec, prefix_buf, prefix_len, sp, cw, n_seg)
    t_vec = torch.as_tensor(tvec, dtype=torch.float32, device=dev)
    y_text, lens_text = _build_y(caption_embs, null_emb, null_len, y_lens_win, sp, extra, n_den)
    y_null = null_emb[None].expand(n_seg, L, null_emb.shape[-1])
    lens_null = np.full((n_seg,), null_len, np.int32)
    t_off = (sp + torch.arange(n_seg, dtype=torch.int32, device=dev)) * chunk_patches
    dw = n_den * cw

    def meta(n, slice_point, ks, ke, lens, update, use_cache):
        return _meta(n, ctn, HP, WP, slice_point, ks, ke, lens, update=update, use_cache=use_cache,
                     device=dev, extra=extra and use_cache)

    if pack:
        # forward A: text branch and uncond segments, no cache write
        u_start = (cache_sp + n_seg) * ctn + np.arange(n_den, dtype=np.int32) * ctn
        dropout = torch.tensor([False] * n_seg + [True] * n_den, device=dev)
        va = forward(torch.cat([x_chunk, x_chunk[:, -dw:]], dim=1), torch.cat([t_vec, t_vec[-n_den:]]),
                     torch.cat([y_text, y_null[:n_den]], dim=0), dropout,
                     meta(n_seg + n_den, cache_sp, np.concatenate([kv_start, u_start]),
                          np.concatenate([kv_end, u_start + ctn]), np.concatenate([lens_text, lens_null[:n_den]]),
                          False, True),
                     torch.cat([t_off, torch.zeros(n_den, dtype=torch.int32, device=dev)]))
        v1, v3 = va[:, : n_seg * cw], va[:, n_seg * cw :]
    else:
        # branch 1: conditioned on previous chunks + text, no cache write
        v1 = forward(x_chunk, t_vec, y_text, False, meta(n_seg, cache_sp, kv_start, kv_end, lens_text, False, True),
                     t_off)
        # branch 3: unconditional
        u_start, u_end = kvr.self_only_kvrange(n_den, ctn)
        v3, _ = dit_forward(params, config, x_chunk[:, -dw:], t_vec[-n_den:], y_null[:n_den], True, None,
                            meta(n_den, 0, u_start, u_end, lens_null[:n_den], False, False),
                            torch.zeros(n_den, dtype=torch.int32, device=dev))
    # branch 2: conditioned on previous chunks, null caption; writes the cache
    v2 = forward(x_chunk, t_vec, y_null, True, meta(n_seg, cache_sp, kv_start, kv_end, lens_null, True, True), t_off)

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
    return _integrate_and_store(xs, x_chunk[:, -dw:], velocity, dt_t, sp + int(extra), cw, n_den)


def _cfg1_step(config, params, forward: Forward, xs, sp, cache_sp, caption_embs, y_lens_win, null_emb, null_len,
               tvec, kv_start, kv_end, dt, distill_factor, prev_chunks_scale, prefix_buf, prefix_len, *, n_den: int,
               extra: bool, use_prefix: bool, distill_nearly: bool):
    """One denoise step with single-branch CFG (the distill and quantized
    models): one forward on text + previous chunks, which writes the cache.
    With `distill_nearly`, a copy of the first denoised chunk rides along as
    one more segment that attends only itself (text-only, never written to
    the cache), and that chunk's velocity is the blend
    prev_chunks_scale * (with previous chunks) + (1 - prev_chunks_scale) *
    (text only)."""
    mc, rc = config.model_config, config.runtime_config
    dev = xs.device
    cw = rc.chunk_width
    n_seg = n_den + int(extra)
    HP = xs.shape[2] // mc.patch_size
    WP = xs.shape[3] // mc.patch_size
    chunk_patches = cw // mc.t_patch_size
    ctn = chunk_patches * HP * WP

    x_chunk = _slice_window(xs, sp, n_seg, cw)
    if use_prefix:
        x_chunk, tvec = _apply_prefix(x_chunk, tvec, prefix_buf, prefix_len, sp, cw, n_seg)
    y_text, lens_text = _build_y(caption_embs, null_emb, null_len, y_lens_win, sp, extra, n_den)
    t_off = (sp + torch.arange(n_seg, dtype=torch.int32, device=dev)) * chunk_patches

    if distill_nearly:
        ss = int(extra)
        x_in = torch.cat([x_chunk, x_chunk[:, ss * cw : (ss + 1) * cw]], dim=1)
        vmax = (cache_sp + n_seg) * ctn
        ks = np.concatenate([kv_start, [vmax]]).astype(np.int32)
        ke = np.concatenate([kv_end, [vmax + ctn]]).astype(np.int32)
        t_in = np.concatenate([tvec, tvec[ss : ss + 1]])
        y_in = torch.cat([y_text, y_text[ss : ss + 1]], dim=0)
        lens = np.concatenate([lens_text, lens_text[ss : ss + 1]])
        t_off = torch.cat([t_off, torch.tensor([(sp + n_seg) * chunk_patches], dtype=torch.int32, device=dev)])
        n_fwd = n_seg + 1
    else:
        x_in, ks, ke, t_in, y_in, lens, n_fwd = x_chunk, kv_start, kv_end, tvec, y_text, lens_text, n_seg

    meta = _meta(n_fwd, ctn, HP, WP, cache_sp, ks, ke, lens, update=True, use_cache=True, device=dev,
                 extra=extra, distill_nearly=distill_nearly)
    out = forward(x_in, torch.as_tensor(t_in, dtype=torch.float32, device=dev), y_in, False, meta, t_off,
                  distill_factor=distill_factor)
    if distill_nearly:
        near_pre_text = out[:, ss * cw : (ss + 1) * cw]
        near_text = out[:, -cw:]
        blended = near_pre_text * prev_chunks_scale + near_text * (1 - prev_chunks_scale)
        out = torch.cat([out[:, : ss * cw], blended, out[:, (ss + 1) * cw : n_seg * cw]], dim=1)

    dw = n_den * cw
    dt_t = torch.as_tensor(dt, dtype=torch.float32, device=dev)
    return _integrate_and_store(xs, x_chunk[:, -dw:], out[:, -dw:], dt_t, sp + int(extra), cw, n_den)


def _prefix_warmup_step(config, forward: Forward, prefix_latent, null_emb, null_len, kv_start, kv_end, clean_t,
                        distill_factor, *, n_chunks: int) -> None:
    """Forward the clean prefix chunks (prefix_latent [C, n_chunks * cw, H,
    W]) once with null captions at t = clean_t; the forward writes their
    KV into the cache."""
    mc, rc = config.model_config, config.runtime_config
    dev = prefix_latent.device
    HP = prefix_latent.shape[2] // mc.patch_size
    WP = prefix_latent.shape[3] // mc.patch_size
    chunk_patches = rc.chunk_width // mc.t_patch_size
    ctn = chunk_patches * HP * WP
    y = null_emb[None].expand(n_chunks, *null_emb.shape)
    lens = np.full((n_chunks,), null_len, np.int32)
    t = torch.full((n_chunks,), float(clean_t), dtype=torch.float32, device=dev)
    t_off = torch.arange(n_chunks, dtype=torch.int32, device=dev) * chunk_patches
    meta = _meta(n_chunks, ctn, HP, WP, 0, kv_start, kv_end, lens, update=True, use_cache=True, device=dev)
    forward(prefix_latent, t, y, True, meta, t_off, distill_factor=distill_factor)

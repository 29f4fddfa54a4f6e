"""ARDF sample transport: the chunk-wise autoregressive denoising walk (the
port of `magi_tpu.sampling.transport`).

The host loop does the scheduling arithmetic (windows, timesteps, kv
ranges, CFG scales: small numpy) and writes each step's values into fixed
device buffers (`StepInputs`: one pinned staging buffer, one non-blocking
copy); the step then runs the CFG forwards of the DiT on the device,
combines them, Euler-integrates and writes the window back into the
latent state in place, reading every step-dependent value from those
buffers.  So a step is a function of its variant alone (`_variant`: the
JAX package's static arguments), and on the card each variant is captured
once in a CUDA graph and replayed (`core.graphs`), the counterpart of the
JAX package's jitted steps (`_jitted_steps`, `_stream_jits`): keyed by the
config's content and the environment the step reads (`_config_key`) and
the variant, captured before the walk (`warm_step_variants`), replayed
from the same buffers.  `ArdfSampler(capture=False)` runs the same steps
eagerly (the yardstick); on the CPU nothing is captured.

It covers the 3-branch CFG walk, with three forwards a step or, under
`engine_config.pack_uncond`, two (the uncond segments packed into the
text forward), and the single-branch (distill / quantized) walk with its
nearly-clean ride-along chunk.  The KV cache lives in device memory (the
bf16 tensor, or the int8 {kv, scale} dict of int8 attention), with a
sliding cache window when `kv_offload` is set under noise2clean kv ranges
(rolled in place); `kv_offload` under the default kv ranges keeps the
whole cache in pinned host memory instead (`HostKVCache`) and streams one
layer's slab at a time to the device around `dit_layer_step` (captured
piece by piece: prologue, each layer, epilogue, with the copies and
events between them on the host).  A prefix video (i2v, v2v) is pasted
over the window's frames it covers at every step, the chunks it covers
whole run as clean (t = 1), and those chunks' KV is written into the
cache by one warm-up forward before the first step.  `walk_many`
round-robins several requests step by step; `sampling.batched` walks them
in lockstep.

On a model-parallel mesh (`parallel.mesh`) each rank walks the same
schedule from the same noise with its shards of the tree and the cache
(`kv_cache_shape` gives the rank's head shard), and its steps are captured
as well, in pieces cut at every collective (`dit_forward`'s mesh path:
the collectives run between the replays, into slots of the workspace's
arena), the counterpart of the JAX package's jitted steps with their
shard_maps inside; `capture=False` walks eagerly there too.  Every rank
captures the same variants in the same order.  `kv_offload` under the
default kv ranges is ignored there with a log line (the cache is already
sharded), as the JAX package ignores it.
"""

from __future__ import annotations

import dataclasses
import functools
import itertools
import os
import time
import weakref
from collections import Counter, deque
from typing import Callable, Generator, Optional, Sequence, Tuple

import numpy as np
import torch

from magi_tpu_torch.core import graphs as G
from magi_tpu_torch.core.config import MagiConfig
from magi_tpu_torch.core.dataclasses import ForwardMeta, SegmentAttnSpec
from magi_tpu_torch.core.logger import print_rank_0
from magi_tpu_torch.core.profiler import span
from magi_tpu_torch.core.utils import resolve_device, round_up
from magi_tpu_torch.parallel import mesh as mesh_lib
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


# Every environment variable a step reads while it runs (the model's int8
# attention switches and K5's scheme), with its default: part of the key
# of a captured step, so flipping one never replays a stale graph.
STEP_ENV = (("MAGI_ATTN_INT8", "0"), ("MAGI_ATTN_INT8_STORE", "1"), ("MAGI_ATTN_Q8_SCHEME", "qk8"))

# the request id (`req`) each sampler takes at construction: it ties a
# request's spans together across threads
_REQUESTS = itertools.count()


def _mesh_key() -> Optional[tuple]:
    """The process's mesh as a captured step depends on it: its shape, this
    rank and the backend (None without a mesh)."""
    mesh = mesh_lib.get_mesh()
    return None if mesh is None else (tuple(mesh.ranks.shape), mesh.rank, mesh.backend)


def _config_key(config: MagiConfig) -> str:
    """Deterministic content key over every config field, `STEP_ENV` and
    the mesh (`_mesh_key`) (the JAX package's `_config_key`): equal-content
    configs share it, and a config object whose id is recycled cannot alias
    another's."""
    return repr((dataclasses.asdict(config.model_config), dataclasses.asdict(config.runtime_config),
                 dataclasses.asdict(config.engine_config), tuple(os.environ.get(k, d) for k, d in STEP_ENV),
                 _mesh_key()))


class StepInputs:
    """A walk's per-step values in fixed device buffers: every value the
    JAX package passes its jitted steps as a traced argument.  int32: `sp`
    (first chunk of the window), `cache_sp` (its cache slot), `null_len`,
    `prefix_len`, the kv ranges `kv_start` / `kv_end` [width] and the
    window's caption lengths `y_lens` [requests, width]; f32: `tvec`, `dt`,
    the CFG scales `ps` / `ts` [width], `dfac` (the distill step size) and
    `pcs` (prev_chunks_scale).  `stage` writes them into one pinned host
    buffer and copies it to the device in one non-blocking copy on the
    current stream; a step reads leading slices of the fields."""

    _I32 = ("sp", "cache_sp", "null_len", "prefix_len", "kv_start", "kv_end", "y_lens")
    _F32 = ("tvec", "dt", "ps", "ts", "dfac", "pcs")

    def __init__(self, width: int, requests: int, device: torch.device):
        shapes = dict(sp=(), cache_sp=(), null_len=(), prefix_len=(), kv_start=(width,), kv_end=(width,),
                      y_lens=(requests, width), tvec=(width,), dt=(width,), ps=(width,), ts=(width,), dfac=(),
                      pcs=())
        sizes = {k: int(np.prod(v)) for k, v in shapes.items()}
        total = 4 * sum(sizes.values())
        on_card = device.type == "cuda"
        self.device = device
        self._dev = torch.zeros(total, dtype=torch.uint8, device=device)
        self._host = torch.zeros(total, dtype=torch.uint8, pin_memory=on_card)
        host = self._host.numpy()
        self._views = {}
        off = 0
        for name in self._I32 + self._F32:
            dtype = torch.int32 if name in self._I32 else torch.float32
            n = 4 * sizes[name]
            setattr(self, name, self._dev[off : off + n].view(dtype).view(shapes[name]))
            self._views[name] = host[off : off + n].view(np.int32 if dtype == torch.int32 else np.float32).reshape(
                shapes[name])
            off += n
        self._copied = torch.cuda.Event() if on_card else None
        self._pending = False

    def stage(self, **values) -> None:
        """Write `values` (scalars, or arrays filling a field's leading
        entries; `y_lens` [requests, n]) and copy them to the device."""
        if self._pending:
            self._copied.synchronize()  # the last copy has read the staging buffer
        for name, v in values.items():
            view = self._views[name]
            if view.ndim == 0:
                view[...] = v
            else:
                a = np.asarray(v, view.dtype)
                if name == "y_lens":
                    a = a.reshape(view.shape[0], -1)
                    view[:, : a.shape[1]] = a
                else:
                    view[: a.shape[0]] = a
        self._dev.copy_(self._host, non_blocking=True)
        if self._copied is not None:
            self._copied.record(torch.cuda.current_stream(self.device))
            self._pending = True


def _meta(n_seg, ctn, HP, WP, slice_point, kv_start, kv_end, y_lens, *, update, use_cache, device,
          extra=False, distill_nearly=False) -> ForwardMeta:
    """A forward's metadata from host values (ints, numpy arrays), copied to
    `device`; the steps build theirs from `StepInputs` (`_step_meta`)."""
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
        slice_point=i32(slice_point),
        self_attn=SegmentAttnSpec(kv_start=i32(kv_start), kv_end=i32(kv_end)),
        y_lens=i32(y_lens),
    )


# A cache-touching DiT forward of one request: (x, t, y, caption_dropout,
# meta, t_offsets, distill_factor=None, tag=...) -> velocity.  The resident
# cache's is `dit_forward` on it (on a model-parallel mesh in `run`'s
# pieces); the host-streamed cache's is `ArdfSampler._streamed_forward`;
# `tag` names the forward's output piece.
Forward = Callable[..., torch.Tensor]


def _resident_forward(params, config: MagiConfig, cache, run) -> Forward:
    def forward(x, t, y, caption_dropout, meta, t_offsets, distill_factor=None, tag=""):
        return dit_forward(params, config, x, t, y, caption_dropout, cache, meta, t_offsets,
                           distill_factor=distill_factor, run=run, tag=tag)[0]

    return forward


def _signature(tree) -> tuple:
    """The parameter tree's structure: every leaf's path, dtype and shape
    (which kernels a step launches, at which shapes); () for no tree (a
    sampler that only plans)."""
    if tree is None:
        return ()
    def leaf(v):
        if isinstance(v, dict):
            return _signature(v)
        return (str(v.dtype), tuple(v.shape)) if isinstance(v, torch.Tensor) else (repr(v),)

    return tuple((k,) + leaf(v) for k, v in sorted(tree.items()))


def _leaf_map(tree, fn):
    return {k: fn(v) for k, v in tree.items()} if isinstance(tree, dict) else fn(tree)


def _roll_left(t: torch.Tensor, shift: int, axis: int) -> torch.Tensor:
    """`t` rolled left by `shift` along `axis` (torch.roll's values) in its
    own storage, as the JAX package's donated roll: captured steps keep
    their pointers into the cache.  Moves one block of `shift` tokens at a
    time, so no copy's source and destination overlap, with the first
    block as the only scratch."""
    n = t.shape[axis]
    shift %= n
    if shift == 0:
        return t
    head = t.narrow(axis, 0, shift).clone()
    for lo in range(0, n - shift, shift):
        m = min(shift, n - shift - lo)
        t.narrow(axis, lo, m).copy_(t.narrow(axis, lo + shift, m))
    t.narrow(axis, n - shift, shift).copy_(head)
    return t


class ArdfSampler:
    """Drives chunk-wise autoregressive denoising for one request.

    `noise` (optional, [C, T, H, W]) replaces the initial latent noise that
    `generator` would draw, so a test can give this walk and the JAX
    package's the same start.  `capture` (default True) runs the steps as
    CUDA graphs on the card; False runs them eagerly.

    The walk's state (latents, KV cache, step inputs, captions, prefix
    buffer) and its step callables live in a `core.graphs.Workspace` of
    the process's pool, keyed by the config, the shapes, the requests, the
    cache mode and the parameter tree: a sampler takes an idle one of its
    key (the graphs an earlier walk captured, replayed with this request
    copied into their buffers) or builds one, and gives it back when its
    walk ends or it is collected.  After its walk a sampler's state is the
    pool's: read it before building the next sampler of an equal key."""

    # token axis of the cache leaves ([L, 2, hk, tok, hd], scale [L, 2, hk, tok])
    _token_axis = 3
    R = 1  # requests walked together (`sampling.batched` walks several)

    def __init__(self, config: MagiConfig, params, inp: InferenceInput, generator: Optional[torch.Generator] = None,
                 *, noise: Optional[torch.Tensor] = None, device=None, capture: bool = True):
        dev = resolve_device(device)
        if noise is not None:
            if tuple(noise.shape) != tuple(inp.latent_size):
                raise ValueError(f"noise shape {tuple(noise.shape)} != latent size {inp.latent_size}")
        else:
            noise = torch.randn(inp.latent_size, generator=generator, device=dev, dtype=torch.float32)
        self._setup(config, params, [inp], [noise], dev, capture)

    def _setup(self, config: MagiConfig, params, inps: Sequence[InferenceInput], noises: Sequence[torch.Tensor],
               device: torch.device, capture: bool) -> None:
        """The walk's geometry and schedule from the first request, then
        (span `magi/request/sampler`) every step's plan and its state in a
        workspace, the requests' loaded into it."""
        inp = inps[0]
        self.req = next(_REQUESTS)
        self.config = config
        self.params = params
        self.inp = inp
        self.device = device
        self.capture = bool(capture)
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

        # KV memory, two regimes under kv_offload: noise2clean kv ranges
        # bound the attended span, so the device keeps a sliding cache
        # window that rolls forward (O(1) memory in length; it holds at
        # least the prefix chunks the warm-up writes); the default ranges
        # attend every earlier chunk, so the whole cache lives in host
        # memory and streams to the device one layer at a time (host mode)
        offset_chunks = 0 if inp.prefix_video is None else inp.prefix_video.shape[1] // self.cw
        self.host_mode = bool(ec.kv_offload and not rc.noise2clean_kvrange)
        if self.host_mode and not mesh_lib.model_parallel_trivial():
            # the cache is sharded 1/(cp*pp*tp) on a mesh: host streaming buys nothing
            print_rank_0("kv_offload with default kv ranges ignored on a model-parallel mesh (the cache is sharded; "
                         "host streaming is the single-device fallback)")
            self.host_mode = False
        if ec.kv_offload and rc.noise2clean_kvrange:
            reach = max(rc.noise2clean_kvrange)
            if rc.clean_chunk_kvrange != -1:
                reach = max(reach, rc.clean_chunk_kvrange)
            self.cache_chunks = min(self.chunk_num, max(reach + self.window + 1, offset_chunks))
        else:
            self.cache_chunks = self.chunk_num
        self.cache_base = 0  # chunk index of cache slot 0
        self.counts: Counter = Counter()
        self.cache_tokens = round_up(self.cache_chunks * self.ctn, 1024)
        self.chunk_offset = offset_chunks
        self.prefix_len = 0 if inp.prefix_video is None else int(inp.prefix_video.shape[1])
        self._warmed = False
        self.step_seconds: list = []  # host wall time of each denoise step, device work included
        self.capture_seconds = 0.0  # host seconds `warm_step_variants` spent warming and capturing
        self._plans: dict = {}  # step -> `_plan(step)` (`_planned`)
        key = self._workspace_key(inps)
        ws = G.WORKSPACES.take(key)
        with span("magi/request/sampler", req=self.req, leased=ws is not None):
            for step in range(self.total_forward_steps()):
                self._planned(step)
            self._take_workspace(key, ws, inps, noises)

    # ----- the workspace ------------------------------------------------

    def _workspace_key(self, inps: Sequence[InferenceInput]) -> tuple:
        """What fixes the workspace's buffers and graphs: the config (and the
        step environment and the mesh: its shape, the rank, the backend),
        the requests' count and shapes, the cache mode and size, and the
        parameter tree (its identity: the graphs read its addresses; the
        workspace holds it, so the id stays its own)."""
        inp = inps[0]
        pv = inp.prefix_video
        return (str(self.device), _config_key(self.config), self.R, tuple(inp.latent_size),
                tuple(inp.caption_embs.shape), str(inp.caption_embs.dtype), tuple(inp.null_emb.shape),
                str(inp.null_emb.dtype), None if pv is None else tuple(pv.shape), self.host_mode, self.cache_tokens,
                id(self.params), _signature(self.params))

    def _take_workspace(self, key: tuple, ws: Optional[G.Workspace], inps: Sequence[InferenceInput],
                        noises: Sequence[torch.Tensor]) -> None:
        """Lease `ws` (an idle workspace of this walk's `key`, taken from the
        pool) and copy the requests into it, or, when it is None, build one
        from them."""
        state = self._request_tensors(inps, noises)
        if ws is None:
            ws = G.Workspace(key, self.params, self.device)
            G.WORKSPACES.add(ws)  # frees other keys' idle workspaces before these buffers
            for name, t in state.items():
                setattr(ws, name, None if t is None else t.to(self.device, copy=True))
            ws.cache, ws.host_cache = self._new_cache()
            ws.inputs = StepInputs(max(self.window + 1, self.chunk_offset), self.R, self.device)
        else:
            for name, t in state.items():
                if t is not None:
                    getattr(ws, name).copy_(t)
            if ws.cache is not None:
                _leaf_map(ws.cache, torch.Tensor.zero_)
            if ws.host_cache is not None:
                ws.host_cache.reset()
        self._ws = ws
        self._ticket = ws.lease(self)
        weakref.finalize(self, G.WORKSPACES.give_back, ws, self._ticket)
        self.xs, self.cache, self.host_cache = ws.xs, ws.cache, ws.host_cache
        self._text_embs, self._null_emb, self.prefix_buf = ws.text_embs, ws.null_emb, ws.prefix_buf
        self.inputs, self._steps, self._arena = ws.inputs, ws.steps, ws.arena

    def _request_tensors(self, inps: Sequence[InferenceInput], noises: Sequence[torch.Tensor]) -> dict:
        """The request's state as the workspace holds it (sets the host's
        caption lengths `_lens_eff`): the latents, the caption slabs, the
        null caption, the prefix video's latent zero-padded to the chunk
        grid (None without one)."""
        inp = inps[0]
        text, self._lens_eff = self._captions(inp)
        prefix = None if inp.prefix_video is None else self._padded_prefix(inp.prefix_video)
        return dict(xs=noises[0].to(device=self.device, dtype=torch.float32), text_embs=text, null_emb=inp.null_emb,
                    prefix_buf=prefix)

    def _new_cache(self):
        """(device cache, host cache) of a new workspace, zeroed."""
        if self.host_mode:
            return None, HostKVCache(self.config, self.cache_tokens, self.device)
        return init_kv_cache(self.config, self.cache_tokens, self.device), None

    def release(self) -> None:
        """Give the workspace back to the pool (the walk is over): the next
        sampler of this key may take it.  Also done when the sampler is
        collected."""
        G.WORKSPACES.give_back(self._ws, self._ticket)

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
        variants = self.warm_step_variants()
        self.prepare()
        print_rank_0(f"walk: {variants} step variants, {self.graphs} graphs ({self.capture_seconds:.3f} s capturing, "
                     f"{G.captures('walk')} captured in the process); first step")
        for step in range(self.total_forward_steps()):
            emitted = self.timed_step(step)
            if emitted is not None:
                yield emitted
        self.release()

    def timed_step(self, step: int) -> Optional[Tuple[int, torch.Tensor]]:
        """`do_step`, then wait for the current stream's work (other streams,
        such as a decode worker's, run on) and log the host seconds.  Span
        `magi/step`, with the step's variant, its denoised chunks, whether
        a clean chunk leads its window, and the query and key tokens of the
        self-attention of its window's forward (`_plan`'s `q_tokens`,
        `kv_tokens`)."""
        t0 = time.perf_counter()
        p = self._planned(step)
        with span("magi/step", req=self.req, step=step, variant=self._variant(p), n_den=p["n_den"],
                  extra=p["extra"], q_tokens=p["q_tokens"], kv_tokens=p["kv_tokens"]):
            emitted = self.do_step(step)
            with span("magi/step/sync"):
                if self.device.type == "cuda":
                    torch.cuda.current_stream(self.device).synchronize()
        self.step_seconds.append(time.perf_counter() - t0)
        return emitted

    def prepare(self) -> None:
        """Write the prefix chunks' KV into the cache, once."""
        with span("magi/request/prepare", req=self.req):
            if self.chunk_offset > 0 and not self._warmed:
                self._stage_warmup()
                self._run(("warmup", self.chunk_offset), 0)
                self._warmed = True

    def _planned(self, step: int) -> dict:
        """`_plan(step)`, worked out once."""
        p = self._plans.get(step)
        if p is None:
            p = self._plans[step] = self._plan(step)
        return p

    def _plan(self, step: int) -> dict:
        """Pure host arithmetic for one step: schedule, ranges, flags, and
        the tokens of its window's forward: its queries (`q_tokens`, the
        ride-along chunk's included) and the keys its self-attention reads
        over every segment's kv range (`kv_tokens`)."""
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
            q_tokens=(n_seg + int(distill_nearly)) * self.ctn,
            kv_tokens=int(np.sum(kv_end - kv_start)) + int(distill_nearly) * self.ctn,
        )

    def _variant(self, p: dict) -> tuple:
        """A step's variant: the JAX package's static arguments of its jitted
        step (`_cfg3_step`: n_den, extra, use_prefix, pack; `_cfg1_step`:
        n_den, extra, use_prefix, distill_nearly).  The streamed step never
        packs, as the JAX package's."""
        if self.config.runtime_config.cfg_number == 3:
            pack = bool(self.config.engine_config.pack_uncond and not self.host_mode)
            return ("cfg3", p["n_den"], p["extra"], p["use_prefix"], pack)
        return ("cfg1", p["n_den"], p["extra"], p["use_prefix"], p["distill_nearly"])

    def step_variants(self) -> list:
        """The variants of this walk's steps in the order they first come,
        after the prefix warm-up's ("warmup", n_chunks) when there is one:
        the functions the JAX package compiles for it."""
        out = [("warmup", self.chunk_offset)] if self.chunk_offset > 0 else []
        for step in range(self.total_forward_steps()):
            v = self._variant(self._planned(step))
            if v not in out:
                out.append(v)
        return out

    def do_step(self, step: int) -> Optional[Tuple[int, torch.Tensor]]:
        """Run one denoise step; returns (chunk_idx, latent) if a chunk
        finished.  Spans `magi/step/plan` (the plan, the cache window's
        slide, the staged inputs) and `magi/step/replay` (the step)."""
        with span("magi/step/plan"):
            p = self._planned(step)
            c_start, c_end, sp, n_seg = p["c_start"], p["c_end"], p["sp"], p["n_seg"]

            # slide the cache window forward if this step would overflow it
            new_base = max(0, sp + n_seg - self.cache_chunks)
            if new_base > self.cache_base:
                shift = (new_base - self.cache_base) * self.ctn
                _leaf_map(self.cache, lambda c: _roll_left(c, shift, self._token_axis))
                self.cache_base = new_base
            kv_start_r = p["kv_start"] - self.cache_base * self.ctn
            kv_end_r = p["kv_end"] - self.cache_base * self.ctn
            if kv_start_r.min() < 0:
                raise RuntimeError(
                    f"kv range {p['kv_start'].min()} fell behind the sliding cache window (base {self.cache_base})"
                )
            cache_sp = sp - self.cache_base
            if (cache_sp + n_seg) * self.ctn > self.cache_tokens:
                raise ValueError(f"cache write [{cache_sp * self.ctn}, {(cache_sp + n_seg) * self.ctn}) overflows "
                                 f"{self.cache_tokens} tokens")
            self._stage_step(p, sp, cache_sp, kv_start_r, kv_end_r)
        with span("magi/step/replay"):
            self._run(self._variant(p), cache_sp)

        for ci in range(c_start, c_end):
            self.counts[ci] += 1
        if self.counts[c_start] == self.num_steps:
            chunk = self._emit(c_start)
            if chunk is not None:
                return c_start - self.chunk_offset, chunk
        return None

    # ----- step inputs, step callables ----------------------------------

    def _stage_step(self, p: dict, sp: int, cache_sp: int, kv_start, kv_end) -> None:
        """The step's values into `self.inputs` (the CFG scales of a 3-CFG
        step, the distill step size of a 1-CFG one)."""
        ec, inp = self.config.engine_config, self.inp
        extra = {}
        if self.config.runtime_config.cfg_number == 3:
            extra["ps"], extra["ts"] = self._cfg_scales(p["tvec_padded"][-p["n_den"]:])
        elif ec.distill:
            extra["dfac"] = sched.distill_dt_factor(self.num_steps, float(self.interval[p["didx"]]))
        self.inputs.stage(sp=sp, cache_sp=cache_sp, null_len=inp.null_len, prefix_len=self.prefix_len,
                          kv_start=kv_start, kv_end=kv_end, y_lens=self._lens_eff[..., p["c_start"]:p["c_end"]],
                          tvec=p["tvec"], dt=p["dt"], pcs=inp.prev_chunks_scale, **extra)

    def _stage_warmup(self) -> None:
        rc, ec = self.config.runtime_config, self.config.engine_config
        kv_s, kv_e = kvr.prefix_kvrange(rc, self.chunk_offset, self.ctn)
        extra = {}
        if ec.distill:
            extra["dfac"] = sched.distill_dt_factor(self.num_steps, float(self.interval[0]))
        self.inputs.stage(sp=0, cache_sp=0, null_len=self.inp.null_len, prefix_len=self.prefix_len, kv_start=kv_s,
                          kv_end=kv_e, **extra)

    def _run(self, variant: tuple, cache_sp: int) -> None:
        """Run a step of `variant` on the staged inputs: a new eager step
        when `capture` is off, else the variant's callable, built (and on
        the card captured) at its first use.  `cache_sp` (the window's cache
        slot) is read on the host only, for the streamed cache's copies."""
        if not self.capture:
            self._body(variant)(G.PLAIN, cache_sp)
            return
        key = (_config_key(self.config), variant)
        fn = self._steps.get(key)
        if fn is None:
            fn = self._steps[key] = self._callable(key)
        fn(cache_sp)

    def _callable(self, key: tuple):
        """The step callable of (config key, variant); its first run in the
        process for this cache mode and parameter tree warms eagerly
        (`core.graphs`)."""
        return G.make_callable(f"step variant {key[1]}", self._body(key[1]), self.device, self._ws,
                               key + (self.host_mode, _signature(self.params)))

    def _body(self, variant: tuple) -> Callable:
        """The step of `variant` as `body(run, cache_sp)`: with the resident
        cache on one device, one piece (one graph); with the host-streamed
        one, the pieces of `_stream_jits` (see `_streamed_forward`); on a
        model-parallel mesh, the pieces between its collectives (the step's
        own, and `dit_forward`'s of each forward).  It finds its sampler
        through the workspace, which holds the step callables and outlives
        the sampler: the sampler leasing it now, whose state is the
        workspace's buffers."""
        ws = weakref.ref(self._ws)

        def requests(run, cache_sp):
            me = ws().sampler()
            for r in range(me.R):
                me._request_step(run, variant, r, cache_sp)

        if self.host_mode or not mesh_lib.model_parallel_trivial():
            return requests
        return lambda run, cache_sp: run.piece("step", requests, run, cache_sp)

    def _request_state(self, r: int):
        """Request r's (latent state, cache, caption slabs, prefix buffer)."""
        return self.xs, self.host_cache if self.host_mode else self.cache, self._text_embs, self.prefix_buf

    def _request_step(self, run, variant: tuple, r: int, cache_sp: int) -> None:
        """One request's step of `variant` on its state (the latent state and
        the cache behind its forward are written in place)."""
        ec, si = self.config.engine_config, self.inputs
        xs, cache, text_embs, prefix = self._request_state(r)
        if self.host_mode:
            forward = functools.partial(self._streamed_forward, run, cache_sp)
        else:
            forward = _resident_forward(self.params, self.config, cache, run)
        dfac = si.dfac if ec.distill else None
        if variant[0] == "warmup":
            n = variant[1]
            _prefix_warmup_step(run, self.config, forward, prefix[:, : n * self.cw], self._null_emb, si, dfac,
                                n_chunks=n)
            return
        _, n_den, extra, use_prefix, flag = variant
        common = (run, self.config, self.params, forward, xs, si, si.y_lens[r], text_embs, self._null_emb, prefix)
        if variant[0] == "cfg3":
            _cfg3_step(*common, n_den=n_den, extra=extra, use_prefix=use_prefix, pack=flag)
        else:
            _cfg1_step(*common, dfac, n_den=n_den, extra=extra, use_prefix=use_prefix, distill_nearly=flag)

    def _streamed_forward(self, run, cache_sp: int, x, t, y, caption_dropout, meta: ForwardMeta, t_offsets,
                          distill_factor=None, tag=""):
        """`dit_forward` with the layer loop here, the JAX package's
        `_stream_jits`: pieces `prologue`, `layer` (one graph per layer: each
        reads its own weights and slab) and `epilogue_<tag>`; between them
        each layer runs on its cache slab as `HostKVCache` streams it in (the
        next layer's upload issued before this layer's compute) and, in a
        forward that writes the cache, back out (only the written token
        range, from the host's `cache_sp`).  No host sync in the loop; while
        the pieces are captured no copy is issued."""
        mc = self.config.model_config
        hc = self.host_cache
        C, T, H, W = x.shape
        h, condition, y_xattn, sin, cos = run.piece(
            "prologue", dit_prologue, self.params, self.config, x, t, y, caption_dropout, meta, t_offsets,
            distill_factor)
        start_tok = cache_sp * meta.seg_len
        written = 0
        if meta.update_kv_cache:
            # the distill ride-along chunk is not written
            written = (meta.n_segments - int(meta.distill_nearly_clean_chunk)) * meta.seg_len
        live = run.copies_live
        if live:
            hc.begin(start_tok)
        for idx in range(mc.num_layers):
            cache_l = hc.fetch(idx) if live else hc.slab(idx)
            run.piece("layer", _layer_in_place, self.params, self.config, idx, h, cache_l, condition, y_xattn, sin,
                      cos, meta)
            if live:
                hc.release(idx, start_tok, start_tok + written)
        return run.piece("epilogue_" + tag, dit_epilogue, self.params, self.config, h, T // mc.t_patch_size,
                         H // mc.patch_size, W // mc.patch_size)

    # ----- capture before the walk ---------------------------------------

    def _variant_size(self, variant: tuple, plan: Optional[dict]) -> int:
        """Segments of the variant's widest forward (captures go widest
        first, so the arena's buffers are allocated at their largest)."""
        if variant[0] == "warmup":
            return variant[1]
        n = plan["n_seg"]
        return n + (plan["n_den"] if variant[0] == "cfg3" and variant[4] else int(variant[0] == "cfg1" and variant[4]))

    def warm_step_variants(self) -> int:
        """Build every step variant of the walk before its first step and
        return their count.  On the card each is captured on synthetic
        values (the first graph of a variant in the process runs once
        eagerly before, as the JAX package's warm-up compiles each); the
        walk's state (latents, cache, host cache and its byte counts) and
        the launch counts are left as they were found.  On a mesh every
        rank builds the same variants in the same order (a warm-up's
        collectives pair up across the ranks).  Without `capture` nothing
        is built (returns 0).  Span `magi/request/capture` with the walk's
        variants and the graphs captured now (a variant's step callable
        each), and a `magi/request/capture/warm` and `.../graph` span for
        each variant it warms and captures."""
        if not self.capture:
            return 0
        variants = self.step_variants()
        key = _config_key(self.config)
        todo = [v for v in variants if (key, v) not in self._steps]
        capturing = bool(todo) and G.captures_on(self.device)
        with span("magi/request/capture", req=self.req, variants=len(variants), graphs=len(todo) if capturing else 0):
            for v in todo:
                self._steps[(key, v)] = self._callable((key, v))
            if capturing:
                self._capture(key, todo)
        return len(variants)

    def _capture(self, key: str, todo: list) -> None:
        """Warm and capture the step callables of the variants `todo`."""
        plans = {}
        for step in range(self.total_forward_steps()):
            p = self._planned(step)
            plans.setdefault(self._variant(p), p)
        t0 = time.perf_counter()
        todo = sorted(todo, key=lambda v: -self._variant_size(v, plans.get(v)))
        written = max(self._variant_size(v, plans.get(v)) for v in todo) * self.ctn
        restore = self._save_state(written)
        with G.uncounted():
            try:
                # every variant's eager warm-up, then every capture: the
                # warm-ups reuse one another's freed memory, which then
                # goes back to the card for the captures, which reuse one
                # another's in the workspace's pool
                for capture in (False, True):
                    for v in todo:
                        with span("magi/request/capture/graph" if capture else "magi/request/capture/warm",
                                  variant=v):
                            if v[0] == "warmup":
                                self._stage_warmup()
                            else:
                                p = plans[v]
                                ks = np.zeros(p["n_seg"], np.int32)
                                ke = (np.arange(p["n_seg"], dtype=np.int32) + 1) * self.ctn
                                self._stage_step(p, 0, 0, ks, ke)
                            if capture:
                                self._steps[(key, v)].build(0)
                            else:
                                self._steps[(key, v)].warm(0)
                    if not capture:
                        G.release_cached(self.device)
            finally:
                restore()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.capture_seconds += time.perf_counter() - t0

    def _save_state(self, tokens: int) -> Callable[[], None]:
        """What the warm-up steps write (they run at `sp` 0: the latent state
        and cache tokens [0, tokens)), saved; returns its restore."""
        tokens = min(tokens, self.cache_tokens)
        xs = self.xs.clone()
        pristine = not self.counts and not self._warmed
        if self.host_mode:
            hc = self.host_cache
            leaves = [(hc._host_kv, 1)] + ([(hc._host_sc, 3)] if hc._host_sc is not None else [])
            moved = (hc.h2d_bytes, hc.d2h_bytes)
        else:
            cache = self.cache
            leaves = [(c, self._token_axis) for c in (cache.values() if isinstance(cache, dict) else [cache])]
        kept = None if pristine else [c.narrow(ax, 0, tokens).clone() for c, ax in leaves]

        def restore():
            self.xs.copy_(xs)
            for i, (c, ax) in enumerate(leaves):
                region = c.narrow(ax, 0, tokens)
                region.zero_() if kept is None else region.copy_(kept[i])
            if self.host_mode:
                self.host_cache.h2d_bytes, self.host_cache.d2h_bytes = moved

        return restore

    @property
    def graphs(self) -> int:
        """CUDA graphs captured for this walk (0 off the card, where a
        `StandIn` counts its recorded pieces)."""
        return G.graph_count(self._steps.values())

    def capture_breakdown(self) -> dict:
        """Host seconds spent building this walk's graphs (`core.graphs`)."""
        return G.capture_breakdown(self._steps.values())

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

    def reset(self) -> None:
        """Empty the cache for a new walk, as a new one starts: every buffer
        zeroed, the byte counts too (the copy stream drained first)."""
        if self.device.type == "cuda":
            self._copy.synchronize()
        for t in [self._host_kv, self._host_sc] + self._slab_kv + (self._slab_sc or []):
            if t is not None:
                t.zero_()
        self._read = 0
        self.h2d_bytes = self.d2h_bytes = 0

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

    def slab(self, l: int):
        """Layer l's slab views, with no copy (what a captured layer reads)."""
        return self._slab(l % 2)

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
    device) as chunks finish.  Every request's step variants are built (on
    the card: captured) before the first step.  Each step waits only for
    its own stream (`ArdfSampler.timed_step`), so a consumer's decode on
    another stream overlaps the next steps."""
    queue = deque()
    for s in samplers:
        s.warm_step_variants()
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
        else:
            s.release()


# ---------------------------------------------------------------------------
# device steps
# ---------------------------------------------------------------------------
#
# Each step reads its step-dependent values from `StepInputs` (`si`) and
# takes only the variant's statics as Python values; its device work lies
# in `run.piece` regions (`core.graphs`), with nothing between two pieces
# but views, metadata and the streamed cache's host-side copies.


def _frames(start: torch.Tensor, n: int) -> torch.Tensor:
    """Indices [start, start + n) from a device start: int64 on its device."""
    return start.long() + torch.arange(n, device=start.device)


def _apply_prefix(x_chunk, tvec, prefix_buf, prefix_len, frames, start_f, cw, n_seg):
    """The prefix video's latents pasted over the window's frames they
    cover; the chunks they cover whole get t = 1 (clean).  Returns a new
    window and tvec."""
    pwin = prefix_buf.index_select(1, frames)
    x_chunk = torch.where((frames < prefix_len)[None, :, None, None], pwin, x_chunk)
    nclean = torch.clamp(prefix_len - start_f, min=0) // cw
    tvec = torch.where(torch.arange(n_seg, device=tvec.device) < nclean, 1.0, tvec)
    return x_chunk, tvec


def _build_y(caption_embs, null_emb, null_len, y_lens_win, sp, extra, n_den):
    """Per-segment captions: an optional leading clean chunk gets the null caption."""
    y_win = caption_embs.index_select(0, _frames(sp + int(extra), n_den))
    if extra:
        return torch.cat([null_emb[None], y_win], dim=0), torch.cat([null_len.reshape(1), y_lens_win])
    return y_win, y_lens_win


def _window_inputs(config, xs, si, y_lens, caption_embs, null_emb, prefix_buf, n_den, extra, use_prefix):
    """The window's latents [C, n_seg * cw, H, W] (prefix pasted), timesteps,
    captions, caption lengths and temporal offsets of a step at `si.sp`."""
    cw = config.runtime_config.chunk_width
    n_seg = n_den + int(extra)
    start_f = si.sp * cw
    frames = _frames(start_f, n_seg * cw)
    x_chunk = xs.index_select(1, frames)
    tvec = si.tvec[:n_seg]
    if use_prefix:
        x_chunk, tvec = _apply_prefix(x_chunk, tvec, prefix_buf, si.prefix_len, frames, start_f, cw, n_seg)
    y_text, lens_text = _build_y(caption_embs, null_emb, si.null_len, y_lens[:n_den], si.sp, extra, n_den)
    t_off = (si.sp + torch.arange(n_seg, dtype=torch.int32, device=xs.device)) * (
        cw // config.model_config.t_patch_size)
    return x_chunk, tvec, y_text, lens_text, t_off


def _pre3(config, xs, si, y_lens, caption_embs, null_emb, prefix_buf, n_den, extra, use_prefix):
    """`_window_inputs` and the null captions' lengths [n_seg]."""
    n_seg = n_den + int(extra)
    return _window_inputs(config, xs, si, y_lens, caption_embs, null_emb, prefix_buf, n_den, extra, use_prefix) + (
        si.null_len.reshape(1).expand(n_seg).contiguous(),)


def _integrate_and_store(xs, x_chunk_den, velocity, dt, c_start, cw, n_den):
    """Per-chunk Euler step x += v*dt, written back into the latent state
    (in place) from chunk `c_start` (a device scalar) on."""
    C, Tw, H, W = x_chunk_den.shape
    v = velocity.reshape(C, n_den, cw, H, W)
    x = x_chunk_den.reshape(C, n_den, cw, H, W) + v * dt[None, :, None, None, None]
    xs.index_copy_(1, _frames(c_start * cw, Tw), x.reshape(C, Tw, H, W))


def _step_meta(si, n, ctn, HP, WP, lens, ks, ke, *, update, use_cache, extra, distill_nearly=False) -> ForwardMeta:
    return ForwardMeta(n_segments=n, seg_len=ctn, H=HP, W=WP, T_total=0, update_kv_cache=update,
                       use_kv_cache=use_cache, distill_nearly_clean_chunk=distill_nearly, fwd_extra_1st_chunk=extra,
                       slice_point=si.cache_sp, self_attn=SegmentAttnSpec(kv_start=ks, kv_end=ke), y_lens=lens)


def _geometry(config, xs):
    mc = config.model_config
    HP, WP = xs.shape[2] // mc.patch_size, xs.shape[3] // mc.patch_size
    return HP, WP, config.runtime_config.chunk_width // mc.t_patch_size * HP * WP


def _pack_inputs(x_chunk, t_vec, y_text, y_null, lens_text, lens_null, t_off, ks, ke, cache_sp, n_seg, n_den, cw,
                 ctn):
    """Forward A of a packed step: the window's segments, then the uncond
    segments (null captions, their own caption dropout, temporal offsets
    from 0, ranges over their own tokens past the window's in the current
    source)."""
    dw = n_den * cw
    dev = x_chunk.device
    u_start = (cache_sp + n_seg) * ctn + torch.arange(n_den, dtype=torch.int32, device=dev) * ctn
    return (torch.cat([x_chunk, x_chunk[:, -dw:]], dim=1), torch.cat([t_vec, t_vec[-n_den:]]),
            torch.cat([y_text, y_null[:n_den]], dim=0), torch.arange(n_seg + n_den, device=dev) >= n_seg,
            torch.cat([ks, u_start]), torch.cat([ke, u_start + ctn]), torch.cat([lens_text, lens_null[:n_den]]),
            torch.cat([t_off, torch.zeros(n_den, dtype=torch.int32, device=dev)]))


def _uncond_inputs(n_den, ctn, device):
    u_start = torch.arange(n_den, dtype=torch.int32, device=device) * ctn
    return u_start, u_start + ctn, torch.zeros(n_den, dtype=torch.int32, device=device)


def _uncond(run, config, params, x_chunk, t_vec, y_null, lens_null, si, n_den, ctn, HP, WP):
    """Branch 3 of a 3-CFG step: the denoised chunks alone, unconditional
    (self-only ranges, fresh positions, no cache)."""
    dw = n_den * config.runtime_config.chunk_width
    ks, ke, t_off = run.piece("uncond_in", _uncond_inputs, n_den, ctn, x_chunk.device)
    meta = _step_meta(si, n_den, ctn, HP, WP, lens_null[:n_den], ks, ke, update=False, use_cache=False, extra=False)
    return dit_forward(params, config, x_chunk[:, -dw:], t_vec[-n_den:], y_null[:n_den], True, None, meta, t_off,
                       run=run, tag="uncond")[0]


def _combine3(xs, si, x_chunk, v1, v2, v3, n_den, extra, cw):
    """The 3-CFG combination of the branches, integrated into `xs`."""
    dw = n_den * cw

    def per_chunk(o):
        return o.reshape(o.shape[0], n_den, cw, *o.shape[2:])

    c1, c2, u = per_chunk(v1[:, -dw:]), per_chunk(v2[:, -dw:]), per_chunk(v3)
    scale_p = si.ps[:n_den][None, :, None, None, None]
    scale_t = si.ts[:n_den][None, :, None, None, None]
    velocity = (1 - scale_p) * u + (scale_p - scale_t) * c2 + scale_t * c1
    velocity = velocity.reshape(velocity.shape[0], dw, *velocity.shape[3:])
    _integrate_and_store(xs, x_chunk[:, -dw:], velocity, si.dt[:n_den], si.sp + int(extra), cw, n_den)


def _cfg3_step(run, config, params, forward: Forward, xs, si, y_lens, caption_embs, null_emb, prefix_buf, *,
               n_den: int, extra: bool, use_prefix: bool, pack: bool) -> None:
    """One denoise step with 3-branch CFG: (1) text + previous chunks,
    (3) unconditional (self-only ranges, fresh positions, no cache),
    (2) null caption + previous chunks, which writes the cache.  `pack`
    runs (1) and (3) as one forward (`_pack_inputs`).  Pieces: pre3,
    [pack], the forwards, uncond (on a model-parallel mesh uncond_in and
    its forward's pieces), combine3."""
    cw = config.runtime_config.chunk_width
    n_seg = n_den + int(extra)
    HP, WP, ctn = _geometry(config, xs)
    L = caption_embs.shape[1]
    x_chunk, t_vec, y_text, lens_text, t_off, lens_null = run.piece(
        "pre3", _pre3, config, xs, si, y_lens, caption_embs, null_emb, prefix_buf, n_den, extra, use_prefix)
    y_null = null_emb[None].expand(n_seg, L, null_emb.shape[-1])
    ks, ke = si.kv_start[:n_seg], si.kv_end[:n_seg]
    meta = functools.partial(_step_meta, si, ctn=ctn, HP=HP, WP=WP, use_cache=True, extra=extra)
    if pack:
        xa, ta, ya, drop, ksa, kea, lensa, toffa = run.piece(
            "pack", _pack_inputs, x_chunk, t_vec, y_text, y_null, lens_text, lens_null, t_off, ks, ke, si.cache_sp,
            n_seg, n_den, cw, ctn)
        va = forward(xa, ta, ya, drop, meta(n=n_seg + n_den, lens=lensa, ks=ksa, ke=kea, update=False), toffa,
                     tag="pack")
        v1, v3 = va[:, : n_seg * cw], va[:, n_seg * cw :]
    else:
        v1 = forward(x_chunk, t_vec, y_text, False, meta(n=n_seg, lens=lens_text, ks=ks, ke=ke, update=False), t_off,
                     tag="text")
        uncond = (config, params, x_chunk, t_vec, y_null, lens_null, si, n_den, ctn, HP, WP)
        if mesh_lib.model_parallel_trivial():
            v3 = run.piece("uncond", _uncond, G.PLAIN, *uncond)
        else:  # its collectives run between pieces
            v3 = _uncond(run, *uncond)
    v2 = forward(x_chunk, t_vec, y_null, True, meta(n=n_seg, lens=lens_null, ks=ks, ke=ke, update=True), t_off,
                 tag="null")
    run.piece("combine3", _combine3, xs, si, x_chunk, v1, v2, v3, n_den, extra, cw)


def _pre1_nearly(config, xs, si, y_lens, caption_embs, null_emb, prefix_buf, n_den, extra, use_prefix, ctn):
    """`_window_inputs` with the ride-along chunk: a copy of the first
    denoised chunk as one more segment that attends only itself (text
    only, never written to the cache).  Returns the window, then the
    forward's latents, timesteps, captions, lengths, offsets and ranges."""
    cw = config.runtime_config.chunk_width
    n_seg = n_den + int(extra)
    ss = int(extra)
    x_chunk, tvec, y_text, lens_text, t_off = _window_inputs(config, xs, si, y_lens, caption_embs, null_emb,
                                                             prefix_buf, n_den, extra, use_prefix)
    vmax = ((si.cache_sp + n_seg) * ctn).reshape(1)
    chunk_patches = cw // config.model_config.t_patch_size
    return (x_chunk, torch.cat([x_chunk, x_chunk[:, ss * cw : (ss + 1) * cw]], dim=1),
            torch.cat([tvec, tvec[ss : ss + 1]]), torch.cat([y_text, y_text[ss : ss + 1]], dim=0),
            torch.cat([lens_text, lens_text[ss : ss + 1]]), torch.cat([t_off, ((si.sp + n_seg) * chunk_patches).reshape(1)]),
            torch.cat([si.kv_start[:n_seg], vmax]), torch.cat([si.kv_end[:n_seg], vmax + ctn]))


def _post1(xs, si, x_chunk, out, n_den, extra, cw, distill_nearly):
    """The ride-along chunk's blend prev_chunks_scale * (with previous
    chunks) + (1 - prev_chunks_scale) * (text only), then the Euler step
    into `xs`."""
    n_seg = n_den + int(extra)
    if distill_nearly:
        ss = int(extra)
        near_pre_text = out[:, ss * cw : (ss + 1) * cw]
        near_text = out[:, -cw:]
        blended = near_pre_text * si.pcs + near_text * (1 - si.pcs)
        out = torch.cat([out[:, : ss * cw], blended, out[:, (ss + 1) * cw : n_seg * cw]], dim=1)
    dw = n_den * cw
    _integrate_and_store(xs, x_chunk[:, -dw:], out[:, -dw:], si.dt[:n_den], si.sp + int(extra), cw, n_den)


def _cfg1_step(run, config, params, forward: Forward, xs, si, y_lens, caption_embs, null_emb, prefix_buf,
               distill_factor, *, n_den: int, extra: bool, use_prefix: bool, distill_nearly: bool) -> None:
    """One denoise step with single-branch CFG (the distill and quantized
    models): one forward on text + previous chunks, which writes the cache,
    with the ride-along chunk under `distill_nearly` (`_pre1_nearly`,
    `_post1`).  Pieces: pre1, the forward, post1."""
    cw = config.runtime_config.chunk_width
    n_seg = n_den + int(extra)
    HP, WP, ctn = _geometry(config, xs)
    args = (config, xs, si, y_lens, caption_embs, null_emb, prefix_buf, n_den, extra, use_prefix)
    if distill_nearly:
        x_chunk, x_in, t_in, y_in, lens, t_off, ks, ke = run.piece("pre1", _pre1_nearly, *args, ctn)
    else:
        x_chunk, t_in, y_in, lens, t_off = run.piece("pre1", _window_inputs, *args)
        x_in, ks, ke = x_chunk, si.kv_start[:n_seg], si.kv_end[:n_seg]
    meta = _step_meta(si, n_seg + int(distill_nearly), ctn, HP, WP, lens, ks, ke, update=True, use_cache=True,
                      extra=extra, distill_nearly=distill_nearly)
    out = forward(x_in, t_in, y_in, False, meta, t_off, distill_factor=distill_factor, tag="text")
    run.piece("post1", _post1, xs, si, x_chunk, out, n_den, extra, cw, distill_nearly)


def _warmup_inputs(config, si, n_chunks, device):
    chunk_patches = config.runtime_config.chunk_width // config.model_config.t_patch_size
    return (si.null_len.reshape(1).expand(n_chunks).contiguous(),
            torch.full((n_chunks,), float(config.runtime_config.clean_t), dtype=torch.float32, device=device),
            torch.arange(n_chunks, dtype=torch.int32, device=device) * chunk_patches)


def _prefix_warmup_step(run, config, forward: Forward, prefix_latent, null_emb, si, distill_factor, *,
                        n_chunks: int) -> None:
    """Forward the clean prefix chunks (prefix_latent [C, n_chunks * cw, H,
    W]) once with null captions at t = clean_t; the forward writes their
    KV into the cache from slot `si.cache_sp` (0) over `si`'s kv ranges."""
    HP, WP, ctn = _geometry(config, prefix_latent)
    lens, t, t_off = run.piece("warmup_pre", _warmup_inputs, config, si, n_chunks, prefix_latent.device)
    y = null_emb[None].expand(n_chunks, *null_emb.shape)
    meta = _step_meta(si, n_chunks, ctn, HP, WP, lens, si.kv_start[:n_chunks], si.kv_end[:n_chunks], update=True,
                      use_cache=True, extra=False)
    forward(prefix_latent, t, y, True, meta, t_off, distill_factor=distill_factor, tag="warmup")


def _layer_in_place(params, config, idx, h, cache_l, condition, y_xattn, sin, cos, meta) -> None:
    """Layer `idx` of the streamed forward, its output written over `h`."""
    h.copy_(dit_layer_step(params, config, idx, h, cache_l, condition, y_xattn, sin, cos, meta))

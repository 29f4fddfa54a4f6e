"""One run of a cell: set-up, the measured window, the check, the metrics.

The window drives one text-to-video request through the program's pieces as
`MagiPipeline._run` composes them, without its file writing: the inputs
(`prompt_process.build_inference_input`), the walk (`ArdfSampler`, its
steps replayed from CUDA graphs: `warm_step_variants`, `prepare`,
`timed_step`) and the VAE decode of every chunk the walk emits
(`video_process.post_chunk_process`).  Set-up makes the weights and inputs
from the seed, builds the DiT tree through the program's `TreeSink` (which
quantizes a quantized config's linears leaf by leaf), installs the VAE
where `video_process.get_vae` keeps it, and warms and captures the walk's
step variants and the decode on a first sampler, which it then releases:
the window's request takes that idle workspace and captures nothing, as a
resident engine's second request does.  The window opens at the request's
start, or, where the traffic names a lead-in (`lead_in_steps`), after the
steps it names, so that the window holds the walk's steady state; the
request's first chunk is timed from its start in both.

After the window the run reads the peak memory, frees the program's state
and holds what the window produced against the plain reference
(`benchmark.reference`): a few denoise steps drawn from the seed, and the
decode of the first emitted chunk.  The reference can only follow the walk
step by step from the program's latent state (the step's input frames, as
the program held them before the step), with two exceptions that check what
this skips: step 0 starts from the benchmark's own noise, and the keys and
values a step reads from the KV cache are worked out again from the clean
chunk they belong to.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import json
import sys
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from benchmark import cells, schedule, trace as tr, weights as W, work
from benchmark.reference import dit as ref_dit, vae as ref_vae

FORBIDDEN = ("jax", "jaxlib", "flax", "magi_tpu")


def forbidden_modules() -> List[str]:
    """Top-level names of loaded modules that the run may not hold, compared whole."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


@dataclasses.dataclass
class Reading:
    """What a run measured, for the metric readers (`metrics/<name>.py`)."""

    cfg: dict  # the program's config dict, as run
    chunk_num: int
    caption_tokens: int
    frames_per_chunk: int
    setup_s: float
    window_s: float
    steps: List[tuple]  # (step index, host seconds) of the window's steps
    chunk_steps: int  # chunks denoised by one step, summed over the window's steps
    first_chunk_s: Optional[float]
    peak_bytes: int
    decode_seconds: List[float]
    capture_seconds: float
    trace: Optional[tr.Trace] = None
    groups: Optional[tr.KernelGroups] = None

    @property
    def num_steps(self) -> int:
        return self.cfg["runtime_config"]["num_steps"]

    def ops(self) -> List[work.Op]:
        """The work of the window's steps, counted from the config."""
        return work.window_ops(self.cfg, self.caption_tokens, [i for i, _ in self.steps], self.chunk_num)


def checked_steps(seed: int, rc: dict, ec: dict, chunk_num: int, total: int) -> List[int]:
    """The steps whose output the reference recomputes: step 0 (from the
    noise) and, drawn from the seed among the first two stages that have
    each, a step with the window full and nothing cached, a step that
    writes a clean chunk's keys and values into the cache, and a step that
    reads them from it.  Under three-branch CFG, where none of these has
    denoised chunks under different guidance scales, one more step that
    has, drawn alike, so that a wrong scale lookup shows."""
    rng = np.random.default_rng(W.sub_seed(seed, "checks"))
    dpss = rc["num_steps"] // rc["window_size"]
    plans = [schedule.plan(rc, ec, chunk_num, i) for i in range(total)]
    kinds = [lambda p: p.n_den == rc["window_size"] and not p.extra and not p.cached,
             lambda p: p.extra, lambda p: bool(p.cached)]
    out = {0}

    def draw(kind):
        stages = sorted({p.index // dpss for p in plans if kind(p)})[:2]
        pool = [p.index for p in plans if kind(p) and p.index // dpss in stages]
        if pool:
            out.add(int(rng.choice(pool)))

    for kind in kinds:
        draw(kind)
    mixed = lambda p: len(set(p.scales)) > 1  # noqa: E731
    if rc["cfg_number"] == 3 and not any(mixed(plans[i]) for i in out):
        draw(mixed)
    return sorted(out)


def lead_in_steps(traffic: dict, rc: dict, ec: dict, chunk_num: int, total: int) -> int:
    """The steps the request runs before the window opens, by the traffic's
    `lead_in`: none (absent or "none"), or "ramp", the walk's first stages
    up to the step that writes the first clean chunk's keys and values into
    the cache, so that the window holds the steady state."""
    lead_in = traffic.get("lead_in", "none")
    if lead_in == "none":
        return 0
    if lead_in == "ramp":
        return next(i for i in range(total) if schedule.plan(rc, ec, chunk_num, i).extra)
    raise ValueError(f"lead_in {lead_in!r}: the harness knows 'none' and 'ramp'")


def _span(on: bool, name: str):
    return torch.profiler.record_function(name) if on else contextlib.nullcontext()


def build_dit(cfg: dict, config, seed: int, device, smooth) -> dict:
    """The DiT tree as the program builds it: every leaf through its
    `TreeSink` (quantizing a quantized config's linears as they arrive)."""
    from magi_tpu_torch.ops.quant import TreeSink
    from magi_tpu_torch.pipeline.pipeline import _quant_bits

    mc = cfg["model_config"]
    L = mc["num_layers"]
    leaves = list(W.dit_leaves(mc, smooth))
    smooths = {lf.path[: -len("/act_smooth")]: W.draw_stacked(lf, seed, device, L) for lf in leaves
               if lf.law == "smooth"}
    sink = TreeSink(_quant_bits(config))
    for lf in leaves:
        if lf.law == "smooth":
            continue
        if not lf.stacked:
            sink.leaf(lf.path, W.draw(lf, seed, device))
        elif lf.law == "lin":
            node = lf.path[: -len("/weight")]
            sink.linear(node, W.draw_stacked(lf, seed, device, L), smooths.get(node))
        else:
            sink.leaf(lf.path, W.draw_stacked(lf, seed, device, L))
    return sink.tree()


def install_vae(vc: dict, config, seed: int, device):
    """The VAE decoder drawn from the seed, put where `get_vae` keeps the
    VAE it loaded, so the program's decode serves it."""
    from magi_tpu_torch.core.utils import nest
    from magi_tpu_torch.models.vae.model import VaeConfig, ViTVAE
    from magi_tpu_torch.pipeline import video_process

    flat = {lf.path[len("vae/"):]: (W.draw_stacked(lf, seed, device, vc["depth"]) if lf.stacked
                                    else W.draw(lf, seed, device)) for lf in W.vae_leaves(vc)}
    vae = ViTVAE(VaeConfig(**vc), nest(flat.items()))
    mc = config.model_config
    key = (config.runtime_config.vae_pretrained, str(device), mc.out_channels // (2 if mc.half_channel_vae else 1))
    video_process._vae_cache[key] = vae
    return key


def pool_bytes(device) -> Dict[str, int]:
    """The caching allocator's segments on `device` split by pool: bytes the
    default pool holds unallocated, and bytes the private pools (the CUDA
    graphs' and the VAE's) hold in all and unallocated.  A captured step's
    activations live in its private pool unallocated between replays."""
    out = {"default_free": 0, "graph_pools": 0, "graph_pools_free": 0}
    for seg in torch.cuda.memory_snapshot():
        if seg["device"] != torch.device(device).index:
            continue
        free = seg["total_size"] - seg["allocated_size"]
        if tuple(seg["segment_pool_id"]) == (0, 0):
            out["default_free"] += free
        else:
            out["graph_pools"] += seg["total_size"]
            out["graph_pools_free"] += free
    return out


def run(cell: cells.Cell, seed: int, seconds: float, trace: bool, device: str, t_start: float,
        control: Optional[str] = None, trace_path: Optional[str] = None) -> dict:
    """One run; returns the result line's object (and its checks).  `control`
    names one of the configuration's controls to run in the program's place:
    a lower-precision path of the program, or, where the control names
    `reference` sections, the plain reference at those settings, put in
    place of the program's denoise steps on the same inputs."""
    from magi_tpu_torch.core import graphs as G
    from magi_tpu_torch.core.config import MagiConfig
    from magi_tpu_torch.pipeline import video_process
    from magi_tpu_torch.pipeline.prompt_process import build_inference_input
    from magi_tpu_torch.pipeline.video_process import post_chunk_process
    from magi_tpu_torch.sampling.transport import ArdfSampler

    dev = torch.device(device)
    on_card = dev.type == "cuda"
    cfg = cell.program_config(control)
    config = MagiConfig.from_dict(cfg)
    rc, ec, mc = cfg["runtime_config"], cfg["engine_config"], cfg["model_config"]
    smooth = tuple(cell.config.get("smooth_linears", ()))
    tokens = int(cell.traffic["caption_tokens"])
    embs, mask = W.caption(seed, mc["caption_max_length"], mc["caption_channels"], tokens)

    # ----- set-up -----
    params = build_dit(cfg, config, seed, dev, smooth)
    vae_key = install_vae(cell.config["vae"], config, seed, dev)
    null_caption = params["y_embedder"]["null_caption_embedding"].float().cpu().numpy()
    inp = build_inference_input(config, null_caption, embs, mask, dev)
    noise = W.noise(seed, tuple(inp.latent_size), dev)
    chunk_num, cw = inp.chunk_num, rc["chunk_width"]
    warm = ArdfSampler(config, params, inp, noise=noise, device=dev, capture=True)
    total = warm.total_forward_steps()
    variants = warm.warm_step_variants()
    capture_s, graphs = warm.capture_seconds, warm.graphs
    post_chunk_process(torch.zeros_like(noise[:, :cw]), config, dev)  # captures the decode
    warm.release()
    del warm
    checks = checked_steps(seed, rc, ec, chunk_num, total)
    plans = {i: schedule.plan(rc, ec, chunk_num, i) for i in checks}
    n_den = [schedule.plan(rc, ec, chunk_num, i).n_den for i in range(total)]
    snaps = {i: (torch.empty((noise.shape[0], (p.c_end - p.lo) * cw) + noise.shape[2:], pin_memory=on_card),
                 torch.empty((noise.shape[0], p.n_den * cw) + noise.shape[2:], pin_memory=on_card))
             for i, p in plans.items()}
    kv_step = next((i for i, p in plans.items() if p.extra), None)
    cache_kv = None  # the program's layer-0 keys and values of the clean chunk that step writes
    captures0 = G.captures("walk")
    log(f"set-up: {variants} step variants, {graphs} graphs captured in {capture_s:.3f} s; {total} steps in the "
        f"walk of {chunk_num} chunks; caption {tokens} tokens; checked steps {checks}")
    lead = lead_in_steps(cell.traffic, rc, ec, chunk_num, total)
    if on_card:
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    prof = None

    def start_trace():
        nonlocal prof
        if trace:
            from torch.profiler import ProfilerActivity, profile

            prof = profile(activities=[ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card else []))
            prof.__enter__()

    if not lead:
        start_trace()

    # ----- one request from its start; the window opens with it, or after the traffic's lead-in -----
    t0 = time.perf_counter()
    setup_s = t0 - t_start
    steps: List[tuple] = []
    chunk_steps, step = 0, 0
    decode_seconds: List[float] = []
    first = None  # (seconds from t0, frames, latent on the host)

    def one_step(sampler, timed: bool):
        nonlocal step, chunk_steps, first, cache_kv
        snap = snaps.get(step)
        p = plans.get(step)
        if snap is not None:
            snap[0].copy_(sampler.xs[:, p.lo * cw : p.c_end * cw], non_blocking=True)
        with _span(timed and trace, "bench/step"):
            emitted = sampler.timed_step(step)
        if snap is not None:
            snap[1].copy_(sampler.xs[:, p.c_start * cw : p.c_end * cw], non_blocking=True)
        if step == kv_step:
            ctn = sampler.ctn
            slot = p.sp - sampler.cache_base
            cache_kv = cache_rows(sampler.cache, slot * ctn, (slot + 1) * ctn)
        if timed:
            steps.append((step, sampler.step_seconds[-1]))
            chunk_steps += n_den[step]
        if emitted is not None and (timed or first is None):
            with _span(timed and trace, "bench/decode"):
                td = time.perf_counter()
                frames = post_chunk_process(emitted[1], config, dev)
                if timed:
                    decode_seconds.append(time.perf_counter() - td)
            if first is None:
                first = (time.perf_counter() - t0, frames, emitted[1].cpu())
        step += 1

    def request():
        with _span(trace, "bench/request"):
            inp = build_inference_input(config, null_caption, embs, mask, dev)
            sampler = ArdfSampler(config, params, inp, noise=noise, device=dev, capture=True)
            sampler.warm_step_variants()
            sampler.prepare()
        return sampler, inp

    def window(sampler, deadline):
        while step < total and time.perf_counter() < deadline:
            one_step(sampler, True)

    if lead:
        sampler, inp = request()
        while step < lead:
            one_step(sampler, False)
        start_trace()
        w0 = time.perf_counter()
        with _span(trace, "bench/window"):
            window(sampler, w0 + seconds)
    else:
        w0 = t0
        with _span(trace, "bench/window"):
            sampler, inp = request()
            window(sampler, w0 + seconds)
    window_s = time.perf_counter() - w0
    # allocated, and the graph pools' unallocated bytes: a captured step's
    # activations live there, reserved for the replays and never allocated
    peak_reserved = torch.cuda.max_memory_reserved(dev) if on_card else 0
    peak_allocated = torch.cuda.max_memory_allocated(dev) if on_card else 0
    pools = pool_bytes(dev) if on_card else {"default_free": 0, "graph_pools": 0, "graph_pools_free": 0}
    peak = peak_allocated + pools["graph_pools_free"]
    captured = G.captures("walk") - captures0
    reading_trace = None
    if prof is not None:
        prof.__exit__(None, None, None)
        prof.export_chrome_trace(trace_path)
        reading_trace = tr.Trace(trace_path)
        del prof
    # answers due: the checked steps and the first chunk, however late
    while step < total and (step <= max(checks) or first is None):
        one_step(sampler, False)
    if on_card:
        torch.cuda.synchronize(dev)
    log(f"window: after {lead} lead-in steps, {len(steps)} steps ({chunk_steps} chunk-steps) and {len(decode_seconds)} decodes in "
        f"{window_s:.3f} s; {captured} graphs captured in it; first chunk at "
        f"{'none' if first is None else f'{first[0]:.3f} s'}; peak {peak} bytes ({peak_allocated} allocated + "
        f"{pools['graph_pools_free']} unallocated in graph pools of {pools['graph_pools']}); reserved {peak_reserved}, "
        f"{pools['default_free']} of it unallocated in the default pool")
    bad = forbidden_modules()
    if bad:
        raise SystemExit(f"the run loaded {bad}: the benchmark may not import them")

    # ----- free the program, then the reference -----
    sampler.release()
    del sampler, params, inp
    G.release_workspaces()
    video_process._vae_cache.pop(vae_key, None)
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    # the reference's f32 matmuls and convolution in f32, not TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ref_cfg = cell.program_config(None)
    limits = cell.limits or {}
    taus = {k: lim["tau"] for k, lim in limits.items() if "tau" in lim}
    values = check(ref_cfg, cell.config, seed, dev, plans, snaps, noise, first, caption=embs[0], tokens=tokens,
                   smooth=smooth, control=control is not None, taus=taus, cache_kv=(kv_step, cache_kv),
                   ref_control=cell.config["controls"][control].get("reference") if control else None)
    del noise
    log("readings: " + json.dumps(values))
    if limits:
        checks_out = {k: {"value": values[k], "limit": lim["limit"]} for k, lim in limits.items()}
        correct = all(c["value"] <= c["limit"] for c in checks_out.values())
    else:  # no limits set yet: every number, and not correct
        checks_out = {k: {"value": v, "limit": None} for k, v in values.items()}
        correct = False

    reading = Reading(cfg=cfg, chunk_num=chunk_num, caption_tokens=tokens,
                      frames_per_chunk=cw * rc["temporal_downsample_factor"], setup_s=setup_s, window_s=window_s,
                      steps=steps, chunk_steps=chunk_steps, first_chunk_s=None if first is None else first[0],
                      peak_bytes=peak, decode_seconds=decode_seconds, capture_seconds=capture_s,
                      trace=reading_trace, groups=tr.KernelGroups())
    wanted = cell.per_layer if trace else cell.end_to_end
    metrics = {}
    for m in wanted:
        v = cells.reader(cell.bench_dir, m["name"])(reading)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    device_info = {"platform": "gpu" if on_card else "cpu",
                   "kind": torch.cuda.get_device_name(dev) if on_card else "cpu",
                   "count": 1, "memory_peak_bytes": int(peak)}
    result = {"correct": bool(correct), "attempted": len(steps), "failed": 0, "metrics": metrics,
              "device": device_info}
    if reading_trace is not None:
        device_info.update(busy_s=reading_trace.busy_s(), window_s=reading_trace.window_s)
        groups = reading.groups
        by_group = sorted(reading_trace.group_seconds(groups).items(), key=lambda kv: -kv[1])[:10]
        result["breakdown"] = {"device_ops": [[groups.names[k], s] for k, s in by_group],
                               "idle_gaps": [[n, s] for n, s in reading_trace.idle_gaps()]}
    result["checks"] = checks_out
    return result


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    """|a - b| / |b| (L2 norms, f64)."""
    a, b = a.double(), b.double()
    return float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b))


TAILS = (0.02, 0.05, 0.1, 0.25, 0.5)  # the tails logged for setting a new cell's limits


def _tail(d_prog: torch.Tensor, d_ref: torch.Tensor, t: float) -> float:
    """The share of d_prog's values off d_ref by more than t times d_ref's rms."""
    rms = float(d_ref.double().square().mean().sqrt())
    return float(((d_prog.double() - d_ref.double()).abs() > t * rms).double().mean())


def step_numbers(d_prog: torch.Tensor, d_ref: torch.Tensor, n_chunks: int, taus) -> dict:
    """A step's numbers from its updates [C, n_chunks * cw, H, W]: the
    relative L2 gap and, for each tau, the share of the step's values off by
    more than tau times the reference update's rms (step_tail_<tau>); the
    same of each chunk against its own update's rms, the largest over the
    chunks (chunk_gap, chunk_tail_<tau>), since the chunks of a step move by
    different amounts."""
    C, T = d_ref.shape[:2]
    chunks = list(zip(d_prog.reshape(C, n_chunks, T // n_chunks, -1).unbind(1),
                      d_ref.reshape(C, n_chunks, T // n_chunks, -1).unbind(1)))
    out = {"step_gap": _rel(d_prog, d_ref), "chunk_gap": max(_rel(a, b) for a, b in chunks)}
    out.update({f"step_tail_{t}": _tail(d_prog, d_ref, t) for t in taus})
    out.update({f"chunk_tail_{t}": max(_tail(a, b, t) for a, b in chunks) for t in taus})
    return out


def cache_rows(cache, lo: int, hi: int) -> torch.Tensor:
    """Layer 0's keys and values of cache tokens [lo, hi), f32 [2, hk, hi - lo,
    hd] on the host, from the program's KV cache: one [L, 2, hk, tok, hd]
    tensor, or the int8 dict {kv, scale [L, 2, hk, tok]} (`init_kv_cache`)."""
    if isinstance(cache, dict):
        return cache["kv"][0, :, :, lo:hi].float().cpu() * cache["scale"][0, :, :, lo:hi, None].cpu()
    return cache[0, :, :, lo:hi].float().cpu()


def _decode_off(frames: np.ndarray, ref: np.ndarray) -> float:
    """The share of uint8 frame values two or more levels off the reference's."""
    return float((np.abs(frames.astype(np.int16) - ref.astype(np.int16)) >= 2).mean())


def reference_forwards(rc: dict, p: schedule.Step, x_in: torch.Tensor, device) -> List[ref_dit.Forward]:
    """The reference's forwards of step `p` on its frames `x_in` (chunks p.lo
    to p.c_end), one for each of the step's (`schedule.Step.forwards`).  In
    a forward that reads the cache, the cached chunks stand in for the KV
    cache, their keys and values worked out again from their clean frames
    as the forward that wrote them did (with its caption dropout).  The
    uncond forward holds the denoised chunks alone, in slots from 0."""
    cw = rc["chunk_width"]
    writer_drop = next(drop for _, drop, writes in p.forwards if writes)
    out = []
    for k, (segments, drop, _) in enumerate(p.forwards):
        if p.scales and k == 2:
            segs, pos, rope = list(segments), list(range(len(segments))), [s.pos for s in segments]
            drops = [drop] * len(segs)
        else:
            segs = [schedule.Segment(src=c, pos=c, t=float(rc["clean_t"]), text=False, kv=(c, c + 1))
                    for c in p.cached] + list(segments)
            pos, rope = [s.pos for s in segs], None
            drops = [writer_drop] * len(p.cached) + [drop] * len(segments)
        x = torch.cat([x_in[:, (s.src - p.lo) * cw : (s.src - p.lo + 1) * cw] for s in segs], dim=1)
        out.append(ref_dit.Forward(x=x.to(device), pos=pos, t=[s.t for s in segs], text=[s.text for s in segs],
                                   kv=[s.kv for s in segs], drop=drops, rope=rope))
    return out


def reference_update(rc: dict, p: schedule.Step, vels: List[torch.Tensor]) -> torch.Tensor:
    """The reference's change to the latents step `p` denoises, from the
    velocities of its forwards (`reference_forwards`): v * dt per chunk.
    Under three-branch CFG v = (1 - p) u + (p - s) c2 + s c1 per chunk, from
    the text (c1), null-caption (c2) and uncond (u) forwards, in f32."""
    cw = rc["chunk_width"]
    v = vels[0][:, len(p.cached) * cw :].float().cpu()  # the window's segments and the ride-along
    n_win = len(p.segments) - int(p.nearly)
    if p.nearly:
        ss = int(p.extra)
        v[:, ss * cw : (ss + 1) * cw] = v[:, ss * cw : (ss + 1) * cw] * 0.7 + v[:, -cw:] * 0.3
    v = v[:, (n_win - p.n_den) * cw : n_win * cw]
    if p.scales:
        c1 = v
        c2 = vels[1][:, (len(p.cached) + n_win - p.n_den) * cw :].float().cpu()
        u = vels[2].float().cpu()
        ps, ts = (torch.tensor(x, dtype=torch.float32).repeat_interleave(cw)[None, :, None, None]
                  for x in zip(*p.scales))
        v = (1 - ps) * u + (ps - ts) * c2 + ts * c1
    dt = torch.tensor(p.dt, dtype=torch.float32).repeat_interleave(cw)[None, :, None, None]
    return v * dt


def check(cfg: dict, conf: dict, seed: int, device, plans: Dict[int, schedule.Step], snaps: dict,
          noise: torch.Tensor, first, *, caption: np.ndarray, tokens: int, smooth, control: bool,
          taus: Dict[str, float], cache_kv: tuple = (None, None), ref_control: Optional[dict] = None) -> dict:
    """The numbers a run is judged by; its cell's limits file says which, and
    gives the tau of each tail in `taus` (name -> tau).

    For each checked step, d = x_after - x_before is the step's change to the
    latents it denoises: the program's from its frames before and after the
    step, the reference's from its velocity and the step's dt on the same
    frames before (on the benchmark's own noise for step 0).  Each of
    `step_numbers` is taken as its largest over the steps, and a tail named
    in `taus` at its tau.  decode_off is the share of the first emitted
    chunk's uint8 frame values two or more levels off the reference's
    decode of the latent the program emitted; in a control run the compared
    frames are the reference's own at int8 (the VAE's control).  cache_gap
    is the relative L2 gap of the keys and values of layer 0 (a layer of
    bf16 linears in every configuration) that the step `cache_kv[0]` wrote
    into the KV cache for its clean chunk, `cache_kv[1]`, against the
    reference's.  With `ref_control` (section overrides of `cfg`), the
    updates and keys and values judged are the reference's own under those
    overrides, on the program's inputs: a control the program has no path
    for."""
    rc = cfg["runtime_config"]
    cw = rc["chunk_width"]
    all_taus = sorted(set(TAILS) | set(taus.values()))
    fwds, meta = [], []
    for i, p in sorted(plans.items()):
        before, after = snaps[i]
        x_in = noise[:, p.lo * cw : p.c_end * cw].cpu() if i == 0 else before
        step_fwds = reference_forwards(rc, p, x_in, device)
        if i == cache_kv[0]:
            tp, pp = cfg["model_config"]["t_patch_size"], cfg["model_config"]["patch_size"]
            ctn = cw // tp * (x_in.shape[2] // pp) * (x_in.shape[3] // pp)
            writer = next(f for f, (_, _, writes) in zip(step_fwds, p.forwards) if writes)
            writer.kv_rows = (len(p.cached) * ctn, (len(p.cached) + 1) * ctn)
        meta.append((i, p, x_in, after, len(fwds), len(step_fwds)))
        fwds += step_fwds
    outs = ref_dit.velocities(cfg, seed, device, fwds, torch.from_numpy(caption), tokens, smooth)
    if ref_control is not None:
        cfg_c = {k: dict(v, **ref_control.get(k, {})) for k, v in cfg.items()}
        fwds_c = [dataclasses.replace(f, kv0=None) for f in fwds]
        outs_c = ref_dit.velocities(cfg_c, seed, device, fwds_c, torch.from_numpy(caption), tokens, smooth)
        kv0_c = next((f.kv0 for f in fwds_c if f.kv0 is not None), None)
        cache_kv = (cache_kv[0], kv0_c)
    steps = []
    for i, p, x_in, after, k, n in meta:
        if ref_control is not None:
            d_prog = reference_update(rc, p, outs_c[k : k + n])
        else:
            d_prog = after.float() - x_in[:, (p.c_start - p.lo) * cw : (p.c_end - p.lo) * cw].float()
        steps.append(step_numbers(d_prog, reference_update(rc, p, outs[k : k + n]), p.n_den, all_taus))
        log(f"check: step {i} (chunks {p.c_start}-{p.c_end - 1}, extra {p.extra}, nearly {p.nearly}, cached "
            f"{list(p.cached)}): " + ", ".join(f"{k} {v:.6g}" for k, v in steps[-1].items()))
    out = {k: max(st[k] for st in steps) for k in steps[0]}
    out.update({name: out[f"{name}_{tau}"] for name, tau in taus.items()})
    kv0 = next((f.kv0 for f in fwds if f.kv0 is not None), None)
    if kv0 is not None:
        prog = cache_kv[1]
        out.update(cache_gap=_rel(prog, kv0), cache_gap_k=_rel(prog[0], kv0[0]), cache_gap_v=_rel(prog[1], kv0[1]))
        log(f"check: the KV cache's layer 0 at step {cache_kv[0]}: cache_gap {out['cache_gap']:.6g} (keys "
            f"{out['cache_gap_k']:.6g}, values {out['cache_gap_v']:.6g})")
    _, frames, latent = first
    vc = conf["vae"]
    ref = ref_vae.decode_chunk(vc, seed, device, latent, rc["scale_factor"], rc["fps"])
    if control:
        frames = ref_vae.decode_chunk(vc, seed, device, latent, rc["scale_factor"], rc["fps"], int8=True)
    out["decode_off"] = _decode_off(frames, ref)
    return out

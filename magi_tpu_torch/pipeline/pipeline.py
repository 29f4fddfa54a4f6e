"""User-facing pipeline: MagiPipeline.run_{text,image,video}_to_video and,
for several prompts, run_text_to_video_batch (lockstep) and
run_text_to_video_many (interleaved).

This port runs the single-device paths: text-to-video, image-to-video (the
image's latent as a one-frame prefix) and video-to-video (the latent of a
prefix video's first 32 frames), for the bf16 base model (3-branch CFG,
in three forwards a step or two under `engine_config.pack_uncond`) and the
distill / quantized models (single-branch CFG, `fp8_quant` or
`MAGI_INT8=1`): int8 weights, or nibble-packed int4 weights (w4a8) under
`quant_bits: 4` or `MAGI_INT4=1`, as the 24B runs on one device, with int8
attention when `engine_config.attn_int8` or `MAGI_ATTN_INT8=1` is set (its
scheme from `MAGI_ATTN_Q8_SCHEME`: qk8, sage or dq); the KV cache on the
device, or under `kv_offload` with the default kv ranges in pinned host
memory, streamed a layer at a time.  The weights come from the released
checkpoints the config names (`load`, the fp8 variant under `fp8_quant`;
`vae_pretrained`; `t5_pretrained`, on the host or staged onto the device
as `t5_device` says), or are random under SKIP_LOAD_MODEL=1.  With
MAGI_PROFILE_DIR set, each walk is traced (`core.profiler.maybe_trace`).
On the card the denoise steps and the VAE run as CUDA graphs (`core.graphs`,
the counterpart of the JAX package's jit); `MagiPipeline(capture=False)`
walks eagerly.  Multi-device parallelism raises `NotImplementedError`
naming its ROADMAP item.
"""

from __future__ import annotations

import contextlib
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import List, Sequence

import numpy as np
import torch

from magi_tpu_torch.core.config import MagiConfig
from magi_tpu_torch.core.graphs import uncounted
from magi_tpu_torch.core.logger import print_rank_0
from magi_tpu_torch.core.profiler import log_memory, maybe_trace
from magi_tpu_torch.core.timer import event_path_timer
from magi_tpu_torch.core.utils import env_is_true, resolve_device, set_random_seed
from magi_tpu_torch.pipeline.prompt_process import build_inference_input, get_txt_embeddings
from magi_tpu_torch.pipeline.video_process import (
    post_chunk_process,
    process_image,
    process_prefix_video,
    save_video_to_disk,
)
from magi_tpu_torch.sampling.batched import DpBatchedSampler
from magi_tpu_torch.sampling.transport import ArdfSampler, walk_many


def get_dit(config: MagiConfig, device: torch.device, generator: torch.Generator) -> dict:
    """The DiT parameters: the checkpoint of `runtime_config.load` (its
    fp8 variant dequantized on `device`, with the smooth-quant factors),
    or random weights under SKIP_LOAD_MODEL=1; then quantized (first/last
    layers kept bf16, smooth-quant linears folded) when `fp8_quant`,
    `MAGI_INT8=1` or `MAGI_INT4=1` is set: to nibble-packed int4 under
    `quant_bits: 4` or `MAGI_INT4=1`, else to int8."""
    from magi_tpu_torch.ops.quant import quantize_params_int4, quantize_params_int8

    if env_is_true("SKIP_LOAD_MODEL"):
        from magi_tpu_torch.models.dit.model import init_dit_params

        print_rank_0("SKIP_LOAD_MODEL set: using random weights")
        params = init_dit_params(config, device, generator)
    else:
        from magi_tpu_torch.checkpoint.loader import load_dit_params

        params = load_dit_params(config, device)
        print_rank_0("Load checkpoint successfully")
    if config.engine_config.fp8_quant or env_is_true("MAGI_INT8") or env_is_true("MAGI_INT4"):
        if config.engine_config.quant_bits == 4 or env_is_true("MAGI_INT4"):
            params = quantize_params_int4(params)
            print_rank_0("Quantized DiT linears to nibble-packed int4 (w4a8; first and last layers bf16)")
        else:
            params = quantize_params_int8(params)
            print_rank_0("Quantized DiT linears to int8 (first and last layers bf16)")
    return params


def _check_supported(config: MagiConfig) -> None:
    """Engine settings the model would otherwise ignore (the sampler, the
    model and get_dit refuse the rest)."""
    if config.engine_config.world_size > 1:
        raise NotImplementedError("multi-GPU parallelism is ROADMAP queue 1 item 14")


class MagiPipeline:
    def __init__(self, config_path: str, device=None, capture: bool = True):
        self.config = MagiConfig.from_json(config_path)
        _check_supported(self.config)
        self.device = resolve_device(device)
        self.capture = capture  # the samplers' (`ArdfSampler`): CUDA graphs on the card
        self.generator = set_random_seed(self.config.runtime_config.seed, self.device)
        print_rank_0(self.config)

    def run_text_to_video(self, prompt: str, output_path: str) -> dict:
        """Generate a video for `prompt` and write it to `output_path`;
        returns the stats of `_run`."""
        return self._run(prompt, None, output_path)

    def run_image_to_video(self, prompt: str, image_path: str, output_path: str) -> dict:
        """The same, continuing the image at `image_path`."""
        return self._run(prompt, process_image(image_path, self.config, self.device), output_path)

    def run_video_to_video(self, prompt: str, prefix_video_path: str, output_path: str) -> dict:
        """The same, continuing the video at `prefix_video_path`."""
        return self._run(prompt, process_prefix_video(prefix_video_path, self.config, self.device), output_path)

    def _request_generator(self, i: int) -> torch.Generator:
        """Request i's generator of a multi-request run, derived from the
        run's seed and i."""
        gen = torch.Generator(device=self.device)
        gen.manual_seed(int(np.random.SeedSequence([self.config.runtime_config.seed, i]).generate_state(1)[0]))
        return gen

    def _prepare_requests(self, prompts: Sequence[str], output_paths: Sequence[str]):
        if not prompts or len(prompts) != len(output_paths):
            raise ValueError(f"{len(prompts)} prompts need as many output paths, got {len(output_paths)}")
        params = get_dit(self.config, self.device, self.generator)
        null_caption = params["y_embedder"]["null_caption_embedding"].float().cpu().numpy()
        inps = [build_inference_input(self.config, null_caption, *get_txt_embeddings(p, self.config, self.device),
                                      self.device) for p in prompts]
        return params, inps, [self._request_generator(i) for i in range(len(prompts))]

    def run_text_to_video_batch(self, prompts: Sequence[str], output_paths: Sequence[str]) -> List[dict]:
        """Generate a video for each prompt, the requests denoised in
        lockstep (`DpBatchedSampler`, one host scheduler; every kernel at its
        single-request shape).  Requests whose schedules differ
        (`check_lockstep`) go to `run_text_to_video_many`'s interleaved walk
        instead.  Returns one stats dict per request, as `_run`'s, with the
        run's wall seconds and its mode."""
        t0 = time.perf_counter()
        params, inps, gens = self._prepare_requests(prompts, output_paths)
        why = next(filter(None, (DpBatchedSampler.check_lockstep(inps[0], inp) for inp in inps[1:])), None)
        if why is not None:
            print_rank_0(f"lockstep batch impossible ({why}); falling back to interleaved mode")
            return self._walk_many(params, inps, gens, output_paths, t0)
        sampler = DpBatchedSampler(self.config, params, inps, gens, device=self.device, capture=self.capture)
        R = len(prompts)
        segments, decode_seconds, finite = [[] for _ in range(R)], [[] for _ in range(R)], [True] * R
        with maybe_trace("walk_batch", self.device):
            for chunk_idx, chunks in sampler.walk():  # [R, C, <=cw, H, W]
                for r in range(R):
                    finite[r] = finite[r] and bool(torch.isfinite(chunks[r]).all())
                    td = time.perf_counter()
                    segments[r].append(post_chunk_process(chunks[r], self.config, self.device))
                    decode_seconds[r].append(time.perf_counter() - td)
                print_rank_0(f"chunk {chunk_idx + 1}/{inps[0].chunk_num} done (batch of {R})")
        wall = time.perf_counter() - t0
        log_memory("after batched walk", self.device)
        return [dict(self._write(segments[r], output_paths[r], finite[r], sampler.step_seconds, decode_seconds[r]),
                     wall_seconds=wall, mode="lockstep") for r in range(R)]

    def run_text_to_video_many(self, prompts: Sequence[str], output_paths: Sequence[str]) -> List[dict]:
        """Generate a video for each prompt on one engine, the requests'
        denoise steps round-robin (`walk_many`; schedules may differ) and
        each finished chunk decoded on a one-worker thread, on the card on
        its own CUDA stream, so one request's decode overlaps the others'
        steps.  Returns one stats dict per request, as `_run`'s, with the
        run's wall seconds and its mode."""
        t0 = time.perf_counter()
        return self._walk_many(*self._prepare_requests(prompts, output_paths), output_paths, t0)

    def _walk_many(self, params, inps, gens, output_paths, t0: float) -> List[dict]:
        samplers = [ArdfSampler(self.config, params, inp, gen, device=self.device, capture=self.capture)
                    for inp, gen in zip(inps, gens)]
        R = len(samplers)
        segments, decode_seconds, finite = [[] for _ in range(R)], [[] for _ in range(R)], [True] * R
        on_card = self.device.type == "cuda"
        decode_stream = torch.cuda.Stream(self.device) if on_card else None
        if on_card:
            # capture every step variant and the decode of the chunks' shape
            # here, before the worker decodes on its own thread and stream
            for s in samplers:
                s.warm_step_variants()
            with uncounted():
                for shape in {tuple(s.xs[..., : s.cw, :, :].shape) for s in samplers}:
                    post_chunk_process(torch.zeros(shape, device=self.device), self.config, self.device)

        def decode(ridx, chunk_idx, chunk, ready):
            td = time.perf_counter()
            with torch.cuda.stream(decode_stream) if on_card else contextlib.nullcontext():
                if on_card:
                    decode_stream.wait_event(ready)
                out = post_chunk_process(chunk, self.config, self.device)
            print_rank_0(f"request {ridx}: chunk {chunk_idx + 1} done")
            return out, time.perf_counter() - td

        def collect(ridx, fut):
            out, seconds = fut.result()
            segments[ridx].append(out)
            decode_seconds[ridx].append(seconds)

        with maybe_trace("walk_many", self.device), ThreadPoolExecutor(max_workers=1) as pool:
            pending = deque()
            for ridx, chunk_idx, chunk in walk_many(samplers):
                finite[ridx] = finite[ridx] and bool(torch.isfinite(chunk).all())
                ready = None
                if on_card:
                    # the decode waits for the step that made the chunk, and
                    # the allocator keeps the chunk until the decode is done
                    ready = torch.cuda.Event()
                    ready.record(torch.cuda.current_stream(self.device))
                    chunk.record_stream(decode_stream)
                pending.append((ridx, pool.submit(decode, ridx, chunk_idx, chunk, ready)))
                # one worker finishes in order: drain what is done, so
                # emitted chunks are released as the walk goes on
                while pending and pending[0][1].done():
                    collect(*pending.popleft())
            while pending:
                collect(*pending.popleft())
        wall = time.perf_counter() - t0
        log_memory("after interleaved walk", self.device)
        return [dict(self._write(segments[r], output_paths[r], finite[r], samplers[r].step_seconds,
                                 decode_seconds[r]), wall_seconds=wall, mode="interleaved") for r in range(R)]

    def _write(self, segments, output_path: str, finite: bool, step_seconds, decode_seconds) -> dict:
        """Write the decoded chunks as one video; the request's stats."""
        video = np.concatenate(segments, axis=0)
        path = save_video_to_disk(video, output_path, fps=self.config.runtime_config.fps)
        print_rank_0(f"{video.shape[0]} frames -> {path}")
        return {
            "frames": int(video.shape[0]),
            "video_shape": tuple(video.shape),
            "video_std": float(video.std()),
            "latents_finite": finite,
            "path": path,
            "step_seconds": list(step_seconds),
            "decode_seconds": list(decode_seconds),
        }

    def _run(self, prompt: str, prefix_video, output_path: str) -> dict:
        """Generate from `prompt` after the latent `prefix_video` ([C, T_pre,
        H', W'] or None) and write the video to `output_path`.  Returns
        what the run measured: the decoded video's shape and standard
        deviation, whether every emitted latent was finite, the path
        written, and the host seconds of every denoise step and of every
        chunk decode."""
        t0 = time.perf_counter()
        caption_embs, emb_masks = get_txt_embeddings(prompt, self.config, self.device)
        params = get_dit(self.config, self.device, self.generator)
        null_caption = params["y_embedder"]["null_caption_embedding"].float().cpu().numpy()
        inp = build_inference_input(self.config, null_caption, caption_embs, emb_masks, self.device, prefix_video)

        sampler = ArdfSampler(self.config, params, inp, self.generator, device=self.device, capture=self.capture)
        event_path_timer().synced_record("begin_walk")
        segments, decode_seconds, finite = [], [], True
        with maybe_trace("walk", self.device):
            for chunk_idx, chunk in sampler.walk():
                finite = finite and bool(torch.isfinite(chunk).all())
                td = time.perf_counter()
                segments.append(post_chunk_process(chunk, self.config, self.device))
                decode_seconds.append(time.perf_counter() - td)
                print_rank_0(f"chunk {chunk_idx + 1}/{inp.chunk_num - sampler.chunk_offset} done")
        event_path_timer().synced_record("end_walk")
        log_memory("after walk", self.device)
        stats = self._write(segments, output_path, finite, sampler.step_seconds, decode_seconds)
        print_rank_0(f"Finish MagiPipeline in {time.perf_counter() - t0:.1f}s")
        return stats

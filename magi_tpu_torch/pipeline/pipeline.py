"""User-facing pipeline: MagiPipeline.run_text_to_video(prompt, output_path).

This slice runs the bf16 single-device text-to-video path with random
weights (SKIP_LOAD_MODEL=1).  What it does not cover yet raises
`NotImplementedError` naming its ROADMAP item.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from magi_tpu_torch.core.config import MagiConfig
from magi_tpu_torch.core.logger import print_rank_0
from magi_tpu_torch.core.profiler import log_memory
from magi_tpu_torch.core.timer import event_path_timer
from magi_tpu_torch.core.utils import env_is_true, resolve_device, set_random_seed
from magi_tpu_torch.pipeline.prompt_process import build_inference_input, get_txt_embeddings
from magi_tpu_torch.pipeline.video_process import post_chunk_process, save_video_to_disk
from magi_tpu_torch.sampling.transport import ArdfSampler


def get_dit(config: MagiConfig, device: torch.device, generator: torch.Generator) -> dict:
    """The DiT parameters: random weights under SKIP_LOAD_MODEL=1."""
    from magi_tpu_torch.models.dit.model import init_dit_params

    if not env_is_true("SKIP_LOAD_MODEL"):
        raise NotImplementedError("loading a DiT checkpoint (checkpoint/loader.py) is ROADMAP queue 1 item 6")
    if config.engine_config.fp8_quant or env_is_true("MAGI_INT8") or env_is_true("MAGI_INT4"):
        raise NotImplementedError("quantized execution is ROADMAP queue 1 item 11")
    print_rank_0("SKIP_LOAD_MODEL set: using random weights")
    return init_dit_params(config, device, generator)


def _check_supported(config: MagiConfig) -> None:
    """Engine settings the model would otherwise ignore (the sampler and
    get_dit refuse the rest)."""
    ec = config.engine_config
    if ec.world_size > 1:
        raise NotImplementedError("multi-GPU parallelism is ROADMAP queue 1 item 14")
    if ec.attn_int8:
        raise NotImplementedError("int8 attention is ROADMAP queue 1 item 12")


class MagiPipeline:
    def __init__(self, config_path: str, device=None):
        self.config = MagiConfig.from_json(config_path)
        _check_supported(self.config)
        self.device = resolve_device(device)
        self.generator = set_random_seed(self.config.runtime_config.seed, self.device)
        print_rank_0(self.config)

    def run_text_to_video(self, prompt: str, output_path: str) -> dict:
        """Generate a video for `prompt` and write it to `output_path`.
        Returns what the run measured: the decoded video's shape and
        standard deviation, whether every emitted latent was finite, the
        path written, and the host seconds of every denoise step and of
        every chunk decode."""
        t0 = time.perf_counter()
        caption_embs, emb_masks = get_txt_embeddings(prompt, self.config)
        params = get_dit(self.config, self.device, self.generator)
        null_caption = params["y_embedder"]["null_caption_embedding"].float().cpu().numpy()
        inp = build_inference_input(self.config, null_caption, caption_embs, emb_masks, self.device)

        sampler = ArdfSampler(self.config, params, inp, self.generator, device=self.device)
        event_path_timer().synced_record("begin_walk")
        segments, decode_seconds, finite = [], [], True
        for chunk_idx, chunk in sampler.walk():
            finite = finite and bool(torch.isfinite(chunk).all())
            td = time.perf_counter()
            segments.append(post_chunk_process(chunk, self.config, self.device))
            decode_seconds.append(time.perf_counter() - td)
            print_rank_0(f"chunk {chunk_idx + 1}/{inp.chunk_num} done")
        event_path_timer().synced_record("end_walk")
        log_memory("after walk", self.device)
        video = np.concatenate(segments, axis=0)
        path = save_video_to_disk(video, output_path, fps=self.config.runtime_config.fps)
        print_rank_0(f"Finish MagiPipeline: {video.shape[0]} frames -> {path} in {time.perf_counter() - t0:.1f}s")
        return {
            "frames": int(video.shape[0]),
            "video_shape": tuple(video.shape),
            "video_std": float(video.std()),
            "latents_finite": finite,
            "path": path,
            "step_seconds": list(sampler.step_seconds),
            "decode_seconds": decode_seconds,
        }

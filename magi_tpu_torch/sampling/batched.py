"""Lockstep request batching (the port of `magi_tpu.sampling.batched` on one
device): N requests that share the schedule denoise together, one host
scheduler for all.

The per-request state is stacked on a leading request axis: the latent
`xs` [R, C, T, H, W], the KV cache [R, L, 2, hk, tok, hd] (the int8 dict's
leaves too), the captions and their lengths (`StepInputs.y_lens` has a row
per request), and the prefix buffer.  Each step runs the single-request
step function once per request on that request's views, which it writes
in place: the counterpart of the JAX package's `lax.map` over the
requests, which likewise keeps every kernel at its unbatched shape.  On
the card a step variant's R request steps are captured as one CUDA graph,
as the JAX package jits the mapped step once (`_batched_steps`' single-
device half).  `walk()` yields `(chunk_idx, [R, C, <=cw, H, W])`.

Requests must share latent geometry, step count, chunk count and prefix
length (`check_lockstep`); mixed text / no text is fine.  The
host-streamed cache (`kv_offload` under the default kv ranges) streams one
request's cache through the device at a time and is refused here, as the
JAX package's lockstep sampler has no host mode: such requests run
interleaved (`walk_many`).  The JAX package's dp mesh (`dp_size > 1`) is
not ported: `pipeline._check_supported` refuses it.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from magi_tpu_torch.core.config import MagiConfig
from magi_tpu_torch.core.utils import resolve_device
from magi_tpu_torch.sampling.transport import ArdfSampler, InferenceInput, _leaf_map


class DpBatchedSampler(ArdfSampler):
    """ArdfSampler over a stack of requests with identical host scheduling.
    Initial noise is one `noises[r]` or one draw from `generators[r]` per
    request; `capture` as `ArdfSampler`'s."""

    _token_axis = 4  # [R, L, 2, hk, tok, hd] and the scale leaf [R, L, 2, hk, tok]

    @staticmethod
    def check_lockstep(base: InferenceInput, inp: InferenceInput) -> Optional[str]:
        """A description of the first mismatch, or None if `inp` can join a
        batch led by `base` (the bucketing key for servers)."""
        checks = [
            ("latent_size", base.latent_size, inp.latent_size),
            ("num_steps", base.num_steps, inp.num_steps),
            ("chunk_num", base.chunk_num, inp.chunk_num),
            ("prev_chunks_scale", base.prev_chunks_scale, inp.prev_chunks_scale),
            (
                "prefix length",
                0 if base.prefix_video is None else base.prefix_video.shape[1],
                0 if inp.prefix_video is None else inp.prefix_video.shape[1],
            ),
            # the null caption slab is model-derived: the batch shares the
            # base request's copy
            ("null_len", base.null_len, inp.null_len),
        ]
        for name, a, b in checks:
            if a != b:
                return f"{name} differs ({a} vs {b})"
        return None

    def __init__(self, config: MagiConfig, params, inps: Sequence[InferenceInput],
                 generators: Optional[Sequence[torch.Generator]] = None, *,
                 noises: Optional[Sequence[torch.Tensor]] = None, device=None, capture: bool = True):
        R = len(inps)
        if R == 0 or len(generators if noises is None else noises) != R:
            raise ValueError(f"{R} requests need as many generators or noises")
        base = inps[0]
        for i, inp in enumerate(inps[1:], start=1):
            why = self.check_lockstep(base, inp)
            if why is not None:
                raise ValueError(
                    f"dp batch requires lockstep requests, but request {i} "
                    f"vs 0: {why}.  Bucket mixed-shape requests by "
                    "(latent_size, num_steps, chunk_num, prefix length) and "
                    "run one DpBatchedSampler per bucket."
                )
        if config.engine_config.kv_offload and not config.runtime_config.noise2clean_kvrange:
            raise ValueError(
                "the host-streamed KV cache (kv_offload under the default kv ranges) has no lockstep batch: "
                "run the requests interleaved (walk_many, MagiPipeline.run_text_to_video_many, --interleave)"
            )
        dev = resolve_device(device)
        if noises is None:
            noises = [torch.randn(base.latent_size, generator=g, device=dev, dtype=torch.float32) for g in generators]
        self.R = R
        super().__init__(config, params, base, noise=noises[0], device=dev, capture=capture)
        self.xs = torch.stack([n.to(device=dev, dtype=torch.float32) for n in noises])
        self.cache = _leaf_map(self.cache, lambda c: torch.zeros((R,) + c.shape, dtype=c.dtype, device=dev))
        caps = [self._captions(inp) for inp in inps]
        self._text_embs = torch.stack([c for c, _ in caps])  # [R, n_chunks, L, C]
        self._lens_eff = np.stack([lens for _, lens in caps])  # [R, n_chunks]
        if base.prefix_video is not None:
            self.prefix_buf = torch.stack([self._padded_prefix(inp.prefix_video) for inp in inps])

    def _request_state(self, r: int):
        cache = {k: v[r] for k, v in self.cache.items()} if isinstance(self.cache, dict) else self.cache[r]
        return self.xs[r], cache, self._text_embs[r], None if self.prefix_buf is None else self.prefix_buf[r]

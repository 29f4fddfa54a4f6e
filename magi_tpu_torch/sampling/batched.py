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
interleaved (`walk_many`).

On a mesh with dp > 1 each dp group runs its contiguous share of the
requests (`_maybe_dp_shard`, the JAX package's shard_map over dp) as the
program above, and `MagiPipeline.run_text_to_video_batch` gathers the
videos to rank 0, which writes them.  The JAX package's `_map_requests`
(its lax.map over the requests) is the step's loop over its requests here.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from magi_tpu_torch.core.config import MagiConfig
from magi_tpu_torch.core.utils import resolve_device
from magi_tpu_torch.models.dit.model import init_kv_cache
from magi_tpu_torch.parallel import mesh as mesh_lib
from magi_tpu_torch.sampling.transport import ArdfSampler, InferenceInput, _leaf_map


def _maybe_dp_shard(n: int) -> range:
    """The indices of the requests this rank's dp group runs, of `n`: a
    contiguous share on a mesh with dp > 1 (n must divide over dp), every
    request otherwise."""
    mesh = mesh_lib.get_mesh()
    dp = 1 if mesh is None else mesh.shape[mesh_lib.AXIS_DP]
    if dp == 1:
        return range(n)
    if n % dp:
        raise ValueError(f"batch size {n} must divide over dp={dp}")
    per, i = n // dp, mesh.coords()[mesh_lib.AXIS_DP]
    return range(i * per, (i + 1) * per)


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
        self._setup(config, params, inps, noises, dev, capture)

    def _request_tensors(self, inps: Sequence[InferenceInput], noises: Sequence[torch.Tensor]) -> dict:
        caps = [self._captions(inp) for inp in inps]
        self._lens_eff = np.stack([lens for _, lens in caps])  # [R, n_chunks]
        prefix = None
        if inps[0].prefix_video is not None:
            prefix = torch.stack([self._padded_prefix(inp.prefix_video) for inp in inps])
        return dict(xs=torch.stack([n.to(device=self.device, dtype=torch.float32) for n in noises]),
                    text_embs=torch.stack([c for c, _ in caps]),  # [R, n_chunks, L, C]
                    null_emb=inps[0].null_emb, prefix_buf=prefix)

    def _new_cache(self):
        one = init_kv_cache(self.config, self.cache_tokens, torch.device("meta"))  # a request's shapes and dtypes
        return _leaf_map(one, lambda c: torch.zeros((self.R,) + c.shape, dtype=c.dtype, device=self.device)), None

    def _request_state(self, r: int):
        cache = {k: v[r] for k, v in self.cache.items()} if isinstance(self.cache, dict) else self.cache[r]
        return self.xs[r], cache, self._text_embs[r], None if self.prefix_buf is None else self.prefix_buf[r]

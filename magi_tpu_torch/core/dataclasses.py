"""Forward-pass metadata containers.

MAGI's packed sequences are equal-length chunks (`seg_len` tokens each),
so a forward carries a few ints and small int32 range tensors instead of
per-token cu_seqlens.  The ranges, the caption lengths and
`slice_point` are int32 tensors on the model's device, as in the JAX
package, where they are traced values: the kernels read the ranges there,
and the KV-cache write and the split of the ranges per source read
`slice_point` there, so no host value of a step is baked into a captured
CUDA graph.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class SegmentAttnSpec:
    """Per-segment attention ranges: queries are `n_segments` contiguous
    blocks of `seg_len` tokens; segment i attends kv tokens
    [kv_start[i], kv_end[i]) of the kv view."""

    kv_start: torch.Tensor  # int32 [n_segments]
    kv_end: torch.Tensor  # int32 [n_segments]


@dataclasses.dataclass(frozen=True)
class ForwardMeta:
    """Everything the DiT forward needs besides tensors."""

    n_segments: int  # denoising_range_num (incl. extra clean chunk if any)
    seg_len: int  # clip_token_nums = chunk_width/t_patch * H/p * W/p
    H: int  # latent patch-grid height
    W: int  # latent patch-grid width
    T_total: int  # informational only
    update_kv_cache: bool  # write current kv into the cache
    use_kv_cache: bool  # read history from the cache (view = cache + current)
    distill_nearly_clean_chunk: bool  # last segment is the ride-along copy
    fwd_extra_1st_chunk: bool  # first segment is a clean chunk (t=clean_t)

    slice_point: torch.Tensor  # int32 []: chunks already in the cache (cache write offset)
    self_attn: SegmentAttnSpec  # ranges into the kv view (token units)
    y_lens: torch.Tensor  # int32 [n_segments]: valid caption tokens per segment

    @property
    def total_q(self) -> int:
        return self.n_segments * self.seg_len

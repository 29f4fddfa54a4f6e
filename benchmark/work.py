"""The work a denoise step asks of the chip, counted from the config and the
step index alone (never from the program), and the least time it could take
on one H100.

Peaks are NVIDIA's published dense rates of the H100 SXM at 700 W: 989
TFLOP/s bf16, 1979 TOP/s int8, 67 TFLOP/s fp32 outside the tensor cores,
3.35 TB/s of HBM.  A call's bound is the larger of its operations over the
peak of their precision and its bytes over the bandwidth, each input read
once and each output written once whatever the kernel reads again; a group
of linears on one input reads that input once.  Self-attention reads its
keys and values over the union of the ranges its segments attend.
"""

from __future__ import annotations

import dataclasses
from typing import List

from benchmark import schedule

PEAK = {"bf16": 989e12, "int8": 1979e12, "fp32": 67e12}
PEAK_BYTES = 3.35e12


@dataclasses.dataclass(frozen=True)
class Op:
    """One kind of call in a step: `kind` ("linear", "self_attention",
    "cross_attention", "embed"), the precision of its operations, its
    operations and bytes summed over the step's calls of it, and the sum of
    the calls' bounds in seconds."""

    kind: str
    precision: str
    ops: float
    nbytes: float
    bound_s: float

    @property
    def peak_s(self) -> float:
        """Seconds at the precision's peak rate alone."""
        return self.ops / PEAK[self.precision]


def bound(ops: float, nbytes: float, precision: str) -> float:
    """The least seconds for one call: operations at peak or bytes at bandwidth."""
    return max(ops / PEAK[precision], nbytes / PEAK_BYTES)


@dataclasses.dataclass(frozen=True)
class Geometry:
    """What a step's work depends on besides its plan: tokens a chunk, the
    caption rows, the request's caption tokens, and the config's widths."""

    ctn: int
    caption_rows: int
    caption_tokens: int
    null_tokens: int
    mc: dict
    w8a8: bool

    @classmethod
    def of(cls, cfg: dict, caption_tokens: int, null_tokens: int = 50) -> "Geometry":
        mc, rc = cfg["model_config"], cfg["runtime_config"]
        hp = rc["video_size_h"] // 8 // mc["patch_size"]
        wp = rc["video_size_w"] // 8 // mc["patch_size"]
        ctn = rc["chunk_width"] // mc["t_patch_size"] * hp * wp
        return cls(ctn=ctn, caption_rows=mc["caption_max_length"], caption_tokens=caption_tokens,
                   null_tokens=null_tokens, mc=mc, w8a8=bool(cfg["engine_config"].get("fp8_quant")))


def _linear_group(rows: int, k: int, outs: List[int], precision: str, calls: int) -> tuple:
    """A group of linears on one input of `rows` x `k`: (ops, bytes, bound) over `calls` calls."""
    xb = 2  # the bf16 input, quantized inside the group under int8
    wb = 1 if precision == "int8" else 2
    ops = sum(2.0 * rows * k * n for n in outs)
    nbytes = rows * k * xb + sum(k * n * wb + rows * n * 2 for n in outs)
    return ops * calls, nbytes * calls, bound(ops, nbytes, precision) * calls


def step_ops(geo: Geometry, step: schedule.Step) -> List[Op]:
    """The step's work by kind and precision: each of its forwards (one, or
    three under three-branch CFG) over its segments, every layer.  The
    count follows the forwards the step's arithmetic needs, not how the
    program batches them (packing the uncond segments into the text forward
    counts the same)."""
    mc = geo.mc
    D, hd, hq, hk = mc["hidden_size"], mc["kv_channels"], mc["num_attention_heads"], mc["num_query_groups"]
    L, ffn = mc["num_layers"], mc["ffn_hidden_size"]
    fc1 = 2 * ffn if mc["gated_linear_unit"] else ffn
    mid = L - 2 if geo.w8a8 else 0
    acc = {}

    def add(kind, prec, ops, nbytes, b):
        o, nb, bs = acc.get((kind, prec), (0.0, 0.0, 0.0))
        acc[(kind, prec)] = (o + ops, nb + nbytes, bs + b)

    for segments, _, _ in step.forwards:
        n = len(segments)
        tokens = n * geo.ctn
        cap_rows = n * geo.caption_rows
        groups = [  # (rows, k, outs): q/qx/k/v share the pre-LN input
            (tokens, D, [hq * hd, hq * hd, hk * hd, hk * hd]),
            (cap_rows, D, [2 * hk * hd]),
            (tokens, 2 * hq * hd, [D]),
            (tokens, D, [fc1]),
            (tokens, ffn, [D]),
        ]
        for rows, k, outs in groups:
            if mid:
                add("linear", "int8", *_linear_group(rows, k, outs, "int8", mid))
            add("linear", "bf16", *_linear_group(rows, k, outs, "bf16", L - mid))
        # self-attention: QK^T and PV, 2 operations a multiply-add, over each
        # segment's range; keys and values read once over the union of ranges
        pairs = sum((b - a) for a, b in (s.kv for s in segments)) * geo.ctn * geo.ctn
        ops = 4.0 * hq * hd * pairs
        lo = min(s.kv[0] for s in segments)
        hi = max(s.kv[1] for s in segments)
        kv_tokens = (hi - lo) * geo.ctn
        nbytes = 2 * (2 * tokens * hq * hd + 2 * kv_tokens * hk * hd)  # bf16 q and out, k and v
        add("self_attention", "bf16", ops * L, nbytes * L, bound(ops, nbytes, "bf16") * L)
        # caption cross-attention over each segment's valid caption tokens
        cap = sum(geo.caption_tokens if s.text else geo.null_tokens for s in segments)
        ops = 4.0 * hq * hd * geo.ctn * cap
        nbytes = 2 * (2 * tokens * hq * hd + 2 * cap * hk * hd)
        add("cross_attention", "bf16", ops * L, nbytes * L, bound(ops, nbytes, "bf16") * L)
        # the fp32 patch embedding, caption projection and final linear
        in_feat = mc["in_channels"] * mc["t_patch_size"] * mc["patch_size"] ** 2
        out_feat = mc["out_channels"] * mc["t_patch_size"] * mc["patch_size"] ** 2
        ops = 2.0 * tokens * (in_feat + out_feat) * D + 2.0 * cap_rows * mc["caption_channels"] * D
        nbytes = 4 * (tokens * (in_feat + out_feat + 2 * D) + cap_rows * (mc["caption_channels"] + D))
        add("embed", "fp32", ops, nbytes, bound(ops, nbytes, "fp32"))
    return [Op(kind, prec, *v) for (kind, prec), v in acc.items()]


def window_ops(cfg: dict, caption_tokens: int, steps: List[int], chunk_num: int) -> List[Op]:
    """The summed work of the steps `steps` of a walk of `chunk_num` chunks."""
    geo = Geometry.of(cfg, caption_tokens)
    out = []
    for i in steps:
        out += step_ops(geo, schedule.plan(cfg["runtime_config"], cfg["engine_config"], chunk_num, i))
    return out

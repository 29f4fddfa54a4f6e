"""The mesh's collectives, in one place: all-to-all, all-gather, all-reduce
(sum and max) and broadcast over a `mesh.Group`, on `torch.distributed`.

The backend is the process group's, from the config's
`engine_config.distributed_backend`: NCCL across cards; gloo for several
ranks on one card (NCCL refuses two ranks on one device).  Every collective
here is handed its tensors where they live: PyTorch's gloo backend (2.11 on
the H100 machine, `scripts/gloo_cuda_probe.py`) takes CUDA tensors for each
of them (all_to_all_single with and without splits, all_gather, all_reduce
sum and max, broadcast, synchronous and asynchronous, int8 and bf16), so
nothing is staged through host buffers here; a backend that refused one
would raise.  Gloo moves CUDA tensors through host memory itself, so a gloo
run on one card measures no scaling.

The collectives that only move data (all-to-all, all-gather, broadcast)
move the tensors' bytes (a uint8 view), so every dtype travels alike;
all-reduce sums or maxes its dtype (f32 in the port's calls).

`traffic` counts, per collective, the calls and the payload bytes this
rank handed in (the input tensor's bytes; for all_to_all the pieces bound
for other ranks, for a broadcast the tensor's bytes on every rank).

A captured step (`core.graphs`) runs its collectives between its pieces:
each collective raises inside a piece (`graphs.in_piece()`), and
`all_to_all` and `all_gather` write into an `out` buffer when given one
(the step's slot, which the next piece's graph reads at its fixed
address); `all_reduce` works in place on a piece's output, and
`broadcast_many` into the tensors it is handed."""

from __future__ import annotations

import contextlib
from collections import Counter
from typing import Callable, List, Optional, Sequence

import torch

from magi_tpu_torch.core import graphs

traffic: Counter = Counter()  # "<op>_calls" and "<op>_bytes"


def reset_traffic() -> None:
    traffic.clear()


def _count(op: str, nbytes: int) -> None:
    traffic[op + "_calls"] += 1
    traffic[op + "_bytes"] += int(nbytes)


class Pending:
    """A collective in flight: `wait()` finishes it and returns its result."""

    def __init__(self, finish: Callable):
        self._finish = finish
        self._done = False
        self._value = None

    def wait(self):
        if not self._done:
            self._value = self._finish()
            self._done = True
        return self._value


def _bytes(t: torch.Tensor) -> torch.Tensor:
    return t.contiguous().view(-1).view(torch.uint8)


def _outside_pieces(op: str) -> None:
    if graphs.in_piece():
        raise RuntimeError(f"comm.{op} inside a piece of a step: a collective runs between pieces (core.graphs)")


def all_to_all(x: torch.Tensor, group, in_splits: Sequence[int], out_splits: Sequence[int],
               out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """A 1-D all-to-all: `x` holds the pieces for the group's ranks in group
    order (`in_splits` elements each), the result the pieces from them
    (`out_splits`), written into `out` when given (contiguous, of
    sum(out_splits) elements)."""
    _outside_pieces("all_to_all")
    if out is None:
        out = torch.empty(sum(out_splits), dtype=x.dtype, device=x.device)
    if group.size == 1:
        return out.copy_(x)
    import torch.distributed as dist

    es = x.element_size()
    me = group.ranks.index(dist.get_rank())
    _count("all_to_all", (sum(in_splits) - in_splits[me]) * es)
    dist.all_to_all_single(_bytes(out), _bytes(x), [n * es for n in out_splits], [n * es for n in in_splits],
                           group=group.pg)
    return out


def all_gather(x: torch.Tensor, group, out: Optional[torch.Tensor] = None) -> List[torch.Tensor]:
    """Every rank's `x` (equal shapes), in group order; with `out` ([group
    size, *x.shape], contiguous) written into its rows, which come back."""
    _outside_pieces("all_gather")
    if group.size == 1 and out is None:
        return [x]
    x = x.contiguous()
    outs = [torch.empty_like(x) for _ in group.ranks] if out is None else list(out.unbind(0))
    if group.size == 1:
        outs[0].copy_(x)
        return outs
    import torch.distributed as dist

    _count("all_gather", x.numel() * x.element_size())
    dist.all_gather([_bytes(o) for o in outs], _bytes(x), group=group.pg)
    return outs


def all_reduce(x: torch.Tensor, group, op: str = "sum") -> torch.Tensor:
    """`x` reduced ("sum" or "max") over the group, in place; returns it."""
    _outside_pieces("all_reduce")
    if group.size == 1:
        return x
    import torch.distributed as dist

    _count("all_reduce", x.numel() * x.element_size())
    dist.all_reduce(x, op={"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}[op], group=group.pg)
    return x


def broadcast_many(tensors: List[torch.Tensor], src: int, group) -> Pending:
    """Broadcast `tensors` (on global rank `src` the values, elsewhere the
    buffers they arrive in) from `src` over the group, asynchronously;
    `wait()` returns them once they are there.  The broadcasts start once
    the work already queued on the current stream is done (a buffer reused
    for another layer must not be overwritten under its last reader), and
    work queued after them overlaps them: under NCCL they run on a side
    stream that first waits for the current one (waiting joins the current
    stream to it); gloo orders its copies of CUDA tensors so itself."""
    _outside_pieces("broadcast")
    import torch.distributed as dist

    if group.size == 1:
        return Pending(lambda: tensors)
    side: Optional[torch.cuda.Stream] = None
    if group.backend == "nccl" and group.device.type == "cuda":
        side = _side_stream(group.device)
        side.wait_stream(torch.cuda.current_stream(group.device))
    for t in tensors:
        _count("broadcast", t.numel() * t.element_size())
    with torch.cuda.stream(side) if side is not None else contextlib.nullcontext():
        works = [dist.broadcast(_bytes(t), src=src, group=group.pg, async_op=True) for t in tensors]

    def finish():
        for w in works:
            w.wait()
        if side is not None:
            cur = torch.cuda.current_stream(group.device)
            cur.wait_stream(side)
            for t in tensors:
                t.record_stream(cur)
        return tensors

    return Pending(finish)


_SIDE: dict = {}


def _side_stream(device: torch.device) -> torch.cuda.Stream:
    if device not in _SIDE:
        _SIDE[device] = torch.cuda.Stream(device)
    return _SIDE[device]

#!/usr/bin/env python3
"""Which collectives of PyTorch's gloo backend take CUDA tensors, on this
machine's PyTorch: two ranks on one card (`cuda:0`), each collective tried
once on CUDA tensors and checked against the expected values, then the
host seconds of a 32 MiB all_to_all_single on CUDA tensors (where gloo
takes them) and through pinned host buffers.

    python3 scripts/gloo_cuda_probe.py

Prints one JSON line, `{"torch": ..., "accepts_cuda": {op: true | "error"},
"a2a_32MiB_ms": {...}}`.  `magi_tpu_torch/parallel/comm.py` stages through
host memory exactly the collectives this reports as refused.  This is a
probe: it catches each collective's error to report it; the port never
does."""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
import time


def worker() -> None:
    import torch
    import torch.distributed as dist

    dist.init_process_group("gloo")
    r, n = dist.get_rank(), dist.get_world_size()
    dev = torch.device("cuda", 0)
    res = {}

    def attempt(name, fn):
        try:
            ok = fn()
            res[name] = True if ok else "wrong values"
        except Exception as e:  # the probe's whole point: report what refuses
            res[name] = f"{type(e).__name__}: {str(e).splitlines()[0][:160]}"

    def a2a_equal():
        x = torch.arange(4, device=dev, dtype=torch.float32) + 10 * r
        out = torch.empty_like(x)
        dist.all_to_all_single(out, x)
        want = torch.tensor([0, 1, 10, 11] if r == 0 else [2, 3, 12, 13], device=dev, dtype=torch.float32)
        return torch.equal(out, want)

    def a2a_splits():
        x = torch.arange(3, device=dev, dtype=torch.float32) + 10 * r
        ins = [1, 2] if r == 0 else [2, 1]
        outs = [1, 2] if r == 0 else [2, 1]
        out = torch.empty(sum(outs), device=dev)
        dist.all_to_all_single(out, x, output_split_sizes=outs, input_split_sizes=ins)
        want = [0, 10, 11] if r == 0 else [1, 2, 12]
        return torch.equal(out, torch.tensor(want, device=dev, dtype=torch.float32))

    def all_gather_list():
        x = torch.full((3,), float(r), device=dev)
        outs = [torch.empty_like(x) for _ in range(n)]
        dist.all_gather(outs, x)
        return all(torch.equal(o, torch.full((3,), float(i), device=dev)) for i, o in enumerate(outs))

    def all_gather_tensor():
        x = torch.full((3,), float(r), device=dev)
        out = torch.empty(3 * n, device=dev)
        dist.all_gather_into_tensor(out, x)
        return torch.equal(out, torch.arange(n, device=dev, dtype=torch.float32).repeat_interleave(3))

    def all_reduce(op, want):
        x = torch.full((3,), float(r + 1), device=dev)
        dist.all_reduce(x, op=op)
        return torch.equal(x, torch.full((3,), want, device=dev))

    def broadcast(async_op):
        x = torch.full((3,), float(r + 5), device=dev)
        w = dist.broadcast(x, src=1, async_op=async_op)
        if async_op:
            w.wait()
        return torch.equal(x, torch.full((3,), 6.0, device=dev))

    def bf16_all_reduce():
        x = torch.full((3,), float(r + 1), device=dev, dtype=torch.bfloat16)
        dist.all_reduce(x)
        return torch.equal(x.float(), torch.full((3,), 3.0, device=dev))

    def int8_broadcast():
        x = torch.full((3,), r - 100, device=dev, dtype=torch.int8)
        dist.broadcast(x, src=0)
        return torch.equal(x, torch.full((3,), -100, device=dev, dtype=torch.int8))

    attempt("all_to_all_single", a2a_equal)
    attempt("all_to_all_single_splits", a2a_splits)
    attempt("all_gather", all_gather_list)
    attempt("all_gather_into_tensor", all_gather_tensor)
    attempt("all_reduce_sum", lambda: all_reduce(dist.ReduceOp.SUM, 3.0))
    attempt("all_reduce_max", lambda: all_reduce(dist.ReduceOp.MAX, 2.0))
    attempt("all_reduce_sum_bf16", bf16_all_reduce)
    attempt("broadcast", lambda: broadcast(False))
    attempt("broadcast_async", lambda: broadcast(True))
    attempt("broadcast_int8", int8_broadcast)

    times = {}
    x = torch.randn(8 * 2**20, device=dev)  # 32 MiB
    out = torch.empty_like(x)
    if res["all_to_all_single"] is True:
        dist.all_to_all_single(out, x)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(5):
            dist.all_to_all_single(out, x)
        torch.cuda.synchronize()
        times["cuda_tensors"] = (time.perf_counter() - t0) / 5 * 1e3
    hx = torch.empty(x.shape, pin_memory=True)
    ho = torch.empty(x.shape, pin_memory=True)
    t0 = time.perf_counter()
    for _ in range(5):
        hx.copy_(x)
        dist.all_to_all_single(ho, hx)
        out.copy_(ho, non_blocking=True)
    torch.cuda.synchronize()
    times["pinned_host"] = (time.perf_counter() - t0) / 5 * 1e3
    if r == 0:
        print(json.dumps({"torch": torch.__version__, "cuda": torch.version.cuda, "accepts_cuda": res,
                          "a2a_32MiB_ms": times}))
    dist.barrier()
    dist.destroy_process_group()


def main() -> int:
    if "--worker" in sys.argv:
        worker()
        return 0
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    cmd = [sys.executable, "-m", "torch.distributed.run", "--nproc_per_node", "2", "--master_addr", "localhost",
           "--master_port", str(port), os.path.abspath(__file__), "--worker"]
    return subprocess.run(cmd, timeout=600).returncode


if __name__ == "__main__":
    sys.exit(main())

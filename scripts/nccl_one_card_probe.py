"""Does NCCL take two ranks on one card?

    python3 scripts/nccl_one_card_probe.py [--timeout 60]

Starts two processes, both on cuda:0, that join one NCCL process group
(`tcp://localhost:<free port>`) and run the collectives a mesh step of the
port calls (all_reduce sum and max, all_to_all_single with splits,
all_gather, broadcast), each checked against its expected values.  The
parent kills both after `--timeout` seconds.  Prints each rank's outcome
and, as its last line, one JSON object: {"nccl_two_ranks_one_card": true}
when both ranks ran every collective and got the right values, else false
with the first error.  Exits 0 either way (the answer is the output); 2
without a card."""

from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import time


def rank_main(rank: int, port: int) -> int:
    import torch
    import torch.distributed as dist

    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}", world_size=2, rank=rank)
    dev = torch.device("cuda", 0)
    x = torch.full((4,), float(rank + 1), device=dev)
    dist.all_reduce(x)
    assert x.tolist() == [3.0] * 4, x
    m = torch.full((4,), float(rank), device=dev)
    dist.all_reduce(m, op=dist.ReduceOp.MAX)
    assert m.tolist() == [1.0] * 4, m
    send = torch.arange(6, device=dev, dtype=torch.float32) + 10 * rank
    recv = torch.empty(6, device=dev)
    dist.all_to_all_single(recv, send, [3, 3], [3, 3])
    want = [10 * 0 + 3 * rank + i for i in range(3)] + [10 * 1 + 3 * rank + i for i in range(3)]
    assert recv.tolist() == want, (recv, want)
    outs = [torch.empty(2, device=dev) for _ in range(2)]
    dist.all_gather(outs, torch.full((2,), float(rank), device=dev))
    assert [o.tolist() for o in outs] == [[0.0, 0.0], [1.0, 1.0]], outs
    b = torch.full((3,), 7.0 if rank == 0 else 0.0, device=dev)
    dist.broadcast(b, src=0)
    assert b.tolist() == [7.0] * 3, b
    torch.cuda.synchronize()
    dist.destroy_process_group()
    print(f"rank {rank}: every collective ran and agreed", flush=True)
    return 0


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--timeout", type=float, default=60)
    ap.add_argument("--rank", type=int, default=None)
    ap.add_argument("--port", type=int, default=None)
    args = ap.parse_args()
    if args.rank is not None:
        return rank_main(args.rank, args.port)

    import torch

    if not torch.cuda.is_available():
        print("no CUDA device")
        return 2
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, NCCL_DEBUG=os.environ.get("NCCL_DEBUG", "WARN"))
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--rank", str(r), "--port", str(port)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env)
             for r in range(2)]
    t0 = time.perf_counter()
    outs, timed_out = [], False
    for p in procs:
        try:
            out, _ = p.communicate(timeout=max(1.0, args.timeout - (time.perf_counter() - t0)))
        except subprocess.TimeoutExpired:
            timed_out = True
            for q in procs:
                q.kill()
            out, _ = p.communicate()
        outs.append(out)
    for r, (p, out) in enumerate(zip(procs, outs)):
        print(f"--- rank {r}: exit {p.returncode}")
        print(out[-3000:])
    ok = not timed_out and all(p.returncode == 0 for p in procs)
    error = None
    if not ok:
        lines = [ln.strip() for out in outs for ln in out.splitlines()]
        first = next((ln for key in ("Duplicate GPU", "Error:", "Error") for ln in lines if key in ln), None)
        error = "timed out" if timed_out else (first or "a rank failed")
    print(f"card: {torch.cuda.get_device_name(0)}; {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"nccl_two_ranks_one_card": ok, "error": error, "torch": torch.__version__,
                      "nccl": ".".join(map(str, torch.cuda.nccl.version()))}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

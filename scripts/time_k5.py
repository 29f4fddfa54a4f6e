#!/usr/bin/env python3
"""Time the two-source attention kernels of `csrc/attention_tma.cu` (K1 and
K5 under qk8, sage and dq) on the card at the shapes of `chip_smoke.py`
phase 2: 5 segments of 1536 tokens (4 denoised, spans of 1, 2, 3 and 5
chunks, and the ride-along copy), an int8 cache of 2 clean chunks, the
DiT's q prologue.  Each kernel is first held against its plain version
(4e-3 + 1e-2 |ref|), then timed with CUDA events.

    python3 scripts/time_k5.py [--heads 24|48] [--iters 10] [--csrc DIR ...] [--phases]

With --csrc, each DIR (a changed copy of `magi_tpu_torch/csrc`) is built
into a library of its own (under build/time_k5/) and timed in turns with
the package's build, as package, DIR..., DIR..., package, so versions are
compared within one call on one card.  With --phases, the package's
sources are also built with -DMAGI_PHASE_CLOCKS, and one launch of each
kernel prints its clocks per kv tile and warp by phase (the phases of
`csrc/attention_tma.cu`'s note).  Prints the card's name and power limit,
then one line per version and kernel."""

from __future__ import annotations

import argparse
import ctypes
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

import torch  # noqa: E402

from magi_tpu_torch.ops import _lib  # noqa: E402
from magi_tpu_torch.ops import attention as A  # noqa: E402
from magi_tpu_torch.ops import attention_q8 as A8  # noqa: E402

ATTN_TOL = dict(atol=4e-3, rtol=1e-2)


def build(csrc: str, tag: str, flags=()) -> ctypes.CDLL:
    """The sources of `csrc` compiled as `_lib.build` does (plus `flags`),
    into a library of their own; ptxas's register and spill lines of the
    attention kernels printed."""
    out = os.path.join(HERE, "build", "time_k5", tag)
    os.makedirs(out, exist_ok=True)
    nvcc = _lib._nvcc()
    procs = []
    for src in _lib.SOURCES:
        obj = os.path.join(out, src.replace(".cu", ".o"))
        cmd = [nvcc, *_lib.NVCC_FLAGS, *flags, "-c", "-o", obj, os.path.join(csrc, src)]
        procs.append((obj, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    log = ""
    for obj, p in procs:
        text, _ = p.communicate()
        log += text
        if p.returncode != 0:
            sys.exit(f"building {csrc} failed:\n{text}")
    lib = os.path.join(out, _lib.LIB_NAME)
    subprocess.run([nvcc, "-shared", "-o", lib, *[o for o, _ in procs]], check=True)
    entry = ""
    for line in log.splitlines():
        if "Compiling entry" in line:
            entry = line.split("'")[1] if "'" in line else line
        elif ("registers" in line or "spill" in line) and "seg_attn" in entry:
            print(f"  ptxas {tag} {entry}: {line.split('ptxas info    : ')[-1].strip()}")
    handle = ctypes.CDLL(lib)
    for name, argtypes in _lib._SIGNATURES.items():
        fn = getattr(handle, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return handle


def inputs(dev, hq: int):
    """Phase 2's K5 inputs (seed 1) and K1's on the same values in bf16."""
    g = torch.Generator(device=dev)
    g.manual_seed(1)

    def randn(*shape, dtype=torch.bfloat16):
        return torch.randn(shape, generator=g, device=dev).to(dtype)

    hk, hd, rot, ctn, n_seg, eps = 8, 128, 48, 1536, 5, 1e-6
    S = n_seg * ctn
    kw, kb = 1.0 + 0.1 * randn(hd, dtype=torch.float32), 0.1 * randn(hd, dtype=torch.float32)
    ang = torch.rand((S, rot), generator=g, device=dev) * 6.28
    sin, cos = torch.sin(ang), torch.cos(ang)
    q = randn(S, hq, hd)
    L1 = 4 * ctn
    cache8 = torch.zeros((2, hk, L1, hd), dtype=torch.int8, device=dev)
    cache_sc = torch.zeros((2, hk, L1), device=dev)
    cache8[:, :, : 2 * ctn], cache_sc[:, :, : 2 * ctn] = A8.quantize_kv_per_token(randn(2, hk, 2 * ctn, hd))
    kv8, kv_sc = A.kv_norm_rope_pack(randn(S, hk, hd), randn(S, hk, hd), kw, kb, sin, cos, eps=eps, quantize=True)
    i32 = dict(dtype=torch.int32, device=dev)
    ge = torch.tensor([(2 + j + 1) * ctn for j in range(4)] + [7 * ctn], **i32)
    gs = torch.clamp(ge - torch.tensor([1, 2, 3, 5, 1], **i32) * ctn, min=0)
    st = 2 * ctn
    ranges = (torch.clamp(gs, max=st), torch.clamp(ge, max=st), torch.clamp(gs - st, min=0),
              torch.clamp(ge - st, min=0))
    pro = (1.0 + 0.1 * randn(hd, dtype=torch.float32), 0.1 * randn(hd, dtype=torch.float32), sin, cos, eps)
    args8 = (q, cache8, cache_sc, kv8, kv_sc, *ranges)
    cache = (cache8.float() * cache_sc[..., None]).bfloat16()
    kv = (kv8.float() * kv_sc[..., None]).bfloat16()
    args1 = (q, cache, kv, *ranges)
    attended = int(((ranges[1] - ranges[0]) + (ranges[3] - ranges[2])).sum())
    return args8, args1, pro, ctn, 2 * 2 * ctn * attended * hd * hq


def cuda_ms(fn, iters: int) -> float:
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--heads", type=int, default=24, choices=(24, 48))
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--csrc", action="append", default=[], help="a changed copy of magi_tpu_torch/csrc")
    ap.add_argument("--phases", action="store_true", help="clocks per kv tile by phase")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("no CUDA device: this script times kernels on the GPU")
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    print(smi.stdout.strip())

    versions = [("package", build(_lib.CSRC_DIR, "package"))]
    for i, d in enumerate(args.csrc):
        versions.append((f"{i + 1}:{os.path.basename(os.path.normpath(d))}", build(os.path.abspath(d), f"v{i + 1}")))
    args8, args1, pro, seg, ops = inputs(dev, args.heads)
    kernels = {
        "K1": (lambda: A.segmented_attention_two_source(*args1, seg_len=seg, q_prologue=pro),
               lambda: A.segmented_attention_two_source_reference(A.apply_q_prologue(args1[0], pro), *args1[1:],
                                                                  seg_len=seg)),
    }
    for scheme in A8.SCHEMES:
        kernels[scheme] = (
            lambda scheme=scheme: A8.segmented_attention_two_source_q8(*args8, seg_len=seg, q_prologue=pro,
                                                                      scheme=scheme),
            lambda scheme=scheme: getattr(A8, f"segmented_attention_two_source_q8_{scheme}_reference")(
                *args8, seg_len=seg, q_prologue=pro))
    refs = {name: plain().float() for name, (_, plain) in kernels.items()}

    a = torch.randn((8192, 8192), device=dev, dtype=torch.bfloat16)
    for _ in range(50):  # the clocks up from idle before the first timing
        a @ a
    order = versions + versions[1:][::-1] + versions[:1] if len(versions) > 1 else versions
    for tag, handle in order:
        _lib._lib = handle
        for name, (call, _) in kernels.items():
            out = call().float()
            torch.cuda.synchronize()
            ok = bool(torch.isfinite(out).all()) and torch.allclose(out, refs[name], **ATTN_TOL)
            err = float((out - refs[name]).abs().max())
            ms = cuda_ms(call, args.iters)
            print(f"{tag} {name} {args.heads}/8 heads: {ms:.4f} ms, {ops / ms / 1e9:.1f} T operations/s, "
                  f"max_abs_err {err:.3e} {'ok' if ok else 'FAILED'}", flush=True)
    if args.phases:
        handle = build(_lib.CSRC_DIR, "phases", ["-DMAGI_PHASE_CLOCKS"])
        handle.magi_phase_clocks.argtypes = [ctypes.c_void_p]
        handle.magi_phase_clocks.restype = ctypes.c_int
        _lib._lib = handle
        clocks = (ctypes.c_ulonglong * 9)()
        names = ["wait tile", "Q K^T", "wait converted", "softmax", "P V"]
        for name, (call, _) in kernels.items():
            call()
            torch.cuda.synchronize()
            _lib.check(handle.magi_phase_clocks(clocks), "magi_phase_clocks")  # cleared
            call()
            torch.cuda.synchronize()
            _lib.check(handle.magi_phase_clocks(clocks), "magi_phase_clocks")
            c = list(clocks)
            per = lambda i, n: c[i] / max(c[n], 1)
            cons = ", ".join(f"{nm} {per(i, 7):.0f}" for i, nm in enumerate(names))
            conv = f"; converters: wait {per(5, 8):.0f}, convert {per(6, 8):.0f}" if c[8] else ""
            print(f"phases {name} {args.heads}/8 heads, clocks per tile and warp: consumers: {cons} "
                  f"(sum {sum(per(i, 7) for i in range(5)):.0f}){conv}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Time the attention kernels and the kv pack alone on the card at the
shapes of `chip_smoke.py` phase 2: the two-source kernels of `csrc/attention_tma.cu`
(K1 and K5 under qk8, sage and dq: 5 segments of 1536 tokens, 4 denoised
with spans of 1, 2, 3 and 5 chunks and the ride-along copy, an int8 cache
of 2 clean chunks, the DiT's q prologue) and the single-source kernels of
`csrc/attention.cu` (K2, the caption cross-attention: 4 segments of 1536
tokens, 24/8 heads, captions of 50, 7, 800 and 0 tokens in 800-token
slabs, norm-only prologue, and the walk's captions, every one 50 tokens or
every one 7; K2g, the VAE's attention at head_dim 64: 2 segments of 3073
tokens, 16/16 heads, and the 720x720 decode's 2 x 24301, timed only: its
plain version's scores would need 75 GB); and K3, K3q of `csrc/norm.cu`
(the k-side LayerNorm + rotary + pack, bf16 and int8: hk 8, hd 128, rot
48, at phase 2's S = 6144 and 7680 and at the 720x720 steps' 48600 and
60750: K3, K3q, K3_720, K3q_720).  Each kernel is first held against its
plain version (4e-3 + 1e-2 |ref|; captions of 50 and 7 tokens 2e-2 +
2e-2 |ref|; K3 1e-2 + 1e-2 |ref|; K3q one int8 step on under 1e-3 of
the values, scales to 1e-6 relative), then timed with CUDA events beside
its bound: over a loop of calls from the host and, for all but K1 and
K5, also as calls replayed in a CUDA graph (the device time alone: at
tens of microseconds the host's loop of wrapper calls can be the slower
side) and the host's own time per call (perf_counter around a loop of
calls that does not wait for the device).

    python3 scripts/time_k5.py [--heads 24|48] [--iters 10] [--kernels K2,K2g,K3,K3q,...] [--csrc DIR ...] [--phases]

With --csrc, each DIR (a changed copy of `magi_tpu_torch/csrc`) is built
into a library of its own (under build/time_k5/) and timed in turns with
the package's build, as package, DIR..., DIR..., package, so versions are
compared within one call on one card.  With --phases, the package's
sources are also built with -DMAGI_PHASE_CLOCKS, and one launch of each
kernel prints its clocks per kv tile (and per item for K2, K2g) and warp
by phase (the phases of each source's note).  Prints the card's name and
power limit, then one line per version and kernel."""

from __future__ import annotations

import argparse
import ctypes
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

import torch  # noqa: E402

from chip_smoke import cuda_ms, graph_ms  # noqa: E402
from magi_tpu_torch.ops import _lib  # noqa: E402
from magi_tpu_torch.ops import attention as A  # noqa: E402
from magi_tpu_torch.ops import attention_q8 as A8  # noqa: E402

ATTN_TOL = dict(atol=4e-3, rtol=1e-2)
SHORT_TOL = dict(atol=2e-2, rtol=2e-2)
PEAK_BF16 = 989e12  # H100 SXM, dense, at 700 W
PEAK_BYTES = 3.35e12


def host_ms(fn, iters: int = 200) -> float:
    """The host's time per call of fn (a loop of calls that the device
    does not hold up: fewer than its launch queue holds)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    ms = (time.perf_counter() - t0) / iters * 1e3
    torch.cuda.synchronize()
    return ms


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
        elif ("registers" in line or "spill" in line) and ("seg_attn" in entry or "kv_norm" in entry):
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


def single_source_kernels(dev) -> dict:
    """K2 and K2g at phase 2's shapes (seed 2): name -> (kernel call,
    plain call or None, operations, bound ms, tolerance, clock entry)."""
    g = torch.Generator(device=dev)
    g.manual_seed(2)

    def randn(*shape, dtype=torch.bfloat16):
        return torch.randn(shape, generator=g, device=dev).to(dtype)

    out = {}
    hq, hk, hd, L, ctn, n_seg, eps = 24, 8, 128, 800, 1536, 4, 1e-6
    q = randn(n_seg * ctn, hq, hd)
    kx, vx = randn(n_seg * L, hk, hd), randn(n_seg * L, hk, hd)
    pro = (1.0 + 0.1 * randn(hd, dtype=torch.float32), 0.1 * randn(hd, dtype=torch.float32), None, None, eps)
    xs = torch.arange(n_seg, dtype=torch.int32, device=dev) * L
    for tag, lens in (("K2", [50, 7, 800, 0]), ("K2_all50", [50] * 4), ("K2_all7", [7] * 4)):
        xe = xs + torch.tensor(lens, dtype=torch.int32, device=dev)
        attended = sum(lens)
        nbytes = 2 * q.numel() * 2 + attended * 2 * hk * hd * 2
        ops = 4 * ctn * attended * hd * hq
        bms = max(nbytes / PEAK_BYTES, ops / PEAK_BF16) * 1e3
        tol = ATTN_TOL if min(lens) > 50 else SHORT_TOL
        out[tag] = (lambda xe=xe: A.segmented_attention_v2(q, kx, vx, xs, xe, seg_len=ctn, q_prologue=pro),
                    lambda xe=xe: A.segmented_attention_reference(A.apply_q_prologue(q, pro), kx, vx, xs, xe,
                                                                  seg_len=ctn),
                    ops, bms, tol, "magi_seg_attn_phase_clocks")
    hv, hdv = 16, 64
    for tag, N in (("K2g", 3 * 32 * 32 + 1), ("K2g_720", 3 * 90 * 90 + 1)):
        qv, kv_, vv_ = (randn(2 * N, hv, hdv) for _ in range(3))
        st = torch.arange(2, dtype=torch.int32, device=dev) * N
        ops = 4 * 2 * N * N * hdv * hv
        bms = max(4 * qv.numel() * 2 / PEAK_BYTES, ops / PEAK_BF16) * 1e3
        plain = None if N > 10000 else (
            lambda qv=qv, kv_=kv_, vv_=vv_, st=st, N=N: A.segmented_attention_reference(qv, kv_, vv_, st, st + N,
                                                                                         seg_len=N))
        out[tag] = (lambda qv=qv, kv_=kv_, vv_=vv_, st=st, N=N: A.segmented_attention(qv, kv_, vv_, st, st + N,
                                                                                      seg_len=N),
                    plain, ops, bms, ATTN_TOL, "magi_seg_attn_phase_clocks")
    return out


def k3_int8_check(out, ref):
    """K3q against its plain version: int8 values at most one step off on
    under 1e-3 of them, scales within 1e-6 relative.  (ok, a summary)."""
    (q8, sc), (ref8, ref_sc) = out, ref
    dq = (q8.int() - ref8.int()).abs()
    share = float((dq > 0).float().mean())
    sc_rel = float(((sc - ref_sc).abs() / ref_sc).max())
    ok = int(dq.max()) <= 1 and share < 1e-3 and sc_rel <= 1e-6
    return ok, f"int8 off by one on {share:.2e}, scales within {sc_rel:.1e} relative"


def kv_pack_kernels(dev) -> dict:
    """K3 and K3q at phase 2's shapes (S = 6144 and 7680: 4 segments of
    1536 tokens, and the ride-along copy) and at the 720x720 steps' (4 x
    12150 base, 5 x 12150 distill), hk 8, hd 128, rot 48: name -> (kernel
    call, plain call, bytes, bound ms, tolerance or check, None)."""
    from chip_smoke import kv_pack_inputs

    hk, hd, rot, eps = 8, 128, 48, 1e-6
    g = torch.Generator(device=dev)
    g.manual_seed(3)
    kw = 1.0 + 0.1 * torch.randn(hd, generator=g, device=dev)
    kb = 0.1 * torch.randn(hd, generator=g, device=dev)
    out = {}
    for tag, S, q in (("K3", 4 * 1536, False), ("K3q", 5 * 1536, True), ("K3_720", 4 * 12150, False),
                      ("K3q_720", 5 * 12150, True)):
        k, v, sin, cos = kv_pack_inputs(dev, S, hk, hd, rot)
        nbytes = 2 * S * hk * hd * 2 + 2 * S * rot * 4 + 2 * hd * 4 + 2 * S * hk * hd * (1 if q else 2)
        nbytes += 2 * S * hk * 4 if q else 0
        plain = A.kv_norm_rope_pack_q8_reference if q else A.kv_norm_rope_pack_reference
        out[tag] = (lambda k=k, v=v, sin=sin, cos=cos, q=q: A.kv_norm_rope_pack(k, v, kw, kb, sin, cos, eps=eps,
                                                                                quantize=q),
                    lambda k=k, v=v, sin=sin, cos=cos, plain=plain: plain(k, v, kw, kb, sin, cos, eps=eps),
                    nbytes, nbytes / PEAK_BYTES * 1e3, k3_int8_check if q else dict(atol=1e-2, rtol=1e-2), None)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--heads", type=int, default=24, choices=(24, 48))
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--kernels", default="", help="comma list of the kernels to time (default: all)")
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
    _lib._lib = versions[0][1]
    args8, args1, pro, seg, ops = inputs(dev, args.heads)
    bound = max(ops / PEAK_BF16, 0) * 1e3
    kernels = {  # name -> (call, plain call or None, operations, bound ms, tolerance, clock entry)
        "K1": (lambda: A.segmented_attention_two_source(*args1, seg_len=seg, q_prologue=pro),
               lambda: A.segmented_attention_two_source_reference(A.apply_q_prologue(args1[0], pro), *args1[1:],
                                                                  seg_len=seg),
               ops, bound, ATTN_TOL, "magi_phase_clocks"),
    }
    for scheme in A8.SCHEMES:
        kernels[scheme] = (
            lambda scheme=scheme: A8.segmented_attention_two_source_q8(*args8, seg_len=seg, q_prologue=pro,
                                                                      scheme=scheme),
            lambda scheme=scheme: getattr(A8, f"segmented_attention_two_source_q8_{scheme}_reference")(
                *args8, seg_len=seg, q_prologue=pro),
            ops, None, ATTN_TOL, "magi_phase_clocks")
    kernels.update(single_source_kernels(dev))
    kernels.update(kv_pack_kernels(dev))
    if args.kernels:
        by_lower = {k.lower(): k for k in kernels}
        kernels = {by_lower[k.lower()]: kernels[by_lower[k.lower()]] for k in args.kernels.split(",")}
    refs = {name: plain() for name, (_, plain, *_) in kernels.items() if plain is not None}

    a = torch.randn((8192, 8192), device=dev, dtype=torch.bfloat16)
    for _ in range(50):  # the clocks up from idle before the first timing
        a @ a
    order = versions + versions[1:][::-1] + versions[:1] if len(versions) > 1 else versions
    for tag, handle in order:
        _lib._lib = handle
        for name, (call, _, n_ops, bms, tol, entry) in kernels.items():
            out = call()
            torch.cuda.synchronize()
            check = "(timed only)"
            if callable(tol):  # K3q
                ok, check = tol(out, refs[name])
                check += " ok" if ok else " FAILED"
            elif name in refs:
                out, ref = out.float(), refs[name].float()
                ok = bool(torch.isfinite(out).all()) and torch.allclose(out, ref, **tol)
                check = f"max_abs_err {float((out - ref).abs().max()):.3e} {'ok' if ok else 'FAILED'}"
            elif not bool(torch.isfinite(out.float()).all()):
                check = "not finite: FAILED"
            ms = cuda_ms(call, args.iters if bms is None or bms > 0.2 else max(args.iters, 200))
            share = "" if bms is None else f", bound {bms:.4f} ms ({bms / ms:.1%})"
            if entry != "magi_phase_clocks":  # K2, K2g, K3, K3q: also the device time alone, and the host's
                dms = graph_ms(call, max(args.iters, 50))
                share += f"; replayed in a CUDA graph {dms:.4f} ms" + ("" if bms is None else f" ({bms / dms:.1%})")
                share += f"; host {host_ms(call):.4f} ms a call"
            rate = f"{n_ops / ms / 1e9:.1f} T operations/s" if entry else f"{n_ops / ms / 1e9:.3f} TB/s"
            print(f"{tag} {name}{' ' + str(args.heads) + '/8 heads' if name in ('K1', *A8.SCHEMES) else ''}: "
                  f"{ms:.4f} ms, {rate}{share}, {check}", flush=True)
    if args.phases:
        handle = build(_lib.CSRC_DIR, "phases", ["-DMAGI_PHASE_CLOCKS"])
        for entry in ("magi_phase_clocks", "magi_seg_attn_phase_clocks"):
            getattr(handle, entry).argtypes = [ctypes.c_void_p]
            getattr(handle, entry).restype = ctypes.c_int
        _lib._lib = handle
        clocks = (ctypes.c_ulonglong * 9)()
        two_source = ["wait tile", "Q K^T", "wait converted", "softmax", "P V"]
        single = ["wait tile", "turn", "products", "softmax"]
        for name, (call, *_, entry) in kernels.items():
            if entry is None:  # K3, K3q: no clocks
                continue
            read = getattr(handle, entry)
            call()
            torch.cuda.synchronize()
            _lib.check(read(clocks), entry)  # cleared
            call()
            torch.cuda.synchronize()
            _lib.check(read(clocks), entry)
            c = list(clocks)
            per = lambda i, n: c[i] / max(c[n], 1)
            if entry == "magi_phase_clocks":
                cons = ", ".join(f"{nm} {per(i, 7):.0f}" for i, nm in enumerate(two_source))
                conv = f"; converters: wait {per(5, 8):.0f}, convert {per(6, 8):.0f}" if c[8] else ""
                print(f"phases {name} {args.heads}/8 heads, clocks per tile and warp: consumers: {cons} "
                      f"(sum {sum(per(i, 7) for i in range(5)):.0f}){conv}", flush=True)
            else:
                tiles = ", ".join(f"{nm} {per(i, 7):.0f}" for i, nm in enumerate(single))
                print(f"phases {name}, clocks per kv tile and warp: {tiles} (sum "
                      f"{sum(per(i, 7) for i in range(4)):.0f}); per item and warp: wait q {per(4, 8):.0f}, "
                      f"prologue {per(5, 8):.0f}, epilogue {per(6, 8):.0f}; {c[7] / max(c[8], 1):.2f} tiles an item",
                      flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

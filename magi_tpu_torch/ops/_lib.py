"""Build and bind the port's CUDA kernels.

The sources under `csrc/` have a plain C interface.  At first use each is
compiled by `nvcc` for `sm_90a` (all sources at once, one process each),
linked into one shared library under `build/magi_tpu_torch/` at the root
of the checkout, and loaded with `ctypes`.  A library newer than every
source and header is reused.  No `--use_fast_math`: the int8 kernels are
held bit-exact against their plain versions, which needs IEEE division,
square root and round-to-nearest-even.  There is no fallback: without `nvcc` or a CUDA device
the build raises.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
from typing import Optional

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build", "magi_tpu_torch")
SOURCES = ("attention.cu", "attention_tma.cu", "norm.cu", "quant.cu")
HEADERS = ("ptx.cuh", "tmap.cuh")
LIB_NAME = "libmagi_tpu_torch.so"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v"]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
_F = ctypes.c_float

_SIGNATURES = {
    "magi_seg_attn_two_source": [_P, _P, _P, _LL, _LL, _LL, _LL, _P, _LL, _LL, _LL, _LL, _P, _P, _P, _P,
                                 _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _F, _P],
    "magi_seg_attn_two_source_int8": [_P, _P, _P, _LL, _LL, _LL, _LL, _P, _LL, _LL, _P, _LL, _LL, _LL, _LL, _P,
                                      _LL, _LL, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _F,
                                      _I, _P],
    "magi_seg_attn": [_P, _LL, _LL, _P, _P, _LL, _LL, _P, _LL, _LL, _LL, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                      _I, _I, _F, _F, _I, _P],
    "magi_kv_norm_rope_pack": [_P, _P, _P, _P, _P, _P, _P, _LL, _I, _I, _I, _I, _F, _P],
    "magi_kv_norm_rope_pack_q8": [_P, _P, _P, _P, _P, _P, _P, _P, _LL, _I, _I, _I, _I, _F, _P],
    "magi_qmm_i8": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    "magi_qmm_deq": [_P, _P, _P, _P, _I, _I, _I, _I, _P],
    "magi_rowquant": [_P, _P, _P, _P, _P, _P, _LL, _I, _F, _P],
    "magi_rowquant_swiglu": [_P, _P, _P, _P, _LL, _I, _P],
    "magi_gate_norm_residual": [_P, _P, _P, _P, _P, _P, _LL, _I, _I, _I, _F, _I, _P],
}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the port's CUDA kernels are built on a machine with the CUDA toolkit")
    return path


def _stale(lib_path: str) -> bool:
    if not os.path.exists(lib_path):
        return True
    t = os.path.getmtime(lib_path)
    return any(os.path.getmtime(os.path.join(CSRC_DIR, s)) > t for s in SOURCES + HEADERS)


def build() -> str:
    """Compile every source in parallel and link the library; returns its
    path.  The compilers' output (with `-Xptxas -v`: registers, shared
    memory and spills per kernel) goes to `build.log` beside it."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    lib_path = os.path.join(BUILD_DIR, LIB_NAME)
    if not _stale(lib_path):
        return lib_path
    nvcc = _nvcc()
    procs = []
    for src in SOURCES:
        obj = os.path.join(BUILD_DIR, src.replace(".cu", ".o"))
        cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", obj, os.path.join(CSRC_DIR, src)]
        procs.append((cmd, obj, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    log = []
    failed = []
    for cmd, obj, p in procs:
        out, _ = p.communicate()
        log.append(" ".join(cmd) + "\n" + out)
        if p.returncode != 0:
            failed.append(out)
    if not failed:
        tmp = lib_path + f".tmp{os.getpid()}"
        cmd = [nvcc, "-shared", "-o", tmp, *[obj for _, obj, _ in procs]]
        p = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        log.append(" ".join(cmd) + "\n" + p.stdout)
        if p.returncode != 0:
            failed.append(p.stdout)
        else:
            os.replace(tmp, lib_path)
    with open(os.path.join(BUILD_DIR, "build.log"), "w") as f:
        f.write("\n".join(log))
    if failed:
        raise RuntimeError("building the CUDA kernels failed:\n" + "\n".join(failed))
    return lib_path


def lib() -> ctypes.CDLL:
    """The loaded kernel library, built at first use."""
    global _lib
    with _lock:
        if _lib is None:
            handle = ctypes.CDLL(build())
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(handle, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = handle
    return _lib


def check(err: int, name: str) -> None:
    """Raise if a kernel's C entry point returned a non-zero cudaError_t."""
    if err != 0:
        raise RuntimeError(f"{name} failed to launch: cudaError_t {err}")


def ptr(t) -> Optional[int]:
    """Device pointer of a tensor (None for a missing optional operand)."""
    return None if t is None else t.data_ptr()


def stream(device) -> int:
    """The raw handle of `device`'s current stream (PyTorch's own lookup of
    it, without the Stream object that `torch.cuda.current_stream` builds:
    a few microseconds of host time a launch)."""
    import torch

    index = device.index if device.index is not None else torch.cuda.current_device()
    raw = getattr(torch._C, "_cuda_getCurrentRawStream", None)
    return raw(index) if raw is not None else torch.cuda.current_stream(index).cuda_stream

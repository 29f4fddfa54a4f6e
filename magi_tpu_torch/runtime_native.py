"""ctypes bindings for the native IO runtime (`runtime/magi_io.cpp`): the
port's counterpart of `magi_tpu.runtime_native`.

Host IO, not a device kernel: threaded shard reads with transparent zstd
decompression, bf16 <-> f32 bulk conversion and uint8 frame packing.  The
library is built at first use with `runtime/Makefile`'s flags (g++,
libzstd) into `build/magi_tpu_torch/runtime/<host key>/` at the root of
the checkout, apart from the JAX package's copy in `runtime/`.  The host
key hashes what `-march=native` means to the compiler on this host (its
instruction sets), the machine and the host name, so a checkout copied to
another machine builds its own library instead of loading one compiled
for other instructions.  The file is written under a temporary name and
renamed, so processes building at once never load a partial file.  Every
entry point has a Python fallback (numpy, `zstandard` imported when a
`.zst` needs it, torch's bf16), taken with a warning when the toolchain
or libzstd is missing, and whenever MAGI_DISABLE_NATIVE=1 is set.

Arrays in and out are numpy, but `f32_to_bf16`, which returns a
`torch.bfloat16` tensor (numpy has no bf16), and `bf16_to_f32`, which also
takes one.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import platform
import subprocess
from typing import List, Optional, Union

import numpy as np
import torch

from magi_tpu_torch.core.logger import magi_logger

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_ROOT, "runtime", "magi_io.cpp")
BUILD_DIR = os.path.join(_ROOT, "build", "magi_tpu_torch", "runtime")
CXX_FLAGS = ["-O3", "-march=native", "-std=c++17", "-shared", "-fPIC", "-Wall"]  # runtime/Makefile's
LD_LIBS = ["-lzstd", "-lpthread"]

_LIB: Optional[ctypes.CDLL] = None
_TRIED = False


@functools.lru_cache(maxsize=None)
def lib_path() -> str:
    """Where this host's library lives: under a key of the compiler's
    expansion of `-march=native` (the `cc1` line of `g++ -march=native -E
    -v`, which lists the instruction sets it enables), the machine and the
    host name."""
    out = subprocess.run([os.environ.get("CXX", "g++"), "-march=native", "-E", "-v", "-"], input=b"",
                         capture_output=True, timeout=60, check=True)
    target = [line for line in out.stderr.decode(errors="replace").splitlines() if " -march=" in line]
    key = "\n".join([platform.machine(), platform.node(), *CXX_FLAGS, *target])
    return os.path.join(BUILD_DIR, hashlib.sha256(key.encode()).hexdigest()[:16], "libmagi_io.so")


def _build() -> Optional[str]:
    tmp = None
    try:
        so = lib_path()
        if os.path.exists(so) and os.path.getmtime(so) >= os.path.getmtime(SOURCE):
            return so
        os.makedirs(os.path.dirname(so), exist_ok=True)
        tmp = f"{so}.{os.getpid()}.tmp"
        cmd = [os.environ.get("CXX", "g++")] + CXX_FLAGS + [SOURCE] + LD_LIBS + ["-o", tmp]
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        os.replace(tmp, so)
        return so
    except Exception as e:
        err = getattr(e, "stderr", b"") or b""
        magi_logger.warning(f"native runtime build failed ({e}: {err.decode(errors='replace')[-300:]}); "
                            "using python fallbacks")
        if tmp is not None and os.path.exists(tmp):
            os.remove(tmp)
        return None


def get_lib() -> Optional[ctypes.CDLL]:
    """The library, built and loaded at the first call; None under
    MAGI_DISABLE_NATIVE=1 (read at every call) or where it does not build."""
    global _LIB, _TRIED
    if os.environ.get("MAGI_DISABLE_NATIVE") == "1":
        return None
    if _LIB is not None or _TRIED:
        return _LIB
    _TRIED = True
    so = _build()
    if so is None:
        return None
    try:
        lib = ctypes.CDLL(so)
        lib.magi_zstd_decompress.restype = ctypes.c_int64
        lib.magi_zstd_decompress.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64]
        lib.magi_zstd_content_size.restype = ctypes.c_int64
        lib.magi_zstd_content_size.argtypes = [ctypes.c_void_p, ctypes.c_int64]
        lib.magi_payload_size.restype = ctypes.c_int64
        lib.magi_payload_size.argtypes = [ctypes.c_char_p]
        lib.magi_read_files.restype = ctypes.c_int32
        lib.magi_read_files.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_int32,
            ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int64), ctypes.c_int32,
        ]
        for name in ("magi_bf16_to_f32", "magi_f32_to_bf16"):
            fn = getattr(lib, name)
            fn.restype = None
            fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int32]
        for name in ("magi_u8_thwc_to_f32_cthw", "magi_f32_cthw_to_u8_thwc"):
            fn = getattr(lib, name)
            fn.restype = None
            fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
                           ctypes.c_int32]
        _LIB = lib
    except Exception as e:
        magi_logger.warning(f"native runtime load failed ({e}); using python fallbacks")
        _LIB = None
    return _LIB


def available() -> bool:
    return get_lib() is not None


def _zstd_python(data: bytes) -> bytes:
    import zstandard

    return zstandard.ZstdDecompressor().decompress(data)


def zstd_decompress(data: bytes) -> bytes:
    lib = get_lib()
    if lib is None:
        return _zstd_python(data)
    size = lib.magi_zstd_content_size(data, len(data))
    if size < 0:
        return _zstd_python(data)
    out = ctypes.create_string_buffer(size)
    r = lib.magi_zstd_decompress(data, len(data), out, size)
    if r != size:
        raise RuntimeError(f"zstd decompress failed ({r})")
    return out.raw


def read_files(paths: List[str], n_threads: int = 0) -> List[bytes]:
    """Parallel read (+ transparent .zst decompression) of shard files."""
    lib = get_lib()
    if lib is None:
        out = []
        for p in paths:
            with open(p, "rb") as f:
                data = f.read()
            out.append(zstd_decompress(data) if p.endswith(".zst") else data)
        return out
    return [a.tobytes() for a in read_arrays(paths, n_threads)]


def read_arrays(paths: List[str], n_threads: int = 0) -> List[np.ndarray]:
    """`read_files` into uint8 arrays, without the copy to `bytes` (the
    native library only)."""
    lib = get_lib()
    if lib is None:
        raise RuntimeError("the native runtime is not available")

    sizes = [lib.magi_payload_size(p.encode()) for p in paths]
    for p, s in zip(paths, sizes):
        if s < 0:
            raise OSError(f"cannot stat {p} (or read its zstd frame's size)")
    bufs = [np.empty(s, np.uint8) for s in sizes]
    c_paths = (ctypes.c_char_p * len(paths))(*[p.encode() for p in paths])
    c_dsts = (ctypes.c_void_p * len(paths))(*[b.ctypes.data for b in bufs])
    c_caps = (ctypes.c_int64 * len(paths))(*sizes)
    c_out = (ctypes.c_int64 * len(paths))()
    status = lib.magi_read_files(c_paths, len(paths), c_dsts, c_caps, c_out, n_threads)
    if status != 0:
        raise OSError(f"native shard read failed (paths={paths})")
    return [b[: c_out[i]] for i, b in enumerate(bufs)]


def f32_to_bf16(arr: np.ndarray, n_threads: int = 0) -> torch.Tensor:
    """f32 -> bf16 (round to nearest even), a `torch.bfloat16` tensor."""
    lib = get_lib()
    src = np.ascontiguousarray(arr, dtype=np.float32)
    if lib is None:
        return torch.from_numpy(src).to(torch.bfloat16)
    dst = np.empty(src.shape, np.int16)
    lib.magi_f32_to_bf16(src.ctypes.data, dst.ctypes.data, src.size, n_threads)
    return torch.from_numpy(dst).view(torch.bfloat16)


def bf16_to_f32(arr: Union[np.ndarray, torch.Tensor], n_threads: int = 0) -> np.ndarray:
    """bf16 (uint16-viewed bits, or a `torch.bfloat16` tensor) -> f32."""
    if isinstance(arr, torch.Tensor):
        arr = arr.detach().cpu().contiguous().view(torch.int16).numpy()
    lib = get_lib()
    src = np.ascontiguousarray(arr.view(np.uint16))
    if lib is None:
        return (src.astype(np.uint32) << 16).view(np.float32)
    dst = np.empty(src.shape, np.float32)
    lib.magi_bf16_to_f32(src.ctypes.data, dst.ctypes.data, src.size, n_threads)
    return dst


def u8_thwc_to_f32_cthw(frames: np.ndarray, n_threads: int = 0) -> np.ndarray:
    """uint8 [T,H,W,3] -> f32 [3,T,H,W] in [-1,1]."""
    T, H, W, C = frames.shape
    if C != 3:
        raise ValueError(f"expected 3 channels, got {C}")
    lib = get_lib()
    if lib is None:
        out = frames.astype(np.float32) / 127.5 - 1.0
        return np.ascontiguousarray(out.transpose(3, 0, 1, 2))
    src = np.ascontiguousarray(frames)
    dst = np.empty((3, T, H, W), np.float32)
    lib.magi_u8_thwc_to_f32_cthw(src.ctypes.data, dst.ctypes.data, T, H, W, n_threads)
    return dst


def f32_cthw_to_u8_thwc(video: np.ndarray, n_threads: int = 0) -> np.ndarray:
    """f32 [3,T,H,W] in [-1,1] -> uint8 [T,H,W,3]."""
    C, T, H, W = video.shape
    if C != 3:
        raise ValueError(f"expected 3 channels, got {C}")
    lib = get_lib()
    if lib is None:
        out = np.clip(video * 127.5 + 127.5, 0, 255) + 0.5
        return out.astype(np.uint8).transpose(1, 2, 3, 0)
    src = np.ascontiguousarray(video, dtype=np.float32)
    dst = np.empty((T, H, W, 3), np.uint8)
    lib.magi_f32_cthw_to_u8_thwc(src.ctypes.data, dst.ctypes.data, T, H, W, n_threads)
    return dst

"""The safetensors file format, read and written with torch alone.

A file is an 8-byte little-endian header length n, n bytes of JSON header
({name: {"dtype", "shape", "data_offsets": [begin, end]}}, with an
optional "__metadata__" entry), then the tensors' raw little-endian bytes,
their offsets counted from the end of the header.

* `load_file(path)`: every tensor of a file, as CPU tensors in their stored
  dtype.  A plain file is mapped copy-on-write, so a tensor's bytes are
  read from disk only when it is used (a loader that moves one leaf at a
  time to the card never holds the file in host memory); a
  `.safetensors.zst` shard is decompressed whole through the `zstandard`
  module, and raises an ImportError naming it when it is missing.
* `load_buffer(raw, name)`: the same from a file's bytes already in host
  memory (a uint8 tensor or numpy array, as the native reader gives
  them); the tensors are views of it.
* `save_file(tensors, path)`: the inverse, for the same dtypes.

The dtypes are F32, F16, BF16, F8_E4M3 (`torch.float8_e4m3fn`), I8, U8 and
I32; any other raises.  The port reads its checkpoints with this module:
it needs neither the `safetensors` package nor a native reader.
"""

from __future__ import annotations

import io
import json
import os
from typing import Dict, Optional

import numpy as np
import torch

DTYPES = {
    "F32": torch.float32,
    "F16": torch.float16,
    "BF16": torch.bfloat16,
    "F8_E4M3": torch.float8_e4m3fn,
    "I8": torch.int8,
    "U8": torch.uint8,
    "I32": torch.int32,
}
_NAMES = {v: k for k, v in DTYPES.items()}


def _raw_bytes(path: str) -> torch.Tensor:
    """The file's bytes as a uint8 tensor: decompressed for `.zst`, else a
    copy-on-write map of the file."""
    if path.endswith(".zst"):
        try:
            import zstandard
        except ImportError as e:
            raise ImportError(f"reading the zstd-compressed shard {path} needs the zstandard module") from e
        out = io.BytesIO()
        with open(path, "rb") as f:
            zstandard.ZstdDecompressor().copy_stream(f, out)
        return torch.frombuffer(bytearray(out.getbuffer()), dtype=torch.uint8)
    if os.path.getsize(path) < 8:
        raise ValueError(f"{path} is too short to be a safetensors file")
    return torch.from_numpy(np.memmap(path, dtype=np.uint8, mode="c"))


def load_file(path: str) -> Dict[str, torch.Tensor]:
    """{name: CPU tensor in its stored dtype} of one safetensors file."""
    return load_buffer(_raw_bytes(path), path)


def load_buffer(raw, path: str = "<buffer>") -> Dict[str, torch.Tensor]:
    """{name: CPU tensor in its stored dtype} of a safetensors file's bytes
    `raw` (uint8, a tensor or a numpy array); `path` names it in errors."""
    if isinstance(raw, np.ndarray):
        raw = torch.from_numpy(raw)
    if raw.numel() < 8:
        raise ValueError(f"{path} is too short to be a safetensors file")
    n = int.from_bytes(raw[:8].numpy().tobytes(), "little")
    header = json.loads(raw[8 : 8 + n].numpy().tobytes())
    base = 8 + n
    out = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        dtype = DTYPES.get(info["dtype"])
        if dtype is None:
            raise ValueError(f"{path}: tensor {name} has dtype {info['dtype']}, which this reader does not take "
                             f"(it reads {', '.join(DTYPES)})")
        begin, end = info["data_offsets"]
        shape = tuple(info["shape"])
        itemsize = torch.empty((), dtype=dtype).element_size()
        nbytes = int(np.prod(shape, dtype=np.int64)) * itemsize
        if end - begin != nbytes or base + end > raw.numel():
            raise ValueError(f"{path}: tensor {name} spans bytes [{begin}, {end}), not the {nbytes} of {shape}")
        chunk = raw[base + begin : base + end]
        if (base + begin) % itemsize:
            chunk = chunk.clone()  # an unaligned tensor: viewing it as a wider dtype needs its own storage
        out[name] = chunk.view(dtype).reshape(shape)
    return out


def save_file(tensors: Dict[str, torch.Tensor], path: str, metadata: Optional[Dict[str, str]] = None) -> None:
    """Write `tensors` (any device; contiguous copies are made on the host)
    as one safetensors file, widest dtypes first so every tensor is aligned
    to its element size.  Written to a temporary name, then renamed."""
    items = sorted(tensors.items(), key=lambda kv: (-kv[1].element_size(), kv[0]))
    header, off = {}, 0
    for name, t in items:
        if t.dtype not in _NAMES:
            raise ValueError(f"tensor {name} has dtype {t.dtype}, which the format here does not take")
        nbytes = t.numel() * t.element_size()
        header[name] = {"dtype": _NAMES[t.dtype], "shape": list(t.shape), "data_offsets": [off, off + nbytes]}
        off += nbytes
    if metadata:
        header["__metadata__"] = dict(metadata)
    blob = json.dumps(header, separators=(",", ":")).encode()
    blob += b" " * (-len(blob) % 8)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(len(blob).to_bytes(8, "little"))
        f.write(blob)
        for _, t in items:
            f.write(t.detach().to("cpu").contiguous().reshape(-1).view(torch.uint8).numpy().data)
    os.replace(tmp, path)

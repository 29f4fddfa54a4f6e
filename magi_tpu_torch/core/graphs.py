"""CUDA graphs: the port's counterpart of the JAX package's `jax.jit`.

The JAX package compiles every denoise step variant of the ARDF walk
(`_jitted_steps`), the pieces of the host-streamed step (`_stream_jits`)
and the VAE's encode and decode.  On the card the port captures the same
regions once in CUDA graphs and replays them: a replay launches the
step's kernels from the device with the host out of the loop.

* `StepGraph` is one such function: a `body(run, *args)` whose device work
  lies in `run.piece(name, fn, *args)` regions.  Its first call (or
  `build`, ahead of it) runs the body capturing each piece in a graph of
  its own; every call runs the body's Python again and replays the
  pieces' graphs in order.  The first graph of a key (a config's variant at its shapes)
  in the process runs the body eagerly before it captures, the warm-up
  that builds the kernels, sets their attributes, looks up the tensor-map
  encoder and creates cuBLAS's handle outside any capture (the call's
  result is then the eager run's), as the JAX package compiles once a
  process.  Between pieces the body may do host work that must stay on
  the host (the host-streamed cache's copies and events);
  `run.copies_live` is False while it captures, when that work is
  skipped.
* Graphs bake every pointer they read.  Everything a later replay reads
  is owned by the caller, outside the graphs' temporaries: its buffers
  (the latent state, the KV cache, the per-step inputs) and its `Arena`,
  where a piece's outputs are copied so the next piece finds them at the
  same address.
* One memory pool and one capture stream per device and role
  (`graph_pool`, `_capture_stream`): the walk's live graphs share one;
  the VAE's share another, since the interleaved decode replays on its
  own stream beside the walk's, and two graphs of one pool reuse each
  other's memory, two of one capture stream cuBLAS's workspace.
* A kernel wrapper counts its launches when its Python runs; a replay runs
  none of it.  Each piece records, while it is captured, how many launches
  of each wrapper it holds, and adds them on every replay; the capture's
  own calls are taken back out.  So the counts are those of the kernels
  that ran, eager or replayed.
* No fallback: a capture or a replay that fails raises a `RuntimeError`
  naming the graph.

On the CPU nothing is captured: `PLAIN` runs every piece as a call.
"""

from __future__ import annotations

import contextlib
import gc
import threading
import time
import weakref
from typing import Callable, Dict, Iterator, List, Optional, Tuple

import torch

_lock = threading.Lock()
_pools = weakref.WeakValueDictionary()  # (device index, role) -> the live graphs' torch.cuda.MemPool
_capture_streams: Dict[tuple, torch.cuda.Stream] = {}
_warmed: set = set()  # (device index, warm key) of the graphs whose first call ran eagerly


def launch_counters() -> Tuple[Callable, ...]:
    """The kernel wrappers that count their launches (`.launches`)."""
    from magi_tpu_torch.ops import act_quant, attention, attention_q8, fused_norm, quant

    return (attention.segmented_attention_two_source, attention.segmented_attention, attention.segmented_attention_v2,
            attention.kv_norm_rope_pack, attention.kv_norm_rope_pack_q8, attention_q8.segmented_attention_two_source_q8,
            attention_q8.segmented_attention_two_source_q8_sage, attention_q8.segmented_attention_two_source_q8_dq,
            quant.quantized_matmul_i8, quant.quantized_matmul, act_quant.rowquant_fused, act_quant.rowquant_swiglu,
            fused_norm.gate_norm_residual)


def launch_counts() -> List[int]:
    return [w.launches for w in launch_counters()]


def set_launch_counts(counts: List[int]) -> None:
    for w, n in zip(launch_counters(), counts):
        w.launches = n


@contextlib.contextmanager
def uncounted() -> Iterator[None]:
    """Launches inside the block are taken back out of the counts: warm-ups
    and captures made ahead of a walk are not the walk's work."""
    saved = launch_counts()
    try:
        yield
    finally:
        set_launch_counts(saved)


def _index(device: torch.device) -> int:
    return device.index if device.index is not None else torch.cuda.current_device()


def graph_pool(device: torch.device, role: str) -> "torch.cuda.MemPool":
    """The memory pool that `device`'s live graphs of `role` ("walk" or
    "vae") share.  Every `StepGraph` holds it; once none is left it goes,
    its memory back to the device at the next `torch.cuda.empty_cache()`,
    and the next capture starts a new one."""
    key = (_index(device), role)
    with _lock:
        pool = _pools.get(key)
        if pool is None:
            with torch.cuda.device(key[0]):
                pool = torch.cuda.MemPool()
            _pools[key] = pool
        return pool


def _capture_stream(device: torch.device, role: str) -> torch.cuda.Stream:
    """The stream `device`'s graphs of `role` are captured on.  PyTorch
    keeps cuBLAS's workspace per stream, and a captured GEMM bakes the
    workspace of the stream it was captured on: graphs that replay at
    once on two streams (the walk's and the interleaved decode's) must be
    captured on two streams."""
    key = (_index(device), role)
    with _lock:
        if key not in _capture_streams:
            _capture_streams[key] = torch.cuda.Stream(key[0])
        return _capture_streams[key]


class Arena:
    """Flat device buffers that hold pieces' outputs at fixed addresses,
    one per output slot and dtype, grown by a new buffer when a larger
    output comes: a graph captured against an older buffer keeps it, so
    none is freed while its owner lives.  A buffer first needed while a
    piece is captured comes from the graphs' pool, where the arena's
    reference keeps any later capture off it.  A slot is reused by every
    piece of that name, one after another (a step's pieces run in order)."""

    def __init__(self, device: torch.device):
        self.device = device
        self._bufs: Dict[tuple, torch.Tensor] = {}
        self._all: List[torch.Tensor] = []

    def put(self, slot: tuple, t: torch.Tensor) -> torch.Tensor:
        key = slot + (t.dtype,)
        buf = self._bufs.get(key)
        if buf is None or buf.numel() < t.numel():
            buf = torch.empty(t.numel(), dtype=t.dtype, device=self.device)
            self._bufs[key] = buf
            self._all.append(buf)
        out = buf[: t.numel()].view(t.shape)
        out.copy_(t)
        return out

    @property
    def nbytes(self) -> int:
        return sum(b.nbytes for b in self._all)


class _Plain:
    """Runs every piece as a call: the CPU, and the eager walk."""

    copies_live = True

    @staticmethod
    def piece(name: str, fn: Callable, *args):
        return fn(*args)


PLAIN = _Plain()


def _persist(arena: Arena, name: str, out):
    if isinstance(out, torch.Tensor):
        return arena.put((name, 0), out)
    if isinstance(out, tuple):
        return tuple(arena.put((name, i), o) if isinstance(o, torch.Tensor) else o for i, o in enumerate(out))
    if out is not None:
        raise TypeError(f"piece {name} returned {type(out).__name__}: a piece returns tensors, a tuple or None")
    return None


class StepGraph:
    """One jitted function's counterpart on the card (see the module's
    docstring).  `name` names it in errors; `body(run, *args)` returns what
    the call returns (pieces' outputs live in `arena`); `role` picks its
    pool and capture stream.  `warm_key` names
    what the first call's eager run warms: the first graph of a key in the
    process runs the body eagerly before it captures, as the JAX package
    compiles a variant once a process; later ones capture at once and
    replay for their first call's result."""

    def __init__(self, name: str, body: Callable, device: torch.device, role: str, arena: Arena,
                 warm_key: Optional[tuple] = None):
        self.name = name
        self.body = body
        self.device = device
        self.pool = graph_pool(device, role)
        self._stream = _capture_stream(device, role)
        self.arena = arena
        self.warm_key = warm_key
        self._mode = "new"
        self._depth = 0
        self._i = 0
        self._pieces: List[tuple] = []  # (name, graph, launch deltas, outputs)
        self.capture_seconds = 0.0  # host seconds of the first call: its warm-up (if any) and capture
        self.warm_seconds = 0.0  # of which the eager warm-up run
        self.instantiate_seconds = 0.0  # of which ending the captures (CUDA instantiates the graphs there)

    @property
    def copies_live(self) -> bool:
        return self._mode != "capture"

    @property
    def graphs(self) -> int:
        return len(self._pieces)

    def __call__(self, *args):
        if self._mode == "new":
            out, ran = self._first(args)
            if ran:
                return out
        self._i = 0
        out = self.body(self, *args)
        if self._i != len(self._pieces):
            raise RuntimeError(f"{self.name}: the replay ran {self._i} pieces of {len(self._pieces)} captured")
        return out

    def build(self, *args) -> None:
        """Capture ahead of the first call, which then only replays (the
        process's first graph of its key still warms eagerly first, its
        result dropped)."""
        if self._mode == "new":
            self._first(args)

    def _first(self, args) -> tuple:
        """Warm (the first graph of the key in the process) and capture;
        returns (the warm-up's result, whether it ran)."""
        t0 = time.perf_counter()
        key = (_index(self.device), self.warm_key)
        out, ran = None, key not in _warmed
        if ran:
            self._mode = "warm"
            out = self.body(self, *args)
            torch.cuda.synchronize(self.device)
            self.warm_seconds = time.perf_counter() - t0
        self._capture(*args)
        with _lock:
            _warmed.add(key)
        self.capture_seconds = time.perf_counter() - t0
        return out, ran

    def _capture(self, *args) -> None:
        saved = launch_counts()
        torch.cuda.synchronize(self.device)
        self._mode, self._i = "capture", 0
        # no garbage collection while capturing: a collected graph's
        # destruction is an API call a capture does not permit
        gc_was_on = gc.isenabled()
        gc.disable()
        try:
            self.body(self, *args)
        except Exception as e:
            self._mode = "failed"
            raise RuntimeError(f"capturing {self.name} in a CUDA graph failed: {e}") from e
        finally:
            if gc_was_on:
                gc.enable()
            set_launch_counts(saved)
        self._mode = "replay"

    def piece(self, name: str, fn: Callable, *args):
        """`fn(*args)`, captured as one graph (or replayed); nested pieces
        run as calls inside the enclosing one."""
        if self._depth:
            return fn(*args)
        if self._mode == "warm":
            self._depth += 1
            try:
                out = fn(*args)
            finally:
                self._depth -= 1
            return _persist(self.arena, name, out)
        if self._mode == "capture":
            return self._capture_piece(name, fn, args)
        if self._mode != "replay":
            raise RuntimeError(f"{self.name}: its capture failed; it cannot run")
        pname, graph, deltas, out = self._pieces[self._i]
        if pname != name:
            raise RuntimeError(f"{self.name}: piece {self._i} is {name}, captured as {pname}")
        self._i += 1
        try:
            graph.replay()
        except RuntimeError as e:
            raise RuntimeError(f"replaying piece {name} of {self.name} failed: {e}") from e
        for w, d in deltas:
            w.launches += d
        return out

    def _capture_piece(self, name: str, fn: Callable, args) -> object:
        graph = torch.cuda.CUDAGraph()
        before = launch_counts()
        stream = self._stream
        stream.wait_stream(torch.cuda.current_stream(self.device))
        self._depth += 1
        try:
            with torch.cuda.stream(stream):
                graph.capture_begin(pool=self.pool.id)
                try:
                    out = _persist(self.arena, name, fn(*args))
                except BaseException:
                    try:  # end the broken capture; the first error is the one to report
                        graph.capture_end()
                    except RuntimeError:
                        pass
                    raise
                t0 = time.perf_counter()
                graph.capture_end()
                self.instantiate_seconds += time.perf_counter() - t0
        except Exception as e:
            self._mode = "failed"
            raise RuntimeError(f"capturing piece {name} of {self.name} in a CUDA graph failed: {e}") from e
        finally:
            self._depth -= 1
        torch.cuda.current_stream(self.device).wait_stream(stream)
        deltas = [(w, a - b) for w, a, b in zip(launch_counters(), launch_counts(), before) if a != b]
        self._pieces.append((name, graph, deltas, out))
        self._i += 1
        return out


def graph_count(graphs) -> int:
    return sum(g.graphs if isinstance(g, StepGraph) else 0 for g in graphs)


def capture_breakdown(graphs) -> dict:
    """Host seconds the first calls of `graphs` spent: in all, in eager
    warm-up runs, and ending captures (instantiating graphs)."""
    sg = [g for g in graphs if isinstance(g, StepGraph)]
    return dict(seconds=sum(g.capture_seconds for g in sg), warm=sum(g.warm_seconds for g in sg),
                instantiate=sum(g.instantiate_seconds for g in sg))


def make_callable(name: str, body: Callable, device: torch.device, arena: Arena, warm_key: tuple,
                  role: str = "walk"):
    """`body` as a step callable: a `StepGraph` on a card, else `body` run
    with `PLAIN`."""
    if device.type == "cuda":
        return StepGraph(name, body, device, role, arena, warm_key)
    return lambda *args: body(PLAIN, *args)

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
* Memory pools and capture streams: a walk's graphs share its
  workspace's pool, so dropping the workspace frees their memory; the
  VAE's graphs share one pool per device (`graph_pool`).  Graphs of one
  pool reuse each other's memory, and graphs captured on one stream
  cuBLAS's workspace, so the walk and the VAE capture on a stream each
  (`_capture_stream`): the interleaved decode replays on its own stream
  beside the walk's.
* A kernel wrapper counts its launches when its Python runs; a replay runs
  none of it.  Each piece records, while it is captured, how many launches
  of each wrapper it holds, and adds them on every replay; the capture's
  own calls are taken back out.  So the counts are those of the kernels
  that ran, eager or replayed.
* No fallback: a capture or a replay that fails raises a `RuntimeError`
  naming the graph.
* A step of a model-parallel mesh runs its collectives between pieces,
  never inside one (`in_piece()` is True while a piece's function runs, and
  every `parallel.comm` collective raises there).  What a collective writes
  and a later piece reads lives in a `slot` of the step's arena, the same
  buffer at every call; while the step is captured (`copies_live` False)
  the collectives are skipped, as the host-streamed copies are, and the
  slots are returned as they are.  Every rank captures the same variants
  in the same order, so the skips stay in lockstep.
* Graphs outlive the walk that captured them, as the JAX package's
  compiled steps outlive a request (`_JIT_CACHE`): a `Workspace` holds a
  walk's fixed buffers and the step callables captured against them, and
  the process's pool (`WORKSPACES`) hands an idle one to the next sampler
  of an equal key, which copies its request into the buffers and
  captures nothing.  Samplers alive at once never share one.  Capturing a
  workspace of a new key frees the idle ones of other keys;
  `release_workspaces()` frees them all, and runs the hooks given to
  `on_release` (the pipeline's resident DiT tree, whose addresses the
  graphs bake, goes there).  `captures(role)` counts the graphs the
  process captured.

On the CPU nothing is captured: `PLAIN` runs every piece as a call, and
`StandIn` (when `CPU_STAND_IN` is set, as the tests set it) records and
replays pieces as a graph would, to show on the CPU what a graph bakes.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import math
import threading
import time
import weakref
from collections import Counter
from typing import Callable, Dict, Iterator, List, Optional, Tuple

import torch

_lock = threading.Lock()
_pools = weakref.WeakValueDictionary()  # (device index, role) -> the live graphs' torch.cuda.MemPool
_capture_streams: Dict[tuple, torch.cuda.Stream] = {}
_warmed: set = set()  # (device index, warm key) of the graphs whose first call ran eagerly
_captured: Counter = Counter()  # role -> graphs captured in the process
_tls = threading.local()  # .depth: pieces whose function runs on this thread
CPU_STAND_IN = False  # step callables on the CPU are `StandIn`s (tests set it)


def in_piece() -> bool:
    """True while a piece's function runs on this thread (eagerly, warming
    up or being captured): no collective may run there."""
    return getattr(_tls, "depth", 0) > 0


@contextlib.contextmanager
def _inside() -> Iterator[None]:
    _tls.depth = getattr(_tls, "depth", 0) + 1
    try:
        yield
    finally:
        _tls.depth -= 1


def captures_on(device: torch.device) -> bool:
    """Whether step callables on `device` capture (a card, or the CPU stand-in)."""
    return device.type == "cuda" or CPU_STAND_IN


def captures(role: Optional[str] = None) -> int:
    """CUDA graphs the process has captured, of `role` ("walk", "vae") or
    of every role: a walk or a decode that adds none replayed graphs
    captured before."""
    return _captured[role] if role is not None else sum(_captured.values())


def launch_counters() -> Tuple[Tuple[Callable, str], ...]:
    """The kernel wrappers' launch counts, as (wrapper, attribute):
    `.launches`, and the GEMMs' `.launches_f32` (those of them with the f32
    epilogue)."""
    from magi_tpu_torch.ops import act_quant, attention, attention_q8, fused_norm, quant

    wrappers = (attention.segmented_attention_two_source, attention.segmented_attention,
                attention.segmented_attention_v2, attention.kv_norm_rope_pack, attention.kv_norm_rope_pack_q8,
                attention_q8.segmented_attention_two_source_q8, attention_q8.segmented_attention_two_source_q8_sage,
                attention_q8.segmented_attention_two_source_q8_dq, quant.quantized_matmul_i8, quant.quantized_matmul,
                act_quant.rowquant_fused, act_quant.rowquant_swiglu, fused_norm.gate_norm_residual)
    return tuple((w, "launches") for w in wrappers) + ((quant.quantized_matmul_i8, "launches_f32"),
                                                      (quant.quantized_matmul, "launches_f32"))


def launch_counts() -> List[int]:
    return [getattr(w, a) for w, a in launch_counters()]


def set_launch_counts(counts: List[int]) -> None:
    for (w, a), n in zip(launch_counters(), counts):
        setattr(w, a, n)


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
    if device.type != "cuda":
        return -1
    return device.index if device.index is not None else torch.cuda.current_device()


def release_cached(device: torch.device) -> None:
    """Hand the caching allocator's free blocks on `device` back to the
    card (`torch.cuda.empty_cache`; nothing on the CPU).  A capture
    allocates from its graph pool, which cannot take blocks the allocator
    keeps cached for eager work, so a capture after an eager warm-up of
    the same step would otherwise need the step's activations twice (the
    released 24B base step at 576x1024 did not fit on an 80 GB card so)."""
    if device.type == "cuda":
        with torch.cuda.device(device):
            torch.cuda.empty_cache()


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
        out = self.slot(slot, tuple(t.shape), t.dtype)
        out.copy_(t)
        return out

    def slot(self, name, shape: tuple, dtype: torch.dtype) -> torch.Tensor:
        """The buffer of `name` and `dtype` as an (uninitialized) tensor of
        `shape`: `put`'s for a piece's output, and the one a collective
        writes between pieces."""
        n = math.prod(shape)
        key = (name, dtype)
        buf = self._bufs.get(key)
        if buf is None or buf.numel() < n:
            buf = torch.empty(n, dtype=dtype, device=self.device)
            self._bufs[key] = buf
            self._all.append(buf)
        return buf[:n].view(shape)

    @property
    def nbytes(self) -> int:
        return sum(b.nbytes for b in self._all)


class _Plain:
    """Runs every piece as a call: the CPU, and the eager walk.  Its slots
    are new buffers at every call."""

    copies_live = True

    @staticmethod
    def piece(name: str, fn: Callable, *args):
        with _inside():
            return fn(*args)

    @staticmethod
    def slot(name, shape: tuple, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
        return torch.empty(shape, dtype=dtype, device=device)


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
    capture stream, and its pool unless `pool` is given.  `warm_key` names
    what the first call's eager run warms: the first graph of a key in the
    process runs the body eagerly before it captures, as the JAX package
    compiles a variant once a process; later ones capture at once and
    replay for their first call's result."""

    def __init__(self, name: str, body: Callable, device: torch.device, role: str, arena: Arena,
                 warm_key: Optional[tuple] = None, pool: Optional["torch.cuda.MemPool"] = None):
        self._pieces: List[tuple] = []  # (name, graph, launch deltas, outputs); goes before `pool` does
        self._slots: List[torch.Tensor] = []  # the slots the body asked for at capture, in order
        self.name = name
        self.body = body
        self.device = device
        self.role = role
        on_card = device.type == "cuda"
        self.pool = pool if pool is not None or not on_card else graph_pool(device, role)
        self._stream = _capture_stream(device, role) if on_card else None
        self.arena = arena
        self.warm_key = warm_key
        self._mode = "new"
        self._depth = 0
        self._i = 0
        self._j = 0
        self.capture_seconds = 0.0  # host seconds of the first call: its warm-up (if any) and capture
        self.warm_seconds = 0.0  # of which the eager warm-up run
        self.instantiate_seconds = 0.0  # of which ending the captures (CUDA instantiates the graphs there)

    @property
    def copies_live(self) -> bool:
        return self._mode != "capture"

    @property
    def failed(self) -> bool:
        return self._mode == "failed"

    @property
    def graphs(self) -> int:
        return len(self._pieces)

    def _sync(self) -> None:
        torch.cuda.synchronize(self.device)

    def __call__(self, *args):
        if self._mode == "new":
            out, ran = self._first(args)
            if ran:
                return out
        self._i = self._j = 0
        out = self.body(self, *args)
        if self._i != len(self._pieces) or self._j != len(self._slots):
            raise RuntimeError(f"{self.name}: the replay ran {self._i} pieces of {len(self._pieces)} captured and "
                               f"asked for {self._j} slots of {len(self._slots)}")
        return out

    def build(self, *args) -> None:
        """Capture ahead of the first call, which then only replays (the
        process's first graph of its key still warms eagerly first, its
        result dropped)."""
        if self._mode == "new":
            self._first(args)

    def warm(self, *args) -> None:
        """The eager warm-up of `build` alone (when this is the process's
        first graph of its key), its result dropped: a caller that builds
        several graphs warms them all, hands the allocator's cached blocks
        back (`release_cached`) and then builds them, so the captures take
        the memory the warm-ups freed instead of holding it beside theirs."""
        if self._mode == "new":
            self._warm(args)

    def _warm(self, args) -> tuple:
        """Run the body eagerly if the key is not warmed in the process yet;
        returns (its result, whether it ran)."""
        key = (_index(self.device), self.warm_key)
        if key in _warmed:
            return None, False
        t0 = time.perf_counter()
        self._mode = "warm"
        try:
            out = self.body(self, *args)
            self._sync()
        finally:
            self._mode = "new"
        with _lock:
            _warmed.add(key)
        seconds = time.perf_counter() - t0
        self.warm_seconds += seconds
        self.capture_seconds += seconds
        return out, True

    def _first(self, args) -> tuple:
        """Warm (the first graph of the key in the process) and capture;
        returns (the warm-up's result, whether it ran).  Between the two the
        warm-up's freed blocks go back to the card, where the capture's pool
        can take them."""
        out, ran = self._warm(args)
        t0 = time.perf_counter()
        if ran:
            release_cached(self.device)
        self._capture(*args)
        self.capture_seconds += time.perf_counter() - t0
        return out, ran

    def _capture(self, *args) -> None:
        saved = launch_counts()
        self._sync()
        self._mode, self._i, self._slots = "capture", 0, []
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

    def slot(self, name, shape: tuple, dtype: torch.dtype, device: Optional[torch.device] = None) -> torch.Tensor:
        """A buffer of `shape` that a collective between two pieces writes
        and a later piece reads: the arena's slot of `name`, and at a replay
        the very buffer that the same request of the capture got (the
        graphs baked its address)."""
        if self._mode == "replay":
            if self._j >= len(self._slots):
                raise RuntimeError(f"{self.name}: slot {name} was not asked for at capture")
            buf = self._slots[self._j]
            if tuple(buf.shape) != tuple(shape) or buf.dtype != dtype:
                raise RuntimeError(f"{self.name}: slot {name} of {tuple(shape)} {dtype} was captured as "
                                   f"{tuple(buf.shape)} {buf.dtype}")
            self._j += 1
            return buf
        if self._mode == "failed":
            raise RuntimeError(f"{self.name}: its capture failed; it cannot run")
        buf = self.arena.slot(name, tuple(shape), dtype)
        if self._mode == "capture":
            self._slots.append(buf)
        return buf

    def piece(self, name: str, fn: Callable, *args):
        """`fn(*args)`, captured as one graph (or replayed); nested pieces
        run as calls inside the enclosing one."""
        if self._depth:
            return fn(*args)
        if self._mode == "warm":
            self._depth += 1
            try:
                with _inside():
                    out = fn(*args)
            finally:
                self._depth -= 1
            return _persist(self.arena, name, out)
        if self._mode == "capture":
            return self._capture_piece(name, fn, args)
        if self._mode != "replay":
            raise RuntimeError(f"{self.name}: its capture failed; it cannot run")
        entry = self._pieces[self._i]
        if entry[0] != name:
            raise RuntimeError(f"{self.name}: piece {self._i} is {name}, captured as {entry[0]}")
        self._i += 1
        out = self._replay_piece(entry, args)
        for w, a, d in entry[2]:
            setattr(w, a, getattr(w, a) + d)
        return out

    def _replay_piece(self, entry: tuple, args):
        name, graph, _, out = entry
        try:
            graph.replay()
        except RuntimeError as e:
            raise RuntimeError(f"replaying piece {name} of {self.name} failed: {e}") from e
        return out

    def _record(self, name: str, graph, before: List[int], out) -> object:
        deltas = [(w, a, n - b) for (w, a), n, b in zip(launch_counters(), launch_counts(), before) if n != b]
        self._pieces.append((name, graph, deltas, out))
        with _lock:
            _captured[self.role] += 1
        self._i += 1
        return out

    def _capture_piece(self, name: str, fn: Callable, args) -> object:
        graph = torch.cuda.CUDAGraph()
        before = launch_counts()
        stream = self._stream
        stream.wait_stream(torch.cuda.current_stream(self.device))
        self._depth += 1
        try:
            with torch.cuda.stream(stream), _inside():
                graph.capture_begin(pool=self.pool.id)
                try:
                    out = _persist(self.arena, name, fn(*args))
                except BaseException:
                    try:  # end the broken capture; the first error is the one to report
                        graph.capture_end()
                    except RuntimeError:
                        # it raised before the allocator stopped sending allocations to
                        # the pool: left so, the allocator counts a capture underway, and
                        # the next release of cached memory (a pool's end) aborts
                        try:
                            torch._C._cuda_endAllocateToPool(_index(self.device), self.pool.id)
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
        return self._record(name, graph, before, out)


def _bound(value, seen=None) -> tuple:
    """What a graph bakes of a piece's argument: each tensor's address,
    shape, strides and dtype, and each host scalar's value, through
    tuples, lists, dicts and dataclasses; other objects by identity."""
    if isinstance(value, torch.Tensor):
        return ("tensor", value.data_ptr(), tuple(value.shape), value.stride(), value.dtype)
    if value is None or isinstance(value, (bool, int, float, str, torch.dtype, torch.device)):
        return (value,)
    if isinstance(value, (tuple, list)):
        return tuple(_bound(v) for v in value)
    if isinstance(value, dict):
        return tuple((k, _bound(v)) for k, v in value.items())
    if dataclasses.is_dataclass(value) and not isinstance(value, type):
        return tuple((f.name, _bound(getattr(value, f.name))) for f in dataclasses.fields(value))
    return ("object", id(value))


class StandIn(StepGraph):
    """The CPU stand-in of a `StepGraph`: what a graph bakes, shown on the
    CPU.  Its capture records each piece's function and the arguments it
    was given, and runs it once; a replay calls that function on the
    recorded arguments, never on those the body passes now, and copies its
    outputs into the recorded ones in the arena, as a graph reads and
    writes the addresses it baked.  So a piece handed a new buffer at each
    call (a collective's output that is not a slot) computes on the stale
    one.  With `strict` (the default; set on the class) a replay whose
    arguments are not what the capture recorded (`_bound`: another tensor,
    shape or strides, or another host value) raises, naming the piece."""

    strict = True

    def __init__(self, name: str, body: Callable, device: torch.device, arena: Arena, warm_key: Optional[tuple] = None):
        super().__init__(name, body, device, "walk", arena, warm_key)

    def _sync(self) -> None:
        pass

    def _capture_piece(self, name: str, fn: Callable, args) -> object:
        before = launch_counts()
        self._depth += 1
        try:
            with _inside():
                out = _persist(self.arena, name, fn(*args))
        except Exception as e:
            self._mode = "failed"
            raise RuntimeError(f"capturing piece {name} of {self.name} failed: {e}") from e
        finally:
            self._depth -= 1
        return self._record(name, (fn, args, _bound(args)), before, out)

    def _replay_piece(self, entry: tuple, args):
        name, (fn, recorded, bound), _, out = entry
        if self.strict and _bound(args) != bound:
            raise RuntimeError(f"{self.name}: piece {name} was handed other arguments than at its capture "
                               f"(a graph would read the captured ones)")
        self._depth += 1
        try:
            with _inside():
                new = fn(*recorded)
        finally:
            self._depth -= 1
        for o, n in zip(out if isinstance(out, tuple) else (out,), new if isinstance(new, tuple) else (new,)):
            if isinstance(o, torch.Tensor):
                o.copy_(n)
        return out


def graph_count(graphs) -> int:
    return sum(g.graphs if isinstance(g, StepGraph) else 0 for g in graphs)


def capture_breakdown(graphs) -> dict:
    """Host seconds the first calls of `graphs` spent: in all, in eager
    warm-up runs, and ending captures (instantiating graphs)."""
    sg = [g for g in graphs if isinstance(g, StepGraph)]
    return dict(seconds=sum(g.capture_seconds for g in sg), warm=sum(g.warm_seconds for g in sg),
                instantiate=sum(g.instantiate_seconds for g in sg))


def make_callable(name: str, body: Callable, device: torch.device, workspace: "Workspace", warm_key: tuple):
    """`body` as a step callable of `workspace`: a `StepGraph` in its arena
    and memory pool on a card, a `StandIn` on the CPU under `CPU_STAND_IN`,
    else `body` run with `PLAIN`."""
    if device.type == "cuda":
        return StepGraph(name, body, device, "walk", workspace.arena, warm_key, workspace.graph_pool())
    if CPU_STAND_IN:
        return StandIn(name, body, device, workspace.arena, warm_key)
    return lambda *args: body(PLAIN, *args)


class Workspace:
    """A walk's fixed buffers (the sampler sets them as attributes: the
    latent state, the KV cache, the step inputs, the captions, the prefix
    buffer) with the `arena`, the step callables (`steps`) captured
    against them and their memory pool, and the parameter `tree` they
    read, held so its addresses stay valid.  One sampler at a time leases it (`lease`); the
    steps find that sampler through `sampler`."""

    def __init__(self, key: tuple, tree, device: torch.device):
        self.key = key
        self.tree = tree
        self.device = device
        self.arena = Arena(device)
        self.steps: dict = {}
        self.sampler: Callable[[], object] = lambda: None
        self._pool: Optional["torch.cuda.MemPool"] = None
        self._ticket: Optional[object] = None
        self._generation = -1

    def graph_pool(self) -> "torch.cuda.MemPool":
        """The memory pool of the workspace's graphs: theirs alone, so the
        memory goes when the workspace does (at the next
        `torch.cuda.empty_cache()`, or when the allocator needs it)."""
        if self._pool is None:
            with torch.cuda.device(_index(self.device)):
                self._pool = torch.cuda.MemPool()
        return self._pool

    def lease(self, sampler) -> object:
        """Give the workspace to `sampler`; returns the ticket that gives it back."""
        self._ticket = object()
        self.sampler = weakref.ref(sampler)
        return self._ticket

    @property
    def broken(self) -> bool:
        """A capture failed: its callables cannot run again."""
        return any(getattr(fn, "failed", False) for fn in self.steps.values())


class WorkspacePool:
    """The process's workspaces by key.  `take(key)` leases out an idle
    workspace of `key` (None if there is none: the caller builds one and
    `add`s it, which frees the idle workspaces of other keys);
    `give_back(ws, ticket)` returns a workspace when its sampler's walk
    ends or the sampler is collected (only its current lessee's ticket
    counts); `release()` frees every idle workspace, and keeps out the
    leased ones."""

    def __init__(self):
        self._idle: Dict[tuple, List[Workspace]] = {}
        self._generation = 0

    def take(self, key: tuple) -> Optional[Workspace]:
        with _lock:
            idle = self._idle.get(key)
            return idle.pop() if idle else None

    def add(self, ws: Workspace) -> None:
        with _lock:
            self._idle = {k: v for k, v in self._idle.items() if k == ws.key}
            ws._generation = self._generation

    def give_back(self, ws: Workspace, ticket: object) -> None:
        with _lock:
            if ws._ticket is not ticket:
                return
            ws._ticket = None
            ws.sampler = lambda: None
            if ws._generation == self._generation and not ws.broken:
                self._idle.setdefault(ws.key, []).append(ws)

    def idle(self, key: Optional[tuple] = None) -> int:
        """Idle workspaces, of `key` or in all."""
        with _lock:
            return len(self._idle.get(key, ())) if key is not None else sum(map(len, self._idle.values()))

    def release(self) -> None:
        with _lock:
            self._idle.clear()
            self._generation += 1


WORKSPACES = WorkspacePool()
_release_hooks: List[Callable[[], None]] = []


def on_release(hook: Callable[[], None]) -> None:
    """Run `hook` in every `release_workspaces()`: a cache of what the
    workspaces' graphs read frees it there."""
    _release_hooks.append(hook)


def release_workspaces() -> None:
    """Free every idle workspace (its buffers and graphs) and run the
    `on_release` hooks; workspaces leased now are dropped when their
    samplers give them back.  Their memory returns to the device at the
    next `torch.cuda.empty_cache()`."""
    WORKSPACES.release()
    for hook in _release_hooks:
        hook()

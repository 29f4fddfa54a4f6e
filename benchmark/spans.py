"""The program's own spans in a trace of the window (`trace.Trace.spans`):
`magi_tpu_torch` names each `magi/<layer>/<part>`, followed after one space
by `key=value` attributes separated by spaces (`core/profiler.py::span`).
Here they are parsed, clipped to the window, and laid over the device's
busy intervals (`Trace.busy`) to give the device's idle time inside them,
nested or overlapping spans counted once.  A trace of a program that
records no such span gives none, and the readers built on this return
None."""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Sequence, Tuple

PREFIX = "magi/"

Interval = Tuple[float, float]  # microseconds, trace clock


class Span(NamedTuple):
    path: str  # magi/<layer>/<part>
    attrs: Dict[str, str]
    start: float  # microseconds, clipped to the window
    end: float

    @property
    def seconds(self) -> float:
        return (self.end - self.start) * 1e-6


def parse(name: str) -> Tuple[str, Dict[str, str]]:
    """A span name -> (its path, its attributes by key, values as written)."""
    path, *pairs = name.split(" ")
    attrs = {}
    for pair in pairs:
        key, eq, value = pair.partition("=")
        if not key or not eq:
            raise ValueError(f"span {name!r}: {pair!r} is not key=value")
        attrs[key] = value
    return path, attrs


def program_spans(trace, path: str = PREFIX) -> List[Span]:
    """The trace's program spans whose path is `path`, or lies under it when
    `path` ends with "/", clipped to the window (those outside it dropped),
    in order of start."""
    out = []
    for name, a, b in trace.spans:
        if not name.startswith(PREFIX):
            continue
        p, attrs = parse(name)
        if p != path and not (path.endswith("/") and p.startswith(path)):
            continue
        a, b = max(a, trace.start), min(b, trace.end)
        if b > a:
            out.append(Span(p, attrs, a, b))
    return sorted(out, key=lambda s: s.start)


def union(intervals: Sequence[Interval]) -> List[Interval]:
    """The union of intervals as disjoint intervals, in order."""
    out: List[list] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def idle_seconds(busy: Sequence[Interval], groups: Sequence[Sequence[Interval]]) -> List[float]:
    """For each group of intervals, the seconds inside their union in which
    no device operation ran; `busy` is `Trace.busy()` (disjoint, in order)."""
    out = []
    for group in groups:
        idle = 0.0
        j = 0
        for a, b in union(group):
            while j < len(busy) and busy[j][1] <= a:
                j += 1
            covered, k = 0.0, j
            while k < len(busy) and busy[k][0] < b:
                covered += min(b, busy[k][1]) - max(a, busy[k][0])
                k += 1
            idle += (b - a) - covered
        out.append(idle * 1e-6)
    return out


def mean_idle_ms(trace, path: str):
    """The mean over the window's spans of `path` of the device's idle
    milliseconds inside each; None without a trace or such a span."""
    if trace is None:
        return None
    found = program_spans(trace, path)
    if not found:
        return None
    idle = idle_seconds(trace.busy(), [[(s.start, s.end)] for s in found])
    return 1e3 * sum(idle) / len(idle)

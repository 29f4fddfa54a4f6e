"""Reading a `torch.profiler` trace of the measured window: device operations
with their intervals, grouped by `kernel_groups.json`; the union of their
intervals (the device's busy time, operations on two streams counted once);
and the longest idle gaps, each named by the harness span the host was in.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Tuple

HERE = os.path.dirname(os.path.abspath(__file__))
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")

Interval = Tuple[float, float]  # microseconds, trace clock


class KernelGroups:
    """The data file of kernel name patterns."""

    def __init__(self, path: str = os.path.join(HERE, "kernel_groups.json")):
        with open(path) as f:
            d = json.load(f)
        self.groups = d["groups"]
        self.other = d["other"]
        self.names = {g["key"]: g["name"] for g in self.groups}
        self.names[self.other["key"]] = self.other["name"]

    def key_of(self, kernel: str) -> str:
        for g in self.groups:
            if any(p in kernel for p in g["patterns"]):
                return g["key"]
        return self.other["key"]


class Trace:
    """The device operations and host spans of a chrome trace, clipped to the
    span named `window`."""

    def __init__(self, path: str, window: str = "bench/window"):
        with open(path) as f:
            events = json.load(f)["traceEvents"]
        spans = [(e["name"], float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0))) for e in events
                 if e.get("ph") == "X" and e.get("cat") == "user_annotation"]
        wins = [(a, b) for n, a, b in spans if n == window]
        if not wins:
            raise RuntimeError(f"the trace holds no span {window!r}")
        self.start, self.end = wins[0]
        self.spans = [(n, a, b) for n, a, b in spans if n != window]
        self.ops = []  # (name, start, end)
        for e in events:
            if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS:
                a, b = float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0))
                a, b = max(a, self.start), min(b, self.end)
                if b > a:
                    self.ops.append((e["name"], a, b))

    @property
    def window_s(self) -> float:
        return (self.end - self.start) * 1e-6

    def busy(self) -> List[Interval]:
        """The union of the device operations' intervals, in order."""
        out: List[list] = []
        for _, a, b in sorted(self.ops, key=lambda o: o[1]):
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return [(a, b) for a, b in out]

    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy()) * 1e-6

    def group_seconds(self, groups: KernelGroups) -> Dict[str, float]:
        """Device seconds by group key (a sum of operation times)."""
        out: Dict[str, float] = {}
        for name, a, b in self.ops:
            k = groups.key_of(name)
            out[k] = out.get(k, 0.0) + (b - a) * 1e-6
        return out

    def idle_gaps(self, top: int = 10) -> List[Tuple[str, float]]:
        """The longest stretches with no device operation, each named by the
        host span that overlaps it most and its start in the window."""
        edges = [self.start] + [x for iv in self.busy() for x in iv] + [self.end]
        gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2) if edges[i + 1] > edges[i]]
        gaps.sort(key=lambda g: g[0] - g[1])
        out = []
        for a, b in gaps[:top]:
            best, name = 0.0, "host outside any span"
            for n, sa, sb in self.spans:
                ov = min(b, sb) - max(a, sa)
                if ov > best:
                    best, name = ov, n
            out.append((f"{name} at {(a - self.start) * 1e-6:.3f} s", (b - a) * 1e-6))
        return out

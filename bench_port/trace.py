"""The device trace of a window: ``torch.profiler`` (CUPTI) around it, its
Chrome trace written to a git-ignored file, then read back into the
device's operations inside the window.

The window is the span of the ``bench_window`` annotation, the host's
clock from the sync that opens it to the sync that closes it.  A device
operation is a kernel, a copy or a fill; the device is busy where any of
them runs (the union of their intervals), idle elsewhere in the window.
An idle gap is named by what the host was doing at its middle: the
shortest host event (an operator or a runtime call) around that instant.
"""

from __future__ import annotations

import contextlib
import json
from collections import defaultdict
from dataclasses import dataclass
from pathlib import Path
from typing import List, Optional, Tuple

import torch

WINDOW = "bench_window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver")
TOP = 10


@contextlib.contextmanager
def profiled(path: Path):
    """Profile the host and the device while the body runs, inside one
    ``bench_window`` annotation; write the trace to ``path``."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        with torch.profiler.record_function(WINDOW):
            yield
    prof.export_chrome_trace(str(path))


@dataclass
class View:
    """What the metric readers read: the cell, the window's counts, and
    the device's operations in the window."""
    cell: object
    steps: int
    frames: int
    window_s: float
    busy_s: float
    kernels: List[Tuple[str, float, float]]   # name, start µs, length µs
    ops: List[Tuple[str, float, float]]       # every device operation
    gaps: List[Tuple[str, float]]             # host's doing, idle s

    def breakdown(self) -> dict:
        by_name = defaultdict(float)
        for name, _, dur in self.ops:
            by_name[name] += dur * 1e-6
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
        gaps = sorted(self.gaps, key=lambda g: -g[1])[:TOP]
        return {"device_ops": [[n[:160], s] for n, s in top],
                "idle_gaps": [[n[:160], s] for n, s in gaps]}


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    merged: List[List[float]] = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return [(a, b) for a, b in merged]


def _host_at(host: List[Tuple[str, float, float]], t: float) -> str:
    best: Optional[Tuple[float, str]] = None
    for name, a, d in host:
        if a <= t <= a + d and (best is None or d < best[0]):
            best = (d, name)
    return best[1] if best else "host (no event)"


def read(path: Path, cell, window) -> View:
    """The trace at ``path`` of ``window`` (``cell.run_window``'s)."""
    events = json.loads(Path(path).read_text())["traceEvents"]
    spans = [e for e in events if e.get("ph") == "X" and "dur" in e]
    mark = next(e for e in spans if e.get("name") == WINDOW
                and e.get("cat") == "user_annotation")
    lo, hi = float(mark["ts"]), float(mark["ts"]) + float(mark["dur"])
    ops, kernels = [], []
    for e in spans:
        if e.get("cat") not in DEVICE_CATS:
            continue
        a = max(float(e["ts"]), lo)
        b = min(float(e["ts"]) + float(e["dur"]), hi)
        if b <= a:
            continue
        op = (e["name"], a, b - a)
        ops.append(op)
        if e["cat"] == "kernel":
            kernels.append(op)
    busy = _union([(a, a + d) for _, a, d in ops])
    host = [(e["name"], float(e["ts"]), float(e["dur"])) for e in spans
            if e.get("cat") in HOST_CATS]
    edges = [lo, *[x for iv in busy for x in iv], hi]
    idle = sorted(((a, b) for a, b in zip(edges[::2], edges[1::2]) if b > a),
                  key=lambda g: g[0] - g[1])[:TOP]
    gaps = [(_host_at(host, (a + b) / 2), (b - a) * 1e-6) for a, b in idle]
    return View(cell=cell, steps=window.steps, frames=window.frames,
                window_s=(hi - lo) * 1e-6,
                busy_s=sum(b - a for a, b in busy) * 1e-6,
                kernels=kernels, ops=ops, gaps=gaps)

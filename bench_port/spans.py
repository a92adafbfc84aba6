"""The program's spans in a window's device trace: each device operation
assigned to the ``rvk.*`` spans around its launch
(``rawaudiovae_kelsey_tpu_torch/observe/spans.py`` names them).

A device operation is a kernel, a copy or a fill, clipped to the
``bench_window`` annotation as ``trace.py`` clips it (the whole trace where
there is none).  Its launch is the ``cuda_runtime`` or ``cuda_driver`` event
of the same ``args.correlation``; the spans around it are the ``rvk.*``
``user_annotation`` events whose interval holds the launch's timestamp, on
any thread (autograd launches the backward's kernels from a thread of its
own while the caller's thread sits in ``rvk.backward``), the innermost
being the one that starts last.  Device-side copies of the annotations
(``gpu_user_annotation``) are not read.

What the metric readers read (``metrics/<name>.py``, ms):

* ``step_ms_p90``: each ``rvk.step``'s device interval, from the start of
  its first operation to the end of its last; the 90th percentile over the
  window's steps (linear between the two nearest ranks);
* ``step_idle_ms``: each step's interval less the union of its operations,
  mean over the steps;
* ``epoch_boundary_ms``: from the end of an epoch's last step to the start
  of the next epoch's first (each step belongs to the last ``rvk.epoch``
  begun before it), mean over the window's boundaries;
* ``adam_ms``: the union of the operations under ``rvk.adam``, a step;
* ``torch_ops_ms``: the union of the operations under ``rvk.step`` and
  under neither an ``rvk.row*`` span nor ``rvk.adam``, a step.

Each is ``None`` where the window has no device operation (a CPU run) or no
``rvk.step`` span (a program without spans).  The file is read once a
process: the summary is kept by path and modification time.

    python3 -m bench_port.spans <trace.json>

prints the table of every span name — count, then device ms a step, the
union of its operations (total) and of those it is the innermost span of
(self) — and the metrics.
"""

from __future__ import annotations

import bisect
import functools
import json
import os
import sys
from collections import defaultdict
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional, Tuple

WINDOW = "bench_window"
PREFIX = "rvk."
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")

Interval = Tuple[float, float]


def union_us(intervals: List[Interval]) -> float:
    """The length of the union of ``intervals``."""
    total, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if b <= end:
            continue
        total += b - max(a, end)
        end = b
    return total


def percentile(values: List[float], q: float) -> float:
    """The ``q``-th percentile, linear between the two nearest ranks."""
    v = sorted(values)
    pos = q / 100.0 * (len(v) - 1)
    i = int(pos)
    if i + 1 >= len(v):
        return v[-1]
    return v[i] + (v[i + 1] - v[i]) * (pos - i)


@dataclass
class Summary:
    """A window's device operations by span."""
    steps: int = 0
    window_ms: float = 0.0
    busy_ms: float = 0.0
    unattributed_ms: float = 0.0
    step_ms: List[float] = field(default_factory=list)
    step_idle: List[float] = field(default_factory=list)
    boundaries: List[float] = field(default_factory=list)
    adam_ms: float = 0.0           # the window's, all steps
    torch_ops_ms: float = 0.0
    # span name → (count, total ms, self ms), all steps
    table: Dict[str, Tuple[int, float, float]] = field(default_factory=dict)

    def metrics(self) -> Dict[str, Optional[float]]:
        if not self.steps:
            return dict.fromkeys(("step_ms_p90", "step_idle_ms",
                                  "epoch_boundary_ms", "adam_ms",
                                  "torch_ops_ms"))
        n = self.steps
        return {"step_ms_p90": percentile(self.step_ms, 90.0),
                "step_idle_ms": sum(self.step_idle) / n,
                "epoch_boundary_ms": (sum(self.boundaries)
                                      / len(self.boundaries)
                                      if self.boundaries else None),
                "adam_ms": self.adam_ms / n,
                "torch_ops_ms": self.torch_ops_ms / n}


def summarize(events: List[dict]) -> Summary:
    """The :class:`Summary` of a Chrome trace's ``traceEvents``."""
    spans = [e for e in events if e.get("ph") == "X" and "dur" in e]
    mark = next((e for e in spans if e.get("name") == WINDOW
                 and e.get("cat") == "user_annotation"), None)
    if mark is not None:
        lo = float(mark["ts"])
        hi = lo + float(mark["dur"])
    else:
        lo = min((float(e["ts"]) for e in spans), default=0.0)
        hi = max((float(e["ts"]) + float(e["dur"]) for e in spans),
                 default=0.0)
    launched = {e["args"]["correlation"]: float(e["ts"]) for e in spans
                if e.get("cat") in LAUNCH_CATS
                and "correlation" in e.get("args", {})}
    # by start, an outer span before an inner one of the same start
    marks = sorted(((float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                     e["name"]) for e in spans
                    if e.get("cat") == "user_annotation"
                    and str(e.get("name", "")).startswith(PREFIX)),
                   key=lambda m: (m[0], -m[1]))
    # (launch, start, end) of each device operation in the window
    ops = []
    for e in spans:
        if e.get("cat") not in DEVICE_CATS:
            continue
        a = max(float(e["ts"]), lo)
        b = min(float(e["ts"]) + float(e["dur"]), hi)
        if b <= a:
            continue
        ops.append((launched.get(e.get("args", {}).get("correlation")),
                    a, b))
    out = Summary(window_ms=(hi - lo) * 1e-3,
                  busy_ms=union_us([(a, b) for _, a, b in ops]) * 1e-3)
    if not ops:
        return out

    # the spans around each launch (indices into marks, innermost last):
    # one sweep over both in time order; an op with no launch event has none
    around: List[Tuple[int, ...]] = [()] * len(ops)
    active: List[int] = []
    nxt = 0
    for i in sorted((i for i in range(len(ops)) if ops[i][0] is not None),
                    key=lambda i: ops[i][0]):
        t = ops[i][0]
        while nxt < len(marks) and marks[nxt][0] <= t:
            active.append(nxt)
            nxt += 1
        active = [m for m in active if marks[m][1] >= t]
        around[i] = tuple(active)

    by_mark: Dict[int, List[Interval]] = defaultdict(list)
    by_name: Dict[str, List[Interval]] = defaultdict(list)
    self_name: Dict[str, List[Interval]] = defaultdict(list)
    adam, torch_ops, loose = [], [], []
    for i, (_, a, b) in enumerate(ops):
        ns = [marks[m][2] for m in around[i]]
        if not ns:
            loose.append((a, b))
            continue
        self_name[ns[-1]].append((a, b))
        for n in set(ns):
            by_name[n].append((a, b))
        for m in around[i]:
            if marks[m][2] == "rvk.step":
                by_mark[m].append((a, b))
        if "rvk.adam" in ns:
            adam.append((a, b))
        elif "rvk.step" in ns and not any(n.startswith("rvk.row")
                                          for n in ns):
            torch_ops.append((a, b))

    steps = sorted(m for m in by_mark)
    epochs = [marks[m][0] for m in range(len(marks))
              if marks[m][2] == "rvk.epoch" and lo <= marks[m][0] <= hi]
    # each step's device interval, grouped by the epoch begun before it
    groups: Dict[int, List[Interval]] = defaultdict(list)
    for m in steps:
        ivs = by_mark[m]
        first = min(a for a, _ in ivs)
        last = max(b for _, b in ivs)
        out.step_ms.append((last - first) * 1e-3)
        out.step_idle.append((last - first - union_us(ivs)) * 1e-3)
        groups[bisect.bisect_right(epochs, marks[m][0])].append(
            (first, last))
    keys = sorted(k for k in groups if k > 0)
    for k0, k1 in zip(keys, keys[1:]):
        if k1 == k0 + 1:
            out.boundaries.append(
                (groups[k1][0][0] - groups[k0][-1][1]) * 1e-3)
    out.steps = len(steps)
    out.adam_ms = union_us(adam) * 1e-3
    out.torch_ops_ms = union_us(torch_ops) * 1e-3
    out.unattributed_ms = union_us(loose) * 1e-3
    counts: Dict[str, int] = defaultdict(int)
    for start, _, name in marks:
        if lo <= start <= hi:
            counts[name] += 1
    out.table = {n: (counts[n], union_us(by_name[n]) * 1e-3,
                     union_us(self_name[n]) * 1e-3)
                 for n in sorted(set(counts) | set(by_name))}
    return out


@functools.lru_cache(maxsize=2)
def _summary(path: str, mtime_ns: int) -> Summary:
    with open(path) as fh:
        events = json.load(fh)["traceEvents"]
    return summarize(events)


def read(path: Path) -> Summary:
    """The :class:`Summary` of the trace at ``path``, read once a process."""
    path = Path(path)
    return _summary(str(path), os.stat(path).st_mtime_ns)


def metric(view, name: str) -> Optional[float]:
    """The metric ``name`` of the trace ``cell.run`` wrote for ``view``'s
    cell; ``None`` where that trace has no ``rvk.step`` span with device
    operations."""
    from bench_port import cell as cell_mod
    path = cell_mod.TRACES / f"{view.cell.name}.json"
    if not path.exists():
        return None
    return read(path).metrics()[name]


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) != 1:
        print("usage: python3 -m bench_port.spans <trace.json>",
              file=sys.stderr)
        return 2
    s = read(Path(argv[0]))
    per = max(s.steps, 1)
    print(f"steps {s.steps}  window {s.window_ms:.3f} ms  busy "
          f"{s.busy_ms:.3f} ms  in no rvk span {s.unattributed_ms:.3f} ms "
          f"({100.0 * s.unattributed_ms / max(s.busy_ms, 1e-9):.3f} % of "
          "busy)")
    print(f"{'span':<36} {'count':>7} {'total ms/step':>14} "
          f"{'self ms/step':>13}")
    for name, (count, total, own) in s.table.items():
        print(f"{name:<36} {count:>7} {total / per:>14.4f} "
              f"{own / per:>13.4f}")
    for name, value in s.metrics().items():
        print(f"{name} {value!r}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Step timing and profiler capture — the JAX package's
``observe/timing.py``, ported.

``StepTimer`` reads the host clock; on a CUDA device it synchronises first,
so a window ends when the device's queued work has ended, not when the host
finished enqueueing it.  ``trace_capture`` wraps a window of steps in a
``torch.profiler`` trace (CPU and, where there is one, CUDA activity),
written as a Chrome trace into the log directory; the program's spans
(``observe/spans.py``) are in it.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from pathlib import Path
from typing import Optional

import torch


def synchronize(device: Optional[torch.device]) -> None:
    if device is not None and torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


@dataclass
class StepTimer:
    """The host clock around a window of steps, synchronised at both ends:
    ``start()``, then ``stop()`` returns the window's seconds."""

    device: Optional[torch.device] = None
    _t0: Optional[float] = None

    def start(self) -> None:
        synchronize(self.device)
        self._t0 = time.perf_counter()

    def stop(self) -> float:
        synchronize(self.device)
        return time.perf_counter() - self._t0


class trace_capture:
    """``with trace_capture(logdir): ...`` records a ``torch.profiler``
    trace of the block into ``<logdir>/trace.json`` (viewable in
    chrome://tracing or Perfetto)."""

    def __init__(self, logdir):
        self.logdir = Path(logdir)
        self.prof: Optional[torch.profiler.profile] = None

    def __enter__(self):
        acts = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self.prof = torch.profiler.profile(activities=acts)
        self.prof.__enter__()
        return self

    def __exit__(self, *exc):
        self.prof.__exit__(*exc)
        self.logdir.mkdir(parents=True, exist_ok=True)
        self.prof.export_chrome_trace(str(self.logdir / "trace.json"))
        return False

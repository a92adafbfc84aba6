"""Graceful interruption: checkpoint-on-SIGTERM/SIGINT (the JAX package's
``train/interrupt.py``, ported).

The reference had no failure handling at all (SURVEY.md §5.3 — errors were
unhandled, checkpoints never reloaded).  Preemptible jobs get a SIGTERM
before eviction; this handler flips a flag the trainers poll each batch, so
they finish the in-flight step, write a checkpoint, and exit cleanly —
``--resume`` then continues seamlessly (the step's noise is a function of
the seed and the step, parallel/step.py).
"""

from __future__ import annotations

import os
import signal
from types import FrameType
from typing import Optional


class GracefulInterrupt:
    """``with GracefulInterrupt() as stop: ... if stop: checkpoint+break``."""

    def __init__(self, signals=(signal.SIGTERM, signal.SIGINT)):
        self._signals = signals
        self._previous = {}
        self.requested = False
        self.signum: Optional[int] = None

    def _handler(self, signum: int, frame: Optional[FrameType]) -> None:
        self.requested = True
        self.signum = signum
        # async-signal-safe notice: print() re-enters the buffered stdout
        # writer and raises RuntimeError if the signal lands mid-write
        # (both trainers print constantly), killing the run WITHOUT the
        # checkpoint this class exists to guarantee — os.write is safe
        msg = (f"\nReceived signal {signum}: finishing step, then "
               "checkpointing and exiting...\n").encode()
        try:
            os.write(2, msg)
        except OSError:
            pass

    def __enter__(self) -> "GracefulInterrupt":
        for sig in self._signals:
            try:
                self._previous[sig] = signal.signal(sig, self._handler)
            except ValueError:
                # not the main thread (e.g. under a test runner) — fall back
                # to never-interrupted behavior rather than crash
                self._previous.pop(sig, None)
        return self

    def __exit__(self, *exc) -> bool:
        for sig, prev in self._previous.items():
            # prev is None when the old handler was installed outside
            # Python (embedded interpreter) — signal.signal(sig, None)
            # would raise; default-restore instead
            signal.signal(sig, prev if prev is not None else signal.SIG_DFL)
        return False

    def __bool__(self) -> bool:
        return self.requested

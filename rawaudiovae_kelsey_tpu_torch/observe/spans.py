"""Named spans in the program, on the profiler's clock.

``with span("rvk.step"): ...`` marks the block as a
``torch.profiler.record_function`` range while a ``torch.profiler``
records (``observe/timing.py`` ``trace_capture``, or any other profiler
around the call), so the span lands in the same Chrome trace as the
device's kernels, as a ``user_annotation`` event.  With no profiler
recording it is one shared ``nullcontext``: entering ``record_function``
costs tens of µs of host time a call, the check a fraction of one.  There
is no setting: spans are on exactly while a profiler records.

Every name starts with ``rvk.``:

===================  ======================================================
``rvk.epoch``        an epoch's permutation (``parallel/resident.py``), and
                     the whole-matrix gather of the ``frames`` layout
``rvk.gather``       a batch's gather from the ``corpus`` layout
``rvk.step``         one update (``parallel/step.py``, ``spmd.py``)
``rvk.forward``      a loss call: noise, casts, encode, reparameterize,
                     decode, loss
``rvk.backward``     a ``torch.autograd.grad``
``rvk.adam``         ``optimizer.update``
``rvk.allreduce``    a mesh collective
``rvk.wnorm``        a weight norm's recomputation from ``g`` and ``v``
                     (the Oobleck model's convolutions)
``rvk.rowNN.<op>``   a call of an ``ops/`` wrapper, NN its row of the
                     port's kernel table (PERF.md), whether it launches
                     the kernel or runs its plain version
===================  ======================================================
"""

from __future__ import annotations

import contextlib
import functools

import torch

_OFF = contextlib.nullcontext()


def span(name: str):
    """A ``record_function(name)`` range while a profiler records, else a
    no-op context."""
    if torch._C._autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return _OFF


def spanned(name: str):
    """Decorate a function so that each call runs inside ``span(name)``;
    the name is the decorated function's ``span_name``."""
    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            if not torch._C._autograd._profiler_enabled():
                return fn(*args, **kwargs)
            with torch.profiler.record_function(name):
                return fn(*args, **kwargs)
        inner.span_name = name
        return inner
    return wrap

"""step_idle_ms (ms/step, layer "step"): each ``rvk.step``'s device
interval less the union of its operations, the gaps between a step's
kernels; mean over the window's steps (``spans.py``)."""

from bench_port import spans


def read(view):
    return spans.metric(view, "step_idle_ms")

"""step_ms_p90 (ms, layer "step"): each ``rvk.step``'s device interval,
from the start of its first operation to the end of its last, at the 90th
percentile over the window's steps (``spans.py``)."""

from bench_port import spans


def read(view):
    return spans.metric(view, "step_ms_p90")

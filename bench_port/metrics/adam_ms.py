"""adam_ms (ms/step, layer "step"): the union of the device operations
launched under ``rvk.adam`` (``train/optim.py``'s update), over the
window's steps (``spans.py``)."""

from bench_port import spans


def read(view):
    return spans.metric(view, "adam_ms")

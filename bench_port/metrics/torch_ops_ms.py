"""torch_ops_ms (ms/step, layer "ops wrappers"): the union of the device
operations launched under ``rvk.step`` and under neither an ``rvk.row*``
span nor ``rvk.adam``, over the window's steps (``spans.py``): the step's
work that no port kernel does — PyTorch's elementwise ops, casts, the loss
and its gradient, cuBLAS."""

from bench_port import spans


def read(view):
    return spans.metric(view, "torch_ops_ms")

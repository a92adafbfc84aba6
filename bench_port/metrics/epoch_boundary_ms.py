"""epoch_boundary_ms (ms, layer "resident engine"): from the end of the
last operation of an epoch's last ``rvk.step`` to the start of the first
operation of the next epoch's first, mean over the window's boundaries
(``spans.py``).  It holds the permutation (``rvk.epoch``), the first gather
and the device's wait for the host, and with it the window's own device
sync at each epoch's end (``cell.py`` ``run_window``)."""

from bench_port import spans


def read(view):
    return spans.metric(view, "epoch_boundary_ms")

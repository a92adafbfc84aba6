"""kernels_roofline (%, layer "kernels"): the least time of the window's
required work over the device's busy time in it.  A step's least time is
``flops.py`` ``least_step_seconds``: every product at the larger of its
FLOPs at the tier's pass count over the peak and its bytes over HBM's,
plus Adam's seven fp32 streams a parameter.  The count is of the work,
whatever kernels do it."""

from bench_port import flops


def read(view):
    if view.steps == 0 or view.busy_s <= 0:
        return None
    cell = view.cell
    least = flops.least_step_seconds(cell.config, cell.config["batch_size"],
                                     cell.precision) * view.steps
    return 100.0 * least / view.busy_s

"""step_mfu (%, layer "step"): the model FLOPs of the window's training
steps over the window's seconds times the tier's peak (``flops.py``:
2 · (3 · MACs − MACs of the first layer) a frame; 989 TFLOP/s for bf16 and
``high``, 67 TFLOP/s for ``highest``)."""

from bench_port import flops


def read(view):
    if view.steps == 0 or view.window_s <= 0:
        return None
    cell = view.cell
    work = flops.train_flops_per_frame(cell.config) * view.frames
    return 100.0 * work / (view.window_s * flops.peak_flops(cell.precision))

"""snake_roofline (%, layer "kernels"): SnakeBeta's least time a step, its
bytes over HBM's rate (``conv_work.py``: 5 elements moved an element, 10 B
in bf16, 107.5 GB a step of 48 × 65,536 stereo frames), over the device
time of the ``rvk.row21.*`` spans a step (``snake_ms``); nothing where the
program has no such span."""

from bench_port import conv_work


def read(view):
    ms = conv_work.snake_ms(view)
    if ms is None:
        return None
    cell = view.cell
    least = conv_work.snake_least_seconds(cell.config, cell.precision)
    return 100.0 * least * 1e3 / ms

"""oobleck_step_mfu (%, layer "step"): the Oobleck VAE's training FLOPs of
the window's steps over the window's seconds times the tier's peak
(``conv_work.py``: 2 · (3 · MACs − MACs of the first convolution) a stereo
time step, 46.46 TFLOP a step of 48 × 65,536; 989 TFLOP/s for bf16)."""

from bench_port import conv_work, flops


def read(view):
    if view.steps == 0 or view.window_s <= 0:
        return None
    cell = view.cell
    work = conv_work.train_flops_per_step(cell.config) * view.steps
    return 100.0 * work / (view.window_s * flops.peak_flops(cell.precision))

"""What a training step of the Oobleck VAE (``configs/stable_audio_vae.json``)
must compute and move: the convolutions' FLOPs by layer and SnakeBeta's
bytes, from the widths the configuration gives the program
(``program.vae``; the layers as ``reference/oobleck_vae.py`` lists them).

Counted at the input's rate, a stereo time step: a convolution of Cin → Cout
channels and kernel k whose output runs at 1/r of it costs Cin·Cout·k/r
multiply-adds; a transpose convolution costs the same at its input's rate.
A training step runs three products a layer (forward, input gradient,
weight gradient) except the first convolution's input gradient (the frames
are data), so its FLOPs are 2 · (3 · MACs − MACs of the first layer):

    stable_audio_vae  2 · (3 · 2,462,016 − 2·128·7) = 14,768,512 a step of
                      time, 14,768,512 · 65,536 · 48 = 46.46 TFLOP a step

Weight norm, the SnakeBetas, the residual adds and the biases are left out
(under 0.1 % of it).  SnakeBeta runs on 3,418 channel-samples a time step
(36 calls in each of the encoder and the decoder); its fused forward reads
and writes each once and its backward reads two and writes one, so it
moves 5 elements' bytes an element a step: 10 B in bf16, the bound
``snake_roofline`` holds it to.

:func:`snake_ms` reads the device time of the ``rvk.row21.*`` spans
(``ops/snake.py``) from the window's trace (``spans.py``).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

from bench_port import spans
from bench_port.flops import HBM_BYTES_S
from bench_port.reference.oobleck_vae import layer_paths, widths

_ELEM_BYTES = {"bfloat16": 2, "highest": 4}
_SNAKE_PASSES = 5   # forward x, y; backward x, dy, dx


def _walk(config: dict) -> List[Tuple[str, tuple, tuple, float]]:
    """Every layer in forward order with its work a time step: ``(kind,
    path, dims, amount)``, multiply-adds for a convolution, channel-samples
    for a SnakeBeta.  A strided convolution (``down``, kernel 2s) divides
    the rate by s and a transpose one (``up``) multiplies it by s."""
    out, rate = [], 1.0
    for kind, path, dims in layer_paths(config):
        if kind == "snake":
            out.append((kind, path, dims, dims[0] * rate))
            continue
        a, b, k, transposed, _ = dims
        if transposed:
            out.append((kind, path, dims, a * b * k * rate))
            rate *= k // 2
            continue
        if path[-1] == "down":
            rate /= k // 2
        out.append((kind, path, dims, a * b * k * rate))
    return out


def conv_macs(config: dict) -> List[Tuple[tuple, float]]:
    """``(path, multiply-adds a time step)`` of every convolution's
    forward, in forward order."""
    return [(path, m) for kind, path, _, m in _walk(config)
            if kind == "conv"]


def train_flops_per_time_step(config: dict) -> float:
    macs = conv_macs(config)
    return 2.0 * (3.0 * sum(m for _, m in macs) - macs[0][1])


def train_flops_per_step(config: dict) -> float:
    steps = config["segment_length"] // widths(config)["io"]
    return train_flops_per_time_step(config) * steps * config["batch_size"]


def snake_elements_per_time_step(config: dict) -> float:
    return sum(n for kind, _, _, n in _walk(config) if kind == "snake")


def snake_bytes_per_step(config: dict, precision: str) -> float:
    steps = config["segment_length"] // widths(config)["io"]
    return (snake_elements_per_time_step(config) * steps
            * config["batch_size"] * _SNAKE_PASSES * _ELEM_BYTES[precision])


def snake_least_seconds(config: dict, precision: str) -> float:
    """SnakeBeta's bytes a step over HBM's rate."""
    return snake_bytes_per_step(config, precision) / HBM_BYTES_S


SNAKE_SPANS = "rvk.row21."


def snake_ms(view) -> Optional[float]:
    """The device ms a step of the operations launched under the
    ``rvk.row21.*`` spans in ``view``'s trace; ``None`` where the trace has
    no step or no such span (a program without the kernel)."""
    from bench_port import cell as cell_mod
    path = cell_mod.TRACES / f"{view.cell.name}.json"
    if not path.exists():
        return None
    summary = spans.read(path)
    ms = sum(total for name, (_, total, _) in summary.table.items()
             if name.startswith(SNAKE_SPANS))
    if not summary.steps or ms <= 0:
        return None
    return ms / summary.steps

"""snake_ms (ms/step, layer "kernels"): the union of the device operations
launched under the ``rvk.row21.*`` spans (``ops/snake.py``: SnakeBeta's
fused forward and backward), over the window's steps (``spans.py``);
nothing where the program has no such span."""

from bench_port import conv_work


def read(view):
    return conv_work.snake_ms(view)

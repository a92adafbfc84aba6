"""The training corpus, made on the device from the run's seed: the torch
form of ``benchmarks/erokia_run.py`` ``synth_wave``.

The corpus is ``files`` clips laid end to end.  Clip ``i`` is an
"instrument": a fundamental ``f0 = 55 · 2^((i mod 13)/12 + ⌊i/13⌋/2)`` Hz
with three detuned partials (2.005, 3.99 and 5.03 × f0 at amplitudes 0.20,
0.12, 0.06 beside the fundamental's 0.34), random phases, a slow amplitude
envelope ``0.55 + 0.40 · sin(2π (0.11 + 0.013 i) t)``, and Gaussian noise
at 0.04, clipped to ±0.99.  The phases and the noise come from a device
generator seeded from the run's seed; the sizes are the traffic's alone,
so every seed trains the same amount of work on other numbers.
"""

from __future__ import annotations

import math

import torch

from bench_port.seeds import CORPUS_TAG, stream_seed

PARTIALS = ((1.0, 0.34), (2.005, 0.20), (3.99, 0.12), (5.03, 0.06))


def synth(samples: int, files: int, rate: int, seed: int, device
          ) -> torch.Tensor:
    """``samples`` fp32 samples at ``rate`` Hz on ``device``."""
    g = torch.Generator(device=device)
    g.manual_seed(stream_seed(seed, CORPUS_TAG))
    phases = torch.rand((files, len(PARTIALS)), generator=g, device=device,
                        dtype=torch.float64) * (2 * math.pi)
    out = torch.empty(samples, device=device)
    per = samples // files
    for i in range(files):
        a = i * per
        b = samples if i == files - 1 else a + per
        t = torch.arange(b - a, device=device, dtype=torch.float64) / rate
        f0 = 55.0 * 2.0 ** ((i % 13) / 12.0 + (i // 13) * 0.5)
        wave = torch.zeros_like(t)
        for k, (mult, amp) in enumerate(PARTIALS):
            wave += amp * torch.sin(2 * math.pi * f0 * mult * t + phases[i, k])
        wave *= 0.55 + 0.40 * torch.sin(2 * math.pi * (0.11 + 0.013 * i) * t)
        noise = torch.randn(b - a, generator=g, device=device)
        out[a:b] = (wave.float() + 0.04 * noise).clamp_(-0.99, 0.99)
    return out

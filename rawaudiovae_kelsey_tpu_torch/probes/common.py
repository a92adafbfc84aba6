"""What the probes share: the model configurations, the operation count of
a train step, the card's roofline peaks and the timing.

The configurations are those of the JAX repository's ``bench.py``
(``_build_cfg`` and its constants): the dense model at the widths of
``configs/default.ini``, the deep one at ``configs/deep_wide.ini``'s, the
conv1d one at ``configs/conv1d.ini``'s.

Timing.  Device work is timed with CUDA events around ``launches`` calls
after a warm-up (a host clock that ends in a synchronise under
``clock="host"``, the step-level rate; on the CPU always the host clock).
Two variants are compared as alternating pairs — A B, B A, A B, ... — so
that drift in clocks and a busy host hit both alike, and each is reported
as its median with the 10th and 90th percentile over the pairs.
"""

from __future__ import annotations

import statistics
import subprocess
import time
from typing import Callable, Dict, List, Sequence

import torch

from rawaudiovae_kelsey_tpu_torch.config import Config

SEG, UNITS, LATENT = 1024, 2048, 256
KL_BETA, LR = 1e-4, 1e-4

DEEP_SEG, DEEP_HIDDEN = 4096, (4096, 2048, 1024, 512)
CONV_CHANNELS, CONV_K, CONV_S = (32, 64, 128, 256), 9, 4

# the four large layers of the deep model, (k, n): what deep_bwd --all runs
DEEP_SHAPES = ((4096, 4096), (4096, 2048), (2048, 1024), (1024, 512))

# one NVIDIA H100 SXM (the data sheet's dense rates): device memory
# bytes/s, and FLOP/s of bf16 on the tensor cores and fp32 outside them
H100_HBM_BYTES_S = 3.35e12
H100_PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}

ARCHS = ("dense", "deep", "conv1d")


def build_cfg(arch: str, batch: int, precision: str, backend: str,
              microbatch: int = 0) -> Config:
    """The configuration of ``arch`` at its full width."""
    cfg = Config()
    cfg.vae.latent_dim = LATENT
    cfg.vae.kl_beta = KL_BETA
    cfg.training.learning_rate = LR
    cfg.training.batch_size = batch
    cfg.tpu.precision = precision
    cfg.tpu.backend = backend
    cfg.tpu.microbatch_size = microbatch
    if arch == "dense":
        cfg.audio.segment_length = SEG
        cfg.vae.n_units = UNITS
    elif arch == "deep":
        cfg.vae.arch = "deep"
        cfg.audio.segment_length = DEEP_SEG
        cfg.audio.hop_length = 512
        cfg.vae.hidden_dims = ",".join(str(d) for d in DEEP_HIDDEN)
    elif arch == "conv1d":
        cfg.vae.arch = "conv1d"
        cfg.audio.segment_length = SEG
        cfg.vae.conv_channels = ",".join(str(c) for c in CONV_CHANNELS)
        cfg.vae.conv_kernel = CONV_K
        cfg.vae.conv_stride = CONV_S
    else:
        raise ValueError(arch)
    return cfg


def flops_per_frame(arch: str) -> float:
    """Train-step FLOPs a frame: 2 · (multiply-adds of the forward) × 3 for
    forward, input-gradient and weight-gradient products."""
    if arch == "dense":
        macs = SEG * UNITS + 2 * UNITS * LATENT + LATENT * UNITS + UNITS * SEG
    elif arch == "deep":
        dims = [DEEP_SEG, *DEEP_HIDDEN]
        macs = sum(a * b for a, b in zip(dims[:-1], dims[1:]))
        macs += 2 * DEEP_HIDDEN[-1] * LATENT              # latent heads
        rdims = [LATENT, *reversed(DEEP_HIDDEN), DEEP_SEG]
        macs += sum(a * b for a, b in zip(rdims[:-1], rdims[1:]))
    elif arch == "conv1d":
        # strided SAME convolutions: L_out = ceil(L_in / S), multiply-adds
        # L_out · K · Cin · Cout; the transposed ones mirror them
        macs = 0
        chs = [1, *CONV_CHANNELS]
        length = SEG
        for cin, cout in zip(chs[:-1], chs[1:]):
            length = -(-length // CONV_S)
            macs += length * CONV_K * cin * cout
        flat = length * CONV_CHANNELS[-1]
        macs += 2 * flat * LATENT + LATENT * flat         # heads + dec_in
        for cin, cout in zip(chs[::-1][:-1], chs[::-1][1:]):
            macs += length * CONV_K * cin * cout
            length *= CONV_S
    else:
        raise ValueError(arch)
    return 3.0 * 2.0 * macs


def resolve_device(name: str, prog: str) -> torch.device:
    """The device a probe runs on; exits when CUDA is asked for and there
    is none (``--device cpu`` runs the plain versions)."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(
            f"{prog}: --device cuda but no CUDA device is available (pass "
            "--device cpu to run the plain PyTorch versions on the CPU)")
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def device_name(device: torch.device) -> str:
    """What every result is tagged with: the card's name and power limit as
    ``nvidia-smi`` gives them (the name alone if it cannot be asked), or
    ``cpu``."""
    if device.type != "cuda":
        return "cpu"
    name = torch.cuda.get_device_name(device)
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader", f"--id={device.index or 0}"],
            capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired):
        return name
    return smi.stdout.strip() if smi.returncode == 0 and smi.stdout.strip() \
        else name


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def time_ms(fn: Callable[[], object], launches: int, device: torch.device,
            clock: str = "device") -> float:
    """Milliseconds a call of ``fn`` over ``launches`` calls in a row (no
    warm-up here)."""
    sync(device)
    if device.type == "cuda" and clock == "device":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(launches):
            fn()
        end.record()
        sync(device)
        return start.elapsed_time(end) / launches
    t0 = time.perf_counter()
    for _ in range(launches):
        fn()
    sync(device)
    return (time.perf_counter() - t0) * 1e3 / launches


def summary(samples: Sequence[float]) -> Dict[str, float]:
    """Median, 10th and 90th percentile of ``samples``."""
    xs = sorted(samples)
    if len(xs) == 1:
        return {"median": xs[0], "p10": xs[0], "p90": xs[0], "n": 1}
    cuts = statistics.quantiles(xs, n=10, method="inclusive")
    return {"median": statistics.median(xs), "p10": cuts[0], "p90": cuts[-1],
            "n": len(xs)}


def alternate(variants: Dict[str, Callable[[], object]], pairs: int,
              launches: int, device: torch.device, warmup: int = 2,
              clock: str = "device") -> Dict[str, Dict[str, float]]:
    """Time each of ``variants`` ``pairs`` times, in turns whose order
    reverses every round; → ``{name: summary of its ms a call}``."""
    for fn in variants.values():
        for _ in range(warmup):
            fn()
    names: List[str] = list(variants)
    samples: Dict[str, List[float]] = {name: [] for name in names}
    for i in range(pairs):
        for name in (names if i % 2 == 0 else names[::-1]):
            samples[name].append(
                time_ms(variants[name], launches, device, clock))
    return {name: summary(ts) for name, ts in samples.items()}


def fmt(s: Dict[str, float]) -> str:
    return f"{s['median']:8.3f} ms (p10 {s['p10']:.3f}, p90 {s['p90']:.3f})"

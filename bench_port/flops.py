"""The yardstick's arithmetic: what a training step of an MLP VAE must
compute and move, and the card's peaks it is held against.

A configuration (``configs/<name>.json``) gives the widths; the layers of
the step are then, in forward order,

    encoder   seg → h[0] → … → h[-1]            (ReLU)
    heads     h[-1] → latent, twice (mu, logvar)
    decoder   latent → h[-1] → … → h[0] → seg   (ReLU, tanh last)

so the dense model (h = [2048]) is 1024 → 2048, 2048 → 256 twice,
256 → 2048, 2048 → 1024, and the deep/wide one (h = [4096, 2048, 1024,
512]) is 4096 → 4096 → 2048 → 1024 → 512, 512 → 256 twice, 256 → 512 →
1024 → 2048 → 4096 → 4096.

Multiply-adds a frame of the forward (one per weight):

    dense      1024·2048 + 2·2048·256 + 256·2048 + 2048·1024 = 5,767,168
    deep_wide  4096·4096 + 4096·2048 + 2048·1024 + 1024·512
               + 2·512·256 + 256·512 + 512·1024 + 1024·2048
               + 2048·4096 + 4096·4096                       = 55,967,744

A training step runs three products a layer — the forward, the input
gradient and the weight gradient — except the first layer, whose input
gradient is never asked for (the frames are data, not parameters).  So
the FLOPs a frame are 2 · (3 · MACs − MACs of the first layer):

    dense      2 · (3 · 5,767,168 − 1024·2048)  =  30,408,704
    deep_wide  2 · (3 · 55,967,744 − 4096·4096) = 302,252,032

(``probes/common.py`` ``flops_per_frame`` multiplies by 3 throughout and
so counts that first input gradient too: 14 % high for dense, 11 % for
deep_wide.)

Peaks: one NVIDIA H100 SXM by its data sheet, dense rates at the full
700 W — 989 TFLOP/s bf16 on the tensor cores, 67 TFLOP/s fp32 on the CUDA
cores, 3.35 TB/s of HBM.  ``bfloat16`` runs its products on the tensor
cores, ``highest`` in IEEE fp32 on the CUDA cores.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

HBM_BYTES_S = 3.35e12
TENSOR_CORE_FLOPS = 989e12
FP32_FLOPS = 67e12

# tier → (peak FLOP/s of its products, passes a product, bytes an operand)
TIERS: Dict[str, Tuple[float, int, int]] = {
    "bfloat16": (TENSOR_CORE_FLOPS, 1, 2),
    "highest": (FP32_FLOPS, 1, 4),
}

# Adam's seven fp32 streams a parameter: read p, g, mu, nu; write p, mu, nu
ADAM_BYTES_PER_PARAM = 7 * 4
GRAD_BYTES = 4          # weight gradients are fp32 in every tier


def layers(config: dict) -> List[Tuple[int, int]]:
    """``(fan_in, fan_out)`` of every product of the forward, in order."""
    seg, latent = config["segment_length"], config["latent_dim"]
    hidden = list(config["hidden_dims"])
    enc = [seg, *hidden]
    dec = [latent, *reversed(hidden), seg]
    return ([(a, b) for a, b in zip(enc[:-1], enc[1:])]
            + [(hidden[-1], latent)] * 2
            + [(a, b) for a, b in zip(dec[:-1], dec[1:])])


def forward_macs_per_frame(config: dict) -> int:
    return sum(a * b for a, b in layers(config))


def train_flops_per_frame(config: dict) -> int:
    """Model FLOPs a frame of one training step (module docstring)."""
    first_in, first_out = layers(config)[0]
    return 2 * (3 * forward_macs_per_frame(config) - first_in * first_out)


def param_count(config: dict) -> int:
    return sum(a * b + b for a, b in layers(config))


def step_products(config: dict, batch: int, tier: str
                  ) -> List[Tuple[str, int, int]]:
    """``(name, FLOPs, bytes)`` of every product of one training step at
    ``batch`` rows: the FLOPs at the tier's pass count, the bytes each
    operand read once and the output written once (activations at the
    tier's operand width, weight gradients fp32)."""
    _, passes, e = TIERS[tier]
    out = []
    for i, (n, m) in enumerate(layers(config)):
        flops = 2 * batch * n * m * passes
        out.append((f"fwd{i}", flops, e * (batch * n + n * m + batch * m)))
        if i:
            out.append((f"dx{i}", flops, e * (batch * m + n * m + batch * n)))
        out.append((f"dw{i}", flops,
                    e * (batch * n + batch * m) + GRAD_BYTES * (n * m + m)))
    return out


def least_step_seconds(config: dict, batch: int, tier: str) -> float:
    """The least time the card could take for one step's required work:
    each product at the larger of its FLOPs over the tier's peak and its
    bytes over HBM's, and Adam's 28 bytes a parameter over HBM's."""
    peak = TIERS[tier][0]
    products = sum(max(f / peak, b / HBM_BYTES_S)
                   for _, f, b in step_products(config, batch, tier))
    return products + ADAM_BYTES_PER_PARAM * param_count(config) / HBM_BYTES_S


def peak_flops(tier: str) -> float:
    return TIERS[tier][0]

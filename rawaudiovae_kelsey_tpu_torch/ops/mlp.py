"""Dense-VAE forward kernels: the CUDA counterparts of the JAX package's
``ops/pallas_mlp.py`` ``encoder_fwd`` / ``decoder_fwd``.

Each op has three parts, side by side:

* the plain PyTorch version (``encoder_fwd_ref``, ``decoder_fwd_ref``):
  the same arithmetic, in the JAX op order (``x @ w + b``, then the
  activation);
* the wrapper (``encoder_fwd``, ``decoder_fwd``): for a CPU tensor it runs
  the plain version; for a CUDA tensor it checks device, dtype, shape and
  contiguity, launches the hand-written kernel (``csrc/mlp.cu``) on the
  current stream, and counts the launch in ``<wrapper>.launches``.  It
  never falls back: anything the kernel does not take raises;
* the model-level entry points ``encode`` / ``decode``, which play the
  roles of ``pallas_encode`` / ``pallas_decode`` (forward only: serving).

Layouts are the JAX package's: weights ``(in, out)``, biases ``(out,)``.
fp32 in, fp32 out, fp32 accumulation.  The kernels mask the ragged batch
edge themselves; nothing is padded.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from rawaudiovae_kelsey_tpu_torch.ops import _build

Tensor = torch.Tensor


def encoder_fwd_ref(w1, b1, w21, b21, w22, b22, x
                    ) -> Tuple[Tensor, Tensor, Tensor]:
    """Plain version of :func:`encoder_fwd`."""
    h = torch.relu(x @ w1 + b1)
    return h @ w21 + b21, h @ w22 + b22, h


def decoder_fwd_ref(w3, b3, w4, b4, z) -> Tuple[Tensor, Tensor]:
    """Plain version of :func:`decoder_fwd`."""
    h3 = torch.relu(z @ w3 + b3)
    return torch.tanh(h3 @ w4 + b4), h3


def require(t: Tensor, name: str, shape: Tuple[int, ...],
            device: torch.device, dtype: torch.dtype = torch.float32) -> None:
    """Raise unless ``t`` is what a kernel takes: on ``device``, of
    ``dtype``, of ``shape``, contiguous."""
    if not isinstance(t, Tensor):
        raise TypeError(f"{name}: expected a tensor, got {type(t).__name__}")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, kernel takes {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def cuda_device(x: Tensor, name: str) -> torch.device:
    """The device a kernel launch for ``x`` runs on; raises for anything
    but a CUDA tensor (CPU tensors never reach here)."""
    if not isinstance(x, Tensor) or x.device.type != "cuda":
        where = x.device if isinstance(x, Tensor) else type(x).__name__
        raise ValueError(f"{name}: the kernel runs on CUDA tensors, got "
                         f"{where}")
    if x.dim() != 2:
        raise ValueError(f"{name}: expected a 2-D batch, got shape "
                         f"{tuple(x.shape)}")
    return x.device


def encoder_fwd(w1, b1, w21, b21, w22, b22, x
                ) -> Tuple[Tensor, Tensor, Tensor]:
    """Fused ``relu(x@W1+b1)`` → ``(mu, logvar, h)``.

    Replaces ``rawaudiovae_kelsey_tpu/ops/pallas_mlp.py`` ``encoder_fwd``.
    CUDA: two launches of the tiled GEMM (``csrc/mlp.cu``), h then both
    heads in one."""
    if x.device.type == "cpu":
        return encoder_fwd_ref(w1, b1, w21, b21, w22, b22, x)
    dev = cuda_device(x, "encoder_fwd: x")
    batch, seg = x.shape
    units, latent = w1.shape[1], w21.shape[1]
    require(x, "x", (batch, seg), dev)
    require(w1, "w1", (seg, units), dev)
    require(b1, "b1", (units,), dev)
    require(w21, "w21", (units, latent), dev)
    require(b21, "b21", (latent,), dev)
    require(w22, "w22", (units, latent), dev)
    require(b22, "b22", (latent,), dev)
    mu = torch.empty((batch, latent), device=dev, dtype=torch.float32)
    logvar = torch.empty((batch, latent), device=dev, dtype=torch.float32)
    h = torch.empty((batch, units), device=dev, dtype=torch.float32)
    if batch:
        _build.launch("rvk_encoder_fwd", dev, x, w1, b1, w21, b21, w22, b22,
                      mu, logvar, h, batch, seg, units, latent)
        encoder_fwd.launches += 1
    return mu, logvar, h


encoder_fwd.launches = 0


def decoder_fwd(w3, b3, w4, b4, z) -> Tuple[Tensor, Tensor]:
    """Fused ``tanh(relu(z@W3+b3)@W4+b4)`` → ``(y, h3)``.

    Replaces ``rawaudiovae_kelsey_tpu/ops/pallas_mlp.py`` ``decoder_fwd``.
    CUDA: two launches of the tiled GEMM (``csrc/mlp.cu``), h3 then y."""
    if z.device.type == "cpu":
        return decoder_fwd_ref(w3, b3, w4, b4, z)
    dev = cuda_device(z, "decoder_fwd: z")
    batch, latent = z.shape
    units, seg = w3.shape[1], w4.shape[1]
    require(z, "z", (batch, latent), dev)
    require(w3, "w3", (latent, units), dev)
    require(b3, "b3", (units,), dev)
    require(w4, "w4", (units, seg), dev)
    require(b4, "b4", (seg,), dev)
    y = torch.empty((batch, seg), device=dev, dtype=torch.float32)
    h3 = torch.empty((batch, units), device=dev, dtype=torch.float32)
    if batch:
        _build.launch("rvk_decoder_fwd", dev, z, w3, b3, w4, b4, y, h3,
                      batch, latent, units, seg)
        decoder_fwd.launches += 1
    return y, h3


decoder_fwd.launches = 0

Params = Dict[str, Dict[str, Tensor]]


def encode(params: Params, x: Tensor) -> Tuple[Tensor, Tensor]:
    """``models.vae.encode`` through :func:`encoder_fwd` (the role of the
    JAX package's ``pallas_encode``)."""
    mu, logvar, _ = encoder_fwd(
        params["fc1"]["w"], params["fc1"]["b"],
        params["fc21"]["w"], params["fc21"]["b"],
        params["fc22"]["w"], params["fc22"]["b"], x,
    )
    return mu, logvar


def decode(params: Params, z: Tensor) -> Tensor:
    """``models.vae.decode`` through :func:`decoder_fwd` (the role of the
    JAX package's ``pallas_decode``)."""
    y, _ = decoder_fwd(
        params["fc3"]["w"], params["fc3"]["b"],
        params["fc4"]["w"], params["fc4"]["b"], z,
    )
    return y

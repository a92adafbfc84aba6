"""Model registry — the counterpart of the JAX package's
``models/registry.py``: a :class:`ModelDef` of functions over a params dict,
so the server, checkpointing and kernel dispatch are variant-agnostic.

Only ``arch = dense`` is ported.  ``[tpu] backend`` keeps its values:
``pallas`` runs the hand-written CUDA kernels (``ops/mlp.py``; on CPU
tensors their wrappers run the plain versions), ``xla`` the plain PyTorch
ops (``models/vae.py``), ``best`` the kernels on a CUDA device and the plain
ops elsewhere.  Under ``pallas`` the backward of fp32 operands follows
``[tpu] precision`` as the JAX package's ``_fusion`` does: ``float32`` and
``highest`` take the "primitive" composition (``matmul_nt*`` +
``grad_accum``), ``high`` the "split" kernels until the one-kernel
``*_full`` backward is ported; bf16 operands always take "split".
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial
from typing import Callable, Optional, Tuple

import torch

from rawaudiovae_kelsey_tpu_torch.config.schema import Config
from rawaudiovae_kelsey_tpu_torch.models import vae
from rawaudiovae_kelsey_tpu_torch.ops import mlp


@dataclass(frozen=True)
class ModelDef:
    """A VAE family on one device: ``init`` (a ``torch.Generator`` →
    params dict on ``device``) and ``encode``/``decode`` functions of
    ``(params, batch)``."""

    name: str
    segment_length: int
    latent_dim: int
    device: torch.device
    backend: str
    init: Callable[[Optional[torch.Generator]], vae.Params]
    encode: Callable[[vae.Params, torch.Tensor],
                     Tuple[torch.Tensor, torch.Tensor]]
    decode: Callable[[vae.Params, torch.Tensor], torch.Tensor]


def resolve_backend(cfg: Config, device: torch.device) -> str:
    """``best`` → ``pallas`` for the dense model on a CUDA device, ``xla``
    otherwise; an explicit ``pallas`` / ``xla`` is kept."""
    backend = cfg.tpu.backend
    if backend != "best":
        return backend
    return ("pallas" if cfg.vae.arch == "dense" and device.type == "cuda"
            else "xla")


def build_model(cfg: Config, device: torch.device | str = "cpu") -> ModelDef:
    """The ModelDef selected by ``cfg.vae.arch`` on ``device``."""
    device = torch.device(device)
    arch = cfg.vae.arch
    if arch in ("deep", "conv1d"):
        raise NotImplementedError(
            f"arch={arch!r} is not ported to PyTorch yet (ROADMAP.md queue "
            "A: variants); the JAX package rawaudiovae_kelsey_tpu runs it")
    if arch != "dense":
        raise ValueError(f"unknown arch {arch!r}")
    backend = resolve_backend(cfg, device)
    seg, latent = cfg.audio.segment_length, cfg.vae.latent_dim
    encode_fn, decode_fn = vae.encode, vae.decode
    if backend == "pallas":
        fp32_backward = "split" if cfg.tpu.precision == "high" else "primitive"
        encode_fn = partial(mlp.encode, fp32_backward=fp32_backward)
        decode_fn = partial(mlp.decode, fp32_backward=fp32_backward)
    return ModelDef(
        name="dense",
        segment_length=seg,
        latent_dim=latent,
        device=device,
        backend=backend,
        init=partial(vae.init_dense, segment_length=seg,
                     n_units=cfg.vae.n_units, latent_dim=latent,
                     device=device),
        encode=encode_fn,
        decode=decode_fn,
    )


def resident_model(cfg: Config, model: ModelDef) -> ModelDef:
    """The ModelDef the device-resident epoch engine trains with: ``model``
    as :func:`resolve_backend` resolved it.  The JAX package re-routes
    ``backend = best`` to XLA inside its on-chip epoch scan because the
    Pallas custom calls schedule worse there on a TPU; that is a property
    of that compiler and that chip.  Here an epoch is a host loop over the
    same step the host-fed trainer takes, so there is nothing to re-route,
    and ``best`` keeps the kernels on a CUDA device.  An explicit
    ``backend = xla`` / ``pallas`` is honoured as everywhere."""
    return model

"""Model registry — the counterpart of the JAX package's
``models/registry.py``: a :class:`ModelDef` of functions over a params dict,
so the server, checkpointing and kernel dispatch are variant-agnostic.

The three families of the JAX package: ``arch = dense`` (the reference
architecture), ``deep`` (the deep/wide MLP) and ``conv1d``
(``models/variants.py``).  ``[tpu] backend`` keeps its values: ``pallas``
runs the hand-written CUDA kernels (``ops/mlp.py`` for the dense model,
``ops/linear.py`` for the deep one; on CPU tensors their wrappers run the
plain versions), ``xla`` the plain PyTorch ops (``models/vae.py``,
``models/variants.py``), ``best`` the kernels for the dense model on a CUDA
device and the plain ops elsewhere.  The conv1d model runs the plain
convolutions under every backend, as the JAX registry routes it on purpose;
its block-Toeplitz path (``ops/conv.py``) is an explicit op-level API.
Under ``pallas`` the dense model's backward of fp32 operands follows
``[tpu] precision`` as the JAX package's ``_fusion`` does: ``float32`` and
``highest`` take the "primitive" composition (``matmul_nt*`` +
``grad_accum``), ``high`` the "full" chains (``enc_bwd_full`` /
``dec_bwd_full``, every product in three bf16 passes); bf16 operands always
take "split".  The forward kernels and the input-gradient products run IEEE
fp32 under ``high`` too: at least as accurate as the 3-pass product the JAX
package gives them.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial
from typing import Callable, List, Optional, Sequence, Tuple

import torch

from rawaudiovae_kelsey_tpu_torch.config.schema import Config
from rawaudiovae_kelsey_tpu_torch.models import vae, variants
from rawaudiovae_kelsey_tpu_torch.ops import linear, mlp


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


def _parse_int_list(s: str, default: Sequence[int]) -> List[int]:
    s = s.strip()
    if not s:
        return list(default)
    return [int(t) for t in s.replace(" ", "").split(",") if t]


def build_model(cfg: Config, device: torch.device | str = "cpu") -> ModelDef:
    """The ModelDef selected by ``cfg.vae.arch`` on ``device``."""
    device = torch.device(device)
    arch = cfg.vae.arch
    backend = resolve_backend(cfg, device)
    seg, latent = cfg.audio.segment_length, cfg.vae.latent_dim

    if arch == "deep":
        hidden = _parse_int_list(cfg.vae.hidden_dims, (4096, 2048, 1024, 512))
        encode_fn, decode_fn = variants.encode_deep, variants.decode_deep
        if backend == "pallas":
            encode_fn = linear.deep_encode_pallas
            decode_fn = linear.deep_decode_pallas
        return ModelDef(
            name="deep", segment_length=seg, latent_dim=latent,
            device=device, backend=backend,
            init=partial(variants.init_deep, segment_length=seg,
                         hidden_dims=tuple(hidden), latent_dim=latent,
                         device=device),
            encode=encode_fn, decode=decode_fn,
        )

    if arch == "conv1d":
        channels = _parse_int_list(cfg.vae.conv_channels, (32, 64, 128, 256))
        kernel, stride = cfg.vae.conv_kernel, cfg.vae.conv_stride
        width = variants.conv_latent_width(seg, len(channels), stride)
        # backend = pallas keeps the plain convolutions: the JAX registry
        # routes the family so, and ops/conv.py stays an op-level API
        if device.type == "cuda":
            # cuDNN runs fp32 convolutions in TF32 unless told otherwise;
            # the fp32 tiers of this package hold IEEE fp32, as PyTorch's
            # matrix products do by default (a process-wide switch)
            torch.backends.cudnn.allow_tf32 = False
        return ModelDef(
            name="conv1d", segment_length=seg, latent_dim=latent,
            device=device, backend=backend,
            init=partial(variants.init_conv1d, segment_length=seg,
                         channels=tuple(channels), kernel=kernel,
                         stride=stride, latent_dim=latent, device=device),
            encode=partial(variants.encode_conv1d, stride=stride),
            decode=partial(variants.decode_conv1d, stride=stride,
                           width=width, channels=channels[-1]),
        )

    if arch != "dense":
        raise ValueError(f"unknown arch {arch!r}")
    encode_fn, decode_fn = vae.encode, vae.decode
    if backend == "pallas":
        fp32_backward = "full" if cfg.tpu.precision == "high" else "primitive"
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

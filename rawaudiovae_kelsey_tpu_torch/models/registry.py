"""Model registry — the counterpart of the JAX package's
``models/registry.py``: a :class:`ModelDef` of functions over a params dict,
so the server, checkpointing and kernel dispatch are variant-agnostic.

The three families of the JAX package: ``arch = dense`` (the reference
architecture), ``deep`` (the deep/wide MLP) and ``conv1d``
(``models/variants.py``).  ``[tpu] backend`` keeps its values: ``pallas``
runs the hand-written CUDA kernels (``ops/mlp.py`` for the dense model,
``ops/linear.py`` for the deep one; on CPU tensors their wrappers run the
plain versions), ``xla`` the plain PyTorch ops (``models/vae.py``,
``models/variants.py``), ``best`` the measured winner per family and
precision tier, as the JAX registry defines it: on a CUDA device the plain
ops won every cell measured (PERF.md §5), and unmeasured corners take them
as in JAX, so ``best`` resolves to ``xla``.  The conv1d model runs the plain
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
    ``(params, batch)``; ``plain_encode``/``plain_decode`` are the family's
    plain PyTorch ops whatever the backend (what ``torch.export`` traces)."""

    name: str
    segment_length: int
    latent_dim: int
    device: torch.device
    backend: str
    init: Callable[[Optional[torch.Generator]], vae.Params]
    encode: Callable[[vae.Params, torch.Tensor],
                     Tuple[torch.Tensor, torch.Tensor]]
    decode: Callable[[vae.Params, torch.Tensor], torch.Tensor]
    plain_encode: Callable[[vae.Params, torch.Tensor],
                           Tuple[torch.Tensor, torch.Tensor]]
    plain_decode: Callable[[vae.Params, torch.Tensor], torch.Tensor]


def resolve_backend(cfg: Config, device: torch.device) -> str:
    """``best`` → the measured winner for ``cfg``'s family and precision
    tier on ``device``; an explicit ``pallas`` / ``xla`` is kept.

    The JAX registry's rule (``_resolve_backend``): the kernels only where
    they were measured to win, the plain ops for every unmeasured corner
    (dense ``float32`` among them) and on the CPU.  On a CUDA device the
    plain ops won every measured cell (PERF.md §5): the dense model's bf16
    step 2,445,634 against 436,563 frames/s and its resident epoch 911,799
    against 419,444; the deep and conv1d steps too.  So ``best`` is ``xla``
    on every device today, and ``pallas`` is the explicit way to the
    kernels."""
    del device  # the measured winner is the same on every device
    backend = cfg.tpu.backend
    return "xla" if backend == "best" else backend


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
            plain_encode=variants.encode_deep,
            plain_decode=variants.decode_deep,
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
        encode_fn = partial(variants.encode_conv1d, stride=stride)
        decode_fn = partial(variants.decode_conv1d, stride=stride,
                            width=width, channels=channels[-1])
        return ModelDef(
            name="conv1d", segment_length=seg, latent_dim=latent,
            device=device, backend=backend,
            init=partial(variants.init_conv1d, segment_length=seg,
                         channels=tuple(channels), kernel=kernel,
                         stride=stride, latent_dim=latent, device=device),
            encode=encode_fn, decode=decode_fn,
            plain_encode=encode_fn, plain_decode=decode_fn,
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
        plain_encode=vae.encode,
        plain_decode=vae.decode,
    )


def resident_model(cfg: Config, model: ModelDef) -> ModelDef:
    """The ModelDef the device-resident epoch engine trains with: ``model``
    as :func:`resolve_backend` resolved it.  The JAX package re-routes
    ``backend = best`` to XLA inside its on-chip epoch scan; here
    :func:`resolve_backend` already resolves ``best`` to the plain ops, so
    the resident engine trains on them under ``best`` as the JAX one does,
    with nothing to re-route.  An explicit ``backend = xla`` / ``pallas``
    is honoured as everywhere."""
    return model

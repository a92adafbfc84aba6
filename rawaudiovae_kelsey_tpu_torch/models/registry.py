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
Under ``pallas`` the dense model's backward mode is ``ops/mlp.py``
``fusion`` of the step's operand dtype and pass count, as the JAX
package's ``_fusion`` picks it when its step is traced
(:func:`backward_fusion`, read when the model is built): under the switch's
"auto" ``float32`` and ``highest`` take the "primitive" composition
(``matmul_nt*`` + ``grad_accum``), ``high`` the "full" chains
(``enc_bwd_full`` / ``dec_bwd_full``, every product in three bf16 passes),
``bfloat16`` "split"; a forced ``mlp.BWD_FUSION`` is taken by every tier.
The forward's pass count is the step's, not the model's:
JAX traces its train, eval, resident, spmd and stream steps under
``jax.default_matmul_precision(precision)``, and its dense kernels take
three passes under an ambient ``high`` (``pallas_mlp.py:167``), while its
server, ``infer/api.py`` and export run outside any scope, in one pass.
So a ``ModelDef`` computes the forward in one IEEE fp32 pass, and the
steps bind under ``high`` the pass count each op-level function declares
(:func:`under_tier`): 3 for the dense kernels, 4 for the op-level conv1d
model (``ops/conv.py`` ``conv_encode_pallas`` / ``conv_decode_pallas``,
whose Toeplitz products JAX takes in four bf16 passes under ``high``,
``pallas_toeplitz.py:177-182``): the kernels then compute what the TPU
kernels compute.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from functools import partial
from typing import Callable, List, Optional, Sequence, Tuple

import torch

from rawaudiovae_kelsey_tpu_torch.config.schema import Config
from rawaudiovae_kelsey_tpu_torch.models import vae, variants
from rawaudiovae_kelsey_tpu_torch.ops import linear, loss, mlp


@dataclass(frozen=True)
class ModelDef:
    """A VAE family on one device: ``init`` (a ``torch.Generator`` →
    params dict on ``device``) and ``encode``/``decode`` functions of
    ``(params, batch)``; ``plain_encode``/``plain_decode`` are the family's
    plain PyTorch ops whatever the backend (what ``torch.export`` traces).
    ``loss_components`` is the train step's loss, ``(recon, x, mu, logvar,
    kl_beta, segment_length, reduction) → (loss, mse, kld)`` on the
    decoder's output in its own dtype: :func:`kernel_loss` under
    ``pallas`` (the dense and deep families), :func:`plain_loss` otherwise."""

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
    loss_components: Callable[..., Tuple[torch.Tensor, torch.Tensor,
                                         torch.Tensor]]


def plain_loss(recon, x, mu, logvar, kl_beta: float, segment_length: int,
               reduction: str):
    """The step's loss on plain ops: ``models/vae.py`` ``loss_components``
    on the reconstruction brought to fp32, as the JAX step leaves its loss
    to XLA."""
    return vae.loss_components(recon.float(), x, mu, logvar, kl_beta,
                               segment_length, reduction)


def kernel_loss(recon, x, mu, logvar, kl_beta: float, segment_length: int,
                reduction: str):
    """The step's loss under ``backend = pallas``: row 14's two kernels
    (``ops/loss.py`` ``fused_loss_components``) on the reconstruction in
    the decoder's dtype where ``ops/loss.py`` ``takes_fused_loss`` says
    they take the tensors (CUDA, the shapes and dtypes), so no fp32 copy
    of it and no elementwise pass of the plain loss reaches device memory;
    :func:`plain_loss` elsewhere.  The same fp32 function; the sums add in
    another order."""
    if loss.takes_fused_loss(recon, x, mu, logvar):
        return loss.fused_loss_components(recon, x, mu, logvar, kl_beta,
                                          reduction)
    return plain_loss(recon, x, mu, logvar, kl_beta, segment_length,
                      reduction)


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
    loss_fn = kernel_loss if backend == "pallas" else plain_loss

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
            loss_components=loss_fn,
        )

    if arch == "conv1d":
        channels = _parse_int_list(cfg.vae.conv_channels, (32, 64, 128, 256))
        kernel, stride = cfg.vae.conv_kernel, cfg.vae.conv_stride
        width = variants.conv_latent_width(seg, len(channels), stride)
        # backend = pallas keeps the plain convolutions and the plain loss:
        # the JAX registry routes the family so, and ops/conv.py stays an
        # op-level API
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
            loss_components=plain_loss,
        )

    if arch != "dense":
        raise ValueError(f"unknown arch {arch!r}")
    encode_fn, decode_fn = vae.encode, vae.decode
    if backend == "pallas":
        mode = backward_fusion(cfg)
        encode_fn = partial(mlp.encode, mode=mode)
        decode_fn = partial(mlp.decode, mode=mode)
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
        loss_components=loss_fn,
    )


def backward_fusion(cfg: Config) -> str:
    """The dense kernels' backward mode in a step of ``cfg``: ``ops/mlp.py``
    ``fusion`` of the step's operand dtype (bf16 under ``bfloat16``, fp32
    otherwise) and pass count (3 under ``high``), reading the switch
    ``mlp.BWD_FUSION`` as it stands now.  ``build_model`` and
    ``parallel/tensor_parallel.py`` ``tensor_parallel_model`` call it, so
    a step runs the mode its model was built with, as a JAX step runs the
    mode it was traced with."""
    work = torch.bfloat16 if cfg.tpu.precision == "bfloat16" \
        else torch.float32
    return mlp.fusion(work, 3 if cfg.tpu.precision == "high" else 1)


def step_passes(cfg: Config, fn: Callable) -> int:
    """The pass count op-level function ``fn`` (through any
    ``functools.partial``) takes inside a train or eval step of ``cfg``:
    under ``high`` the ``high_passes`` it declares, 1 otherwise and where it
    declares none.  The dense kernels' ``ops/mlp.py`` ``encode`` /
    ``decode`` (and the tensor-parallel forms) declare 3 (fp32 operands:
    JAX ``pallas_mlp.py:167`` ``_ambient_passes`` in the step's
    ``jax.default_matmul_precision``), the op-level conv1d model's
    ``ops/conv.py`` functions 4 (``pallas_toeplitz.py:177-182``).
    ``float32``, ``highest`` and ``bfloat16`` keep one pass, and so do the
    plain ops (``xla``; the registry's conv1d model under every backend):
    they hold IEEE fp32 with TF32 off, as PyTorch's matmuls do."""
    if cfg.tpu.precision != "high":
        return 1
    while isinstance(fn, partial):
        fn = fn.func
    return getattr(fn, "high_passes", 1)


def tier_passes(cfg: Config, model: ModelDef) -> int:
    """The pass count of ``model`` 's kernel products inside a train or eval
    step of ``cfg``: :func:`step_passes` of its ``encode``."""
    return step_passes(cfg, model.encode)


def under_tier(model: ModelDef, cfg: Config) -> ModelDef:
    """``model`` as a train or eval step of ``cfg`` runs it: JAX's
    ``jax.default_matmul_precision(cfg.tpu.precision)`` scope around its
    steps (``parallel/step.py:174``, ``:268``; ``parallel/resident.py:208``,
    ``:375``; ``parallel/spmd.py:100``; ``train/stream.py:536``), carried as
    an argument: ``encode`` / ``decode`` get ``passes`` bound where
    :func:`step_passes` is more than 1 (3 for ``ops/mlp.py`` ``encode``
    and the tensor-parallel forms, 4 for the op-level conv1d model);
    otherwise ``model`` itself.  The server, ``infer/api.py`` and export
    never call it, so they keep the one-pass forward, as JAX's run outside
    any scope."""
    enc, dec = (step_passes(cfg, f) for f in (model.encode, model.decode))
    if enc == dec == 1:
        return model
    return replace(
        model,
        encode=partial(model.encode, passes=enc) if enc > 1 else model.encode,
        decode=partial(model.decode, passes=dec) if dec > 1
        else model.decode)


def resident_model(cfg: Config, model: ModelDef) -> ModelDef:
    """The ModelDef the device-resident epoch engine trains with: ``model``
    as :func:`resolve_backend` resolved it.  The JAX package re-routes
    ``backend = best`` to XLA inside its on-chip epoch scan; here
    :func:`resolve_backend` already resolves ``best`` to the plain ops, so
    the resident engine trains on them under ``best`` as the JAX one does,
    with nothing to re-route.  An explicit ``backend = xla`` / ``pallas``
    is honoured as everywhere."""
    return model

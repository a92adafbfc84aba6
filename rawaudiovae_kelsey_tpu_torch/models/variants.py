"""The model variants beside the dense VAE — the counterpart of the JAX
package's ``models/variants.py``:

* the deep/wide MLP VAE: encoder seg→h0→…→hk (ReLU each) → two latent
  heads; the decoder mirrors back to seg with a tanh output
  (:func:`init_deep` / :func:`encode_deep` / :func:`decode_deep`);
* the conv1d VAE over raw frames: strided convolutions down, transpose
  convolutions back (:func:`init_conv1d` / :func:`encode_conv1d` /
  :func:`decode_conv1d`);
* the Oobleck VAE, Stable Audio Open's autoencoder: weight-normalised
  convolutions, residual units dilated 1, 3 and 9, SnakeBeta activations
  and a softplus bottleneck, over interleaved multichannel frames
  (:func:`init_oobleck` / :func:`encode_oobleck` / :func:`decode_oobleck`;
  a port-only family, which the JAX package does not have).

All reuse the dense VAE's reparameterization and loss (``models/vae.py``),
so a variant swaps only the encode/decode pair.  The params trees are the
JAX package's: ``{"enc": [layer, ...], "dec": [layer, ...], "mu_head":
layer, "logvar_head": layer}`` (+ ``"dec_in"`` for conv1d), a layer being
``{"w", "b"}`` with a linear ``w`` stored ``(in, out)`` and a conv ``w``
``(kernel, in, out)``; activations of the convolutions are NWC, ``(batch,
length, channels)``.  Everything here is plain PyTorch (``x @ w + b``,
``F.conv1d``, ``F.conv_transpose1d``); the hand-written kernels are in
``ops/linear.py`` and ``ops/conv.py``.

SAME padding is JAX's, which is asymmetric.  A strided convolution of
length L gives ``ceil(L/S)`` samples from ``total = max(0, (out-1)·S + K -
L)`` zeros, ``total // 2`` on the left and the rest on the right.  A
transpose convolution (``jax.lax.conv_transpose``, which does not flip the
kernel) gives ``L·S`` samples: the kernel flipped along its width goes
through ``F.conv_transpose1d`` with ``padding = max(0, K-S) // 2`` and the
output is cut to ``L·S``.

Each family also has an ``nn.Module`` face (:class:`DeepVAE`,
:class:`Conv1dVAE`) whose ``params()`` is the tree, sharing storage, as
``models/vae.py`` ``DenseVAE`` has.  The initial distributions are
``nn.Linear``'s and ``nn.Conv1d``'s (U(±1/sqrt(fan_in)) with ``fan_in =
in_ch·kernel``), drawn from an explicit ``torch.Generator``: not JAX's
threefry stream, so parity with the JAX package is held on carried-over
weights.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from rawaudiovae_kelsey_tpu_torch.models.vae import (
    Linear,
    Params,
    forward_with,
    linear,
)
from rawaudiovae_kelsey_tpu_torch.observe.spans import span
from rawaudiovae_kelsey_tpu_torch.tree import tree_map

Tensor = torch.Tensor


def _layer(m: nn.Module) -> dict:
    return {"w": m.w, "b": m.b}


def _detached(params: Params) -> Params:
    return tree_map(lambda t: t.detach(), params)


# ---------------------------------------------------------------- deep MLP --

class DeepVAE(nn.Module):
    """The deep/wide MLP VAE.  Initialised on the CPU from ``generator``
    (the same numbers for every target device), then moved to ``device``."""

    def __init__(self, segment_length: int, hidden_dims: Sequence[int],
                 latent_dim: int,
                 generator: Optional[torch.Generator] = None,
                 device: torch.device | str | None = None):
        super().__init__()
        self.segment_length = segment_length
        dims = [segment_length, *hidden_dims]
        self.enc = nn.ModuleList(
            Linear(dims[i], dims[i + 1], generator)
            for i in range(len(dims) - 1))
        self.mu_head = Linear(dims[-1], latent_dim, generator)
        self.logvar_head = Linear(dims[-1], latent_dim, generator)
        rdims = [latent_dim, *reversed(hidden_dims), segment_length]
        self.dec = nn.ModuleList(
            Linear(rdims[i], rdims[i + 1], generator)
            for i in range(len(rdims) - 1))
        if device is not None:
            self.to(device)

    def params(self) -> Params:
        """The functional params tree, sharing this module's storage."""
        return {"enc": [_layer(m) for m in self.enc],
                "dec": [_layer(m) for m in self.dec],
                "mu_head": _layer(self.mu_head),
                "logvar_head": _layer(self.logvar_head)}

    def encode(self, x: Tensor) -> Tuple[Tensor, Tensor]:
        return encode_deep(self.params(), x)

    def decode(self, z: Tensor) -> Tensor:
        return decode_deep(self.params(), z)

    def forward(self, x: Tensor, generator: Optional[torch.Generator] = None,
                deterministic: bool = False) -> Tuple[Tensor, Tensor, Tensor]:
        return forward_with(self.encode, self.decode, x, self.segment_length,
                            generator, deterministic)


def init_deep(generator: Optional[torch.Generator], segment_length: int,
              hidden_dims: Sequence[int], latent_dim: int,
              device: torch.device | str | None = None) -> Params:
    """Fresh params tree (detached tensors) with :class:`DeepVAE`'s init."""
    return _detached(DeepVAE(segment_length, hidden_dims, latent_dim,
                             generator, device).params())


def encode_deep(params: Params, x: Tensor) -> Tuple[Tensor, Tensor]:
    h = x
    for layer in params["enc"]:
        h = torch.relu(linear(layer, h))
    return linear(params["mu_head"], h), linear(params["logvar_head"], h)


def decode_deep(params: Params, z: Tensor) -> Tensor:
    h = z
    for layer in params["dec"][:-1]:
        h = torch.relu(linear(layer, h))
    return torch.tanh(linear(params["dec"][-1], h))


# ------------------------------------------------------------------ conv1d --

class Conv(nn.Module):
    """One convolution's weights, ``w`` stored ``(kernel, in, out)`` (the
    JAX package's WIO layout); initialised like ``nn.Conv1d``: w and b both
    U(±1/sqrt(in_ch·kernel))."""

    def __init__(self, kernel: int, in_ch: int, out_ch: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        bound = 1.0 / math.sqrt(in_ch * kernel)
        self.w = nn.Parameter(
            torch.empty(kernel, in_ch, out_ch).uniform_(
                -bound, bound, generator=generator))
        self.b = nn.Parameter(
            torch.empty(out_ch).uniform_(-bound, bound, generator=generator))


def same_pad(length: int, kernel: int, stride: int) -> Tuple[int, int]:
    """JAX's SAME padding of a strided convolution → (left, right)."""
    out = -(-length // stride)
    total = max(0, (out - 1) * stride + kernel - length)
    return total // 2, total - total // 2


def conv_same(p, x: Tensor, stride: int) -> Tensor:
    """SAME-padded strided convolution plus bias: x ``(B, L, Cin)``, ``w``
    ``(K, Cin, Cout)`` → ``(B, ceil(L/stride), Cout)`` in x's dtype (the
    bias is added to the rounded product, as the JAX ``_conv`` does)."""
    w = p["w"]
    lo, hi = same_pad(x.shape[1], w.shape[0], stride)
    y = F.conv1d(F.pad(x.transpose(1, 2), (lo, hi)), w.permute(2, 1, 0),
                 stride=stride)
    return y.transpose(1, 2) + p["b"]


def conv_transpose_same(p, x: Tensor, stride: int) -> Tensor:
    """SAME-padded transpose convolution plus bias, the semantics of
    ``jax.lax.conv_transpose`` (kernel not flipped): x ``(B, L, Cin)``,
    ``w`` ``(K, Cin, Cout)`` → ``(B, L·stride, Cout)`` in x's dtype."""
    w = p["w"]
    kernel, length = w.shape[0], x.shape[1]
    pb = max(0, kernel - stride) // 2
    y = F.conv_transpose1d(
        x.transpose(1, 2), w.flip(0).permute(1, 2, 0), stride=stride,
        padding=pb, output_padding=max(0, stride - kernel + 2 * pb))
    return y[:, :, :length * stride].transpose(1, 2) + p["b"]


def conv_latent_width(segment_length: int, n_layers: int, stride: int) -> int:
    w = segment_length
    for _ in range(n_layers):
        w = -(-w // stride)  # ceil, matches SAME padding
    return w


class Conv1dVAE(nn.Module):
    """The conv1d VAE.  encoder: (B, seg, 1) → convolutions of stride
    ``stride`` with ``channels`` → flatten → two latent heads; decoder:
    latent → linear → (B, w, C) → transpose convolutions back to (B, seg,
    1) → tanh.  ``segment_length`` must be divisible by ``stride **
    len(channels)``."""

    def __init__(self, segment_length: int, channels: Sequence[int],
                 kernel: int, stride: int, latent_dim: int,
                 generator: Optional[torch.Generator] = None,
                 device: torch.device | str | None = None):
        super().__init__()
        n = len(channels)
        if segment_length % (stride ** n) != 0:
            raise ValueError(
                f"segment_length {segment_length} not divisible by "
                f"stride**layers = {stride ** n}")
        self.segment_length = segment_length
        self.stride = stride
        self.width = conv_latent_width(segment_length, n, stride)
        self.channels = channels[-1]
        chs = [1, *channels]
        self.enc = nn.ModuleList(
            Conv(kernel, chs[i], chs[i + 1], generator) for i in range(n))
        flat = self.width * channels[-1]
        self.mu_head = Linear(flat, latent_dim, generator)
        self.logvar_head = Linear(flat, latent_dim, generator)
        self.dec_in = Linear(latent_dim, flat, generator)
        rchs = [*reversed(channels), 1]
        self.dec = nn.ModuleList(
            Conv(kernel, rchs[i], rchs[i + 1], generator) for i in range(n))
        if device is not None:
            self.to(device)

    def params(self) -> Params:
        """The functional params tree, sharing this module's storage."""
        return {"enc": [_layer(m) for m in self.enc],
                "dec": [_layer(m) for m in self.dec],
                "mu_head": _layer(self.mu_head),
                "logvar_head": _layer(self.logvar_head),
                "dec_in": _layer(self.dec_in)}

    def encode(self, x: Tensor) -> Tuple[Tensor, Tensor]:
        return encode_conv1d(self.params(), x, self.stride)

    def decode(self, z: Tensor) -> Tensor:
        return decode_conv1d(self.params(), z, self.stride, self.width,
                             self.channels)

    def forward(self, x: Tensor, generator: Optional[torch.Generator] = None,
                deterministic: bool = False) -> Tuple[Tensor, Tensor, Tensor]:
        return forward_with(self.encode, self.decode, x, self.segment_length,
                            generator, deterministic)


def init_conv1d(generator: Optional[torch.Generator], segment_length: int,
                channels: Sequence[int], kernel: int, stride: int,
                latent_dim: int,
                device: torch.device | str | None = None) -> Params:
    """Fresh params tree (detached tensors) with :class:`Conv1dVAE`'s init;
    ``ValueError`` when ``segment_length`` is not divisible by ``stride **
    len(channels)``."""
    return _detached(Conv1dVAE(segment_length, channels, kernel, stride,
                               latent_dim, generator, device).params())


def encode_conv1d(params: Params, x: Tensor, stride: int
                  ) -> Tuple[Tensor, Tensor]:
    h = x[..., None]  # (B, seg) → (B, seg, 1)
    for layer in params["enc"]:
        h = torch.relu(conv_same(layer, h, stride))
    h = h.reshape(h.shape[0], -1)
    return linear(params["mu_head"], h), linear(params["logvar_head"], h)


def decode_conv1d(params: Params, z: Tensor, stride: int, width: int,
                  channels: int) -> Tensor:
    h = torch.relu(linear(params["dec_in"], z))
    h = h.reshape(z.shape[0], width, channels)
    for layer in params["dec"][:-1]:
        h = torch.relu(conv_transpose_same(layer, h, stride))
    h = torch.tanh(conv_transpose_same(params["dec"][-1], h, stride))
    return h[..., 0]  # (B, seg, 1) → (B, seg)


# ----------------------------------------------------------------- oobleck --
#
# Stable Audio Open's autoencoder (Evans et al., arXiv:2407.14358; the
# ``OobleckEncoder`` / ``OobleckDecoder`` of stable-audio-tools'
# ``models/autoencoders.py``), with C = channels, s = strides:
#
#   encoder  conv(io→C0, k7) · for each stage i: RU(Ci, 1), RU(Ci, 3),
#            RU(Ci, 9), snake, conv(Ci→Ci+1, k 2si, stride si, pad
#            ceil(si/2)) · snake · conv(Cn→2·latent, k3)
#   decoder  conv(latent→Cn, k7) · for each stage from the last: snake,
#            convT(Ci+1→Ci, k 2si, stride si, pad ceil(si/2)), RU(Ci, 1),
#            RU(Ci, 3), RU(Ci, 9) · snake · conv(C0→io, k7, no bias)
#   RU(c, d) x + conv(c→c, k1)(snake(conv(c→c, k, dilation d)(snake(x))))
#
# Every convolution is weight-normalised, ``w = g · v / ‖v‖`` with the norm
# per slice of dim 0 (``torch.nn.utils.weight_norm``'s default: per output
# channel of a convolution, per input channel of a transpose convolution),
# recomputed from ``g`` and ``v`` at every call.  The params tree holds
# ``{"g", "v", "b"}`` a convolution (``v`` in PyTorch's layout, ``g`` of
# shape ``(v.shape[0], 1, 1)``, no ``b`` for the last) and ``{"alpha",
# "beta"}`` a SnakeBeta.  Activations are NCW.  The bottleneck is
# ``VAEBottleneck``'s: the encoder's 2·latent channels are mean and scale,
# ``stdev = softplus(scale) + 1e-4``, returned as ``mu = mean`` and
# ``logvar = 2·log(stdev)`` (fp32), each flattened channel-major to
# ``(B, latent · T / Π s)``, so the step's reparameterisation and loss
# apply unchanged.  Frames are interleaved: ``(B, io · T)`` holds sample
# ``t`` of channel ``c`` at ``io · t + c``, as a WAV stores it.

OOBLECK_DILATIONS = (1, 3, 9)
OOBLECK_MIN_STD = 1e-4
SNAKE_EPS = 1e-9


@dataclass(frozen=True)
class OobleckSpec:
    """The widths of an Oobleck VAE: ``channels`` C0..Cn (n stages),
    ``strides`` s0..s(n-1), the residual units' ``kernel``, the frames'
    ``io_channels`` and the bottleneck's ``latent_channels``."""

    channels: Tuple[int, ...]
    strides: Tuple[int, ...]
    kernel: int
    io_channels: int
    latent_channels: int

    @property
    def ratio(self) -> int:
        return math.prod(self.strides)

    def latent_dim(self, segment_length: int) -> int:
        """The flat latent size of a frame of ``segment_length`` samples;
        ``ValueError`` unless it holds whole steps of the downsampling."""
        step = self.io_channels * self.ratio
        if segment_length % step:
            raise ValueError(
                f"segment_length {segment_length} is not a multiple of "
                f"io_channels × Π strides = {step}")
        return self.latent_channels * (segment_length // step)


def _wn_conv(generator, in_ch: int, out_ch: int, kernel: int,
             where: str, bias: bool = True, transposed: bool = False
             ) -> dict:
    """A weight-normalised convolution's leaves with ``nn.Conv1d``'s (or
    ``nn.ConvTranspose1d``'s) init, U(±1/sqrt(fan_in)) for ``v`` and
    ``b``, fan_in being ``v``'s dim 1 times the kernel, and ``g = ‖v‖``, so
    that ``w = v`` at the start."""
    shape = (in_ch, out_ch, kernel) if transposed else (out_ch, in_ch, kernel)
    bound = 1.0 / math.sqrt(shape[1] * kernel)
    v = torch.empty(shape, device=where).uniform_(-bound, bound,
                                                   generator=generator)
    p = {"g": torch.linalg.vector_norm(v, dim=(1, 2), keepdim=True), "v": v}
    if bias:
        p["b"] = torch.empty(out_ch, device=where).uniform_(
            -bound, bound, generator=generator)
    return p


def _snake_params(channels: int, where: str) -> dict:
    return {"alpha": torch.zeros(channels, device=where),
            "beta": torch.zeros(channels, device=where)}


def _res_unit(generator, channels: int, kernel: int, where: str) -> dict:
    return {"act1": _snake_params(channels, where),
            "conv1": _wn_conv(generator, channels, channels, kernel, where),
            "act2": _snake_params(channels, where),
            "conv2": _wn_conv(generator, channels, channels, 1, where)}


def init_oobleck(generator: Optional[torch.Generator], spec: OobleckSpec,
                 device: torch.device | str | None = None) -> Params:
    """Fresh params tree of ``spec``, drawn in forward order on the CPU
    from ``generator`` (the same numbers for every target device), then
    moved to ``device``; on the ``meta`` device nothing is drawn."""
    device = torch.device(device or "cpu")
    where = "meta" if device.type == "meta" else "cpu"
    g, ch, k = generator, spec.channels, spec.kernel

    def units(c):
        return [_res_unit(g, c, k, where) for _ in OOBLECK_DILATIONS]

    encoder = {"conv_in": _wn_conv(g, spec.io_channels, ch[0], 7, where),
               "blocks": []}
    for i, s in enumerate(spec.strides):
        encoder["blocks"].append({
            "res": units(ch[i]), "act": _snake_params(ch[i], where),
            "down": _wn_conv(g, ch[i], ch[i + 1], 2 * s, where)})
    encoder["act"] = _snake_params(ch[-1], where)
    encoder["conv_out"] = _wn_conv(g, ch[-1], 2 * spec.latent_channels, 3,
                                   where)
    decoder = {"conv_in": _wn_conv(g, spec.latent_channels, ch[-1], 7,
                                   where), "blocks": []}
    for i in reversed(range(len(spec.strides))):
        s = spec.strides[i]
        decoder["blocks"].append({
            "act": _snake_params(ch[i + 1], where),
            "up": _wn_conv(g, ch[i + 1], ch[i], 2 * s, where,
                           transposed=True),
            "res": units(ch[i])})
    decoder["act"] = _snake_params(ch[0], where)
    decoder["conv_out"] = _wn_conv(g, ch[0], spec.io_channels, 7, where,
                                   bias=False)
    params = {"encoder": encoder, "decoder": decoder}
    return tree_map(lambda t: t.to(device), params)


def snake_plain(x: Tensor, alpha: Tensor, beta: Tensor) -> Tensor:
    """SnakeBeta on plain ops, in ``x``'s dtype: ``x + 1 / (e^beta + 1e-9)
    · sin²(e^alpha · x)``, ``alpha`` and ``beta`` one value a channel of
    ``x`` ``(B, C, L)``."""
    a = torch.exp(alpha)[:, None]
    inv = 1.0 / (torch.exp(beta)[:, None] + SNAKE_EPS)
    return x + inv * torch.square(torch.sin(a * x))


def weight_norm(p: dict) -> Tensor:
    """``g · v / ‖v‖``, the norm over every dim of ``v`` but the first."""
    with span("rvk.wnorm"):
        return torch._weight_norm(p["v"], p["g"], 0)


def _conv(p: dict, x: Tensor, stride: int = 1, padding: int = 0,
          dilation: int = 1) -> Tensor:
    return F.conv1d(x, weight_norm(p), p.get("b"), stride, padding, dilation)


def _res_apply(p: dict, x: Tensor, dilation: int, act: Callable) -> Tensor:
    k = p["conv1"]["v"].shape[-1]
    y = act(x, p["act1"]["alpha"], p["act1"]["beta"])
    y = _conv(p["conv1"], y, padding=(k - 1) * dilation // 2,
              dilation=dilation)
    y = act(y, p["act2"]["alpha"], p["act2"]["beta"])
    return x + _conv(p["conv2"], y)


def _act(p: dict, x: Tensor, act: Callable) -> Tensor:
    return act(x, p["alpha"], p["beta"])


def encode_oobleck(params: Params, x: Tensor, spec: OobleckSpec,
                   act: Callable = snake_plain) -> Tuple[Tensor, Tensor]:
    """Interleaved frames ``(B, io · T)`` → ``(mu, logvar)``, each fp32
    ``(B, latent · T / Π s)``.  ``act(x, alpha, beta)`` is SnakeBeta:
    :func:`snake_plain`, or ``ops/snake.py`` ``snake`` (the kernels)."""
    p = params["encoder"]
    rows = x.shape[0]
    h = x.reshape(rows, -1, spec.io_channels).transpose(1, 2)
    h = _conv(p["conv_in"], h, padding=3)
    for block, s in zip(p["blocks"], spec.strides):
        for unit, d in zip(block["res"], OOBLECK_DILATIONS):
            h = _res_apply(unit, h, d, act)
        h = _act(block["act"], h, act)
        h = _conv(block["down"], h, stride=s, padding=-(-s // 2))
    h = _conv(p["conv_out"], _act(p["act"], h, act), padding=1)
    mean, scale = h.float().chunk(2, dim=1)
    std = F.softplus(scale) + OOBLECK_MIN_STD
    # contiguous, as row 14's loss kernels take them (a view of the
    # channels' first half is not)
    return (mean.reshape(rows, -1).contiguous(),
            (2.0 * torch.log(std)).reshape(rows, -1))


def decode_oobleck(params: Params, z: Tensor, spec: OobleckSpec,
                   act: Callable = snake_plain) -> Tensor:
    """``z`` ``(B, latent · T / Π s)`` → interleaved frames ``(B, io ·
    T)``, in ``z``'s dtype (no tanh: the published decoder has none)."""
    p = params["decoder"]
    rows = z.shape[0]
    h = _conv(p["conv_in"], z.reshape(rows, spec.latent_channels, -1),
              padding=3)
    for block, s in zip(p["blocks"], reversed(spec.strides)):
        h = _act(block["act"], h, act)
        h = F.conv_transpose1d(h, weight_norm(block["up"]),
                               block["up"]["b"], s, -(-s // 2))
        for unit, d in zip(block["res"], OOBLECK_DILATIONS):
            h = _res_apply(unit, h, d, act)
    h = _conv(p["conv_out"], _act(p["act"], h, act), padding=3)
    return h.transpose(1, 2).reshape(rows, -1)

"""The model variants beside the dense VAE — the counterpart of the JAX
package's ``models/variants.py``:

* the deep/wide MLP VAE: encoder seg→h0→…→hk (ReLU each) → two latent
  heads; the decoder mirrors back to seg with a tanh output
  (:func:`init_deep` / :func:`encode_deep` / :func:`decode_deep`);
* the conv1d VAE over raw frames: strided convolutions down, transpose
  convolutions back (:func:`init_conv1d` / :func:`encode_conv1d` /
  :func:`decode_conv1d`).

Both reuse the dense VAE's reparameterization and loss (``models/vae.py``),
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
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from rawaudiovae_kelsey_tpu_torch.models.vae import (
    Linear,
    Params,
    forward_with,
    linear,
)
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

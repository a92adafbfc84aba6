"""Dense raw-audio VAE in PyTorch — the counterpart of the JAX package's
``models/vae.py``.

Architecture (reference ``rawvae/model.py:5-35``):

    encoder:  x(seg) → Linear(seg→n_units) → ReLU → {Linear(n_units→latent)}×2
    sample:   z = mu + eps * exp(0.5 * logvar),  eps ~ N(0, I)
    decoder:  z(latent) → Linear(latent→n_units) → ReLU → Linear(n_units→seg) → tanh

Two faces over one set of weights:

* :class:`DenseVAE`, an ``nn.Module`` with layers ``fc1 fc21 fc22 fc3 fc4``;
* functional ``encode`` / ``decode`` / ``reparameterize`` on a params dict
  ``{"fc1": {"w": (in, out), "b": (out,)}, ...}`` — the JAX package's tree
  and layout, so the same checkpoint and the same test inputs go through
  both packages.  ``DenseVAE.params()`` is that dict, sharing storage.

Weights are stored ``(in, out)`` (``x @ w + b``), not ``nn.Linear``'s
``(out, in)``; the initial distribution is ``nn.Linear``'s.  Noise comes
from an explicit ``torch.Generator``; it cannot reproduce JAX's threefry
stream, so parity is held with ``deterministic=True`` or injected eps.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
from torch import nn

Tensor = torch.Tensor
# the dense model's tree; the variants' trees hold lists of such layers
Params = Dict[str, Dict[str, Tensor]]

LAYERS = ("fc1", "fc21", "fc22", "fc3", "fc4")


class Linear(nn.Module):
    """``x @ w + b`` with ``w`` stored ``(in, out)``; initialised like
    ``nn.Linear.reset_parameters``: w and b both U(-1/sqrt(fan_in),
    1/sqrt(fan_in))."""

    def __init__(self, fan_in: int, fan_out: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        bound = 1.0 / math.sqrt(fan_in)
        self.w = nn.Parameter(
            torch.empty(fan_in, fan_out).uniform_(-bound, bound,
                                                  generator=generator))
        self.b = nn.Parameter(
            torch.empty(fan_out).uniform_(-bound, bound, generator=generator))

    def forward(self, x: Tensor) -> Tensor:
        return x @ self.w + self.b


class DenseVAE(nn.Module):
    """The 5-layer dense VAE (layer names mirror rawvae/model.py:13-17).
    Initialised on the CPU from ``generator`` (the same numbers for every
    target device), then moved to ``device``."""

    def __init__(self, segment_length: int, n_units: int, latent_dim: int,
                 generator: Optional[torch.Generator] = None,
                 device: torch.device | str | None = None):
        super().__init__()
        self.segment_length = segment_length
        self.fc1 = Linear(segment_length, n_units, generator)
        self.fc21 = Linear(n_units, latent_dim, generator)
        self.fc22 = Linear(n_units, latent_dim, generator)
        self.fc3 = Linear(latent_dim, n_units, generator)
        self.fc4 = Linear(n_units, segment_length, generator)
        if device is not None:
            self.to(device)

    @classmethod
    def from_params(cls, params: Params) -> "DenseVAE":
        """A module holding copies of a params dict's tensors."""
        seg, units = params["fc1"]["w"].shape
        latent = params["fc21"]["w"].shape[1]
        model = cls(seg, units, latent, device=params["fc1"]["w"].device)
        with torch.no_grad():
            for name in LAYERS:
                layer = getattr(model, name)
                layer.w.copy_(params[name]["w"])
                layer.b.copy_(params[name]["b"])
        return model

    def params(self) -> Params:
        """The functional params dict, sharing this module's storage."""
        return {name: {"w": getattr(self, name).w, "b": getattr(self, name).b}
                for name in LAYERS}

    def encode(self, x: Tensor) -> Tuple[Tensor, Tensor]:
        return encode(self.params(), x)

    def decode(self, z: Tensor) -> Tensor:
        return decode(self.params(), z)

    def forward(self, x: Tensor, generator: Optional[torch.Generator] = None,
                deterministic: bool = False) -> Tuple[Tensor, Tensor, Tensor]:
        return forward(self.params(), x, self.segment_length, generator,
                       deterministic)


def init_dense(generator: Optional[torch.Generator], segment_length: int,
               n_units: int, latent_dim: int,
               device: torch.device | str | None = None) -> Params:
    """Fresh params dict (detached tensors) with ``DenseVAE``'s init."""
    model = DenseVAE(segment_length, n_units, latent_dim, generator, device)
    return {name: {k: t.detach() for k, t in p.items()}
            for name, p in model.params().items()}


def linear(p: Dict[str, Tensor], x: Tensor) -> Tensor:
    return x @ p["w"] + p["b"]


def encode(params: Params, x: Tensor) -> Tuple[Tensor, Tensor]:
    """(batch, seg) → (mu, logvar), each (batch, latent).  model.py:19-21."""
    h1 = torch.relu(linear(params["fc1"], x))
    return linear(params["fc21"], h1), linear(params["fc22"], h1)


def reparameterize(mu: Tensor, logvar: Tensor,
                   generator: Optional[torch.Generator] = None,
                   deterministic: bool = False,
                   eps: Optional[Tensor] = None) -> Tensor:
    """z = mu + eps·exp(0.5·logvar).  model.py:23-26.  ``deterministic``
    returns the mean; ``eps`` injects the noise (tests feed both packages
    the same numbers), otherwise it is drawn from ``generator``, which must
    live on ``mu``'s device."""
    if deterministic:
        return mu
    std = torch.exp(0.5 * logvar)
    if eps is None:
        eps = torch.randn(mu.shape, generator=generator, device=mu.device,
                          dtype=mu.dtype)
    return mu + eps * std


def decode(params: Params, z: Tensor) -> Tensor:
    """(batch, latent) → (batch, seg), tanh-bounded.  model.py:28-30."""
    h3 = torch.relu(linear(params["fc3"], z))
    return torch.tanh(linear(params["fc4"], h3))


def loss_components(recon_x: Tensor, x: Tensor, mu: Tensor, logvar: Tensor,
                    kl_beta: float, segment_length: int,
                    reduction: str = "mean") -> Tuple[Tensor, Tensor, Tensor]:
    """``(loss, mse, kld)``: MSE + β·KLD, both mean-reduced by default
    (model.py:38-46; the comment there says "summed" but the code means —
    quirk #1, parity kept), or both summed with ``reduction="sum"``."""
    x = x.reshape(-1, segment_length)
    red = torch.mean if reduction == "mean" else torch.sum
    recon_loss = red(torch.square(recon_x - x))
    kld = -0.5 * red(1.0 + logvar - torch.square(mu) - torch.exp(logvar))
    return recon_loss + kl_beta * kld, recon_loss, kld


def loss_fn(recon_x: Tensor, x: Tensor, mu: Tensor, logvar: Tensor,
            kl_beta: float, segment_length: int,
            reduction: str = "mean") -> Tensor:
    """The loss alone; see :func:`loss_components`."""
    return loss_components(recon_x, x, mu, logvar, kl_beta, segment_length,
                           reduction)[0]


def forward(params: Params, x: Tensor, segment_length: int,
            generator: Optional[torch.Generator] = None,
            deterministic: bool = False) -> Tuple[Tensor, Tensor, Tensor]:
    """Full VAE pass; reshapes input to (-1, segment_length) like
    model.py:33's ``x.view(-1, segment_length)``."""
    return forward_with(lambda x: encode(params, x),
                        lambda z: decode(params, z), x, segment_length,
                        generator, deterministic)


def forward_with(encode_fn, decode_fn, x: Tensor, segment_length: int,
                 generator: Optional[torch.Generator] = None,
                 deterministic: bool = False) -> Tuple[Tensor, Tensor, Tensor]:
    """:func:`forward` over any family's ``encode_fn(x)`` /
    ``decode_fn(z)`` pair."""
    x = x.reshape(-1, segment_length)
    mu, logvar = encode_fn(x)
    z = reparameterize(mu, logvar, generator, deterministic)
    return decode_fn(z), mu, logvar

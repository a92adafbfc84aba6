"""In-kernel Gaussian sampling for the reparameterization step: the CUDA
counterpart of the JAX package's ``ops/rng.py`` (``pallas_reparameterize``,
``[tpu] rng = tpu_prng``).

``z = mu + eps · exp(0.5 · logvar)`` in one pass, with ``eps ~ N(0, 1)``
generated inside the kernel, so the noise never goes through device
memory.  The TPU kernel draws its bits from the TPU core's hardware PRNG,
seeded per batch tile; that stream exists on no other machine (the JAX
module says so itself).  Here the bits come from Philox4x32-10, a
counter-based generator: key = the two seed words, counter = the element's
position ``(column, row, 0, 0)``, words 0 and 1 of the block feed the
element's two uniforms.  The stream is a function of ``(seed, position)``
alone — not of the launch geometry, nor of the device: the plain version
below produces the same words bit for bit on the CPU.  After the bits the
arithmetic is the TPU kernel's: 23 mantissa bits packed into ``[1, 2)``,
flipped to ``(0, 1]`` so ``log`` never sees 0, and Box-Muller's cosine
branch.

Three parts, as for every op of this package: the plain version
(:func:`reparameterize_prng_ref`, integer tensor ops), the wrapper
(:func:`reparameterize_prng`: the plain version for CPU tensors, the kernel
of ``csrc/rng.cu`` for CUDA tensors, counted in ``.launches``, never a
fallback), and the differentiable entry point (:func:`reparameterize`, a
``torch.autograd.Function`` with the JAX module's VJP).

Under a mesh (``parallel/mesh.py``) each rank samples its own rows with
:func:`shard_seed`: its data index times ``0x85EBCA6B`` (JAX's
``-2048144789`` as a wrapping int32) XORed into word 0 of the seed, then
the same kernel — ``sharded_pallas_reparameterize`` of the JAX module.
Ranks draw distinct streams; ranks of one data index (model-axis peers)
draw the same words.  The JAX kernel also spreads its tile index into word
1; Philox's counter is the element's position, so no tile spread is
needed here.
"""

from __future__ import annotations

from typing import Tuple

import torch

from rawaudiovae_kelsey_tpu_torch.ops import _build
from rawaudiovae_kelsey_tpu_torch.ops.mlp import cuda_device, require

Tensor = torch.Tensor
SeedWords = Tuple[int, int]

_M32 = 0xFFFFFFFF
# Philox4x32: the two multipliers and the two Weyl key increments
_PHILOX_M0, _PHILOX_M1 = 0xD2511F53, 0xCD9E8D57
_PHILOX_W0, _PHILOX_W1 = 0x9E3779B9, 0xBB67AE85
_TWO_PI = 6.283185307179586
# the data index's spread into word 0 (Murmur3's odd mix constant)
_SHARD_SPREAD = 0x85EBCA6B


def seed_words(seed: int) -> SeedWords:
    """The low and high 32 bits of a (up to) 64-bit seed.  Both are used:
    one word alone would collide within a long run and replay a whole
    noise tensor (``parallel/step.py`` of the JAX package, lines 71-74)."""
    return seed & _M32, (seed >> 32) & _M32


def shard_seed(seed: SeedWords, index: int) -> SeedWords:
    """``seed`` for the rank at data index ``index``: ``index ·
    0x85EBCA6B`` (mod 2^32) XORed into word 0, word 1 kept (JAX
    ``ops/rng.py:118-166``, the fold ``sharded_pallas_reparameterize``
    makes before the kernel runs)."""
    return (seed[0] ^ (index * _SHARD_SPREAD)) & _M32, seed[1] & _M32


def _mulhilo(m: int, c: Tensor) -> Tuple[Tensor, Tensor]:
    """``(high, low)`` 32-bit halves of ``m · c`` for a 32-bit constant and
    int64 values below 2^32, through 16-bit limbs so that no intermediate
    passes 2^63."""
    p_lo = m * (c & 0xFFFF)                     # < 2^48
    p_hi = m * (c >> 16)                        # < 2^48
    low = p_lo + ((p_hi & 0xFFFF) << 16)        # < 2^49
    return ((p_hi >> 16) + (low >> 32)) & _M32, low & _M32


def philox_words_ref(seed: SeedWords, batch: int, latent: int,
                     device: torch.device | str = "cpu") -> Tensor:
    """Plain version of :func:`philox_words`: ten rounds of Philox4x32 in
    int64 tensor ops."""
    row = torch.arange(batch, device=device, dtype=torch.int64)[:, None]
    col = torch.arange(latent, device=device, dtype=torch.int64)[None, :]
    c0, c1 = col.expand(batch, latent), row.expand(batch, latent)
    c2 = c3 = torch.zeros((batch, latent), device=device, dtype=torch.int64)
    k0, k1 = seed[0] & _M32, seed[1] & _M32
    for _ in range(10):
        hi0, lo0 = _mulhilo(_PHILOX_M0, c0)
        hi1, lo1 = _mulhilo(_PHILOX_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0, k1 = (k0 + _PHILOX_W0) & _M32, (k1 + _PHILOX_W1) & _M32
    return torch.stack((c0, c1), dim=-1)


def philox_words(seed: SeedWords, batch: int, latent: int,
                 device: torch.device | str) -> Tensor:
    """The two 32-bit words behind each element's noise, ``(batch, latent,
    2)`` int64 in ``[0, 2^32)``: on a CUDA device from the kernel's own
    generator (``rvk_philox_words``), so a test can hold it against
    :func:`philox_words_ref` bit for bit."""
    device = torch.device(device)
    if device.type == "cpu":
        return philox_words_ref(seed, batch, latent)
    if device.type != "cuda":
        raise ValueError(f"philox_words: the kernel runs on CUDA, got "
                         f"{device}")
    words = torch.empty((batch, latent, 2), device=device, dtype=torch.int32)
    _build.launch("rvk_philox_words", device, seed[0] & _M32, seed[1] & _M32,
                  words, batch, latent)
    return words.to(torch.int64) & _M32


def _unit_open(bits: Tensor) -> Tensor:
    """int64 words → float32 in (0, 1]: 23 bits into the mantissa of
    [1, 2), then ``2 - v`` (``_bits_to_unit_open`` of the JAX module)."""
    packed = ((bits & 0x007FFFFF) | 0x3F800000).to(torch.int32)
    return 2.0 - packed.view(torch.float32)


def eps_ref(seed: SeedWords, batch: int, latent: int,
            device: torch.device | str = "cpu") -> Tensor:
    """The standard normal noise of the sampler, ``(batch, latent)`` fp32:
    Box-Muller's cosine branch over the Philox words."""
    words = philox_words_ref(seed, batch, latent, device)
    u1, u2 = _unit_open(words[..., 0]), _unit_open(words[..., 1])
    return torch.sqrt(-2.0 * torch.log(u1)) * torch.cos(_TWO_PI * u2)


def reparameterize_prng_ref(seed: SeedWords, mu: Tensor, logvar: Tensor
                            ) -> Tensor:
    """Plain version of :func:`reparameterize_prng`: the same words, the
    same packing, the same Box-Muller, in tensor ops on ``mu``'s device."""
    eps = eps_ref(seed, mu.shape[0], mu.shape[1], mu.device)
    z = mu.float() + eps * torch.exp(0.5 * logvar.float())
    return z.to(mu.dtype)


def reparameterize_prng(seed: SeedWords, mu: Tensor, logvar: Tensor
                        ) -> Tensor:
    """``z = mu + eps · exp(0.5 · logvar)`` with ``eps`` drawn inside the
    kernel from Philox4x32-10 keyed by ``seed`` (two 32-bit words).
    ``mu``, ``logvar`` ``(batch, latent)`` fp32; ``z`` likewise.

    Replaces ``rawaudiovae_kelsey_tpu/ops/rng.py``
    ``pallas_reparameterize``.  CUDA: one launch (``csrc/rng.cu``), one
    thread per element; a ragged batch is masked in the kernel."""
    if mu.device.type == "cpu":
        return reparameterize_prng_ref(seed, mu, logvar)
    dev = cuda_device(mu, "reparameterize_prng: mu")
    batch, latent = mu.shape
    require(mu, "mu", (batch, latent), dev)
    require(logvar, "logvar", (batch, latent), dev)
    z = torch.empty_like(mu)
    if batch:
        _build.launch("rvk_reparameterize", dev, seed[0] & _M32,
                      seed[1] & _M32, mu, logvar, z, batch, latent)
        reparameterize_prng.launches += 1
    return z


reparameterize_prng.launches = 0


class Reparameterize(torch.autograd.Function):
    """``(mu, logvar, seed0, seed1) → z`` through
    :func:`reparameterize_prng`.  With ``eps`` independent of the inputs,
    ``dz/dmu = 1`` and ``dz/dlogvar = ½ · eps · std = ½ · (z − mu)``: the
    residuals are ``(mu, z)``, never ``eps``.  The backward is plain tensor
    ops, as it is plain ``jnp`` in the JAX module."""

    @staticmethod
    def forward(ctx, mu, logvar, seed0, seed1):
        z = reparameterize_prng((seed0, seed1), mu, logvar)
        ctx.save_for_backward(mu, z)
        return z

    @staticmethod
    def backward(ctx, g):
        mu, z = ctx.saved_tensors
        return g, 0.5 * (z - mu) * g, None, None


def reparameterize(seed: SeedWords, mu: Tensor, logvar: Tensor) -> Tensor:
    """Differentiable :func:`reparameterize_prng` (the role of the JAX
    module's custom VJP)."""
    return Reparameterize.apply(mu, logvar, seed[0], seed[1])

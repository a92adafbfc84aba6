"""The port's in-kernel sampler (rawaudiovae_kelsey_tpu_torch/ops/rng.py,
queue B row 13) on the CPU: its plain version — Philox4x32-10 in integer
tensor ops, the TPU kernel's bit packing and Box-Muller — against published
Philox vectors, against its own contracts, and against the JAX package's
``pallas_reparameterize``.

The two packages cannot share a stream: the TPU kernel draws from the TPU
core's hardware PRNG, and off the TPU the JAX function runs a threefry
Box-Muller instead (``ops/rng.py:86-97`` there), which is what runs here.
So the comparison is statistical: same distribution, different numbers.

Tolerances over N = 262144 standard normal samples: the mean's standard
error is N^-1/2 ≈ 2e-3 and the variance's (2/N)^1/2 ≈ 2.8e-3, held at 1e-2
and 1.5e-2 (about 5 sigma); the 1 % and 99 % quantiles (±2.326) have a
standard error of ≈ 7.3e-3 each, and two independent estimates differ by
≈ 1e-2, held at 5e-2.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rawaudiovae_kelsey_tpu.ops.rng import pallas_reparameterize
from rawaudiovae_kelsey_tpu_torch import ops
from rawaudiovae_kelsey_tpu_torch.ops import rng

N_ROWS, LATENT = 1024, 256          # 262144 samples


def test_philox_matches_the_published_vectors():
    """Random123's known-answer tests for philox4x32-10 (kat_vectors):
    counter and key all zero, all ones, and the digits of pi.  The plain
    version returns words 0 and 1 of the block for counter (col, row, 0,
    0); the vectors with a zero upper counter are reachable through it."""
    got = rng.philox_words_ref((0, 0), 1, 1)[0, 0].tolist()
    assert got == [0x6627E8D5, 0xE169C58D]
    # ctr = (0xffffffff,)*4 is not reachable (c2 = c3 = 0 here); check the
    # round function itself on all three vectors instead
    vectors = [
        ((0, 0, 0, 0), (0, 0),
         (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
        ((0xFFFFFFFF,) * 4, (0xFFFFFFFF,) * 2,
         (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
        ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344),
         (0xA4093822, 0x299F31D0),
         (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
    ]
    for ctr, key, want in vectors:
        c = [torch.tensor([v], dtype=torch.int64) for v in ctr]
        k0, k1 = key
        for _ in range(10):
            hi0, lo0 = rng._mulhilo(rng._PHILOX_M0, c[0])
            hi1, lo1 = rng._mulhilo(rng._PHILOX_M1, c[2])
            c = [hi1 ^ c[1] ^ k0, lo1, hi0 ^ c[3] ^ k1, lo0]
            k0 = (k0 + rng._PHILOX_W0) & 0xFFFFFFFF
            k1 = (k1 + rng._PHILOX_W1) & 0xFFFFFFFF
        assert tuple(int(v) for v in c) == want


def test_words_depend_on_position_alone():
    """Element (row, col) gets the same words whatever batch it sits in:
    the stream is a function of (seed, position), not of the shape."""
    big = rng.philox_words_ref((11, 22), 40, 16)
    small = rng.philox_words_ref((11, 22), 7, 16)
    assert torch.equal(big[:7], small)
    narrow = rng.philox_words_ref((11, 22), 40, 5)
    assert torch.equal(big[:, :5], narrow)
    assert int(big.min()) >= 0 and int(big.max()) < 2 ** 32


def test_uniforms_lie_in_the_half_open_unit_interval():
    bits = torch.tensor([0, 1, 0x7FFFFF, 0xFFFFFFFF, 0x800000],
                        dtype=torch.int64)
    u = rng._unit_open(bits)
    assert u.dtype == torch.float32
    assert u.tolist() == [1.0, 2.0 - (1.0 + 2.0 ** -23), 2.0 ** -23,
                          2.0 ** -23, 1.0]


def test_eps_moments():
    eps = rng.eps_ref((2024, 7), N_ROWS, LATENT)
    assert eps.shape == (N_ROWS, LATENT) and eps.dtype == torch.float32
    assert bool(torch.isfinite(eps).all())
    assert abs(float(eps.mean())) < 1e-2
    assert abs(float(eps.var()) - 1.0) < 1.5e-2
    # rows and columns are uncorrelated streams
    assert abs(float((eps[:-1] * eps[1:]).mean())) < 1e-2
    assert abs(float((eps[:, :-1] * eps[:, 1:]).mean())) < 1e-2


def test_sampler_is_reproducible_and_uses_both_seed_words():
    """The JAX test ``test_pallas_reparameterize_uses_both_seed_words``:
    seeds that differ in only the high word draw different noise."""
    g = torch.Generator().manual_seed(0)
    mu = torch.randn((64, 8), generator=g)
    logvar = torch.randn((64, 8), generator=g) * 0.1
    a = ops.reparameterize_prng((5, 0), mu, logvar)
    assert torch.equal(a, ops.reparameterize_prng((5, 0), mu, logvar))
    assert not torch.equal(a, ops.reparameterize_prng((5, 1), mu, logvar))
    assert not torch.equal(a, ops.reparameterize_prng((6, 0), mu, logvar))
    assert a.dtype == mu.dtype and a.shape == mu.shape
    # z = mu + eps * std with the sampler's own eps
    want = mu + rng.eps_ref((5, 0), 64, 8) * torch.exp(0.5 * logvar)
    assert torch.equal(a, want)


def test_seed_words_split_a_64_bit_seed():
    assert rng.seed_words(0x123456789ABCDEF0) == (0x9ABCDEF0, 0x12345678)
    assert rng.seed_words(7) == (7, 0)


def test_backward_formula_matches_autograd_of_the_plain_version():
    """dmu = g and dlogvar = ½·(z − mu)·g (``ops/rng.py:174-181`` of the
    JAX package) equal autograd through ``mu + eps·exp(½·logvar)``."""
    g = torch.Generator().manual_seed(1)
    mu = torch.randn((33, 8), generator=g)
    logvar = torch.randn((33, 8), generator=g) * 0.3
    cot = torch.randn((33, 8), generator=g)

    a, b = mu.clone().requires_grad_(), logvar.clone().requires_grad_()
    (rng.reparameterize((9, 4), a, b) * cot).sum().backward()

    c, d = mu.clone().requires_grad_(), logvar.clone().requires_grad_()
    eps = rng.eps_ref((9, 4), 33, 8)
    ((c + eps * torch.exp(0.5 * d)) * cot).sum().backward()
    assert torch.equal(a.grad, c.grad)
    torch.testing.assert_close(b.grad, d.grad, atol=1e-6, rtol=1e-5)


def test_cpu_wrapper_launches_nothing_and_refuses_other_devices():
    before = ops.reparameterize_prng.launches
    z = torch.zeros((4, 8))
    ops.reparameterize_prng((1, 2), z, z)
    assert ops.reparameterize_prng.launches == before
    meta = torch.empty((4, 8), device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        ops.reparameterize_prng((1, 2), meta, meta)
    with pytest.raises(ValueError, match="CUDA"):
        rng.philox_words((1, 2), 4, 8, "meta")


def test_same_distribution_as_the_jax_sampler():
    """Mean, variance and the 1 % / 99 % quantiles of ``(z − mu) / std``
    from both packages over 262144 samples, on the same ``mu`` and
    ``logvar``."""
    nrng = np.random.default_rng(3)
    mu = nrng.standard_normal((N_ROWS, LATENT)).astype(np.float32)
    logvar = (0.5 * nrng.standard_normal((N_ROWS, LATENT))).astype(np.float32)
    std = np.exp(0.5 * logvar)

    z_port = ops.reparameterize_prng(
        (123, 456), torch.from_numpy(mu), torch.from_numpy(logvar)).numpy()
    z_jax = np.asarray(pallas_reparameterize(
        jnp.asarray([123, 456], jnp.int32), jnp.asarray(mu),
        jnp.asarray(logvar)))
    e_port, e_jax = (z_port - mu) / std, (z_jax - mu) / std
    for e in (e_port, e_jax):
        assert np.isfinite(e).all()
        assert abs(e.mean()) < 1e-2
        assert abs(e.var() - 1.0) < 1.5e-2
    for q in (0.01, 0.99):
        assert abs(np.quantile(e_port, q) - np.quantile(e_jax, q)) < 5e-2
    # different streams: the two draws are uncorrelated
    assert abs(float((e_port * e_jax).mean())) < 1e-2

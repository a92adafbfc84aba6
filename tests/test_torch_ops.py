"""The port's dense-VAE ops (rawaudiovae_kelsey_tpu_torch/ops) against the
JAX package's Pallas kernels.

On the CPU the JAX side runs its Pallas kernels in interpret mode, as
tests/test_pallas.py does, and the port's wrappers run their plain PyTorch
versions, because the tensors lie on the CPU.  The same inputs, made from
a numpy seed, and the same weights (carried with ``params_from_jax``) go
through both.

Tolerances: fp32 ``atol=1e-6, rtol=1e-5`` — the tests/test_model_parity.py
bound.  Both sides form the same fp32 products; only the order of the sums
differs (XLA's CPU dot vs PyTorch's), which moves the last bits of results
of order 1.  The int8 decoder is held at ``atol=1e-5`` as
tests/test_quant.py holds the JAX kernel to its own reference.

The hand-written kernels themselves run only on a GPU:
tests/test_torch_cuda.py and ``python3 chip_smoke.py`` hold them against
the plain versions there.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rawaudiovae_kelsey_tpu.models import vae as jvae
from rawaudiovae_kelsey_tpu.ops import pallas_mlp as jmlp
from rawaudiovae_kelsey_tpu.ops import quant as jquant
from rawaudiovae_kelsey_tpu_torch import ops
from rawaudiovae_kelsey_tpu_torch.compat import params_from_jax
from rawaudiovae_kelsey_tpu_torch.ops import mlp, quant

SEG, UNITS, LATENT = 256, 512, 64
ATOL, RTOL = 1e-6, 1e-5
QUANT_ATOL = 1e-5

ENC = [(layer, k) for layer in ("fc1", "fc21", "fc22") for k in ("w", "b")]
DEC = [(layer, k) for layer in ("fc3", "fc4") for k in ("w", "b")]


@pytest.fixture(scope="module")
def jparams():
    return jax.device_get(
        jvae.init_dense(jax.random.PRNGKey(0), SEG, UNITS, LATENT))


@pytest.fixture(scope="module")
def tparams(jparams):
    return params_from_jax(jparams)


def _x(batch, seed=0):
    return np.random.default_rng(seed).uniform(
        -1, 1, (batch, SEG)).astype(np.float32)


def _z(batch, seed=1):
    return np.random.default_rng(seed).standard_normal(
        (batch, LATENT)).astype(np.float32)


def _close(got, want, atol=ATOL, rtol=RTOL):
    got = got.numpy()
    want = np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_allclose(got, want, atol=atol, rtol=rtol)


@pytest.mark.parametrize("batch", [100, 128])
def test_encoder_fwd_matches_jax_kernel(jparams, tparams, batch):
    x = _x(batch)
    want = jmlp.encoder_fwd(*[jparams[n][k] for n, k in ENC], jnp.asarray(x))
    got = mlp.encoder_fwd(*[tparams[n][k] for n, k in ENC],
                          torch.from_numpy(x))
    for g, w in zip(got, want):  # mu, logvar, h
        _close(g, w)


@pytest.mark.parametrize("batch", [100, 128])
def test_decoder_fwd_matches_jax_kernel(jparams, tparams, batch):
    z = _z(batch)
    want = jmlp.decoder_fwd(*[jparams[n][k] for n, k in DEC], jnp.asarray(z))
    got = mlp.decoder_fwd(*[tparams[n][k] for n, k in DEC],
                          torch.from_numpy(z))
    for g, w in zip(got, want):  # y, h3
        _close(g, w)


def test_encode_decode_entry_points_match_jax_pallas(jparams, tparams):
    x = _x(64, seed=3)
    jmu, jlv = jmlp.pallas_encode(jparams, jnp.asarray(x))
    mu, lv = mlp.encode(tparams, torch.from_numpy(x))
    _close(mu, jmu)
    _close(lv, jlv)
    _close(mlp.decode(tparams, mu), jmlp.pallas_decode(jparams, jmu))


def test_cpu_wrappers_run_the_plain_version_without_launching(tparams):
    x = torch.from_numpy(_x(37))
    z = torch.from_numpy(_z(37))
    qp = quant.quantize_decoder(tparams)
    before = [w.launches for w in ops.KERNEL_WRAPPERS]
    for got, want in (
        (mlp.encoder_fwd(*[tparams[n][k] for n, k in ENC], x),
         mlp.encoder_fwd_ref(*[tparams[n][k] for n, k in ENC], x)),
        (mlp.decoder_fwd(*[tparams[n][k] for n, k in DEC], z),
         mlp.decoder_fwd_ref(*[tparams[n][k] for n, k in DEC], z)),
        ((quant.quantized_decoder_fwd(qp, z),),
         (quant.quantized_decode_ref(qp, z),)),
    ):
        for g, w in zip(got, want):
            assert torch.equal(g, w)
    assert [w.launches for w in ops.KERNEL_WRAPPERS] == before


@pytest.mark.parametrize("op", ["encoder_fwd", "decoder_fwd",
                                "quantized_decoder_fwd"])
def test_wrappers_refuse_tensors_off_cpu_and_cuda(tparams, op):
    """Only a CPU tensor takes the plain version; anything else must be a
    CUDA tensor the kernel launches on, or the wrapper raises."""
    meta = {n: {k: t.to("meta") for k, t in p.items()}
            for n, p in tparams.items()}
    x = torch.empty((8, SEG), device="meta")
    z = torch.empty((8, LATENT), device="meta")
    call = {
        "encoder_fwd": lambda: mlp.encoder_fwd(
            *[meta[n][k] for n, k in ENC], x),
        "decoder_fwd": lambda: mlp.decoder_fwd(
            *[meta[n][k] for n, k in DEC], z),
        "quantized_decoder_fwd": lambda: quant.quantized_decoder_fwd(
            {n: {"q": torch.empty(meta[n]["w"].shape, dtype=torch.int8,
                                  device="meta"),
                 "scale": torch.empty((1, meta[n]["w"].shape[1]),
                                      device="meta"),
                 "b": meta[n]["b"]} for n in ("fc3", "fc4")}, z),
    }[op]
    with pytest.raises(ValueError, match="CUDA"):
        call()


def test_quantize_weight_identical_to_jax():
    rng = np.random.default_rng(0)
    w = rng.standard_normal((128, 256)).astype(np.float32)
    w[:, 0] = 0.0                       # all-zero column → scale 1.0
    w[:, 1] = np.float32(127.0 / 2)     # exact half-way rounding cases
    w[3, 1] = np.float32(127.0)
    jq, js = jquant.quantize_weight(jnp.asarray(w))
    q, s = quant.quantize_weight(torch.from_numpy(w))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    assert q.shape == (128, 256) and s.shape == (1, 256)
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    assert float(s[0, 0]) == 1.0 and int(q[:, 0].abs().max()) == 0


def test_quantize_decoder_identical_to_jax(jparams, tparams):
    jq = jax.device_get(jquant.quantize_decoder(jparams))
    tq = quant.quantize_decoder(tparams)
    for layer in ("fc3", "fc4"):
        for k in ("q", "scale", "b"):
            np.testing.assert_array_equal(tq[layer][k].numpy(),
                                          np.asarray(jq[layer][k]))
    deq = quant.dequantize_weight(tq["fc4"]["q"], tq["fc4"]["scale"])
    np.testing.assert_array_equal(deq.numpy(), np.asarray(
        jquant.dequantize_weight(jq["fc4"]["q"], jq["fc4"]["scale"])))


@pytest.mark.parametrize("batch", [100, 128])
def test_quantized_decoder_fwd_matches_jax_kernel(jparams, tparams, batch):
    z = _z(batch, seed=2)
    want = jquant.quantized_decoder_fwd(jquant.quantize_decoder(jparams),
                                        jnp.asarray(z))
    got = quant.quantized_decoder_fwd(quant.quantize_decoder(tparams),
                                      torch.from_numpy(z))
    _close(got, want, atol=QUANT_ATOL, rtol=0)

"""The port's hand-written CUDA kernels on a GPU, against their plain
PyTorch versions on the same card.  Every test here carries the ``cuda``
marker and skips where ``torch.cuda.is_available()`` is false.

This file imports no JAX (the GPU machine has none).  tests/conftest.py
does, so on the GPU run this file alone without it:

    python -m pytest tests/test_torch_cuda.py --noconftest -m cuda -q

Tolerance ``1e-4`` absolute: kernel and plain are both fp32 (TF32 off)
and form the same products, summed in another order over K <= 2048;
measured differences are ~1e-6, while an indexing or masking fault shows
as 1e-2 or more.
"""

import numpy as np
import pytest
import torch

from rawaudiovae_kelsey_tpu_torch import ops
from rawaudiovae_kelsey_tpu_torch.ops import mlp, quant

ATOL = 1e-4
ENC = [(layer, k) for layer in ("fc1", "fc21", "fc22") for k in ("w", "b")]
DEC = [(layer, k) for layer in ("fc3", "fc4") for k in ("w", "b")]

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (python3 chip_smoke.py checks the "
                    "kernels on the card)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", torch.cuda.current_device())


def _params(device, seg=1024, units=2048, latent=256):
    from rawaudiovae_kelsey_tpu_torch.models.vae import init_dense

    return init_dense(torch.Generator().manual_seed(0), seg, units, latent,
                      device)


@pytest.mark.parametrize("batch", [1, 100, 256, 300])
def test_kernels_match_plain_versions(cuda, batch):
    p = _params(cuda)
    g = torch.Generator(device=cuda).manual_seed(batch)
    x = torch.rand((batch, 1024), generator=g, device=cuda) * 2 - 1
    z = torch.randn((batch, 256), generator=g, device=cuda)
    qp = quant.quantize_decoder(p)
    before = [w.launches for w in ops.KERNEL_WRAPPERS]
    pairs = [
        (mlp.encoder_fwd(*[p[a][k] for a, k in ENC], x),
         mlp.encoder_fwd_ref(*[p[a][k] for a, k in ENC], x)),
        (mlp.decoder_fwd(*[p[a][k] for a, k in DEC], z),
         mlp.decoder_fwd_ref(*[p[a][k] for a, k in DEC], z)),
        ((quant.quantized_decoder_fwd(qp, z),),
         (quant.quantized_decode_ref(qp, z),)),
    ]
    torch.cuda.synchronize()
    for got, want in pairs:
        for a, b in zip(got, want):
            assert a.shape == b.shape and a.device == b.device
            torch.testing.assert_close(a, b, atol=ATOL, rtol=0)
    assert [w.launches for w in ops.KERNEL_WRAPPERS] == \
        [n + 1 for n in before]


def test_kernels_at_odd_widths(cuda):
    """Every edge (batch, output width, depth) is masked in the kernel."""
    p = _params(cuda, seg=200, units=333, latent=37)
    x = torch.rand((45, 200), device=cuda)
    z = torch.randn((45, 37), device=cuda)
    for got, want in (
        (mlp.encoder_fwd(*[p[a][k] for a, k in ENC], x),
         mlp.encoder_fwd_ref(*[p[a][k] for a, k in ENC], x)),
        (mlp.decoder_fwd(*[p[a][k] for a, k in DEC], z),
         mlp.decoder_fwd_ref(*[p[a][k] for a, k in DEC], z)),
    ):
        for a, b in zip(got, want):
            torch.testing.assert_close(a, b, atol=ATOL, rtol=0)


def test_wrappers_raise_on_what_the_kernel_does_not_take(cuda):
    p = _params(cuda, seg=256, units=512, latent=64)
    w = [p[a][k] for a, k in ENC]
    x = torch.zeros((4, 256), device=cuda)
    with pytest.raises(TypeError, match="dtype"):
        mlp.encoder_fwd(*w, x.double())
    with pytest.raises(ValueError, match="contiguous"):
        mlp.encoder_fwd(*w, torch.zeros((256, 4), device=cuda).t())
    with pytest.raises(ValueError, match="shape"):
        mlp.encoder_fwd(*w, torch.zeros((4, 257), device=cuda))
    with pytest.raises(ValueError, match="on cpu"):
        mlp.encoder_fwd(*[t.cpu() for t in w], x)


def test_server_on_the_card_matches_the_plain_backend(cuda):
    from rawaudiovae_kelsey_tpu_torch.config import Config
    from rawaudiovae_kelsey_tpu_torch.infer import InferenceServer
    from rawaudiovae_kelsey_tpu_torch.models import build_model

    cfg = Config()
    outs = {}
    audio = np.random.default_rng(0).uniform(-0.5, 0.5, 30000) \
        .astype(np.float32)
    for backend in ("pallas", "xla"):
        cfg.tpu.backend = backend
        model = build_model(cfg, cuda)
        params = model.init(torch.Generator().manual_seed(3))
        with InferenceServer(model, params, deterministic=True) as s:
            outs[backend] = s.reconstruct(audio, hop=128, ola=True).result(60)
    np.testing.assert_allclose(outs["pallas"], outs["xla"], atol=ATOL)

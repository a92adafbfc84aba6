"""The port's fused loss ops (rawaudiovae_kelsey_tpu_torch/ops/loss.py:
``loss_sums``, ``fused_loss``, ``fused_loss_components`` — queue B row 14)
against the JAX package's ``ops/pallas_loss.py`` and against both packages'
``models/vae.py`` loss, on the cases of tests/test_pallas.py.

On the CPU the JAX side runs its Pallas kernel in interpret mode and the
port's wrapper runs its plain version, because the tensors lie on the CPU.
Inputs come from numpy seeds and go to both packages.

Tolerances: values rel 1e-6 (fp32 sums in another order); the closed-form
input gradients ``atol=1e-7, rtol=1e-5`` — the same elementwise formula on
both sides.

Beside them, without JAX: ``loss_grads`` (the backward's kernel) against
autograd through ``models/vae.py``'s loss, ``takes_fused_loss`` (the rule
that puts the train step's loss on the kernels) on its inputs, and what
reaches the two C entry points, on ``meta`` tensors with the launch
recorded.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rawaudiovae_kelsey_tpu.models import vae as jvae
from rawaudiovae_kelsey_tpu_torch.models import vae
from rawaudiovae_kelsey_tpu_torch.ops import loss

# the module: ``rawaudiovae_kelsey_tpu.ops`` re-exports a function of the
# same name over it
jloss = importlib.import_module("rawaudiovae_kelsey_tpu.ops.pallas_loss")

SEG, LATENT, BETA = 64, 16, 1e-4
BATCHES = [200, 64, 37]     # 200, 37: not a multiple of the JAX 128-row tile
REDUCTIONS = ["mean", "sum"]


def _inputs(seed, n):
    rng = np.random.default_rng(seed)
    return (rng.uniform(-1, 1, (n, SEG)).astype(np.float32),
            rng.uniform(-1, 1, (n, SEG)).astype(np.float32),
            rng.standard_normal((n, LATENT)).astype(np.float32),
            (rng.standard_normal((n, LATENT)) * 0.3).astype(np.float32))


def _t(arrays, grad=False):
    return [torch.from_numpy(a.copy()).requires_grad_(grad) for a in arrays]


@pytest.mark.parametrize("n", BATCHES)
def test_loss_sums_match_jax_kernel(n):
    arrays = _inputs(0, n)
    sq, kl = loss.loss_sums(*_t(arrays))
    jsq, jkl, jn = jloss._loss_sums(*map(jnp.asarray, arrays))
    assert int(jn) == n
    assert sq.dtype == kl.dtype == torch.float32 and sq.dim() == 0
    assert float(sq) == pytest.approx(float(jsq), rel=1e-6)
    assert float(kl) == pytest.approx(float(jkl), rel=1e-6)


def test_loss_sums_take_bf16_and_mixed_inputs():
    arrays = _inputs(3, 37)
    r, x, mu, lv = _t(arrays)
    want = loss.loss_sums_ref(r.bfloat16(), x.bfloat16(), mu, lv)
    got = loss.loss_sums(r.bfloat16(), x.bfloat16(), mu, lv)
    assert all(t.dtype == torch.float32 for t in loss._same_dtype(
        r.bfloat16(), x.bfloat16(), mu, lv))
    assert all(t.dtype == torch.bfloat16 for t in loss._same_dtype(
        r.bfloat16(), x.bfloat16()))
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    jsq, jkl, _ = jloss._loss_sums(
        jnp.asarray(arrays[0]).astype(jnp.bfloat16),
        jnp.asarray(arrays[1]).astype(jnp.bfloat16),
        jnp.asarray(arrays[2]), jnp.asarray(arrays[3]))
    # bf16 differences are coarse (2^-8 steps), so the order of the fp32
    # additions shows a little more: rel 1e-5 (measured 1.5e-6)
    assert float(got[0]) == pytest.approx(float(jsq), rel=1e-5)
    assert float(got[1]) == pytest.approx(float(jkl), rel=1e-5)
    # mixed dtypes are brought to fp32
    mixed = loss.loss_sums(r, x.bfloat16(), mu.bfloat16(), lv)
    want = loss.loss_sums_ref(r, x.bfloat16().float(), mu.bfloat16().float(),
                              lv)
    assert all(torch.equal(a, b) for a, b in zip(mixed, want))


@pytest.mark.parametrize("reduction", REDUCTIONS)
@pytest.mark.parametrize("n", BATCHES)
def test_fused_loss_value_and_grads_match_jax_and_vae(n, reduction):
    arrays = _inputs(0, n)
    js = list(map(jnp.asarray, arrays))
    ts = _t(arrays, grad=True)
    got = loss.fused_loss(*ts, BETA, reduction)
    want = float(jloss.pallas_loss(*js, BETA, reduction))
    value = float(got.detach())
    assert value == pytest.approx(want, rel=1e-6)
    for ref in (float(jvae.loss_fn(*js, BETA, SEG, reduction)),
                float(vae.loss_fn(*_t(arrays), BETA, SEG, reduction))):
        assert value == pytest.approx(ref, rel=1e-6)

    got.backward()
    jg = jax.grad(lambda *a: jloss.pallas_loss(*a, BETA, reduction),
                  argnums=(0, 1, 2, 3))(*js)
    vg = jax.grad(lambda *a: jvae.loss_fn(*a, BETA, SEG, reduction),
                  argnums=(0, 1, 2, 3))(*js)
    for t, a, b in zip(ts, jg, vg):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(a),
                                   atol=1e-7, rtol=1e-5)
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(b),
                                   atol=1e-7, rtol=1e-5)
    # against autograd of the port's own plain loss
    ps = _t(arrays, grad=True)
    vae.loss_fn(*ps, BETA, SEG, reduction).backward()
    for t, p in zip(ts, ps):
        torch.testing.assert_close(t.grad, p.grad, atol=1e-7, rtol=1e-5)


@pytest.mark.parametrize("reduction", REDUCTIONS)
def test_fused_loss_components_match_jax_and_vae(reduction):
    arrays = _inputs(1, 64)
    js = list(map(jnp.asarray, arrays))
    ts = _t(arrays, grad=True)
    got = loss.fused_loss_components(*ts, BETA, reduction)
    want = jloss.pallas_loss_components(*js, BETA, reduction)
    ref = jvae.loss_components(*js, BETA, SEG, reduction)
    mine = vae.loss_components(*_t(arrays), BETA, SEG, reduction)
    for g, w, r, m in zip(got, want, ref, mine):
        g = float(g.detach())
        assert g == pytest.approx(float(w), rel=1e-6)
        assert g == pytest.approx(float(r), rel=1e-6)
        assert g == pytest.approx(float(m), rel=1e-6)

    # cotangents on all three outputs combine linearly
    c = (1.0, 0.5, -2.0)
    sum(ci * gi for ci, gi in zip(c, got)).backward()

    def jtotal(*a):
        out = jloss.pallas_loss_components(*a, BETA, reduction)
        return sum(ci * oi for ci, oi in zip(c, out))

    def vtotal(*a):
        out = jvae.loss_components(*a, BETA, SEG, reduction)
        return sum(ci * oi for ci, oi in zip(c, out))

    jg = jax.grad(jtotal, argnums=(0, 1, 2, 3))(*js)
    vg = jax.grad(vtotal, argnums=(0, 1, 2, 3))(*js)
    for t, a, b in zip(ts, jg, vg):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(a),
                                   atol=1e-7, rtol=1e-5)
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(b),
                                   atol=1e-7, rtol=1e-5)


def test_fused_loss_skips_gradients_nobody_asked_for():
    r, x, mu, lv = _t(_inputs(2, 8))
    r.requires_grad_()
    loss.fused_loss(r, x, mu, lv, BETA).backward()
    assert r.grad is not None and x.grad is None and mu.grad is None


def test_unknown_reduction_raises():
    ts = _t(_inputs(2, 8))
    with pytest.raises(ValueError, match="reduction"):
        loss.fused_loss(*ts, BETA, "median")
    with pytest.raises(ValueError, match="reduction"):
        loss.fused_loss_components(*ts, BETA, "median")


def test_cuda_wrapper_refuses_what_the_kernel_does_not_take():
    """On a CPU tensor the wrapper takes the plain version; the checks that
    guard the kernel are plain Python and run here."""
    from rawaudiovae_kelsey_tpu_torch.ops import mlp

    with pytest.raises(ValueError, match="CUDA"):
        mlp.cuda_device(torch.zeros(2, 2), "recon")
    with pytest.raises(TypeError, match="dtype"):
        mlp.operand_dtype(torch.zeros(2, 2, dtype=torch.float64), "recon")
    assert loss.loss_sums.launches == 0


def _bf16_ulps(a, b):
    """Elementwise distance of two bf16 tensors of one sign, in ulps."""
    return (a.view(torch.int16).int() - b.view(torch.int16).int()).abs()


@pytest.mark.parametrize("reduction", REDUCTIONS)
@pytest.mark.parametrize("kind", ["fp32", "bf16-recon"])
def test_components_backward_matches_autograd_of_the_vae_loss(kind,
                                                              reduction):
    """``FusedLossComponents``' backward on the CPU (``loss_grads``' plain
    version) against autograd through ``models/vae.py``
    ``loss_components`` on the fp32 reconstruction, as the step's plain
    path runs it: fp32 within 1e-6 of each gradient's largest entry; with
    a bf16 reconstruction and target, ``d recon`` within one bf16 ulp."""
    arrays = _inputs(4, 200)
    bf16 = kind == "bf16-recon"
    ts = _t(arrays, grad=True)
    ps = _t(arrays, grad=True)
    if bf16:
        ts[0] = ts[0].detach().bfloat16().requires_grad_()
        ps[0] = ps[0].detach().bfloat16().requires_grad_()
        ts[1], ps[1] = ts[1].detach().bfloat16(), ps[1].detach().bfloat16()
    got = loss.fused_loss_components(*ts, BETA, reduction)
    want = vae.loss_components(ps[0].float(), *ps[1:], BETA, SEG, reduction)
    for g, w in zip(got, want):
        assert float(g.detach()) == pytest.approx(float(w.detach()),
                                                  rel=1e-6)
    c = (1.0, 0.25, -3.0)
    gg = torch.autograd.grad(sum(a * b for a, b in zip(c, got)),
                             [ts[0], ts[2], ts[3]])
    wg = torch.autograd.grad(sum(a * b for a, b in zip(c, want)),
                             [ps[0], ps[2], ps[3]])
    for i, (a, b) in enumerate(zip(gg, wg)):
        assert a.dtype == b.dtype
        if i == 0 and bf16:
            assert int(_bf16_ulps(a, b).max()) <= 1
        else:
            tol = 1e-6 * float(b.abs().max())
            assert float((a - b).abs().max()) <= tol


def test_loss_grads_off_the_card_is_its_plain_version_bit_for_bit():
    """``loss_grads`` on CPU tensors is ``loss_grads_ref``, the gradients
    the Functions' backward formed inline before, and launches nothing."""
    r, x, mu, lv = _t(_inputs(5, 37))
    g_m, g_k = torch.tensor(0.75), torch.tensor(2.5e-4)
    before = loss.loss_grads.launches
    n_x, n_l = r.numel(), mu.numel()
    got = loss.loss_grads(r.bfloat16(), x.bfloat16(), mu, lv, g_m, g_k,
                          n_x, n_l)
    d = (2.0 / n_x) * (r.bfloat16().float() - x.bfloat16().float()) * g_m
    want = (d.bfloat16(), ((1.0 / n_l) * mu * g_k),
            ((1.0 / (2.0 * n_l)) * (torch.exp(lv) - 1.0) * g_k))
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert loss.loss_grads.launches == before


CARD = torch.device("meta")


def _meta(shape, dtype=torch.float32):
    return torch.empty(shape, device=CARD, dtype=dtype)


@pytest.mark.parametrize("case", [
    "pallas", "xla", "best", "cpu", "recon-3d", "x-shape", "logvar-shape",
    "rows", "x-strided", "fp64", "empty"])
def test_takes_fused_loss_on_backend_device_and_shapes(case, monkeypatch):
    """The rule that puts the step's loss on the kernels, through the loss
    a model binds (``models/registry.py``): ``pallas`` binds
    ``kernel_loss``, which takes the kernels on a CUDA device (``meta``
    stands in for it here), recon and x of one 2-D shape, mu and logvar
    of one 2-D shape with as many rows, fp32 or bf16, contiguous, not
    empty; ``xla`` and ``best`` bind ``plain_loss``.  Only the first case
    takes the kernels; every other runs the plain loss."""
    from rawaudiovae_kelsey_tpu_torch.config import Config
    from rawaudiovae_kelsey_tpu_torch.models import registry

    monkeypatch.setattr(loss, "on_card", lambda t: t.device == CARD)
    monkeypatch.setattr(loss, "fused_loss_components",
                        lambda *a: "kernels")
    monkeypatch.setattr(registry, "plain_loss", lambda *a: "plain")
    cfg = Config()
    cfg.tpu.backend = case if case in ("xla", "best") else "pallas"
    model = registry.build_model(cfg, "cpu")
    assert model.loss_components is (
        registry.kernel_loss if cfg.tpu.backend == "pallas"
        else registry.plain_loss)
    rows, seg, latent = 64, 32, 8
    args = [_meta((rows, seg), torch.bfloat16),
            _meta((rows, seg), torch.bfloat16),
            _meta((rows, latent)), _meta((rows, latent))]
    if case == "cpu":
        args = [torch.zeros(a.shape, dtype=a.dtype) for a in args]
    elif case == "recon-3d":
        args[:2] = [_meta((rows, 1, seg), torch.bfloat16)] * 2
    elif case == "x-shape":
        args[1] = _meta((rows, seg + 1), torch.bfloat16)
    elif case == "logvar-shape":
        args[3] = _meta((rows, latent + 1))
    elif case == "rows":
        args[2:] = [_meta((rows + 1, latent))] * 2
    elif case == "x-strided":
        args[1] = _meta((seg, rows), torch.bfloat16).t()
    elif case == "fp64":
        args[2] = _meta((rows, latent), torch.float64)
    elif case == "empty":
        args = [_meta((0, a.shape[1]), a.dtype) for a in args]
    assert loss.takes_fused_loss(*args) == (case in ("pallas", "xla",
                                                     "best"))
    got = model.loss_components(*args, BETA, seg, "mean")
    assert got == ("kernels" if case == "pallas" else "plain")


@pytest.mark.parametrize("arch", ["dense", "deep", "conv1d"])
def test_pallas_binds_the_kernel_loss_but_for_conv1d(arch):
    """Under ``backend = pallas`` the dense and deep families bind
    ``kernel_loss``; the conv1d family keeps its plain convolutions and
    the plain loss under every backend."""
    from rawaudiovae_kelsey_tpu_torch.config import Config
    from rawaudiovae_kelsey_tpu_torch.models import registry

    cfg = Config()
    cfg.vae.arch, cfg.tpu.backend = arch, "pallas"
    model = registry.build_model(cfg, "cpu")
    assert model.loss_components is (
        registry.plain_loss if arch == "conv1d" else registry.kernel_loss)


def _recording(monkeypatch):
    """The device check stood in for and the launches recorded; the launch
    counters come back to their values when the test ends."""
    launched = []
    for w in (loss.loss_sums, loss.loss_grads):
        monkeypatch.setattr(w, "launches", w.launches)
    monkeypatch.setattr(loss, "cuda_device", lambda t, name: t.device)
    monkeypatch.setattr(loss._build, "launch",
                        lambda name, dev, *args: launched.append((name, args)))
    return launched


@pytest.mark.parametrize("reduction", REDUCTIONS)
def test_what_reaches_the_loss_entry_points(reduction, monkeypatch):
    """On ``meta`` tensors: each pair's dtype code, the operands as they
    lie (no fp32 copy), the element counts, the grid (a function of the
    shape alone), the scales; one launch of each kernel for a forward and
    a backward of ``fused_loss_components``, the cotangents passed as
    device tensors."""
    launched = _recording(monkeypatch)
    rows, seg, latent = 4097, 1024, 256
    n_x, n_l = rows * seg, rows * latent
    r = _meta((rows, seg), torch.bfloat16).requires_grad_()
    x = _meta((rows, seg), torch.bfloat16)
    mu, lv = (_meta((rows, latent)).requires_grad_() for _ in range(2))
    before = (loss.loss_sums.launches, loss.loss_grads.launches)
    out = loss.fused_loss_components(r, x, mu, lv, BETA, reduction)
    assert [o.shape for o in out] == [()] * 3
    name, args = launched.pop()
    assert name == "rvk_loss_sums" and launched == []
    assert all(a is b for a, b in zip(args[:4], (r, x, mu, lv)))
    assert args[4].shape == (1024, 2) and args[5].shape == (2,)
    # n_x, n_l, blocks (ceil(n_x / 4096) = 1025, at most 1024), dtypes
    assert args[6:] == (n_x, n_l, 1024, 1, 0)
    d_r, d_mu, d_lv = torch.autograd.grad(out[0], [r, mu, lv])
    name, args = launched.pop()
    assert name == "rvk_loss_grads" and launched == []
    assert all(a is b for a, b in zip(args[:4], (r, x, mu, lv)))
    assert all(g.shape == () and g.dtype == torch.float32
               for g in args[4:6])
    assert [a.dtype for a in args[6:9]] == [torch.bfloat16] + \
        [torch.float32] * 2
    nx, nl = (n_x, n_l) if reduction == "mean" else (1, 1)
    # the gradient's grid: a bf16 reconstruction takes up to 8448 blocks
    assert args[9:] == (n_x, n_l, 2.0 / nx, 1.0 / nl, 1.0 / (2.0 * nl),
                        1025, 1, 0)
    assert (d_r.dtype, d_mu.dtype, d_lv.dtype) == (torch.bfloat16,
                                                   torch.float32,
                                                   torch.float32)
    assert (loss.loss_sums.launches - before[0],
            loss.loss_grads.launches - before[1]) == (1, 1)


def test_a_pair_of_two_dtypes_reaches_the_kernels_in_fp32(monkeypatch):
    """A bf16 recon beside an fp32 x: that pair in fp32 (code 0), and with
    it the bf16 mu / logvar (the kernels take no fp32 recon beside bf16
    mu), each gradient rounded back to its input's bf16; a small batch
    takes one block."""
    launched = _recording(monkeypatch)
    r = _meta((37, 64), torch.bfloat16)
    x = _meta((37, 64))
    mu, lv = _meta((37, 16), torch.bfloat16), _meta((37, 16), torch.bfloat16)
    loss.loss_sums(r, x, mu, lv)
    name, args = launched.pop()
    assert args[0].dtype == torch.float32 and args[1] is x
    assert args[2].dtype == args[3].dtype == torch.float32
    assert args[6:] == (37 * 64, 37 * 16, 1, 0, 0)
    g = _meta(())
    d_r, d_mu, d_lv = loss.loss_grads(r, x, mu, lv, g, g, 1, 1)
    name, args = launched.pop()
    assert all(a.dtype == torch.float32 for a in args[6:9])
    assert args[-3:] == (1, 0, 0)
    # an fp32 reconstruction's gradient takes at most 264 blocks
    big = _meta((8192, 1024))
    loss.loss_grads(big, big, mu[:1].expand(8192, 16).contiguous(),
                    mu[:1].expand(8192, 16).contiguous(), g, g, 1, 1)
    assert launched.pop()[1][-3:] == (264, 0, 0)
    assert (d_r.dtype, d_mu.dtype, d_lv.dtype) == (torch.bfloat16,) * 3
    with pytest.raises(TypeError, match="dtype"):
        loss.loss_grads(r, x, mu, lv, g.bfloat16(), g, 1, 1)

"""Row 17's 4-pass form on the tensor cores (rawaudiovae_kelsey_tpu_torch/
ops/toeplitz.py at ``passes = 4``, csrc/wgmma.cuh ``FourPassRows`` on the
Toeplitz walk, csrc/split.cuh's split pass before it) and where the
``high`` tier reaches it: a train or eval step whose model runs the
op-level convolutions (``ops/conv.py`` ``conv_encode_pallas`` /
``conv_decode_pallas``, ``models/registry.py`` ``under_tier``).

Under ``jax.default_matmul_precision("high")`` the JAX ``toeplitz_fwd``
takes one pass on fp32 operands as four (``pallas_toeplitz.py:177-182``),
forward and ``dx``.  On the CPU the JAX side runs its kernel in interpret
mode under that scope; the port's wrappers run their plain versions (CPU
tensors), and the new walk runs as a numpy model.

* (a) The walk, modelled in numpy: the half plan of ``tile_plan``, the
  k-steps of 64 channels over the taps, the 3-D boxes of x's bf16 halves
  (zero outside the tensor), four fp32 accumulators (hh, ll, hl, lh) over
  all k-steps, ``(hh + ll) + (hl + lh)``, then the bias, then the
  activation, and the masked store of each half's rows.  Against JAX's
  kernel at ``passes = 4`` and the port's 4-pass plain version within
  ``FOUR = 1e-5 · max|plain|`` (``chip_smoke.py`` ``FOUR_PASS_REL``: fp32
  sums in another order move an output by ~1e-7 of the largest, a missing
  cross pass by ~2^-9 of a product); on operands where every sum has one
  term (``chip_smoke.py`` ``exact_toeplitz_case``) bit for bit with the
  plain version, which tells a missing lo·lo pass and another order of the
  four sums.
* (b) A train step and an eval step of the op-level conv1d model under
  ``precision = high`` against JAX's, from the same weights
  (``params_from_jax``) and JAX's eps: loss rel 1e-5 and params atol 1e-5
  after each step, the ``highest`` bound of tests/test_torch_train_step.py;
  the reconstruction atol 1e-5.  Every Toeplitz product the port's step
  makes takes four passes: the test records the pass count each call of
  the plain version saw (before this form the step ran one pass).
* (c) ``tier_passes`` / ``under_tier``: 4 for the op-level conv1d model and
  3 for the dense kernels under ``high``; 1 under every other tier, for the
  registry's conv1d model, and outside a step.
* (d) The dispatch at every conv1d layer in four passes on ``meta`` tensors
  (the launch recorded): the six wide layers and their ``dx`` on the tensor
  cores, the workspace of the halves, the 64-wide tile and ``split_launches``;
  the narrow layers on ``narrow.cuh``; the first version by name.
"""

import dataclasses
import functools
import importlib
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rawaudiovae_kelsey_tpu.config import Config as JConfig
from rawaudiovae_kelsey_tpu.models import build_model as jbuild_model
from rawaudiovae_kelsey_tpu.parallel import build_eval_step as jbuild_eval
from rawaudiovae_kelsey_tpu.parallel import build_train_step as jbuild_step
from rawaudiovae_kelsey_tpu.train import TrainState as JState
from rawaudiovae_kelsey_tpu.train import build_optimizer as jbuild_opt
from rawaudiovae_kelsey_tpu_torch import tree
from rawaudiovae_kelsey_tpu_torch.compat import params_from_jax
from rawaudiovae_kelsey_tpu_torch.config import Config
from rawaudiovae_kelsey_tpu_torch.models import build_model, variants
from rawaudiovae_kelsey_tpu_torch.models.registry import (
    tier_passes,
    under_tier,
)
from rawaudiovae_kelsey_tpu_torch.ops import conv, linear, mlp, toeplitz
from rawaudiovae_kelsey_tpu_torch.ops import tensor_cores
from rawaudiovae_kelsey_tpu_torch.parallel import (
    build_eval_step,
    build_train_step,
)
from rawaudiovae_kelsey_tpu_torch.train import TrainState

from test_torch_toeplitz_forms import _conv1d_layers, _stand_in

jtoep = importlib.import_module("rawaudiovae_kelsey_tpu.ops.pallas_toeplitz")
jconv = importlib.import_module("rawaudiovae_kelsey_tpu.ops.pallas_conv")

FOUR = 1e-5
F32, BF16 = torch.float32, torch.bfloat16
CODES = tensor_cores.KERNEL_CODES
FIRST, TC, NARROW = (CODES[k] for k in ("cuda_cores", "tensor_cores",
                                        "narrow"))
# tests/test_torch_toeplitz_forms.py's plans: t_out below, equal to and
# above nb = 9, at shift 0 and KB - 1
SHIFT_T = [(0, 5), (2, 9), (0, 13), (2, 13)]
WIDTHS = [8, 24]


def _smoke():
    """``chip_smoke.py`` of the repository root, as a module: it builds the
    operands on which the card holds the 4-pass form bit for bit."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


# ------------------------------------------------------ (a) the walk

def _halves(v):
    return tuple(t.numpy() for t in mlp.split_hi_lo(torch.from_numpy(v)))


def _box(x, g0, t0, b0, t_half, b_half):
    """The (b_half · t_half, 64) rows a 3-D TMA box of x at (g0, t0, b0)
    brings, zero outside the tensor."""
    B, nb, G = x.shape
    out = np.zeros((b_half, t_half, 64), np.float32)
    b1, t1, g1 = min(b0 + b_half, B), min(t0 + t_half, nb), min(g0 + 64, G)
    ta = max(t0, 0)
    if b1 > b0 and t1 > ta and g1 > g0:
        out[:b1 - b0, ta - t0:t1 - t0, :g1 - g0] = x[b0:b1, ta:t1, g0:g1]
    return out.reshape(b_half * t_half, 64)


def four_pass_walk(x, w, b, act, t_out, shift, ll=True):
    """numpy model of the 4-pass Toeplitz walk (module docstring, (a));
    ``ll=False`` leaves the lo·lo pass out."""
    B, nb, G = x.shape
    kb, _, N = w.shape
    xh, xl = _halves(x)
    # w viewed as (KB·G, N), zero past its end (a box of the last tap's
    # last channels reads past it where G is no multiple of 64)
    pad = np.zeros((64, N), np.float32)
    wh, wl = (np.concatenate([v, pad]) for v in _halves(w.reshape(kb * G, N)))
    t_half, b_half = toeplitz.tile_plan(t_out)
    y = np.full((B, t_out, N), np.nan, np.float32)
    for h in range(toeplitz.tile_halves(B, t_out, t_half, b_half)):
        b0, t0 = toeplitz.half_origin(h, t_out, t_half, b_half)
        acc = {k: np.zeros((b_half * t_half, N), np.float32)
               for k in ("hh", "ll", "hl", "lh")}
        for step in range(kb * -(-G // 64)):
            j, g0 = toeplitz.k_step(step, G)
            ah, al = (_box(v, g0, t0 - shift + j, b0, t_half, b_half)
                      for v in (xh, xl))
            r = j * G + g0
            bh, bl = wh[r:r + 64], wl[r:r + 64]
            acc["hh"] += ah @ bh
            acc["ll"] += (al @ bl) * ll
            acc["hl"] += ah @ bl
            acc["lh"] += al @ bh
        out = (acc["hh"] + acc["ll"]) + (acc["hl"] + acc["lh"])
        out = linear.apply_act(act, torch.from_numpy(out + b)).numpy()
        for row in range(b_half * t_half):
            bb, tt = b0 + row // t_half, t0 + row % t_half
            if bb < B and tt < t_out:
                y[bb, tt] = out[row]
    return y


def _operands(seed, B, nb, G, kb, N):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, nb, G)).astype(np.float32),
            (rng.standard_normal((kb, G, N)) / (kb * G) ** 0.5
             ).astype(np.float32),
            (rng.standard_normal(N) * 0.1).astype(np.float32))


def _plain(x, w, b, act, t_out, shift, passes=4):
    return toeplitz.toeplitz_fwd_ref(
        *(torch.from_numpy(a) for a in (x, w, b)), act, t_out, shift,
        passes).numpy()


def _within(got, want):
    assert got.shape == want.shape and np.isfinite(got).all()
    err = np.abs(got - want).max()
    assert err <= FOUR * np.abs(want).max(), err


@pytest.mark.parametrize("B", [1, 37])
@pytest.mark.parametrize("shift,t_out", SHIFT_T)
@pytest.mark.parametrize("G", WIDTHS)
@pytest.mark.parametrize("N", WIDTHS)
def test_the_four_pass_walk_matches_plain_and_the_jax_kernel(B, shift, t_out,
                                                             G, N):
    x, w, b = _operands(B * 1000 + G * 10 + N, B, 9, G, 3, N)
    got = four_pass_walk(x, w, b, "tanh", t_out, shift)
    want = np.asarray(jtoep.toeplitz_fwd(jnp.asarray(x), jnp.asarray(w),
                                         jnp.asarray(b), "tanh", t_out,
                                         shift, 4))
    ref = _plain(x, w, b, "tanh", t_out, shift)
    _within(ref, want)
    _within(got, want)
    _within(got, ref)


@pytest.mark.parametrize("B,nb,G,kb,N,t_out,shift", [
    (37, 9, 8, 3, 24, 13, 0), (1, 9, 24, 3, 8, 5, 2),
    (5, 70, 72, 3, 16, 70, 1),          # two halves a row; G past 64
    (17, 4, 64, 3, 40, 4, 1),           # 16 batch rows a half, ragged B
    (3, 12, 16, 4, 24, 13, 3),          # shift KB - 1, t_out past nb
], ids=str)
@pytest.mark.parametrize("act", ["none", "relu"])
def test_single_term_sums_give_the_plain_versions_bits(B, nb, G, kb, N,
                                                       t_out, shift, act):
    """Every output one product (hh + ll) + (hl + lh) of one pair of values:
    the walk's four sums over all taps and the plain version's four sums a
    tap leave the same bits, and so would a kernel that multiplied and
    added them in this order (a missing lo·lo pass, or the 3-pass order,
    changes them)."""
    x, w, b = (t.numpy() for t in _smoke().exact_toeplitz_case(
        torch.device("cpu"), B, nb, G, kb, N, seed=B + G))
    got = four_pass_walk(x, w, b, act, t_out, shift)
    want = _plain(x, w, b, act, t_out, shift)
    np.testing.assert_array_equal(got, want)
    # the operands tell four passes from one, and from three without lo·lo
    assert not np.array_equal(want, _plain(x, w, b, act, t_out, shift, 1))
    assert not np.array_equal(
        want, four_pass_walk(x, w, b, act, t_out, shift, ll=False))


# ------------------------------------------ (b) the `high` op-level step

SEG, LATENT, SEED = 256, 16, 0
CHANNELS, KERNEL, STRIDE = "8,16", 5, 4
WIDTH = variants.conv_latent_width(SEG, 2, STRIDE)


def _cfg(cls, precision="high", backend="pallas"):
    cfg = cls()
    cfg.audio.segment_length = SEG
    cfg.audio.hop_length = 64
    cfg.vae.arch = "conv1d"
    cfg.vae.latent_dim = LATENT
    cfg.vae.conv_channels = CHANNELS
    cfg.vae.conv_kernel = KERNEL
    cfg.vae.conv_stride = STRIDE
    cfg.training.learning_rate = 1e-3
    cfg.tpu.backend = backend
    cfg.tpu.precision = precision
    cfg.tpu.deterministic_inference = True
    return cfg


def _op_level(model, ops):
    """The registry's conv1d model with its encode / decode replaced by the
    op-level Toeplitz path, as its users build it."""
    return dataclasses.replace(
        model, encode=functools.partial(ops.conv_encode_pallas, stride=STRIDE),
        decode=functools.partial(ops.conv_decode_pallas, stride=STRIDE,
                                 width=WIDTH, channels=16))


def jax_eps(step, i, shape):
    key = jax.random.fold_in(jax.random.PRNGKey(SEED), step)
    if i is not None:
        key = jax.random.fold_in(key, i)
    return torch.from_numpy(np.array(
        jax.random.normal(key, shape, dtype=jnp.float32)))


@pytest.fixture
def passes_seen(monkeypatch):
    """The pass count of every Toeplitz product the port makes (on the CPU
    each takes the plain version)."""
    seen = []
    real = toeplitz.toeplitz_fwd_ref

    def spy(x, w, b, act="none", t_out=None, shift=0, passes=1):
        seen.append(passes)
        return real(x, w, b, act, t_out, shift, passes)

    monkeypatch.setattr(toeplitz, "toeplitz_fwd_ref", spy)
    return seen


def test_high_op_level_train_step_matches_jax(passes_seen):
    """Two coupled ``high`` steps of the op-level conv1d model against
    JAX's (its eps injected): the forward and ``dx`` of every Toeplitz
    layer in four passes on both sides, dW, db and the heads in fp32."""
    jcfg = _cfg(JConfig)
    jmodel = _op_level(jbuild_model(jcfg), jconv)
    opt = jbuild_opt(jcfg)
    p = jmodel.init(jax.random.PRNGKey(SEED))
    jstate = JState.create(p, opt.init(p), seed=SEED)
    jstep = jbuild_step(jmodel, jcfg, opt, donate=False)
    cfg = _cfg(Config)
    step = build_train_step(_op_level(build_model(cfg, "cpu"), conv), cfg,
                            noise=jax_eps)
    state = TrainState.create(params_from_jax(jax.device_get(p)), SEED)
    for k in range(2):
        x = np.random.default_rng(10 + k).uniform(
            -1, 1, (24, SEG)).astype(np.float32)
        jstate, jm = jstep(jstate, jnp.asarray(x))
        state, m = step(state, torch.from_numpy(x))
        assert float(m["loss"]) == pytest.approx(float(jm["loss"]), rel=1e-5)
        for t, a in zip(tree.leaves(state.params),
                        jax.tree_util.tree_leaves(jstate.params)):
            np.testing.assert_allclose(t.numpy(), np.asarray(a), atol=1e-5,
                                       rtol=0)
    # two encoder and two decoder layers a forward, dx of all but the
    # first (its input is the batch): 7 products a step
    assert len(passes_seen) == 14 and set(passes_seen) == {4}


def test_high_op_level_eval_step_matches_jax(passes_seen):
    jcfg = _cfg(JConfig)
    jmodel = _op_level(jbuild_model(jcfg), jconv)
    p = jmodel.init(jax.random.PRNGKey(1))
    x = np.random.default_rng(3).uniform(-1, 1, (19, SEG)).astype(np.float32)
    want = jbuild_eval(jmodel, jcfg)(p, jax.random.PRNGKey(0),
                                     jnp.asarray(x))
    cfg = _cfg(Config)
    got = build_eval_step(_op_level(build_model(cfg, "cpu"), conv), cfg)(
        params_from_jax(jax.device_get(p)), None, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=0)
    assert len(passes_seen) == 4 and set(passes_seen) == {4}


# ----------------------------------------------------- (c) the tier rule

def test_the_tier_binds_four_passes_to_the_op_level_conv_model():
    cfg = _cfg(Config)
    model = _op_level(build_model(cfg, "cpu"), conv)
    assert tier_passes(cfg, model) == 4
    bound = under_tier(model, cfg)
    assert bound.encode.keywords == {"stride": STRIDE, "passes": 4}
    assert bound.decode.keywords == {"stride": STRIDE, "width": WIDTH,
                                     "channels": 16, "passes": 4}
    # the ModelDef itself, which a call outside a step takes, keeps one
    assert "passes" not in model.encode.keywords
    assert "passes" not in model.decode.keywords


def test_the_dense_kernels_keep_three_passes_under_high():
    cfg = _cfg(Config)
    cfg.vae.arch = "dense"
    cfg.vae.n_units = 64
    model = build_model(cfg, "cpu")
    assert tier_passes(cfg, model) == 3
    assert under_tier(model, cfg).encode.keywords["passes"] == 3


@pytest.mark.parametrize("precision", ["float32", "highest", "bfloat16"])
def test_every_other_tier_keeps_one_pass_on_the_op_level_model(precision):
    cfg = _cfg(Config, precision)
    model = _op_level(build_model(cfg, "cpu"), conv)
    assert tier_passes(cfg, model) == 1
    assert under_tier(model, cfg) is model


@pytest.mark.parametrize("backend", ["pallas", "xla", "best"])
def test_the_registry_conv1d_model_keeps_one_pass_under_high(backend):
    """The registry's conv1d model runs the plain convolutions under every
    backend, as in JAX: nothing to bind."""
    cfg = _cfg(Config, "high", backend)
    model = build_model(cfg, "cpu")
    assert tier_passes(cfg, model) == 1
    assert under_tier(model, cfg) is model


# -------------------------------------------------- (d) the dispatch rule

def _launches(monkeypatch, layer, passes=4, kernel="auto"):
    """The forward and dx launches of one conv1d layer at batch 4096 in
    fp32 through ``ops/conv.py`` on ``meta`` tensors: ``(args, counts)``
    with ``args`` each launch's arguments after the four tensors and
    ``counts`` what the toeplitz_fwd counters rose by."""
    launched = _stand_in(monkeypatch)
    direction, length, cin, cout = _conv1d_layers()[layer]
    op = conv.conv1d_pallas if direction == "conv" \
        else conv.conv1d_transpose_pallas
    x = torch.empty((4096, length, cin), device="meta", requires_grad=True)
    w = torch.empty((9, cin, cout), device="meta", requires_grad=True)
    b = torch.empty((cout,), device="meta", requires_grad=True)
    counters = ("launches", "tensor_core_launches", "split_launches",
                "narrow_launches", "sgemm_launches")
    before = [getattr(toeplitz.toeplitz_fwd, c) for c in counters]
    if kernel == "auto":
        op(x, w, b, 4, "relu", passes).sum().backward()
    else:
        xf, wpad, t_out, shift = conv.pack_conv1d(x.detach(), w.detach(), 4)
        toeplitz.toeplitz_fwd(xf, wpad, b.detach(), "relu", t_out, shift,
                              passes, kernel=kernel)
    rose = {c: getattr(toeplitz.toeplitz_fwd, c) - n
            for c, n in zip(counters, before)}
    return [args[4:] for _, args in launched], rose


@pytest.mark.parametrize("layer", range(8))
def test_four_passes_take_the_tensor_cores_at_the_wide_layers(monkeypatch,
                                                              layer):
    launches, rose = _launches(monkeypatch, layer)
    assert len(launches) == 2 and rose["launches"] == 2
    wide = layer not in (0, 7)
    assert rose["split_launches"] == 2 * wide
    assert rose["narrow_launches"] == 2 * (not wide)
    assert rose["tensor_core_launches"] == rose["sgemm_launches"] == 0
    for workspace, *args in launches:
        B, nb, G, kb, N, t_out = args[:6]
        assert args[8] == 4 and args[-1] == (TC if wide else NARROW)
        assert toeplitz.takes_tensor_cores(F32, B, nb, t_out, G, N, 4,
                                           kb=kb) == wide
        if wide:
            # x's and w's halves; the 64-wide tile; tile_plan's half
            assert workspace.dtype == BF16 and workspace.shape == (
                2 * (B * nb * G + kb * G * N),)
            assert args[-2] == toeplitz.FOUR_PASS_WIDTH == 64
            assert tuple(args[-4:-2]) == toeplitz.tile_plan(t_out)
        else:
            assert workspace is None


def test_the_first_version_stays_reachable_by_name(monkeypatch):
    launches, rose = _launches(monkeypatch, 1, kernel="cuda_cores")
    ((workspace, *args),) = launches
    assert workspace is None and args[-1] == FIRST and args[8] == 4
    assert rose["launches"] == 1 and rose["split_launches"] == 0


@pytest.mark.parametrize("shapes,match", [
    (((8, 64, 128), (3, 128, 60), (60,)), "takes bf16 operands with one "
     "pass or fp32 ones with four"),                     # N % 8
    (((8, 64, 4), (3, 4, 32), (32,)), "takes bf16"),     # G below 8
])
def test_named_tensor_cores_raise_where_four_passes_cannot_run(
        monkeypatch, shapes, match):
    launched = _stand_in(monkeypatch)
    x, w, b = (torch.empty(sh, device="meta") for sh in shapes)
    with pytest.raises(ValueError, match=match):
        toeplitz.toeplitz_fwd(x, w, b, "relu", 64, 1, 4,
                              kernel="tensor_cores")
    assert launched == []


def test_the_split_pass_grid_bounds_the_four_pass_form():
    """B·nb past the split pass's 65535 blocks of 64 rows keeps the first
    version; bf16 in four passes is never taken."""
    rows = toeplitz.SPLIT_MAX_ROWS
    assert toeplitz.takes_tensor_cores(F32, rows // 64, 64, 64, 128, 64, 4)
    assert not toeplitz.takes_tensor_cores(F32, rows // 64 + 1, 64, 64, 128,
                                           64, 4)
    assert not toeplitz.takes_tensor_cores(BF16, 64, 64, 64, 128, 64, 4)

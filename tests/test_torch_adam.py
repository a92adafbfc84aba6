"""The port's one-pass Adam (rawaudiovae_kelsey_tpu_torch/ops/adam.py).

Bit for bit against ``train/optim.py`` ``Adam.update``: that is the
kernel's contract, and on the CPU the wrapper runs the plain version, which
must already hold it (same operations, same order, same scalars).

Against the TPU kernel ``_leaf_update`` and ``fused_adam_apply`` of
benchmarks/adam_fusion_ab.py with an optax state, on the same seeded
gradients: atol 1e-6 on parameters of magnitude ~1, the tolerance
tests/test_torch_tree.py states for Adam across the packages (the same fp32
operations; XLA may contract a multiply-add).  The probe's ``pallas_call``
passes no ``interpret=``, so the test hands the loaded module a ``pl`` whose
``pallas_call`` adds it; nothing in benchmarks/ changes.
"""

import bisect
import importlib.util
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from hypothesis import given, settings, strategies as st
from jax.experimental import pallas as real_pl

from rawaudiovae_kelsey_tpu.models import variants as jvariants
from rawaudiovae_kelsey_tpu.models import vae as jvae
from rawaudiovae_kelsey_tpu_torch import tree
from rawaudiovae_kelsey_tpu_torch.compat import params_from_jax
from rawaudiovae_kelsey_tpu_torch.ops import adam as adam_ops
from rawaudiovae_kelsey_tpu_torch.train import TrainState
from rawaudiovae_kelsey_tpu_torch.train.optim import Adam

REPO = Path(__file__).resolve().parents[1]
HYPER = dict(b1=0.9, b2=0.999, eps=1e-8, lr=1e-2)


@pytest.fixture(scope="module")
def probe():
    spec = importlib.util.spec_from_file_location(
        "adam_fusion_ab", REPO / "benchmarks" / "adam_fusion_ab.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)          # main() is guarded

    def pallas_call(*args, **kwargs):
        return real_pl.pallas_call(*args, interpret=True, **kwargs)

    mod.pl = types.SimpleNamespace(pallas_call=pallas_call,
                                   BlockSpec=real_pl.BlockSpec)
    return mod


def _jparams(family):
    key = jax.random.PRNGKey(3)
    if family == "dense":
        return jvae.init_dense(key, 64, 48, 8)
    if family == "deep":
        return jvariants.init_deep(key, 64, (48, 32), 8)
    return jvariants.init_conv1d(key, 64, (4, 8), 5, 4, 8)


def _grads(rng, leaves, step):
    # magnitudes that move from step to step, so that v's root and the
    # quotient see several exponents
    return [rng.standard_normal(a.shape).astype(np.float32)
            * 10.0 ** (step % 3 - 1) for a in leaves]


def _states_equal(a, b):
    for field in ("params", "mu", "nu"):
        for (name, ta), (_, tb) in zip(tree.flatten(getattr(a, field)),
                                       tree.flatten(getattr(b, field))):
            assert torch.equal(ta, tb), f"{field}.{name}"
    assert (a.count, a.step) == (b.count, b.step)


@pytest.mark.parametrize("family", ["dense", "deep", "conv1d"])
def test_fused_adam_apply_equals_adam_update_bit_for_bit(family):
    params = params_from_jax(jax.device_get(_jparams(family)))
    ranks = {t.dim() for t in tree.leaves(params)}
    assert ranks == ({1, 2, 3} if family == "conv1d" else {1, 2})
    plain = TrainState.create(params, seed=0)
    fused = plain.clone()
    adam = Adam(learning_rate=1e-2)
    rng = np.random.default_rng(0)
    for step in range(6):
        g = [torch.from_numpy(a) for a in
             _grads(rng, [t.numpy() for t in tree.leaves(params)], step)]
        adam.update(plain, tree.unflatten(plain.params, g))
        adam_ops.FusedAdam(adam).update(
            fused, tree.unflatten(fused.params, [t.clone() for t in g]))
    assert fused.count == 6
    _states_equal(plain, fused)


@pytest.mark.parametrize("shape", [(1,), (255,), (7, 33, 5), (64, 48)])
def test_leaf_update_ref_equals_adam_update_on_one_leaf(shape):
    rng = np.random.default_rng(1)
    p = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    state = TrainState.create({"w": p.clone()}, seed=0)
    q, m, v = p.clone(), torch.zeros(shape), torch.zeros(shape)
    adam = Adam(learning_rate=HYPER["lr"])
    for step in range(1, 5):
        g = torch.from_numpy(_grads(rng, [p.numpy()], step)[0])
        adam.update(state, {"w": g})
        bc = [torch.full((), c) for c in
              adam_ops.bias_corrections(0.9, 0.999, step)]
        adam_ops.leaf_update(q, g, m, v, *bc, **HYPER)
    assert torch.equal(q, state.params["w"])
    assert torch.equal(m, state.mu["w"]) and torch.equal(v, state.nu["w"])


def test_hyper_is_what_eager_multiplies_by():
    """A Python scalar meets an fp32 tensor as the scalar rounded to fp32:
    ``1 - b1`` in double first."""
    c1, b1, c2, b2, eps, neg_lr = adam_ops.hyper(0.9, 0.999, 1e-8, 1e-4)
    one = torch.ones((), dtype=torch.float32)
    assert float((1 - 0.9) * one) == c1 and float(0.9 * one) == b1
    assert float((1 - 0.999) * one) == c2 and float(0.999 * one) == b2
    assert float(-1e-4 * one) == neg_lr and float(one * 1e-8) == eps
    assert c1 != float(np.float32(1) - np.float32(0.9))   # not fp32 - fp32


# leaf shapes: inside the TPU kernel's tile budget (one block), above it with
# rows it can tile (1024 = 2 blocks of 512), above it with rows it cannot
# (1001 is no multiple of 8: the JAX function's plain fallback), and 1-D / 3-D
@pytest.mark.parametrize("shape", [(48, 32), (1024, 512), (1001, 512),
                                   (513,), (5, 4, 8)])
def test_leaf_update_matches_the_tpu_kernel(probe, shape):
    rows, cols = probe._leaf_2d(np.empty(shape)).shape
    bm = probe._row_block(rows, cols)
    if shape == (1024, 512):
        assert rows * cols > probe._TILE_BUDGET_ELEMS and bm == 512
    if shape == (1001, 512):
        assert bm is None
    rng = np.random.default_rng(2)
    p0 = rng.standard_normal(shape).astype(np.float32)
    jp, jm, jv = jnp.asarray(p0), jnp.zeros(shape), jnp.zeros(shape)
    p = torch.from_numpy(p0.copy())
    m, v = torch.zeros(shape), torch.zeros(shape)
    for step in range(1, 4):
        g = _grads(rng, [p0], step)[0]
        bc = adam_ops.bias_corrections(0.9, 0.999, step)
        jp, jm, jv = probe._leaf_update(
            jp, jnp.asarray(g), jm, jv,
            *[jnp.full((1, 1), c, jnp.float32) for c in bc], **HYPER)
        adam_ops.leaf_update(p, torch.from_numpy(g), m, v,
                             *[torch.full((), c) for c in bc], **HYPER)
    for got, want in ((p, jp), (m, jm), (v, jv)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6,
                                   rtol=1e-6)


@pytest.mark.parametrize("family", ["deep", "conv1d"])
def test_fused_adam_apply_matches_the_jax_one_on_an_optax_state(probe,
                                                                family):
    jp = _jparams(family)
    jopt = optax.adam(1e-2).init(jp)
    state = TrainState.create(params_from_jax(jax.device_get(jp)), seed=0)
    adam = Adam(learning_rate=1e-2)
    rng = np.random.default_rng(3)
    leaves = jax.tree_util.tree_leaves(jp)
    for step in range(4):
        g = _grads(rng, leaves, step)
        jg = jax.tree_util.tree_unflatten(
            jax.tree_util.tree_structure(jp), [jnp.asarray(a) for a in g])
        jp, jopt = probe.fused_adam_apply(jg, jopt, jp, lr=1e-2)
        adam_ops.fused_adam_apply(adam, state, tree.unflatten(
            state.params, [torch.from_numpy(a) for a in g]))
    assert state.count == int(jopt[0].count) == 4
    for got, want in ((state.params, jp), (state.mu, jopt[0].mu),
                      (state.nu, jopt[0].nu)):
        for t, a in zip(tree.leaves(got), jax.tree_util.tree_leaves(want)):
            np.testing.assert_allclose(t.numpy(), np.asarray(a), atol=1e-6,
                                       rtol=1e-5)


def test_a_strided_gradient_is_taken():
    p = torch.randn((6, 4), generator=torch.Generator().manual_seed(0))
    a, b = (TrainState.create({"w": p.clone()}, 0) for _ in range(2))
    g = torch.randn((4, 6), generator=torch.Generator().manual_seed(1)).t()
    assert not g.is_contiguous()
    adam = Adam(learning_rate=1e-2)
    adam.update(a, {"w": g})
    adam_ops.fused_adam_apply(adam, b, {"w": g})
    _states_equal(a, b)


def test_the_wrapper_refuses_what_the_kernel_does_not_take():
    """Only a CPU leaf takes the plain version; the checks a CUDA leaf
    passes before its launch are exercised on a device the kernel does not
    run on, where the first of them already raises."""
    t = torch.zeros((4, 3), device="meta")
    s = torch.zeros((), device="meta")
    with pytest.raises(ValueError, match="runs on CUDA tensors"):
        adam_ops.leaf_update(t, t, t, t, s, s, **HYPER)
    with pytest.raises(ValueError, match="runs on CUDA tensors"):
        adam_ops.leaf_update([1.0], t, t, t, s, s, **HYPER)
    dev = torch.device("meta")
    for bad, err in ((t.double(), TypeError), (t[:2], ValueError),
                     (t.t(), ValueError), (torch.zeros((4, 3)), ValueError),
                     (3.0, TypeError)):
        with pytest.raises(err):
            adam_ops._leaf(bad, "g", dev, (4, 3))
    adam_ops._leaf(t, "g", dev, (4, 3))
    with pytest.raises(ValueError, match="shape"):
        adam_ops._leaf(torch.zeros((1,), device="meta"), "bc1", dev, ())


def test_cpu_calls_count_no_launch():
    before = adam_ops.leaf_update.launches
    p = torch.ones(5)
    adam_ops.leaf_update(p, torch.ones(5), torch.zeros(5), torch.zeros(5),
                         torch.full((), 0.1), torch.full((), 0.001), **HYPER)
    assert adam_ops.leaf_update.launches == before
    assert bool((p < 1).all())


# ---- the tree kernel's plan (ops/adam.py tree_plan) and what reaches its
# entry point.  The kernel runs only on the card; its table is laid out
# here, and a plain walk of that table — leaf_update_ref tile by tile, as
# the kernel's blocks take the tiles — is held bit for bit against
# Adam.update.

def _tiles(plan, sizes, tile):
    """(leaf, first element, count) of every tile of every launch, found as
    the kernel finds them: the last leaf that starts at or before the
    tile."""
    out = []
    for launch in plan:
        assert launch.start[0] == 0
        assert len(launch.start) == len(launch.leaves) + 1
        for t in range(launch.start[-1]):
            j = bisect.bisect_right(launch.start, t) - 1
            leaf = launch.leaves[j]
            first = (t - launch.start[j]) * tile
            out.append((leaf, first, min(sizes[leaf] - first, tile)))
    return out


@settings(max_examples=200, deadline=None)
@given(sizes=st.lists(st.one_of(st.just(0), st.integers(1, 20_000)),
                      min_size=0, max_size=120),
       max_leaves=st.integers(1, 60), tile=st.sampled_from([7, 96, 4096]),
       data=st.data())
def test_the_plan_covers_every_element_once(sizes, max_leaves, tile, data):
    aligned = tuple(data.draw(st.lists(st.booleans(), min_size=len(sizes),
                                       max_size=len(sizes))))
    plan = adam_ops.tree_plan(tuple(sizes), aligned, max_leaves, tile)
    seen = [np.zeros(n, dtype=np.int64) for n in sizes]
    for leaf, first, count in _tiles(plan, sizes, tile):
        assert 0 < count <= tile
        seen[leaf][first:first + count] += 1
    assert all((s == 1).all() for s in seen)
    kept = [i for i, n in enumerate(sizes) if n]
    # every non-empty leaf in order, max_leaves a launch; empty leaves and
    # an empty tree take no tile and no launch
    assert [i for launch in plan for i in launch.leaves] == kept
    assert len(plan) == -(-len(kept) // max_leaves)
    assert all(0 < len(launch.leaves) <= max_leaves for launch in plan)
    for launch in plan:
        for j, i in enumerate(launch.leaves):
            assert launch.start[j + 1] - launch.start[j] == -(-sizes[i]
                                                              // tile)
            assert launch.vec[j] == aligned[i]


def test_a_tree_past_k_max_leaves_takes_two_launches():
    k = adam_ops.K_MAX_LEAVES
    sizes = (5000,) * (k + 3)
    plan = adam_ops.tree_plan(sizes, (True,) * (k + 3))
    assert [len(launch.leaves) for launch in plan] == [k, 3]
    assert plan[1].leaves == (k, k + 1, k + 2)
    assert plan[0].start[-1] == 2 * k and plan[1].start == (0, 2, 4, 6)
    # the deep, dense and conv1d trees (22, 10, <= 22 leaves) take one
    assert len(adam_ops.tree_plan((3,) * 22, (True,) * 22)) == 1


def test_unaligned_leaves_are_flagged_scalar():
    plan = adam_ops.tree_plan((4096, 1, 0, 8193, 5), (True, False, False,
                                                      False, True))
    (launch,) = plan
    assert launch.leaves == (0, 1, 3, 4)
    assert launch.vec == (True, False, False, True)
    assert launch.start == (0, 1, 2, 5, 6)


def test_the_plan_matches_the_kernel_source():
    """TILE and K_MAX_LEAVES are csrc/adam.cu's kTile and kMaxLeaves."""
    import re

    text = (Path(adam_ops.__file__).parents[1] / "csrc" / "adam.cu"
            ).read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", text)[1])

    assert const("kMaxLeaves") == adam_ops.K_MAX_LEAVES
    assert const("kThreads") * const("kVec") * 4 == adam_ops.TILE
    assert "kTile = kThreads * kVec * 4;" in text


def _walk(state, grads, adam, max_leaves, tile):
    """One Adam step as the tree kernel takes it: tree_plan's launches, each
    tile one leaf_update_ref on its elements."""
    state.count += 1
    bc = [torch.full((), c) for c in
          adam_ops.bias_corrections(adam.b1, adam.b2, state.count)]
    flat = [[t.view(-1) for t in tree.leaves(x)]
            for x in (state.params, grads, state.mu, state.nu)]
    sizes = tuple(t.numel() for t in flat[0])
    plan = adam_ops.tree_plan(sizes, (True,) * len(sizes), max_leaves, tile)
    for leaf, first, count in _tiles(plan, sizes, tile):
        adam_ops.leaf_update_ref(
            *(x[leaf][first:first + count] for x in flat), *bc, b1=adam.b1,
            b2=adam.b2, eps=adam.eps, lr=adam.learning_rate)


@pytest.mark.parametrize("max_leaves,tile", [(adam_ops.K_MAX_LEAVES,
                                              adam_ops.TILE), (4, 96)])
@pytest.mark.parametrize("family", ["dense", "deep", "conv1d"])
def test_the_plan_walk_equals_adam_update_bit_for_bit(family, max_leaves,
                                                      tile):
    params = params_from_jax(jax.device_get(_jparams(family)))
    plain = TrainState.create(params, seed=0)
    walked = plain.clone()
    adam = Adam(learning_rate=1e-2)
    rng = np.random.default_rng(4)
    for step in range(5):
        g = [torch.from_numpy(a) for a in
             _grads(rng, [t.numpy() for t in tree.leaves(params)], step)]
        adam.update(plain, tree.unflatten(plain.params, g))
        _walk(walked, tree.unflatten(walked.params, g), adam, max_leaves,
              tile)
    _states_equal(plain, walked)


@pytest.mark.parametrize("family", ["dense", "deep", "conv1d"])
def test_the_first_version_path_equals_adam_update_bit_for_bit(family):
    params = params_from_jax(jax.device_get(_jparams(family)))
    plain = TrainState.create(params, seed=0)
    first = plain.clone()
    adam = Adam(learning_rate=1e-2)
    rng = np.random.default_rng(5)
    for step in range(3):
        g = [torch.from_numpy(a) for a in
             _grads(rng, [t.numpy() for t in tree.leaves(params)], step)]
        adam.update(plain, tree.unflatten(plain.params, g))
        adam_ops.fused_adam_apply(adam, first,
                                  tree.unflatten(first.params, g),
                                  kernel="first")
    _states_equal(plain, first)


def _meta_launches(monkeypatch):
    """Run the wrappers' CUDA branch on ``meta`` tensors (their data_ptr is
    the byte offset): record each launch's entry point and arguments, the
    ctypes arrays as lists."""
    calls = []

    def launch(name, device, *args):
        calls.append((name, [list(a) if hasattr(a, "_length_") else a
                             for a in args]))

    monkeypatch.setattr(adam_ops, "_on_cuda", lambda p, op: None)
    monkeypatch.setattr(adam_ops._build, "launch", launch)
    return calls


def _meta_tree(shapes, offset=0):
    base = [torch.zeros(64 + int(np.prod(s)), device="meta") for s in shapes]
    return [b[offset:offset + int(np.prod(s))].view(s)
            for b, s in zip(base, shapes)]


def test_what_reaches_the_tree_entry_point(monkeypatch):
    calls = _meta_launches(monkeypatch)
    shapes = [(5000,), (3, 7), (0,), (64, 64), (1,)]
    ps, ms, vs = (_meta_tree(shapes) for _ in range(3))
    # an unaligned gradient (4 bytes past its base) and a strided one
    gs = _meta_tree(shapes)
    gs[1] = _meta_tree([(3, 7)], offset=1)[0]
    gs[3] = torch.zeros((64, 64), device="meta").t()
    before = adam_ops.adam_tree.launches
    adam_ops.adam_tree(ps, gs, ms, vs, 0.25, 0.5, **HYPER)
    assert adam_ops.adam_tree.launches == before + 1
    ((name, args),) = calls
    assert name == "rvk_adam_tree"
    assert len(args) + 1 == len(adam_ops._build._SIGNATURES[name])
    p, g, m, v, n, start, vec, leaves = args[:8]
    assert n == [5000, 21, 4096, 1] and leaves == 4
    assert start == [0, 2, 3, 4, 5] and vec == [1, 0, 1, 1]
    # a null c_void_p reads back as None
    assert [a or 0 for a in p] == [0, 0, 0, 0]
    assert [a or 0 for a in g] == [0, 4, 0, 0]
    # the corrections by value, no device scalar
    assert args[8:12] == [None, None, 0.25, 0.5]
    assert tuple(args[12:]) == adam_ops.hyper(0.9, 0.999, 1e-8, 1e-2)


def test_the_state_and_the_gradients_are_checked_every_call(monkeypatch):
    calls = _meta_launches(monkeypatch)
    shapes = [(8, 4), (4,)]
    ps, gs, ms, vs = (_meta_tree(shapes) for _ in range(4))
    for _ in range(3):
        adam_ops.adam_tree(ps, gs, ms, vs, 0.1, 0.01, **HYPER)
    assert len(calls) == 3
    # other tensors at other addresses: their own alignment
    ps2 = _meta_tree(shapes, offset=1)
    adam_ops.adam_tree(ps2, gs, ms, vs, 0.1, 0.01, **HYPER)
    assert calls[-1][1][6] == [0, 0]
    # a moment that took a step, then was resized in place at its
    # address: refused on the next call
    m0 = torch.zeros((8, 4), device="meta")
    adam_ops.adam_tree(ps, gs, [m0, ms[1]], vs, 0.1, 0.01, **HYPER)
    m0.resize_(32)
    with pytest.raises(ValueError, match=r"m\[0\].*shape"):
        adam_ops.adam_tree(ps, gs, [m0, ms[1]], vs, 0.1, 0.01, **HYPER)
    with pytest.raises(TypeError, match=r"p\[1\].*dtype"):
        adam_ops.adam_tree([ps[0], ps[1].double()], gs, ms, vs, 0.1, 0.01,
                           **HYPER)
    for bad, err in (([gs[0].double(), gs[1]], TypeError),
                     ([gs[0][:4], gs[1]], ValueError),
                     ([gs[0], 3.0], TypeError),
                     ([gs[0], torch.zeros(4)], ValueError)):
        with pytest.raises(err):
            adam_ops.adam_tree(ps, bad, ms, vs, 0.1, 0.01, **HYPER)
    with pytest.raises(ValueError, match="shape"):
        adam_ops.adam_tree(ps, gs, [ms[0], ms[0]], vs, 0.1, 0.01, **HYPER)
    with pytest.raises(TypeError, match="expected a tensor"):
        adam_ops.adam_tree(ps, gs, ms, [vs[0], 1.0], 0.1, 0.01, **HYPER)
    assert len(calls) == 5


def test_a_tree_past_k_max_leaves_launches_twice(monkeypatch):
    calls = _meta_launches(monkeypatch)
    k = adam_ops.K_MAX_LEAVES
    shapes = [(100,)] * (k + 3)
    ps, gs, ms, vs = (_meta_tree(shapes) for _ in range(4))
    adam_ops.adam_tree(ps, gs, ms, vs, 0.1, 0.01, **HYPER)
    assert [args[7] for _, args in calls] == [k, 3]
    assert [args[5][-1] for _, args in calls] == [k, 3]


def test_leaf_update_launches_the_tree_or_names_the_first_version(
        monkeypatch):
    calls = _meta_launches(monkeypatch)
    p, g, m, v = _meta_tree([(7, 33, 5)] * 4)
    s = torch.zeros((), device="meta")
    before = adam_ops.leaf_update.launches
    adam_ops.leaf_update(p, g, m, v, s, s, **HYPER)
    adam_ops.leaf_update(p, g, m, v, s, s, kernel="first", **HYPER)
    assert adam_ops.leaf_update.launches == before + 2
    (tree_name, tree_args), (first_name, first_args) = calls
    assert tree_name == "rvk_adam_tree" and first_name == "rvk_leaf_update"
    assert tree_args[4:8] == [[1155], [0, 1], [1], 1]
    # the one-leaf table reads its corrections from the two device scalars
    assert tree_args[8] is s and tree_args[9] is s
    assert first_args[6] == 1155
    with pytest.raises(ValueError, match="unknown kernel"):
        adam_ops.leaf_update(p, g, m, v, s, s, kernel="tree", **HYPER)


def test_the_tree_wrapper_refuses_what_it_does_not_take():
    t = torch.zeros((4, 3), device="meta")
    with pytest.raises(ValueError, match="runs on CUDA tensors"):
        adam_ops.adam_tree([t], [t], [t], [t], 0.1, 0.01, **HYPER)
    with pytest.raises(ValueError, match="1 params, 2 gradients"):
        adam_ops.adam_tree([t], [t, t], [t], [t], 0.1, 0.01, **HYPER)
    with pytest.raises(ValueError, match="runs on CUDA tensors, got float"):
        adam_ops.adam_tree([1.0], [t], [t], [t], 0.1, 0.01, **HYPER)
    with pytest.raises(ValueError, match="unknown kernel"):
        adam_ops.fused_adam_apply(Adam(1e-2), None, None, kernel="tree")
    before = adam_ops.adam_tree.launches
    adam_ops.adam_tree([], [], [], [], 0.1, 0.01, **HYPER)
    p = torch.ones(5)
    adam_ops.adam_tree([p], [torch.ones(5)], [torch.zeros(5)],
                       [torch.zeros(5)], 0.1, 0.001, **HYPER)
    assert adam_ops.adam_tree.launches == before
    assert bool((p < 1).all())

"""The port's params trees (rawaudiovae_kelsey_tpu_torch/tree.py and what
calls it) hold lists of layers as the JAX package's pytrees do: the flatten
order is ``jax.tree_util``'s, params and train states cross between the
packages leaf for leaf, Adam walks any tree, and the dense model's
checkpoints keep their layout.

Tolerances: the conversions are exact.  Adam against ``optax.adam`` over
five coupled steps: atol 1e-6 on params of magnitude ~1 (both run the same
fp32 operations; only fused-multiply-add contraction differs).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from rawaudiovae_kelsey_tpu.models import variants as jvariants
from rawaudiovae_kelsey_tpu.train import TrainState as JState
from rawaudiovae_kelsey_tpu.train import checkpoint as jckpt
from rawaudiovae_kelsey_tpu_torch import tree
from rawaudiovae_kelsey_tpu_torch.compat import (
    params_from_jax,
    params_to_jax,
    train_state_from_jax,
    train_state_to_jax,
)
from rawaudiovae_kelsey_tpu_torch.models import vae, variants
from rawaudiovae_kelsey_tpu_torch.train import TrainState, checkpoint
from rawaudiovae_kelsey_tpu_torch.train.optim import Adam


def _jparams(family):
    key = jax.random.PRNGKey(3)
    if family == "deep":
        return jvariants.init_deep(key, 64, (48, 32), 8)
    return jvariants.init_conv1d(key, 64, (4, 8), 5, 4, 8)


def _tparams(family):
    g = torch.Generator().manual_seed(3)
    if family == "deep":
        return variants.init_deep(g, 64, (48, 32), 8)
    return variants.init_conv1d(g, 64, (4, 8), 5, 4, 8)


def _jnames(p):
    flat, _ = jax.tree_util.tree_flatten_with_path(p)
    return [".".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in path) for path, _ in flat]


@pytest.mark.parametrize("family", ["deep", "conv1d"])
def test_flatten_order_is_jax_tree_order(family):
    jp, tp = _jparams(family), _tparams(family)
    names = [n for n, _ in tree.flatten(tp)]
    assert names == _jnames(jp)
    assert [tuple(t.shape) for t in tree.leaves(tp)] == \
        [a.shape for a in jax.tree_util.tree_leaves(jp)]
    if family == "deep":
        assert names[:4] == ["dec.0.b", "dec.0.w", "dec.1.b", "dec.1.w"]
        assert names[-4:] == ["logvar_head.b", "logvar_head.w", "mu_head.b",
                              "mu_head.w"]
    else:
        assert [n.split(".")[0] for n in names[::2]] == [
            "dec", "dec", "dec_in", "enc", "enc", "logvar_head", "mu_head"]


def test_unflatten_and_tree_map_keep_the_structure():
    t = {"b": [1, {"y": 2, "x": 3}], "a": (4, 5)}
    assert tree.leaves(t) == [4, 5, 1, 3, 2]
    assert [n for n, _ in tree.flatten(t)] == ["a.0", "a.1", "b.0", "b.1.x",
                                               "b.1.y"]
    back = tree.unflatten(t, [10, 20, 30, 40, 50])
    assert back == {"a": [10, 20], "b": [30, {"x": 40, "y": 50}]}
    assert tree.tree_map(lambda v: v * 2, t) == {
        "b": [2, {"y": 4, "x": 6}], "a": [8, 10]}


@pytest.mark.parametrize("family", ["deep", "conv1d"])
def test_params_round_trip_with_lists(family):
    jp = jax.device_get(_jparams(family))
    tp = params_from_jax(jp)
    assert isinstance(tp["enc"], list) and isinstance(tp["enc"][0], dict)
    back = params_to_jax(tp)
    assert jax.tree_util.tree_structure(back) == \
        jax.tree_util.tree_structure(jp)
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(jp)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("family", ["deep", "conv1d"])
def test_train_state_round_trip_and_npz_across_packages(family, tmp_path):
    """A JAX train state → the port → its leaves again, and through the npz
    files of both packages, both ways."""
    jp = _jparams(family)
    opt = optax.adam(1e-3)
    jstate = JState.create(jp, opt.init(jp), seed=11)
    jleaves = [np.asarray(a) for a in jax.tree_util.tree_leaves(jstate)]
    n = len(jax.tree_util.tree_leaves(jp))
    assert len(jleaves) == 3 * n + 3
    template = TrainState.create(_tparams(family), seed=0)
    state = train_state_from_jax(jleaves, template)
    assert (state.seed, state.step, state.count) == (11, 0, 0)
    for a, b in zip(train_state_to_jax(state), jleaves):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype
    # the port writes, the JAX package restores
    path = checkpoint.save_checkpoint(tmp_path / "port", state, {"epoch": 2})
    jback, meta = jckpt.restore_checkpoint(path, jstate)
    assert meta["epoch"] == 2
    for a, b in zip(jax.tree_util.tree_leaves(jback), jleaves):
        np.testing.assert_array_equal(np.asarray(a), b)
    # the JAX package writes, the port restores
    jpath = jckpt.save_checkpoint(tmp_path / "jax", jstate, {"epoch": 3})
    back, meta = checkpoint.restore_checkpoint(jpath, template)
    assert meta["epoch"] == 3
    for a, b in zip(train_state_to_jax(back), jleaves):
        np.testing.assert_array_equal(a, b)
    # params files (best_model.npz) both ways
    checkpoint.save_params(tmp_path / "p.npz", state.params)
    jloaded = jckpt.load_params(tmp_path / "p.npz", jp)
    for a, b in zip(jax.tree_util.tree_leaves(jloaded),
                    jax.tree_util.tree_leaves(jp)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    jckpt.save_params(tmp_path / "j.npz", jp)
    loaded = checkpoint.load_params(tmp_path / "j.npz", template.params)
    for t, b in zip(tree.leaves(loaded), jax.tree_util.tree_leaves(jp)):
        np.testing.assert_array_equal(t.numpy(), np.asarray(b))


def test_wrong_family_checkpoint_is_refused(tmp_path):
    state = TrainState.create(_tparams("deep"), seed=0)
    path = checkpoint.save_checkpoint(tmp_path, state)
    with pytest.raises(ValueError, match="shape|leaves"):
        checkpoint.restore_checkpoint(
            path, TrainState.create(_tparams("conv1d"), seed=0))


@pytest.mark.parametrize("family", ["deep", "conv1d"])
def test_adam_over_a_tree_with_lists_matches_optax(family):
    jp = _jparams(family)
    opt = optax.adam(1e-2)
    jopt = opt.init(jp)
    state = TrainState.create(params_from_jax(jax.device_get(jp)), seed=0)
    adam = Adam(learning_rate=1e-2)
    rng = np.random.default_rng(0)
    for _ in range(5):
        g = [rng.normal(size=a.shape).astype(np.float32)
             for a in jax.tree_util.tree_leaves(jp)]
        jg = jax.tree_util.tree_unflatten(
            jax.tree_util.tree_structure(jp), [jnp.asarray(a) for a in g])
        upd, jopt = opt.update(jg, jopt, jp)
        jp = optax.apply_updates(jp, upd)
        adam.update(state, tree.unflatten(
            state.params, [torch.from_numpy(a) for a in g]))
    assert state.count == 5
    for t, a in zip(tree.leaves(state.params),
                    jax.tree_util.tree_leaves(jp)):
        np.testing.assert_allclose(t.numpy(), np.asarray(a), atol=1e-6,
                                   rtol=0)
    for t, a in zip(tree.leaves(state.nu),
                    jax.tree_util.tree_leaves(jopt[0].nu)):
        np.testing.assert_allclose(t.numpy(), np.asarray(a), atol=1e-6,
                                   rtol=1e-5)


def test_state_clone_is_independent_for_lists():
    state = TrainState.create(_tparams("deep"), seed=1)
    other = state.clone()
    other.params["enc"][0]["w"].add_(1.0)
    other.mu["dec"][1]["b"].add_(1.0)
    assert not torch.equal(other.params["enc"][0]["w"],
                           state.params["enc"][0]["w"])
    assert float(state.mu["dec"][1]["b"].abs().sum()) == 0.0


def test_dense_checkpoint_layout_is_unchanged(tmp_path):
    """A dense train state still writes the 33 leaves in the JAX order, and
    loads back."""
    params = vae.init_dense(torch.Generator().manual_seed(0), 32, 24, 8)
    state = TrainState.create(params, seed=(5 << 32) | 9)
    state.step = state.count = 4
    path = checkpoint.save_checkpoint(tmp_path, state)
    with np.load(path) as npz:
        names = sorted(npz.files)
        assert len(names) == 33
        assert npz["leaf_00000"].shape == (24,)          # fc1.b
        assert npz["leaf_00001"].shape == (32, 24)       # fc1.w
        assert npz["leaf_00009"].shape == (24, 32)       # fc4.w
        assert npz["leaf_00010"].dtype == np.int32       # Adam count
        np.testing.assert_array_equal(npz["leaf_00031"], [5, 9])
    back, _ = checkpoint.restore_checkpoint(path, state)
    assert (back.seed, back.step, back.count) == (state.seed, 4, 4)
    for a, b in zip(tree.leaves(back.params), tree.leaves(state.params)):
        assert torch.equal(a, b)

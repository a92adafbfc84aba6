"""Checkpoints under tensor parallelism (rawaudiovae_kelsey_tpu_torch/train/
checkpoint.py): the npz layout across the packages with model-parallel
templates, and the port's sharded format under ``[tpu] checkpoint_format
= orbax`` (its own, a declared divergence from orbax's bytes).

The ranks are CPU processes on a gloo group (tests/torch_ranks.py
``tp_checkpoint``): a state made from the JAX init (params, mu = params /
2, nu = params², count 3, seed 11, step 7) is written on one mesh and read
on another; every leaf must come back with equal bits.  The JAX side
restores into its 4×2 model-parallel template as
tests/test_checkpoint.py:233-261 does.
"""

import dataclasses
import json
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import torch_ranks as R
from rawaudiovae_kelsey_tpu.config import Config as JConfig
from rawaudiovae_kelsey_tpu.models import build_model as jbuild_model
from rawaudiovae_kelsey_tpu.parallel import (
    make_mesh as jmake_mesh,
    named_shardings,
    param_specs as jparam_specs,
)
from rawaudiovae_kelsey_tpu.train import TrainState as JState
from rawaudiovae_kelsey_tpu.train import build_optimizer as jbuild_opt
from rawaudiovae_kelsey_tpu.train.checkpoint import (
    restore_checkpoint as jrestore,
    save_checkpoint as jsave,
)
from rawaudiovae_kelsey_tpu_torch.compat import params_from_jax
from rawaudiovae_kelsey_tpu_torch.config import Config
from rawaudiovae_kelsey_tpu_torch.io import write_wav
from rawaudiovae_kelsey_tpu_torch.train import TrainState
from rawaudiovae_kelsey_tpu_torch.train import checkpoint as ckpt
from rawaudiovae_kelsey_tpu_torch.tree import flatten, tree_map

SEG, UNITS, LATENT = 128, 64, 16


def _jcfg():
    cfg = JConfig()
    cfg.audio.segment_length = SEG
    cfg.audio.hop_length = SEG // 4
    cfg.vae.n_units = UNITS
    cfg.vae.latent_dim = LATENT
    cfg.tpu.model_parallel = 2
    return cfg


def _jax_init():
    return jax.device_get(jbuild_model(_jcfg()).init(jax.random.PRNGKey(0)))


def _whole(params):
    """The state tp_checkpoint writes, whole, as numpy leaves by name."""
    p = {n: np.asarray(v, np.float32) for n, v in flatten(params)}
    return {"params": p, "mu": {n: 0.5 * v for n, v in p.items()},
            "nu": {n: v * v for n, v in p.items()}}


def _expected_shard(whole, name, spec, model, index):
    a = whole[name]
    if spec == "replicated" or model == 1:
        return a
    dim = 0 if spec == "rows" else a.ndim - 1
    w = a.shape[dim] // model
    return np.take(a, range(index * w, (index + 1) * w), axis=dim)


def _hold_restored(got, params, model):
    """A restored rank's shards equal the slices of the written state."""
    from rawaudiovae_kelsey_tpu_torch.parallel.sharding import param_specs

    specs = dict(flatten(param_specs("dense", params_from_jax(params),
                                     model)))
    whole = _whole(params)
    index = got["position"][1]
    for part in ("params", "mu", "nu"):
        for name, value in got[part].items():
            want = _expected_shard(whole[part], name, specs[name], model,
                                   index)
            np.testing.assert_array_equal(value, want, err_msg=name)
    assert (got["count"], got["seed"], got["step"]) == (3, 11, 7)
    assert got["meta"]["epoch"] == 7 and got["meta"]["step"] == 7


@pytest.fixture(scope="module")
def written(tmp_path_factory):
    """The JAX init written at model 2 (sharded directory and npz on a
    1×2 mesh, an npz on a 2×2 one) and at model 1 (sharded, this process),
    a JAX npz, and their restores at model 1 (here), 2 and 4 (ranks)."""
    params = _jax_init()
    root = tmp_path_factory.mktemp("tpckpt")
    m2, m1, npz2, npz22, jnpz = (root / d for d in ("m2", "m1", "npz2",
                                                    "npz22", "jax"))
    saved = R.launch(R.run_jobs, 2, root, [
        ("tp_checkpoint", (("save", 2, params, m2, {}),)),
        ("tp_checkpoint", (("save", 2, params, npz2, {"npz": True}),))])
    saved_m1 = R.tp_checkpoint(0, 1, ("save", 1, params, m1, {}))
    # the JAX package's npz of the same state
    opt = jbuild_opt(_jcfg())
    jstate = JState.create(params, opt.init(params), seed=0)
    w = _whole(params)
    mu_tree = jax.tree_util.tree_unflatten(
        jax.tree_util.tree_structure(params),
        [w["mu"][n] for n, _ in flatten(params)])
    nu_tree = jax.tree_util.tree_unflatten(
        jax.tree_util.tree_structure(params),
        [w["nu"][n] for n, _ in flatten(params)])
    opt_state = jstate.opt_state
    adam = opt_state[0]._replace(count=np.int32(3), mu=mu_tree, nu=nu_tree)
    jstate = dataclasses.replace(jstate, opt_state=(adam, *opt_state[1:]),
                                 step=np.int32(7),
                                 rng=np.asarray([0, 11], np.uint32))
    jpath = jsave(jnpz, jstate, {"epoch": 7}, label=7)
    restores = {
        "m2@1": R.tp_checkpoint(0, 1, ("restore", 1, params,
                                       Path(saved[0][0]), {})),
        "npz2@1": R.tp_checkpoint(0, 1, ("restore", 1, params,
                                         Path(saved[0][1]), {}))}
    four = R.launch(R.run_jobs, 4, root, [
        ("tp_checkpoint", (("save", 2, params, npz22, {"npz": True}),)),
        ("tp_checkpoint", (("restore", 4, params, Path(saved[0][0]), {}),)),
        ("tp_checkpoint", (("restore", 4, params, Path(saved_m1), {}),)),
        ("tp_checkpoint", (("restore", 2, params, Path(jpath), {}),)),
        ("tp_checkpoint", (("restore", 2, params, Path(saved[0][0]), {}),))])
    restores["m2@4"] = [r[1] for r in four]
    restores["m1@4"] = [r[2] for r in four]
    restores["jax@2x2"] = [r[3] for r in four]
    restores["m2@2x2"] = [r[4] for r in four]
    return {"params": params, "saved": saved, "saved_m1": saved_m1,
            "npz_2x2": four[0][0], "restores": restores}


def test_the_sharded_directory_holds_the_ranks_shards_and_an_index(written):
    path = Path(written["saved"][0][0])
    assert path.name == "orbax_00007" and path.is_dir()
    assert sorted(p.name for p in path.iterdir()) == [
        "index.json", "meta.json", "shard_00000-of-00002.npz",
        "shard_00001-of-00002.npz"]
    index = json.loads((path / "index.json").read_text())
    assert index["mesh"] == {"data": 1, "model": 2}
    assert (index["step"], index["count"], index["seed"]) == (7, 3, 11)
    leaves = {leaf["name"]: leaf for leaf in index["leaves"]}
    assert leaves["params.fc1.w"]["shape"] == [SEG, UNITS]
    assert leaves["params.fc1.w"]["spec"] == "columns"
    assert leaves["nu.fc4.w"]["spec"] == "rows"
    assert leaves["mu.fc21.b"]["spec"] == "replicated"
    with np.load(path / "shard_00001-of-00002.npz") as npz:
        assert npz["params.fc1.w"].shape == (SEG, UNITS // 2)
    assert not list(path.parent.glob("*.tmp"))


@pytest.mark.parametrize("key,model", [("m2@1", 1), ("npz2@1", 1),
                                       ("m2@4", 4), ("m1@4", 4),
                                       ("m2@2x2", 2)])
def test_a_checkpoint_restores_on_another_mesh_with_equal_bits(
        written, key, model):
    """Saved at model 2 (or 1), read at model 1, 4, or on a 2×2 mesh:
    every leaf of every rank equals its slice of the written state."""
    got = written["restores"][key]
    for rank in (got if isinstance(got, list) else [got]):
        _hold_restored(rank, written["params"], model)


def test_an_npz_written_on_a_tp_mesh_loads_in_the_jax_package(written):
    """The gathered npz of a 2×2 mesh restores into JAX's 4×2
    model-parallel template with equal values and the template's
    shardings (tests/test_checkpoint.py:233-261's pattern)."""
    params = written["params"]
    cfg = _jcfg()
    model = jbuild_model(cfg)
    opt = jbuild_opt(cfg)
    mesh = jmake_mesh(data_parallel=4, model_parallel=2)
    specs = jparam_specs(model.name, params, 2)
    sharded = jax.device_put(params, named_shardings(mesh, specs))
    template = JState.create(sharded, opt.init(sharded), seed=0)
    restored, meta = jrestore(Path(written["npz_2x2"]), template)
    got = restored.params["fc1"]["w"]
    assert got.sharding == sharded["fc1"]["w"].sharding
    whole = _whole(params)
    for name, value in flatten(jax.device_get(restored.params)):
        np.testing.assert_array_equal(np.asarray(value),
                                      whole["params"][name], err_msg=name)
    mu = jax.device_get(restored.opt_state[0].mu)
    for name, value in flatten(mu):
        np.testing.assert_array_equal(np.asarray(value), whole["mu"][name])
    assert int(restored.step) == 7 and meta["epoch"] == 7


def test_a_jax_npz_restores_into_the_tp_template_with_equal_shards(written):
    for rank in written["restores"]["jax@2x2"]:
        _hold_restored(rank, written["params"], 2)


# ----------------------------------------------- the format, one process

def _state(seed=0):
    params = params_from_jax(_jax_init())
    return TrainState(params=params, mu=tree_map(lambda t: 0.5 * t, params),
                      nu=tree_map(lambda t: t * t, params), count=2,
                      seed=seed, step=5)


def _equal(a, b):
    for part in ("params", "mu", "nu"):
        for (n, x), (_, y) in zip(flatten(getattr(a, part)),
                                  flatten(getattr(b, part))):
            assert torch.equal(x, y), (part, n)
    assert (a.count, a.seed, a.step) == (b.count, b.seed, b.step)


def test_a_torn_directory_is_never_listed_and_retention_counts_dirs(
        tmp_path):
    state = _state()
    for label in (1, 2, 3):
        ckpt.save_checkpoint_sharded(tmp_path, state, {"epoch": label},
                                     label=label)
    ckpt.save_checkpoint(tmp_path, state, {"epoch": 4}, label=4)
    # a crash mid-write leaves only the temporary directory
    (tmp_path / "orbax_00009.tmp").mkdir()
    (tmp_path / "orbax_00009.tmp" / "index.json").write_text("{")
    assert ckpt.latest_checkpoint(tmp_path).name == "ckpt_00004.npz"
    labels = [label for label, _ in ckpt._scan_checkpoints(tmp_path)]
    assert labels == [1, 2, 3, 4]
    removed = ckpt.prune_checkpoints(tmp_path, keep=2)
    assert sorted(p.name for p in removed) == ["orbax_00001", "orbax_00002"]
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "ckpt_00004.json", "ckpt_00004.npz", "orbax_00003",
        "orbax_00009.tmp"]
    got, meta = ckpt.restore_checkpoint(tmp_path / "orbax_00003",
                                        TrainState.create(
                                            tree_map(torch.zeros_like,
                                                     state.params), 0))
    _equal(got, state)
    assert meta == {"epoch": 3, "step": 5}


def test_the_async_save_commits_on_wait(tmp_path):
    """``wait=False`` returns after the host copy: the directory and its
    sidecar appear only at ``wait_for_orbax`` (a later change to the live
    state does not reach the file)."""
    state = _state()
    path = ckpt.save_checkpoint_sharded(tmp_path, state, {"epoch": 1},
                                        label=1, wait=False)
    saved = state.clone()
    state.params["fc1"]["w"].add_(1.0)
    assert not (path / "meta.json").exists()
    ckpt.wait_for_orbax()
    assert sorted(p.name for p in path.iterdir()) == [
        "index.json", "meta.json", "shard_00000-of-00001.npz"]
    got, meta = ckpt.restore_checkpoint(path, TrainState.create(
        tree_map(torch.zeros_like, state.params), 0))
    _equal(got, saved)
    assert meta["epoch"] == 1


def test_a_directory_without_the_index_raises(tmp_path):
    """A directory JAX's orbax wrote (no index of this package) refuses to
    load, with a ValueError that says so."""
    d = tmp_path / "orbax_00004"
    d.mkdir()
    (d / "_CHECKPOINT_METADATA").write_text("{}")
    template = _state()
    with pytest.raises(ValueError, match="not a sharded checkpoint"):
        ckpt.restore_checkpoint(d, template)


# ----------------------------------------------- the trainers' --resume

@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("tpcorpus")
    (root / "audio").mkdir()
    (root / "test_audio").mkdir()
    rng = np.random.default_rng(7)
    for i, n in enumerate([11000, 7000, 15000, 5000]):
        write_wav(root / "audio" / f"t{i}.wav",
                  rng.uniform(-0.5, 0.5, n).astype(np.float32), 44100)
    write_wav(root / "test_audio" / "x.wav",
              rng.uniform(-0.3, 0.3, 3000).astype(np.float32), 44100)
    return root


@pytest.mark.parametrize("kind", ["epoch", "stream"])
def test_resume_from_the_sharded_format_continues_the_step_count(
        corpus, tmp_path, kind):
    """Each trainer at model 2 on two ranks with ``checkpoint_format =
    orbax`` and ``async_checkpoint``, then ``--resume``: the second run
    starts where the first ended and trains on to the longer budget."""
    tpu = {"model_parallel": 2, "checkpoint_format": "orbax",
           "async_checkpoint": True, "backend": "pallas"}
    first = {"tpu": tpu, "extra": {"description": f"tp_{kind}"}}
    second = {"tpu": tpu, "extra": {"description": f"tp_{kind}"},
              "training": {"resume": True, "epochs": 4,
                           "total_num_frames": 16 * 10}}
    runs = R.launch(R.run_jobs, 2, tmp_path, [
        ("trainer_run", (corpus, kind, first)),
        ("trainer_run", (corpus, kind, second))])
    (a0, b0), (a1, b1) = runs
    per = a0["step"] // 3 if kind == "epoch" else None
    assert a0["step"] == a1["step"] and b0["step"] == b1["step"]
    if kind == "epoch":
        assert b0["step"] == 4 * per and b0["steps_taken"] == per
    else:
        assert (a0["step"], b0["step"], b0["steps_taken"]) == (8, 10, 2)
    for run in (a0, b0):
        ws = Path(run["workdir"])
        dirs = sorted(p.name for p in (ws / "model" / "checkpoints").iterdir())
        assert dirs and all(d.startswith("orbax_") for d in dirs), dirs
        assert all((ws / "model" / "checkpoints" / d / "meta.json").is_file()
                   for d in dirs)
        assert (ws / "model" / "last_model.npz").is_file()
    # the gathered last model holds whole leaves
    with np.load(Path(b0["workdir"]) / "model" / "last_model.npz") as npz:
        assert npz["leaf_00001"].shape == (256, 64)       # fc1.w
    assert Config().tpu.checkpoint_format == "npz"

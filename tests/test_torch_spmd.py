"""The port's explicit-collective step (rawaudiovae_kelsey_tpu_torch/
parallel/spmd.py) and its sharded resident epochs (the mesh half of
parallel/resident.py) on CPU ranks over gloo (tests/torch_ranks.py),
against the JAX package on its 8-device CPU mesh and against the port's
one-device engine.

* ``build_shard_map_train_step`` draws noise per rank, as JAX's does, so
  the two trajectories agree in distribution: 20 steps on one batch at
  rtol 5 %, JAX's own bound between its shard_map step and its replicated
  step (tests/test_train_step.py:340-370); the replicas equal bit for bit.
  Fed the same per-rank ``eps``, the port's spmd step and its mesh step
  are the same function: equal bits.
* ``_two_pass_shuffle`` keeps the multiset of rows and lands an equal slice
  of every shard on every rank (tests/test_train_step.py:531-572);
  ``local`` keeps a rank's rows on it; a 2-rank resident epoch equals the
  one-device engine given the same permutation and noise (``perm=``,
  ``noise=``, as the port's resident tests inject them) at the fp32
  tolerances of tests/test_torch_mesh.py: loss rel 1e-5, params atol 1e-6
  (after 12 steps, measured ≤ 4.5e-8).
"""

import jax
import numpy as np
import pytest
import torch

import torch_ranks as R
from rawaudiovae_kelsey_tpu.parallel import (
    build_shard_map_train_step as jbuild_spmd,
)
from rawaudiovae_kelsey_tpu.parallel.resident import (
    _wrap_pad_to as jwrap_pad_to,
)
from rawaudiovae_kelsey_tpu_torch.compat import params_from_jax
from rawaudiovae_kelsey_tpu_torch.data.framing import overlapping_frames
from rawaudiovae_kelsey_tpu_torch.models import build_model
from rawaudiovae_kelsey_tpu_torch.parallel import (
    build_shard_map_train_step,
    make_mesh,
)
from rawaudiovae_kelsey_tpu_torch.parallel import resident
from rawaudiovae_kelsey_tpu_torch.train import TrainState
from test_torch_mesh import (
    ATOL,
    LOSS_REL,
    SEED,
    SEG,
    _batch,
    _jax_init,
    _jcfg,
    jbuild_model,
    jbuild_opt,
    jmake_mesh,
    JState,
    jsharding,
)

LATENT = 16


def _jax_spmd_losses(params, batch, steps):
    cfg = _jcfg()
    model = jbuild_model(cfg)
    opt = jbuild_opt(cfg)
    mesh = jmake_mesh()
    step = jbuild_spmd(model, cfg, opt, mesh, donate=False)
    state = JState.create(params, opt.init(params), seed=SEED)
    sharded = jax.device_put(batch, jsharding(mesh))
    losses = []
    for _ in range(steps):
        state, m = step(state, sharded)
        losses.append(float(m["loss"]))
    return losses


@pytest.fixture(scope="module")
def spmd_runs(tmp_path_factory):
    params = _jax_init()
    batch = _batch(12)
    rng_ = np.random.default_rng(4)
    eps = [rng_.standard_normal((64, LATENT)).astype(np.float32)
           for _ in range(3)]
    jobs = [("spmd_steps", (dict(params=params, seed=SEED, batch=batch,
                                 steps=20),)),
            ("spmd_steps", (dict(params=params, seed=SEED, batch=batch,
                                 steps=3, eps=eps, mesh_too=True),)),
            ("spmd_steps", (dict(params=params, seed=SEED, batch=batch,
                                 steps=3, eps=eps, mesh_too=True,
                                 reduction="sum"),))]
    tmp = tmp_path_factory.mktemp("spmd")
    return (_jax_spmd_losses(params, batch, 20),
            R.launch(R.run_jobs, 2, tmp, jobs))


def test_spmd_step_trains_as_the_jax_shard_map_step(spmd_runs):
    jlosses, runs = spmd_runs
    port = [r[0]["spmd"] for r in runs]
    np.testing.assert_allclose(port[0]["losses"], jlosses, rtol=0.05)
    assert port[0]["losses"][-1] < port[0]["losses"][0]
    # replicated state: every rank holds the same params, bit for bit
    assert port[0]["losses"] == port[1]["losses"]
    for name in port[0]["params"]:
        np.testing.assert_array_equal(port[0]["params"][name],
                                      port[1]["params"][name])


@pytest.mark.parametrize("job", [1, 2], ids=["mean", "sum"])
def test_spmd_step_equals_the_mesh_step_on_the_same_noise(spmd_runs, job):
    _, runs = spmd_runs
    for rank in range(2):
        got = runs[rank][job]
        assert got["spmd"]["losses"] == got["mesh"]["losses"]
        for name in got["spmd"]["params"]:
            np.testing.assert_array_equal(got["spmd"]["params"][name],
                                          got["mesh"]["params"][name])


def test_spmd_step_refuses_microbatches_as_jax_does():
    cfg = R._tiny_cfg(microbatch_size=16)
    model = build_model(cfg, "cpu")
    with pytest.raises(ValueError, match="microbatch"):
        build_shard_map_train_step(model, cfg, None, make_mesh())
    jcfg = _jcfg(micro=16)
    with pytest.raises(ValueError, match="microbatch"):
        jbuild_spmd(jbuild_model(jcfg), jcfg, jbuild_opt(jcfg), jmake_mesh())


def test_spmd_step_on_one_rank_is_the_plain_step_in_distribution():
    """One rank (no group): the spmd step trains; its noise is the rank-0
    fold of the step's seed."""
    cfg = R._tiny_cfg()
    model = build_model(cfg, "cpu")
    step = build_shard_map_train_step(model, cfg, None, make_mesh())
    state = TrainState.create(params_from_jax(_jax_init()), SEED)
    x = torch.from_numpy(_batch(1))
    losses = []
    for _ in range(10):
        state, m = step(state, x)
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0] and state.step == 10


# ------------------------------------------------- sharded resident epochs

FRAMES = 96                        # 48 a rank of 2
CORPUS = SEG + (FRAMES - 1) * (SEG // 4)


def _corpus():
    t = np.arange(CORPUS)
    return (0.5 * np.sin(t / 7.0)
            + 0.05 * np.random.default_rng(2).standard_normal(CORPUS)
            ).astype(np.float32)


@pytest.fixture(scope="module")
def resident_runs(tmp_path_factory):
    params = _jax_init()
    frames = overlapping_frames(_corpus(), SEG, SEG // 4)
    assert len(frames) == FRAMES
    rng_ = np.random.default_rng(6)
    epochs, batch = 2, 16
    n_local, local = FRAMES // 2, batch // 2
    perms = [[rng_.permutation(n_local) for _ in range(2)]
             for _ in range(epochs)]
    n_steps = epochs * (n_local // local)
    eps = [rng_.standard_normal((batch, LATENT)).astype(np.float32)
           for _ in range(n_steps)]
    equal = dict(tpu=dict(resident_shuffle="local"), batch_size=batch,
                 frames=frames, params=params, seed=SEED, perm=perms,
                 eps=eps, epochs=epochs)
    # frames holding their shard's id: where every trained row came from
    ids = np.repeat(np.arange(4, dtype=np.float32), 24)[:, None] * np.ones(
        (1, SEG), np.float32)
    record = dict(batch_size=8, frames=ids, params=params, seed=SEED,
                  epochs=2, record=True)
    tmp = tmp_path_factory.mktemp("resident")
    two = R.launch(R.run_jobs, 2, tmp, [("resident_epochs", (equal,))])
    four = R.launch(R.run_jobs, 4, tmp, [
        ("two_pass", (24, 3)), ("two_pass", (26, 3)),
        ("resident_epochs", (dict(record, tpu=dict(
            resident_shuffle="global")),)),
        ("resident_epochs", (dict(record, tpu=dict(
            resident_shuffle="local")),)),
        ("align_rows", ([5, 3, 7, 1],)),
    ])
    return equal, two, four


def _one_device(case):
    """The port's one-device resident engine on the whole matrix, with the
    ranks' permutations merged batch by batch and the global eps."""
    cfg = R._tiny_cfg(resident_shuffle="local")
    cfg.training.batch_size = case["batch_size"]
    model = build_model(cfg, "cpu")
    n_local, local = FRAMES // 2, case["batch_size"] // 2

    def perm(epoch, n):
        p0, p1 = case["perm"][epoch]
        steps = n_local // local
        return torch.from_numpy(np.concatenate([
            np.concatenate([p0[j * local:(j + 1) * local],
                            n_local + p1[j * local:(j + 1) * local]])
            for j in range(steps)]))

    run_epochs, n_batches = resident.build_resident_epoch(
        model, cfg, None, CORPUS, "frames",
        noise=lambda s, i, shape: torch.from_numpy(case["eps"][s]),
        perm=perm)
    data = resident.put_resident(_corpus(), cfg, "frames", "cpu")
    state = TrainState.create(params_from_jax(case["params"]), SEED)
    state, losses = run_epochs(state, data, 0, k=case["epochs"])
    return losses.numpy(), R._np_params(state.params), n_batches


def test_sharded_resident_epochs_equal_the_one_device_engine(resident_runs):
    case, two, _ = resident_runs
    losses, params, n_batches = _one_device(case)
    for rank in range(2):
        got = two[rank][0]
        assert got["n_batches"] == n_batches == 6
        np.testing.assert_allclose(got["losses"], losses, rtol=LOSS_REL)
        for name, p in got["params"].items():
            np.testing.assert_allclose(p, params[name], atol=ATOL, rtol=0,
                                       err_msg=name)
    for name in two[0][0]["params"]:
        np.testing.assert_array_equal(two[0][0]["params"][name],
                                      two[1][0]["params"][name])
    np.testing.assert_array_equal(two[0][0]["losses"], two[1][0]["losses"])


@pytest.mark.parametrize("job,n_local", [(0, 24), (1, 26)])
def test_two_pass_shuffle_mixes_every_shard_into_every_rank(resident_runs,
                                                            job, n_local):
    _, _, four = resident_runs
    origins = [r[job] for r in four]
    blk = n_local // 4
    for rank, got in enumerate(origins):
        assert len(got) == n_local
        counts = np.bincount(got[: blk * 4], minlength=4)
        np.testing.assert_array_equal(counts, np.full(4, blk))
        # the rows past the largest multiple of n stay local
        assert (got[blk * 4:] == rank).all()
    every = np.concatenate(origins)
    np.testing.assert_array_equal(np.bincount(every, minlength=4),
                                  np.full(4, n_local))


def test_global_shuffle_feeds_every_rank_from_every_shard(resident_runs):
    _, _, four = resident_runs
    for rank, r in enumerate(four):
        seen = np.concatenate(r[2]["seen"])
        assert r[2]["n_batches"] == 12            # 96 rows / 4 / 2
        assert set(np.unique(seen)) == {0, 1, 2, 3}
        assert (r[2]["block"] == rank).all()      # its upload: its block


def test_local_shuffle_keeps_rows_on_their_shard(resident_runs):
    _, _, four = resident_runs
    for rank, r in enumerate(four):
        seen = np.concatenate(r[3]["seen"])
        assert (seen == rank).all()
        # every row of the shard trains once an epoch
        assert len(seen) == 2 * 24 and np.bincount(seen).max() == 48


def test_align_local_rows_pads_every_rank_to_the_largest(resident_runs):
    _, _, four = resident_runs
    counts = [5, 3, 7, 1]
    for rank, r in enumerate(four):
        local, aligned, dev = r[4]
        assert aligned.shape == (7, 8)
        np.testing.assert_array_equal(aligned, jwrap_pad_to(local, 7))
        np.testing.assert_array_equal(dev, aligned)
        assert len(local) == counts[rank]


def test_sharded_engine_refuses_a_batch_that_does_not_divide():
    from rawaudiovae_kelsey_tpu_torch.parallel.mesh import Mesh

    cfg = R._tiny_cfg()
    cfg.training.batch_size = 15
    model = build_model(cfg, "cpu")
    mesh = Mesh(2, 1, 0, torch.device("cpu"))
    with pytest.raises(ValueError, match="not divisible"):
        resident.build_resident_epoch_sharded(model, cfg, None, 96, mesh)
    cfg.training.batch_size = 64
    with pytest.raises(ValueError, match="frames/shard"):
        resident.build_resident_epoch_sharded(model, cfg, None, 40, mesh)

"""The port's data-parallel mesh (rawaudiovae_kelsey_tpu_torch/parallel/
mesh.py, the mesh step of parallel/step.py, the row-weighted loss, the
sharded sampler of ops/rng.py, the padding helpers and
infer/api.py encode_trajectory_sharded) against the JAX package on its
8-device CPU mesh (tests/conftest.py forces it).

The port's ranks are CPU processes on a gloo group (tests/torch_ranks.py,
started with ``torch.multiprocessing``); the JAX side runs in this process.
Both get the same numpy inputs, made from a seed, and the JAX init
converted with ``params_from_jax``; the JAX step's threefry ``eps``
(``fold_in(fold_in(PRNGKey(seed), step), i)``) is injected into the
port's ranks, each taking its block of the global microbatch.

Tolerances (``precision = highest``: IEEE fp32 on both sides, the same
products summed in another order), after one step: the loss rel 1e-5;
the all-reduced gradient, read through Adam's first moment (``mu = 0.1 ·
g`` after one step), within 1e-6 of each leaf's largest value (measured
≤ 2.7e-7: fp32 sums in another order); the params atol 1e-6, JAX's own
bound between its mesh step and its one-device step
(tests/test_train_step.py:255-277), on every element whose gradient is
at least ``ADAM_EPS_ZONE`` = 1e-7.  A first Adam step moves a param by
``lr · g / (|g| + 1e-8)``: where ``|g|`` is near Adam's eps of 1e-8 that
quotient turns the fp32 rounding of ``g`` into an update error of up to
``lr`` (measured 4.1e-6 at ``g = -6.2e-9``; 3 of fc4.w's 8192 elements
lie below 1e-7 here), so those elements are held at atol ``lr``, the
largest change one step can make.  The same against the port's one-device
step; the replicas equal bit for bit after 5 steps (every rank applies
the same all-reduced gradient).  The weighted loss: rel 1e-6 (one
forward, fp32).  ``encode_trajectory_sharded``: atol 1e-6 (fp32 forward).
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_ranks as R
from rawaudiovae_kelsey_tpu.config import Config as JConfig
from rawaudiovae_kelsey_tpu.data.loader import (
    pad_batches_for_mesh as jpad_batches,
)
from rawaudiovae_kelsey_tpu.models import build_model as jbuild_model
from rawaudiovae_kelsey_tpu.parallel import (
    build_train_step as jbuild_step,
    make_mesh as jmake_mesh,
)
from rawaudiovae_kelsey_tpu.parallel.mesh import batch_sharding as jsharding
from rawaudiovae_kelsey_tpu.parallel.resident import (
    _wrap_pad_to as jwrap_pad_to,
    pad_frames_for_mesh as jpad_frames,
)
from rawaudiovae_kelsey_tpu.parallel.sharding import (
    named_shardings,
    param_specs,
)
from rawaudiovae_kelsey_tpu.parallel.step import (
    make_weighted_loss_fn as jweighted,
)
from rawaudiovae_kelsey_tpu.train import TrainState as JState
from rawaudiovae_kelsey_tpu.train import build_optimizer as jbuild_opt
from rawaudiovae_kelsey_tpu_torch.compat import params_from_jax
from rawaudiovae_kelsey_tpu_torch.config import Config
from rawaudiovae_kelsey_tpu_torch.data.loader import pad_batches_for_mesh
from rawaudiovae_kelsey_tpu_torch.models import build_model
from rawaudiovae_kelsey_tpu_torch.ops import rng
from rawaudiovae_kelsey_tpu_torch.parallel import (
    build_train_step,
    make_loss_fn,
    make_mesh,
    make_weighted_loss_fn,
    noise_seed,
)
from rawaudiovae_kelsey_tpu_torch.parallel.mesh import (
    Mesh,
    batch_sharding,
    host_shard_info,
    is_coordinator,
    local_rows,
)
from rawaudiovae_kelsey_tpu_torch.parallel.resident import (
    _wrap_pad_to,
    pad_frames_for_mesh,
)
from rawaudiovae_kelsey_tpu_torch.train import TrainState

SEG, UNITS, LATENT, SEED, LR = 128, 64, 16, 0, 1e-3
BATCH, MICRO = 64, 24          # 2 microbatches of 24 and a tail of 16
LOSS_REL, ATOL, GRAD_REL = 1e-5, 1e-6, 1e-6
ADAM_EPS_ZONE = 1e-7


def _jcfg(reduction="mean", micro=0):
    cfg = JConfig()
    cfg.audio.segment_length = SEG
    cfg.audio.hop_length = SEG // 4
    cfg.vae.n_units = UNITS
    cfg.vae.latent_dim = LATENT
    cfg.training.learning_rate = LR
    cfg.training.loss_reduction = reduction
    cfg.tpu.backend = "xla"
    cfg.tpu.precision = "highest"
    cfg.tpu.microbatch_size = micro
    return cfg


def _jax_init():
    model = jbuild_model(_jcfg())
    return jax.device_get(model.init(jax.random.PRNGKey(SEED)))


def _batch(seed=3, rows=BATCH):
    return np.random.default_rng(seed).uniform(
        -1, 1, (rows, SEG)).astype(np.float32)


def _jax_eps(step, i, rows):
    key = jax.random.fold_in(jax.random.PRNGKey(SEED), step)
    if i is not None:
        key = jax.random.fold_in(key, i)
    return np.asarray(jax.random.normal(key, (rows, LATENT), jnp.float32))


def _eps_of_step(step, micro):
    if not micro:
        return {(step, None): _jax_eps(step, None, BATCH)}
    n_micro, rem = divmod(BATCH, micro)
    out = {(step, i): _jax_eps(step, i, micro) for i in range(n_micro)}
    if rem:
        out[(step, n_micro)] = _jax_eps(step, n_micro, rem)
    return out


def _jax_mesh_step(reduction, micro, params, batch):
    """One step of JAX's GSPMD mesh step (tests/test_train_step.py:
    255-277) over the 8 CPU devices."""
    cfg = _jcfg(reduction, micro)
    model = jbuild_model(cfg)
    opt = jbuild_opt(cfg)
    mesh = jmake_mesh()
    specs = param_specs(model.name, params, 1)
    sharded = jax.device_put(params, named_shardings(mesh, specs))
    state = JState.create(sharded, opt.init(sharded), seed=SEED)
    step = jbuild_step(model, cfg, opt, mesh=mesh, donate=False)
    state, m = step(state, jax.device_put(batch, jsharding(mesh)))
    return (float(m["loss"]), _leaves(jax.device_get(state.params)),
            _leaves(jax.device_get(state.opt_state[0].mu)))


def _port_cfg(reduction="mean", micro=0):
    cfg = R._tiny_cfg(microbatch_size=micro)
    cfg.training.loss_reduction = reduction
    return cfg


def _one_device_step(reduction, micro, params, batch, eps):
    cfg = _port_cfg(reduction, micro)
    step = build_train_step(
        build_model(cfg, "cpu"), cfg,
        noise=lambda s, i, shape: torch.from_numpy(eps[(s, i)]))
    state = TrainState.create(params_from_jax(params), SEED)
    state, m = step(state, torch.from_numpy(batch))
    return (float(m["loss"]), R._np_params(state.params),
            R._np_params(state.mu))


CASES = [(r, m) for r in ("mean", "sum") for m in (0, MICRO)]


@pytest.fixture(scope="module")
def mesh_runs(tmp_path_factory):
    """The port's mesh step on 2 ranks (5 steps) and on 4 ranks (1 step),
    for every case, one start of the ranks each, and the references."""
    params = _jax_init()
    batch = _batch()
    cases2, cases4, refs = [], [], []
    for reduction, micro in CASES:
        eps = {}
        for s in range(5):
            eps.update(_eps_of_step(s, micro))
        case = dict(tpu=dict(microbatch_size=micro), reduction=reduction,
                    params=params, seed=SEED, batch=batch, eps=eps)
        cases2.append(dict(case, steps=5))
        cases4.append(dict(case, steps=1))
        refs.append((_jax_mesh_step(reduction, micro, params, batch),
                     _one_device_step(reduction, micro, params, batch, eps)))
    tmp = tmp_path_factory.mktemp("mesh")
    cases2_1 = [dict(c, steps=1) for c in cases2]
    two = R.launch(R.run_jobs, 2, tmp, [("mesh_steps", (cases2_1,)),
                                        ("mesh_steps", (cases2,))])
    four = R.launch(R.mesh_steps, 4, tmp, cases4)
    return refs, two, four


def _leaves(tree):
    return {f"{n}.{k}": np.asarray(v) for n, d in tree.items()
            for k, v in d.items()}


def _hold(run, want):
    """The loss, the gradient (through ``mu``) and the params of one step
    against a reference ``(loss, params, mu)`` at the tolerances above."""
    loss, params, mu = want
    assert run["losses"][0][0] == pytest.approx(loss, rel=LOSS_REL)
    for name, got in run["params"].items():
        g = mu[name] / 0.1
        np.testing.assert_allclose(run["mu"][name], mu[name], rtol=0,
                                   atol=GRAD_REL * np.abs(mu[name]).max(),
                                   err_msg=name)
        tol = np.where(np.abs(g) >= ADAM_EPS_ZONE, ATOL, LR)
        assert np.all(np.abs(got - params[name]) <= tol), (
            name, float(np.abs(got - params[name]).max()))
        # the zone is a handful of elements, not a way around the bound
        assert (np.abs(g) < ADAM_EPS_ZONE).mean() < 1e-2, name


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("case", range(len(CASES)),
                         ids=[f"{r}-micro{m}" for r, m in CASES])
def test_mesh_step_matches_the_jax_mesh_step(mesh_runs, world, case):
    refs, two, four = mesh_runs
    runs = [r[0][case] for r in two] if world == 2 else [r[case]
                                                         for r in four]
    for run in runs:
        _hold(run, refs[case][0])


@pytest.mark.parametrize("case", range(len(CASES)),
                         ids=[f"{r}-micro{m}" for r, m in CASES])
def test_mesh_step_matches_the_one_device_step_and_replicas_agree(
        mesh_runs, case):
    refs, two, four = mesh_runs
    for run in [r[0][case] for r in two] + [r[case] for r in four]:
        _hold(run, refs[case][1])
    # 5 steps: the replicas are equal bit for bit, moments too
    r0, r1 = (r[1][case] for r in two)
    assert r0["step"] == r1["step"] == 5
    assert r0["losses"] == r1["losses"]
    for name in r0["params"]:
        np.testing.assert_array_equal(r0["params"][name],
                                      r1["params"][name])
        np.testing.assert_array_equal(r0["mu"][name], r1["mu"][name])
    assert r0["losses"][-1][0] < r0["losses"][0][0]


# ------------------------------------------------------------ the mesh

def test_make_mesh_raises_for_a_wrong_product_as_jax_does():
    with pytest.raises(ValueError) as jerr:
        jmake_mesh(3)
    with pytest.raises(ValueError) as err:
        make_mesh(2)                    # no group: one rank
    pattern = r"mesh \d+x\d+ != \d+ devices"
    assert re.fullmatch(pattern, str(jerr.value))
    assert re.fullmatch(pattern, str(err.value))
    assert str(err.value) == "mesh 2x1 != 1 devices"
    mesh = make_mesh()
    assert (mesh.data, mesh.model, mesh.rank, mesh.size) == (1, 1, 0, 1)
    assert mesh.shape == {"data": 1, "model": 1}
    assert host_shard_info() == (0, 1) and is_coordinator()


@pytest.fixture(scope="module")
def tp_groups(tmp_path_factory):
    """``make_mesh(0, 2)`` and ``make_mesh(0, 4)`` on four ranks."""
    return R.launch(R.tp_mesh_groups, 4, tmp_path_factory.mktemp("groups"),
                    [2, 4])


@pytest.mark.parametrize("model_parallel", [2, 4])
def test_model_parallel_raises_naming_the_roadmap(model_parallel,
                                                  tp_groups):
    """``model_parallel > 1`` once raised naming ROADMAP.md; the mesh now
    builds on four ranks, with its groups: a 2×2 mesh gives each rank the
    model group of its data index and the data group of its model index,
    a 1×4 mesh one model group of every rank (the default group).  One
    rank alone still refuses the product."""
    with pytest.raises(ValueError, match=f"mesh 0x{model_parallel} != 1"):
        make_mesh(0, model_parallel)
    for rank, runs in enumerate(tp_groups):
        run = runs[[2, 4].index(model_parallel)]
        data = 4 // model_parallel
        d, m = divmod(rank, model_parallel)
        assert run["shape"] == (data, model_parallel)
        assert run["position"] == (d, m)
        model_ranks = range(d * model_parallel, (d + 1) * model_parallel)
        assert run["model_sum"] == sum(model_ranks)
        assert run["data_sum"] == sum(range(m, 4, model_parallel))
        assert run["gathered"] == [[float(r) for r in model_ranks]]
        assert run["groups"] == ((True, True) if data > 1
                                 else (False, False))


@pytest.mark.parametrize("n,total,micro", [
    (2, 64, 0), (4, 64, 0), (2, 64, 24), (4, 64, 24), (4, 64, 16),
    (8, 64, 8)])
def test_local_rows_partition_every_microbatch(n, total, micro):
    meshes = [Mesh(n, 1, r, torch.device("cpu")) for r in range(n)]
    rows = [local_rows(m, total, micro) for m in meshes]
    assert sorted(np.concatenate(rows).tolist()) == list(range(total))
    for r, m in enumerate(meshes):
        assert len(rows[r]) == total // n
        if not micro:
            s = batch_sharding(m, total)
            assert rows[r].tolist() == list(range(s.start, s.stop))
            continue
        # the rank's rows of global microbatch i are its block of it
        starts = list(range(0, total, micro))
        for i, start in enumerate(starts):
            size = min(micro, total - start)
            per = size // n
            mine = rows[r][i * (micro // n): i * (micro // n) + per]
            assert mine.tolist() == list(range(start + r * per,
                                               start + (r + 1) * per))


def test_batch_sharding_refuses_a_batch_that_does_not_divide():
    with pytest.raises(ValueError, match="does not divide"):
        batch_sharding(Mesh(4, 1, 0, torch.device("cpu")), 10)


# -------------------------------------------------------- padding helpers

@pytest.mark.parametrize("sizes,n", [
    ((8, 8, 3), 4), ((8, 5), 8), ((16, 1), 4), ((7,), 2), ((9, 9), 3)])
def test_pad_batches_for_mesh_matches_jax(sizes, n):
    rng_ = np.random.default_rng(0)
    batches = [rng_.standard_normal((s, 4)).astype(np.float32)
               for s in sizes]
    got = list(pad_batches_for_mesh(iter(batches), n))
    want = list(jpad_batches(iter(batches), n))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape[0] % n == 0
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("rows,n", [(10, 4), (8, 4), (1, 8), (13, 2),
                                    (0, 4)])
def test_pad_frames_for_mesh_matches_jax(rows, n):
    frames = np.arange(rows * 3, dtype=np.float32).reshape(rows, 3)
    np.testing.assert_array_equal(pad_frames_for_mesh(frames, n),
                                  jpad_frames(frames, n))


@pytest.mark.parametrize("rows,target", [(5, 12), (5, 5), (5, 3), (1, 7)])
def test_wrap_pad_to_matches_jax(rows, target):
    frames = np.arange(rows * 2, dtype=np.float32).reshape(rows, 2)
    np.testing.assert_array_equal(_wrap_pad_to(frames, target),
                                  jwrap_pad_to(frames, target))


def test_wrap_pad_to_refuses_an_empty_shard_as_jax_does():
    empty = np.zeros((0, 8), np.float32)
    with pytest.raises(ValueError, match="no frames"):
        _wrap_pad_to(empty, 16)
    with pytest.raises(ValueError, match="no frames"):
        jwrap_pad_to(empty, 16)
    assert pad_frames_for_mesh(empty, 4).shape[0] == 0


# ------------------------------------------------------- weighted loss

@pytest.mark.parametrize("reduction", ["mean", "sum"])
def test_weighted_loss_matches_jax_and_padding_carries_no_gradient(
        reduction):
    params = _jax_init()
    jcfg = _jcfg(reduction)
    jmodel = jbuild_model(jcfg)
    real, pad = 45, 19
    batch = _batch(5, real + pad)
    wv = np.concatenate([np.ones(real), np.zeros(pad)]).astype(np.float32)
    key = jax.random.PRNGKey(11)
    jloss, (jmse, jkld) = jweighted(jmodel, jcfg)(params, key, batch, wv)
    # the JAX loss draws eps = normal(key, mu.shape): inject those numbers
    eps = torch.from_numpy(np.asarray(
        jax.random.normal(key, (real + pad, LATENT), jnp.float32)))
    cfg = _port_cfg(reduction)
    model = build_model(cfg, "cpu")
    loss_fn = make_weighted_loss_fn(model, cfg)
    tparams = params_from_jax(params)
    w = torch.from_numpy(wv)
    x = torch.from_numpy(batch)
    loss, (mse, kld) = loss_fn(tparams, eps, x, w, w.sum())
    for got, want in ((loss, jloss), (mse, jmse), (kld, jkld)):
        assert float(got) == pytest.approx(float(want), rel=1e-6)

    def grads(xb):
        p = {n: {k: v.clone().requires_grad_() for k, v in d.items()}
             for n, d in tparams.items()}
        out, _ = loss_fn(p, eps, xb, w, w.sum())
        leaves = [p[n][k] for n in sorted(p) for k in sorted(p[n])]
        return torch.autograd.grad(out, leaves)

    other = x.clone()
    other[real:] = torch.from_numpy(_batch(9, pad))   # new padding rows
    for a, b in zip(grads(x), grads(other)):
        assert torch.equal(a, b)
    # and the real rows alone, unweighted, give the same loss
    ploss, _ = make_loss_fn(model, cfg)(tparams, eps[:real], x[:real])
    assert float(loss) == pytest.approx(float(ploss), rel=1e-6)


def test_weighted_step_trains_only_on_real_rows():
    """The step's ``weights`` path: one rank, n_real = the weights' sum;
    padding rows' contents do not change the update."""
    params = _jax_init()
    cfg = _port_cfg()
    model = build_model(cfg, "cpu")
    real, pad = 40, 8
    batch = torch.from_numpy(_batch(2, real + pad))
    w = torch.cat([torch.ones(real), torch.zeros(pad)])
    eps = torch.from_numpy(_jax_eps(0, None, real + pad))
    step = build_train_step(model, cfg, noise=lambda s, i, shape: eps)
    outs = []
    for fill in (0.0, 0.5):
        xb = batch.clone()
        xb[real:] = fill
        state = TrainState.create(params_from_jax(params), SEED)
        state, m = step(state, xb, w)
        outs.append((float(m["loss"]), R._np_params(state.params)))
    assert outs[0][0] == outs[1][0]
    for name in outs[0][1]:
        np.testing.assert_array_equal(outs[0][1][name], outs[1][1][name])


# ------------------------------------------------------ sharded sampler

def test_shard_seed_is_the_jax_fold():
    seed = (0x12345678, 0x9ABCDEF0)
    for idx in range(8):
        want = np.int32(np.uint32(seed[0]).view(np.int32)) ^ (
            np.int32(idx) * np.int32(-2048144789))
        got = rng.shard_seed(seed, idx)
        assert got[0] == int(np.asarray(want).view(np.uint32))
        assert got[1] == seed[1]
    assert rng.shard_seed(seed, 0) == seed


def test_model_axis_peers_draw_the_same_words():
    """Ranks of one data index (a model-axis pair of a 2x2 grid) fold the
    same index, so they draw the same words; data-axis neighbours not."""
    dev = torch.device("cpu")
    grid = [Mesh(2, 2, r, dev) for r in range(4)]
    assert [m.data_index for m in grid] == [0, 0, 1, 1]
    words = rng.seed_words(noise_seed(SEED, 3))
    folded = [rng.shard_seed(words, m.data_index) for m in grid]
    assert folded[0] == folded[1] and folded[2] == folded[3]
    assert folded[0] != folded[2]
    a, b, c = (rng.philox_words_ref(folded[i], 16, 8) for i in (0, 1, 2))
    assert torch.equal(a, b) and not torch.equal(a, c)


@pytest.fixture(scope="module")
def sampler_runs(tmp_path_factory):
    case = dict(params=_jax_init(), seed=SEED, batch=_batch(4))
    tmp = tmp_path_factory.mktemp("sampler")
    return (R.launch(R.sampler_seeds, 2, tmp, case),
            R.launch(R.sampler_seeds, 4, tmp, case))


@pytest.mark.parametrize("world", [2, 4])
def test_each_rank_samples_with_its_folded_seed(sampler_runs, world):
    runs = sampler_runs[0 if world == 2 else 1]
    words = rng.seed_words(noise_seed(SEED, 0))
    for rank, seen in enumerate(runs):
        assert len(seen) == 1
        seed, equal = seen[0]
        assert seed == rng.shard_seed(words, rank)
        assert equal                    # z: the plain Philox, bit for bit
    # decorrelated: distinct streams, noise-level correlation (as JAX's
    # tests/test_train_step.py:674-710 holds its sharded sampler)
    eps = [rng.eps_ref(seen[0][0], 512, 128).numpy().ravel()
           for seen in runs]
    for i in range(world):
        for j in range(i + 1, world):
            assert not np.array_equal(eps[i], eps[j])
            assert abs(np.corrcoef(eps[i], eps[j])[0, 1]) < 0.05
    pooled = np.concatenate(eps)
    assert abs(pooled.mean()) < 0.05 and abs(pooled.std() - 1) < 0.05


# ------------------------------------------- encode_trajectory_sharded

def test_encode_trajectory_sharded_matches_jax_and_the_plain_encode(
        tmp_path):
    from rawaudiovae_kelsey_tpu.infer.api import (
        encode_trajectory_sharded as jencode_sharded,
    )
    from rawaudiovae_kelsey_tpu_torch.infer import encode_trajectory

    params = _jax_init()
    rng_ = np.random.default_rng(8)
    audio = (0.4 * np.sin(np.arange(37 * SEG) / 9.0)
             + 0.05 * rng_.standard_normal(37 * SEG)).astype(np.float32)
    jmodel = jbuild_model(_jcfg())
    jmu, jlv = jencode_sharded(jmodel, params, audio, jmake_mesh())
    assert len(jmu) == 37               # an odd frame count
    cases = [dict(params=params, audio=audio),
             dict(params=params, audio=audio, batch_frames=10),
             dict(params=params, audio=audio, hop=SEG // 4)]
    runs = R.launch(R.run_jobs, 2, tmp_path,
                    [("encode_sharded", (c,)) for c in cases])
    model = build_model(_port_cfg(), "cpu")
    tparams = params_from_jax(params)
    for ci, case in enumerate(cases):
        pmu, plv = encode_trajectory(model, tparams, audio,
                                     hop=case.get("hop"))
        for rank in range(2):
            mu, lv = runs[rank][ci]
            np.testing.assert_allclose(mu, pmu, atol=1e-6, rtol=0)
            np.testing.assert_allclose(lv, plv, atol=1e-6, rtol=0)
            if "hop" not in case:
                np.testing.assert_allclose(mu, jmu, atol=1e-6, rtol=0)
                np.testing.assert_allclose(lv, jlv, atol=1e-6, rtol=0)
        np.testing.assert_array_equal(runs[0][ci][0], runs[1][ci][0])


def test_config_defaults_read_data_parallel_zero_as_every_rank():
    cfg = Config()
    assert cfg.tpu.data_parallel == 0 and cfg.tpu.model_parallel == 1

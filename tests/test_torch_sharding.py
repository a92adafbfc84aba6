"""The port's tensor parallelism (rawaudiovae_kelsey_tpu_torch/parallel/
sharding.py, parallel/tensor_parallel.py, the model axis of
parallel/mesh.py and the sharded mesh step of parallel/step.py) against
the JAX package's Megatron split on its 8-device CPU mesh
(tests/conftest.py forces it; tests/test_train_step.py:280-303 is the 4×2
model-parallel step these runs stand beside).

The port's ranks are CPU processes on a gloo group (tests/torch_ranks.py):
a 2×2 mesh (data 2 × model 2, four ranks) and a 1×2 mesh (two ranks).
Both packages get the same numpy batch, made from a seed, and JAX's init
(``params_to_shards``: the JAX params, whole, then each rank's shards);
JAX's threefry ``eps`` (``fold_in(PRNGKey(seed), step)``) is injected into
the port's ranks, each taking its data index's block of the global
microbatch.

Tolerances, after one step (IEEE fp32 products on both sides, summed in
another order across the shards): the loss rel 1e-5; the gradient, read
as Adam's first moment, within 1e-6 of each leaf's largest (2^-16 under
``high``, the 3-pass products' own error); the params atol 1e-5
(JAX's own bound between its 4×2 step and its one-device step) on every
element whose gradient is at least ``ADAM_EPS_ZONE`` = 1e-7, and atol
``lr`` (the largest change one Adam step can make) below it, where
``lr · g / (|g| + 1e-8)`` turns fp32 rounding of a tiny ``g`` into an
update error of up to ``lr`` (tests/test_torch_mesh.py; at most 5 % of
the tree's elements; a gradient of exactly 0 is held at 1e-5); the same
against
the port's one-rank step.  After 3 steps the data replicas' shards are
equal bit for bit, and so are the replicated leaves (fc21.b, fc22.b,
fc4.b, the deep heads after an even encoder) across the ranks of a model
group.  The kernels' route (``backend = pallas``, whose wrappers run their
plain versions on CPU tensors) against the plain split (``xla``):
gradients within 1e-5 of each leaf's largest in fp32 (``float32``: the
primitive backward; ``high``: the full chains), within 2e-2 of it in bf16
(the split backward; bf16 roundings of partial sums taken in another
order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_ranks as R
from rawaudiovae_kelsey_tpu.config import Config as JConfig
from rawaudiovae_kelsey_tpu.models import build_model as jbuild_model
from rawaudiovae_kelsey_tpu.parallel import (
    build_train_step as jbuild_step,
    make_mesh as jmake_mesh,
)
from rawaudiovae_kelsey_tpu.parallel.mesh import batch_sharding as jsharding
from rawaudiovae_kelsey_tpu.parallel.sharding import (
    named_shardings,
    param_specs as jparam_specs,
)
from rawaudiovae_kelsey_tpu.train import TrainState as JState
from rawaudiovae_kelsey_tpu.train import build_optimizer as jbuild_opt
from rawaudiovae_kelsey_tpu_torch.compat import params_from_jax
from rawaudiovae_kelsey_tpu_torch.models import build_model
from rawaudiovae_kelsey_tpu_torch.ops import mlp
from rawaudiovae_kelsey_tpu_torch.parallel import build_train_step
from rawaudiovae_kelsey_tpu_torch.parallel.mesh import Mesh
from rawaudiovae_kelsey_tpu_torch.parallel.sharding import (
    COLUMNS,
    REPLICATED,
    ROWS,
    check_divisible,
    global_shape,
    local_slice,
    param_specs,
    shard_params,
)
from rawaudiovae_kelsey_tpu_torch.train import TrainState
from rawaudiovae_kelsey_tpu_torch.tree import flatten

SEG, UNITS, LATENT, SEED, LR = 128, 64, 16, 0, 1e-3
BATCH, MICRO = 64, 32
LOSS_REL, ATOL = 1e-5, 1e-5
# the gradient, of each leaf's largest element: fp32 sums in another order;
# under ``high`` the 3-pass products' own error, 2^-16 of a product (the
# bf16 remainders' product it drops), which an ulp's change of an operand
# moves (measured 2.9e-6 against JAX, 4.0e-6 against the one-rank step)
GRAD_REL = {"high": 2.0 ** -16}
GRAD_REL_FP32 = 1e-6
ADAM_EPS_ZONE = 1e-7
# the deep variants: an odd encoder (rows heads) with an even decoder, and
# an even encoder (replicated heads) with an odd decoder (its last layer
# forced to rows after a row-parallel one)
DEEP = {"deep3": "96,64,32", "deep2": "96,64"}


def _jcfg(precision="highest", arch="dense", hidden="", micro=0):
    cfg = JConfig()
    cfg.audio.segment_length = SEG
    cfg.audio.hop_length = SEG // 4
    cfg.vae.n_units = UNITS
    cfg.vae.latent_dim = LATENT
    cfg.vae.arch = arch
    if hidden:
        cfg.vae.hidden_dims = hidden
    if arch == "conv1d":
        cfg.vae.conv_channels = "8,16"    # two layers: 128 / 4² frames
    cfg.training.learning_rate = LR
    cfg.tpu.backend = "xla"
    cfg.tpu.precision = precision
    cfg.tpu.microbatch_size = micro
    cfg.tpu.model_parallel = 2
    return cfg


def _jax_init(arch="dense", hidden=""):
    model = jbuild_model(_jcfg(arch=arch, hidden=hidden))
    return jax.device_get(model.init(jax.random.PRNGKey(SEED)))


def _batch(seed=5):
    return np.random.default_rng(seed).uniform(
        -1, 1, (BATCH, SEG)).astype(np.float32)


def _jax_eps(step, i, rows):
    key = jax.random.fold_in(jax.random.PRNGKey(SEED), step)
    if i is not None:
        key = jax.random.fold_in(key, i)
    return np.asarray(jax.random.normal(key, (rows, LATENT), jnp.float32))


def _eps(steps, micro):
    out = {}
    for s in range(steps):
        if not micro:
            out[(s, None)] = _jax_eps(s, None, BATCH)
        else:
            for i in range(BATCH // micro):
                out[(s, i)] = _jax_eps(s, i, micro)
    return out


def _jax_tp_step(cfg, params, batch):
    """One step of JAX's 4×2 model-parallel mesh step
    (tests/test_train_step.py:280-303)."""
    model = jbuild_model(cfg)
    opt = jbuild_opt(cfg)
    mesh = jmake_mesh(data_parallel=4, model_parallel=2)
    specs = jparam_specs(model.name, params, 2)
    sharded = jax.device_put(params, named_shardings(mesh, specs))
    state = JState.create(sharded, opt.init(sharded), seed=SEED)
    step = jbuild_step(model, cfg, opt, mesh=mesh, donate=False)
    state, m = step(state, jax.device_put(batch, jsharding(mesh)))
    return (float(m["loss"]), _named(jax.device_get(state.params)),
            _named(jax.device_get(state.opt_state[0].mu)))


def _named(tree):
    return {name: np.asarray(v) for name, v in flatten(tree)}


def _one_rank_step(case):
    """The port's one-device step on the whole batch, same init and eps,
    built under the case's backward-fusion switch (``"fusion"``, "auto" if
    absent)."""
    cfg = R._tp_cfg(case)
    saved = mlp.BWD_FUSION
    mlp.BWD_FUSION = case.get("fusion", "auto")
    try:
        step = build_train_step(
            build_model(cfg, "cpu"), cfg,
            noise=lambda s, i, shape: torch.from_numpy(case["eps"][(s, i)]))
    finally:
        mlp.BWD_FUSION = saved
    state = TrainState.create(params_from_jax(case["params"]), SEED)
    state, m = step(state, torch.from_numpy(case["batch"]))
    return (float(m["loss"]), R._np_params(state.params),
            R._np_params(state.mu))


# (label, precision, arch, hidden dims, backend, microbatch) of the steps
# held against JAX's 4×2 step
STEP_CASES = [
    ("dense-highest-xla", "highest", "dense", "", "xla", 0),
    ("dense-highest-pallas", "highest", "dense", "", "pallas", 0),
    ("dense-highest-pallas-micro", "highest", "dense", "", "pallas", MICRO),
    ("dense-float32-pallas", "float32", "dense", "", "pallas", 0),
    ("dense-high-pallas", "high", "dense", "", "pallas", 0),
    ("deep3-highest-xla", "highest", "deep", DEEP["deep3"], "xla", 0),
    ("deep3-highest-pallas", "highest", "deep", DEEP["deep3"], "pallas", 0),
    ("deep2-highest-xla", "highest", "deep", DEEP["deep2"], "xla", 0),
    ("deep2-highest-pallas", "highest", "deep", DEEP["deep2"], "pallas", 0),
]
# the kernels' route against the plain split, by backward mode
MODE_CASES = [("split", "bfloat16"), ("primitive", "float32"),
              ("full", "high")]


def _case(label, precision, arch, hidden, backend, micro, steps):
    vae = {"arch": arch}
    if hidden:
        vae["hidden_dims"] = hidden
    return dict(label=label, model=2, vae=vae,
                tpu=dict(precision=precision, backend=backend,
                         microbatch_size=micro),
                params=_jax_init(arch, hidden), seed=SEED, batch=_batch(),
                eps=_eps(steps, micro), steps=steps)


@pytest.fixture(scope="module")
def tp_runs(tmp_path_factory):
    """Every case on the 2×2 mesh (1 step, and 3 steps for the replica
    checks) and on the 1×2 mesh (1 step), one start of the ranks each; the
    gradients of each backward mode's kernels and of the plain split; the
    sampler's seeds; and the references."""
    cases1 = [_case(*c, steps=1) for c in STEP_CASES]
    cases3 = [_case(*c, steps=3) for c in STEP_CASES[:2] + STEP_CASES[5:7]]
    grads = []
    for _, precision in MODE_CASES:
        for backend in ("pallas", "xla"):
            grads.append(dict(model=2, tpu=dict(precision=precision,
                                                backend=backend),
                              params=_jax_init(), batch=_batch(),
                              eps=_jax_eps(0, None, BATCH)))
    sampler = dict(model=2, params=_jax_init(), seed=SEED, batch=_batch())
    # a `high` step with the backward-fusion switch forced to "split"
    forced = [dict(_case("dense-high-split", "high", "dense", "", "pallas", 0,
                         steps=1), fusion="split")]
    tmp = tmp_path_factory.mktemp("tp")
    four = R.launch(R.run_jobs, 4, tmp, [
        ("tp_steps", (cases1,)), ("tp_steps", (cases3,)),
        ("tp_sampler_seeds", (sampler,)),
        ("tp_mesh_groups", ([2, 4],))], deadline=400)
    two = R.launch(R.run_jobs, 2, tmp, [("tp_steps", (cases1,)),
                                        ("tp_grads", (grads,)),
                                        ("tp_steps", (forced,))],
                   deadline=400)
    refs = []
    for c in cases1:
        hidden = c["vae"].get("hidden_dims", "")
        jcfg = _jcfg(c["tpu"]["precision"], c["vae"]["arch"], hidden,
                     c["tpu"]["microbatch_size"])
        refs.append((_jax_tp_step(jcfg, c["params"], c["batch"]),
                     _one_rank_step(c)))
    return {"four": four, "two": two, "refs": refs, "cases1": cases1,
            "cases3": cases3, "forced": forced[0]}


def _hold(run, want, precision):
    """The loss, the gradient (through Adam's first moment, ``mu = 0.1 ·
    g`` after one step) and the params of one step against a reference
    ``(loss, params, mu)`` at the tolerances above."""
    loss, params, mu = want
    grad_rel = GRAD_REL.get(precision, GRAD_REL_FP32)
    assert run["losses"][0][0] == pytest.approx(loss, rel=LOSS_REL)
    in_zone = total = 0
    for name, got in run["params"].items():
        np.testing.assert_allclose(run["mu"][name], mu[name], rtol=0,
                                   atol=grad_rel * np.abs(mu[name]).max(),
                                   err_msg=name)
        g = mu[name] / 0.1
        # a gradient of exactly 0 (a dead ReLU unit's row) moves nothing
        zone = (np.abs(g) < ADAM_EPS_ZONE) & (g != 0)
        tol = np.where(zone, LR, ATOL)
        assert np.all(np.abs(got - params[name]) <= tol), (
            name, float(np.abs(got - params[name]).max()))
        in_zone, total = in_zone + int(zone.sum()), total + g.size
    # the zone is a few elements of the tree, not a way around the bound
    # (the deep model's logvar head, whose gradient is mostly the small KL
    # term's, has 12 % of its elements there at its init)
    assert in_zone <= 0.05 * total


# ------------------------------------------------------------- the specs

def _word(p):
    """A JAX PartitionSpec as the port's word."""
    parts = tuple(p)
    if not any(parts):
        return REPLICATED
    if parts[0] == "model" and len(parts) == 2:
        return ROWS
    return COLUMNS


@pytest.mark.parametrize("model_parallel", [1, 2, 4])
@pytest.mark.parametrize("family", ["dense", "deep3", "deep2", "conv1d"])
def test_param_specs_equal_the_jax_specs(family, model_parallel):
    arch = "deep" if family.startswith("deep") else family
    params = _jax_init(arch, DEEP.get(family, ""))
    want = jparam_specs(arch, params, model_parallel)
    got = param_specs(arch, params_from_jax(params), model_parallel)
    jax_words = [_word(p) for p in jax.tree_util.tree_leaves(
        want, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))]
    assert [w for _, w in flatten(got)] == jax_words
    if model_parallel == 1 or arch == "conv1d":
        assert set(jax_words) == {REPLICATED}
    else:
        assert {COLUMNS, ROWS} <= set(jax_words)


@pytest.mark.parametrize("family", ["dense", "deep3", "deep2"])
@pytest.mark.parametrize("model_parallel", [2, 4])
def test_shards_put_back_together_give_the_same_bits(family,
                                                     model_parallel):
    """Every rank's ``shard_params`` (contiguous copies, never views),
    concatenated along each spec's axis, is the whole tree bit for bit;
    the shards' shapes give back the global ones."""
    arch = "deep" if family.startswith("deep") else family
    params = params_from_jax(_jax_init(arch, DEEP.get(family, "")))
    specs = param_specs(arch, params, model_parallel)
    ranks = [shard_params(params, Mesh(1, model_parallel, r,
                                       torch.device("cpu")), specs)
             for r in range(model_parallel)]
    for (name, whole), (_, spec) in zip(flatten(params), flatten(specs)):
        parts = [dict(flatten(r))[name] for r in ranks]
        assert all(p.is_contiguous() for p in parts)
        assert global_shape(parts[0], spec, model_parallel) == \
            tuple(whole.shape)
        if spec == REPLICATED:
            assert all(torch.equal(p, whole) for p in parts)
            continue
        dim = 0 if spec == ROWS else whole.dim() - 1
        assert torch.equal(torch.cat(parts, dim), whole), name
        assert parts[0].data_ptr() != whole.data_ptr()


def test_a_width_that_does_not_divide_raises_naming_the_layer():
    params = params_from_jax(_jax_init())
    specs = param_specs("dense", params, 3)
    with pytest.raises(ValueError, match=r"fc1\.b: axis 0 of \(64,\)"):
        check_divisible(params, specs, 3)
    one = Mesh(1, 4, 3, torch.device("cpu"))
    w = torch.arange(16.0).reshape(2, 8)
    assert torch.equal(local_slice(w, COLUMNS, one), w[:, 6:])
    assert torch.equal(local_slice(w, REPLICATED, one), w)


def test_the_mesh_builds_its_model_and_data_groups(tp_runs):
    """2×2: rank r at data index r // 2, model index r % 2, its model group
    the ranks of its data index, its data group those of its model index;
    1×4: one model group of every rank (the default group)."""
    ranks = [r[3] for r in tp_runs["four"]]
    for rank, (two_by_two, one_by_four) in enumerate(ranks):
        d, m = divmod(rank, 2)
        assert two_by_two["shape"] == (2, 2)
        assert two_by_two["position"] == (d, m)
        assert two_by_two["model_sum"] == 2 * d + 2 * d + 1
        assert two_by_two["data_sum"] == m + m + 2
        assert two_by_two["gathered"] == [[2.0 * d, 2.0 * d + 1]]
        assert two_by_two["slice"] == [[4.0 * m + k for k in range(4)]]
        assert two_by_two["groups"] == (True, True)
        assert one_by_four["shape"] == (1, 4)
        assert one_by_four["model_sum"] == 6
        assert one_by_four["data_sum"] == rank
        assert one_by_four["slice"] == [[2.0 * rank, 2.0 * rank + 1]]
        assert one_by_four["groups"] == (False, False)


# --------------------------------------------------------------- the step

@pytest.mark.parametrize("mesh", ["2x2", "1x2"])
@pytest.mark.parametrize("case", range(len(STEP_CASES)),
                         ids=[c[0] for c in STEP_CASES])
def test_tp_step_matches_the_jax_4x2_step(tp_runs, mesh, case):
    ranks = tp_runs["four"] if mesh == "2x2" else tp_runs["two"]
    for r in ranks:
        _hold(r[0][case], tp_runs["refs"][case][0], STEP_CASES[case][1])


@pytest.mark.parametrize("case", range(len(STEP_CASES)),
                         ids=[c[0] for c in STEP_CASES])
def test_tp_step_matches_the_one_rank_step(tp_runs, case):
    for r in tp_runs["four"] + tp_runs["two"]:
        _hold(r[0][case], tp_runs["refs"][case][1], STEP_CASES[case][1])


@pytest.mark.parametrize("case", range(4), ids=[
    c[0] for c in STEP_CASES[:2] + STEP_CASES[5:7]])
def test_replicas_and_replicated_leaves_agree_bit_for_bit(tp_runs, case):
    """After 3 steps: the ranks of one model index (the data replicas)
    hold equal shards, and the replicated leaves are equal on every rank;
    the loss went down."""
    runs = [r[1][case] for r in tp_runs["four"]]
    label = tp_runs["cases3"][case]["label"]
    arch = "deep" if label.startswith("deep") else "dense"
    specs = dict(flatten(param_specs(
        arch, params_from_jax(tp_runs["cases3"][case]["params"]), 2)))
    for m in (0, 1):
        a, b = (r for r in runs if r["position"][1] == m)
        assert a["losses"] == b["losses"]
        for name in a["shards"]:
            np.testing.assert_array_equal(a["shards"][name],
                                          b["shards"][name])
    replicated = [n for n, s in specs.items() if s == REPLICATED]
    assert replicated
    for name in replicated:
        for r in runs[1:]:
            np.testing.assert_array_equal(r["shards"][name],
                                          runs[0]["shards"][name])
    assert runs[0]["losses"][-1][0] < runs[0]["losses"][0][0]


@pytest.mark.parametrize("mode,precision", MODE_CASES,
                         ids=[m for m, _ in MODE_CASES])
def test_each_backward_mode_matches_the_plain_split(tp_runs, mode,
                                                    precision):
    """The kernels' tensor-parallel route (ShardedEncode / ShardedDecode in
    ``mode``) against the same split on plain ops, the whole gradients."""
    i = 2 * [m for m, _ in MODE_CASES].index(mode)
    rel = 2e-2 if precision == "bfloat16" else 1e-5
    for r in tp_runs["two"]:
        kern, plain = r[1][i], r[1][i + 1]
        assert kern["loss"] == pytest.approx(plain["loss"], rel=rel)
        for name, g in plain["grads"].items():
            np.testing.assert_allclose(
                kern["grads"][name], g, rtol=0,
                atol=rel * float(np.abs(g).max()), err_msg=name)


def test_a_forced_split_high_step_matches_one_rank(tp_runs):
    """A model-2 step under ``high`` with the switch forced to "split":
    ShardedEncode / ShardedDecode run ``enc_bwd_dw1`` + ``grad_accum2`` and
    ``dec_bwd_fused`` + ``grad_accum`` on the shards at the forward's three
    passes, against the one-rank step built under the same switch."""
    want = _one_rank_step(tp_runs["forced"])
    for r in tp_runs["two"]:
        _hold(r[2][0], want, "high")


def test_the_model_ranks_of_a_data_index_draw_the_same_noise(tp_runs):
    """Under ``rng = tpu_prng`` the sampler's seed words fold the data
    index only: equal on the model ranks of a data index, different
    across data indices."""
    seen = {tuple(r[2]["position"]): r[2]["seeds"] for r in tp_runs["four"]}
    assert seen[(0, 0)] == seen[(0, 1)] and seen[(1, 0)] == seen[(1, 1)]
    assert seen[(0, 0)] != seen[(1, 0)]
    assert len(seen[(0, 0)]) == 1


# ------------------------------------ the row-parallel forms' wrappers

def _stand_in(monkeypatch):
    """CUDA-free: the wrappers on ``meta`` tensors, each launch recorded."""
    from rawaudiovae_kelsey_tpu_torch.ops import _build, linear, mlp
    from rawaudiovae_kelsey_tpu_torch.ops import tensor_cores

    launched = []
    for module in (mlp, linear):
        monkeypatch.setattr(module, "cuda_device", lambda t, name: t.device)
    monkeypatch.setattr(tensor_cores, "pointers_aligned", lambda *t: True)
    monkeypatch.setattr(tensor_cores, "sm_count", lambda device: 132)
    monkeypatch.setattr(_build, "launch",
                        lambda name, dev, *args: launched.append((name, args)))
    return launched


def _meta(dtype, *shapes):
    return [torch.empty(s, device="meta", dtype=dtype) for s in shapes]


@pytest.mark.parametrize("dtype,code", [(torch.bfloat16, 1),
                                        (torch.float32, 2)])
def test_the_dense_partial_forms_launch_their_entry_points(monkeypatch,
                                                           dtype, code):
    """At model 2's shards of the default model (units 1024 of 2048) and
    the microbatch: the row-parallel entry points, every argument of their
    signatures, fp32 partial sums out, the operand dtype's hidden layer,
    the row's counters (one launch of the row, one row-parallel)."""
    from rawaudiovae_kelsey_tpu_torch.ops import _build, mlp

    launched = _stand_in(monkeypatch)
    seg, units, latent = 1024, 1024, 256
    before = (mlp.encoder_fwd.launches, mlp.encoder_fwd.partial_launches,
              mlp.decoder_fwd.partial_launches)
    mu, lv, h = mlp.encoder_fwd_partial(*_meta(
        dtype, (seg, units), (units,), (units, latent), (units, latent),
        (8192, seg)))
    assert (mu.dtype, lv.dtype, h.dtype) == (torch.float32,) * 2 + (dtype,)
    assert mu.shape == (8192, latent) and h.shape == (8192, units)
    y, h3 = mlp.decoder_fwd_partial(*_meta(
        dtype, (latent, units), (units,), (units, seg), (8192, latent)))
    assert y.dtype == torch.float32 and y.shape == (8192, seg)
    assert h3.dtype == dtype
    (enc, enc_args), (dec, dec_args) = launched
    assert enc == "rvk_encoder_fwd_partial" and dec == \
        "rvk_decoder_fwd_partial"
    for name, args in launched:
        assert len(args) == len(_build._SIGNATURES[name]) - 1, name
        assert args[-1] == code, name
    assert enc_args[9:13] == (8192, seg, units, latent)
    assert dec_args[7:11] == (8192, latent, units, seg)
    assert (mlp.encoder_fwd.launches - before[0],
            mlp.encoder_fwd.partial_launches - before[1],
            mlp.decoder_fwd.partial_launches - before[2]) == (1, 1, 1)


@pytest.mark.parametrize("ksplit", [False, True])
@pytest.mark.parametrize("dtype,k,n,code", [
    (torch.bfloat16, 2048, 2048, 1), (torch.float32, 2048, 2048, 2),
    (torch.float32, 1026, 512, 0), (torch.bfloat16, 512, 70, 0)])
def test_linear_partial_launches_the_rows_kernel(monkeypatch, ksplit,
                                                 dtype, k, n, code):
    """``linear_partial`` takes the kernel its row takes for the shape
    (tensor cores, sgemm.cuh, the first version); the first version of the
    k-split form gets its slices and an fp32 workspace, the whole-k one
    slices 0; the output is the fp32 partial sums; the launch counts in
    the row's wrapper."""
    from rawaudiovae_kelsey_tpu_torch.ops import linear

    launched = _stand_in(monkeypatch)
    wrapper = linear.linear_ksplit_fwd if ksplit else linear.linear_fwd
    before = (wrapper.launches, wrapper.partial_launches)
    x, w = _meta(dtype, (4096, k), (k, n))
    y = linear.linear_partial(x, w, ksplit)
    assert y.dtype == torch.float32 and y.shape == (4096, n)
    (name, args), = launched
    assert name == "rvk_linear_partial" and args[-1] == code
    slices = linear.ksplit_slices(k) if ksplit else 0
    assert args[4:9] == (4096, k, n, slices, linear.KSPLIT_BLOCK_K)
    ws = args[3]
    if ksplit and code == 0:
        assert ws.dtype == torch.float32 and ws.shape == (slices, 4096, n)
    else:
        assert ws is None
    assert (wrapper.launches - before[0],
            wrapper.partial_launches - before[1]) == (1, 1)

"""The port's SOM workflow (rawaudiovae_kelsey_tpu_torch/infer/som_train.py,
infer/som.py) and its ``som`` command against the JAX package's, on the
CPU.

The fit is held from JAX's own initial codebook: the test draws it as JAX
``train_som`` does (threefry), hands it to the port's ``fit_som`` and holds
the result against JAX ``train_som`` at ``atol=1e-4`` on well-separated
blobs (the two run the same fp32 schedule and products; their sums differ
in order).  The port's ``train_som`` draws its initial codebook from a
``torch.Generator`` instead, so end to end it is held to the JAX tests'
own contracts: blobs separated, dead units kept in place, artifacts in the
reference schema.  ``assign_clusters`` gives the same indices and
``write_som_artifacts`` the same bytes as JAX's.
"""

import json

import numpy as np
import pytest
import torch

import jax

from rawaudiovae_kelsey_tpu.config import Config as JConfig
from rawaudiovae_kelsey_tpu.infer import som as jsom
from rawaudiovae_kelsey_tpu.infer import som_train as jtrain
from rawaudiovae_kelsey_tpu.models import build_model as jbuild_model
from rawaudiovae_kelsey_tpu_torch.compat import params_from_jax
from rawaudiovae_kelsey_tpu_torch.config import Config, save_config
from rawaudiovae_kelsey_tpu_torch.infer import som, som_train
from rawaudiovae_kelsey_tpu_torch.io import write_wav
from rawaudiovae_kelsey_tpu_torch.models import build_model
from rawaudiovae_kelsey_tpu_torch.train import save_params

SEG, UNITS, LATENT = 64, 128, 8


def _blobs(dim=4, per=30, seed=0, scale=0.3):
    rng = np.random.default_rng(seed)
    centers = np.zeros((3, dim), np.float32)
    centers[0, 0], centers[1, 0], centers[2, 1] = 5, -5, 8
    return np.concatenate([
        c + scale * rng.standard_normal((per, dim)).astype(np.float32)
        for c in centers])


def _jax_w0(features, grid, seed):
    """JAX ``train_som``'s initial codebook (som_train.py:50-55)."""
    x = jax.numpy.asarray(features, jax.numpy.float32)
    n, dim = x.shape
    m = grid[0] * grid[1]
    key = jax.random.PRNGKey(seed)
    init_idx = jax.random.randint(key, (m,), 0, n)
    w0 = x[init_idx] + 1e-3 * jax.random.normal(
        jax.random.fold_in(key, 1), (m, dim))
    return np.array(w0)        # writable, for torch.from_numpy


@pytest.mark.parametrize("grid,iters,seed", [((3, 3), 120, 1),
                                             ((4, 2), 60, 0),
                                             ((2, 2), 1, 3)])
def test_fit_from_the_jax_codebook_matches_jax(grid, iters, seed):
    feats = _blobs(seed=seed)
    want = jtrain.train_som(feats, grid=grid, iters=iters, seed=seed)
    got = som_train.fit_som(torch.from_numpy(feats),
                            torch.from_numpy(_jax_w0(feats, grid, seed)),
                            grid, iters)
    assert got.shape == want.shape == (grid[0] * grid[1], 4)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=0)


def _command_features(n, seed=0):
    """Features at the ``som`` command's shape: ``n`` latent means of 256."""
    return np.random.default_rng(seed).standard_normal(
        (n, 256)).astype(np.float32)


def _holds_float64_fit(feats, codebook, w0, grid, iters):
    """``codebook`` as good a fit as the float64 fit from ``w0``: its
    quantization error within 5 % of the data's spread of the float64
    fit's, and every feature assigned a unit at its true least distance
    (to 1e-5 of ``‖x‖² + ‖w‖²``, the fp32 search's rounding)."""
    w64 = som_train.fit_som(torch.from_numpy(feats).double(),
                            torch.as_tensor(w0).double(), grid, iters)
    qe64, _ = som_train.fit_quality(
        feats, w64.numpy(), som_train.assign_clusters(
            feats, w64.float().numpy(), "cpu"))
    qe, gap = som_train.fit_quality(
        feats, codebook, som_train.assign_clusters(feats, codebook, "cpu"))
    spread = np.linalg.norm(feats - feats.mean(axis=0), axis=1).mean()
    assert abs(qe - qe64) <= 0.05 * spread, (qe, qe64, spread)
    assert gap <= 1e-5, gap


@pytest.mark.parametrize("n", [12, 200])
@pytest.mark.parametrize("fit", ["port", "jax", "train_som"])
def test_fit_at_the_command_shape_holds_a_float64_fit(fit, n):
    """At 8x8 units over a dozen features of 256 (units drawn from one
    sample) the fp32 fit parts from the float64 one value by value, on one
    device and in either package; it holds it in quantization error and in
    every feature's BMU distance."""
    grid, iters, seed = (8, 8), 200, 0
    feats = _command_features(n)
    w0 = _jax_w0(feats, grid, seed)
    if fit == "port":
        codebook = som_train.fit_som(torch.from_numpy(feats),
                                     torch.from_numpy(w0), grid,
                                     iters).numpy()
    elif fit == "jax":
        codebook = np.array(jtrain.train_som(feats, grid=grid, iters=iters,
                                             seed=seed))
    else:
        codebook = som_train.train_som(feats, grid=grid, iters=iters,
                                       seed=seed, device="cpu")
        w0 = som_train.initial_codebook(torch.from_numpy(feats), grid, seed)
    _holds_float64_fit(feats, codebook, w0, grid, iters)


@pytest.mark.parametrize("call", ["train_som", "assign_clusters",
                                  "sample_z"])
def test_library_calls_default_to_the_card(call):
    """Given no device, the library calls run on the card: without one
    they fail rather than fall back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from rawaudiovae_kelsey_tpu_torch.infer import api

    feats = _blobs()
    calls = {
        "train_som": lambda: som_train.train_som(feats, grid=(2, 2), iters=1),
        "assign_clusters": lambda: som_train.assign_clusters(feats,
                                                             feats[:4]),
        "sample_z": lambda: api.sample_z(1, feats, feats),
    }
    with pytest.raises((AssertionError, RuntimeError)):
        calls[call]()


def test_dead_units_hold_position():
    rng = np.random.default_rng(1)
    # all data in a tight cluster far from the origin: JAX's own test
    feats = (rng.normal(0, 0.05, (200, 8)) + 10.0).astype(np.float32)
    codebook = som_train.train_som(feats, grid=(6, 6), iters=60, seed=0,
                                   device="cpu")
    assert np.linalg.norm(codebook, axis=1).min() > 1.0
    # a unit no sample supports keeps its position bit for bit: one step
    # with a neighborhood far narrower than the grid's spacing
    x = torch.from_numpy(_blobs())
    w0 = torch.from_numpy(_jax_w0(x.numpy(), (4, 4), 2))
    w1 = som_train.fit_som(x, w0, (4, 4), iters=1, sigma0=0.01)
    won = set(som_train.assign_clusters(x.numpy(), w0.numpy(),
                                        "cpu").tolist())
    for unit in range(16):
        moved = not torch.equal(w1[unit], w0[unit])
        assert moved == (unit in won), unit


def test_training_separates_blobs():
    feats = _blobs()
    codebook = som_train.train_som(feats, grid=(3, 3), iters=120, seed=1,
                                   device="cpu")
    assert codebook.shape == (9, 4)
    assignments = som_train.assign_clusters(feats, codebook, "cpu")
    blobs = [set(assignments[i * 30:(i + 1) * 30].tolist()) for i in range(3)]
    assert all(len(b) <= 2 for b in blobs)
    assert len({assignments[i * 30] for i in range(3)}) == 3
    # the init is seeded: the same seed, the same codebook
    np.testing.assert_array_equal(
        codebook, som_train.train_som(feats, grid=(3, 3), iters=120, seed=1,
                                      device="cpu"))
    assert not np.array_equal(
        codebook, som_train.train_som(feats, grid=(3, 3), iters=120, seed=2,
                                      device="cpu"))


@pytest.mark.parametrize("seed", [0, 5])
def test_assign_clusters_matches_jax(seed):
    rng = np.random.default_rng(seed)
    feats = rng.standard_normal((57, 6)).astype(np.float32)
    codebook = rng.standard_normal((16, 6)).astype(np.float32)
    got = som_train.assign_clusters(feats, codebook, "cpu")
    want = jtrain.assign_clusters(feats, codebook)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("relative", [False, True])
def test_write_som_artifacts_gives_the_jax_bytes(tmp_path, relative):
    rng = np.random.default_rng(2)
    assignments = rng.integers(0, 9, 11)
    root = tmp_path / "audio"
    files = [root / f"s{i}.wav" for i in range(11)]
    rel = root if relative else None
    paths = som_train.write_som_artifacts(tmp_path / "port", assignments,
                                          files, relative_to=rel)
    jpaths = jtrain.write_som_artifacts(tmp_path / "jax", assignments, files,
                                        relative_to=rel)
    for p, j in zip(paths, jpaths):
        assert p.name == j.name
        assert p.read_bytes() == j.read_bytes()


def _write_corpus(folder, n=6, seed=1):
    folder.mkdir()
    rng = np.random.default_rng(seed)
    for i in range(n):
        # two families of content: tones vs noise
        if i % 2 == 0:
            wave = 0.5 * np.sin(np.linspace(0, 150 * (i + 1), SEG * 4))
        else:
            wave = rng.uniform(-0.5, 0.5, SEG * 4)
        write_wav(folder / f"s{i}.wav", wave.astype(np.float32), 44100)


def _cfg(cls):
    cfg = cls()
    cfg.audio.segment_length = SEG
    cfg.audio.hop_length = SEG // 4
    cfg.vae.n_units = UNITS
    cfg.vae.latent_dim = LATENT
    cfg.tpu.backend = "pallas"
    cfg.tpu.precision = "highest"
    return cfg


@pytest.fixture(scope="module")
def pair():
    jmodel = jbuild_model(_cfg(JConfig))
    jparams = jax.device_get(jmodel.init(jax.random.PRNGKey(0)))
    return jmodel, jparams, build_model(_cfg(Config), "cpu"), \
        params_from_jax(jparams)


def test_file_features_match_jax(tmp_path, pair):
    jmodel, jparams, model, params = pair
    _write_corpus(tmp_path / "wavs")
    got, files = som_train.extract_file_features(model, params,
                                                 tmp_path / "wavs", 44100)
    want, jfiles = jtrain.extract_file_features(jmodel, jparams,
                                                tmp_path / "wavs", 44100)
    assert files == jfiles
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    with pytest.raises(FileNotFoundError):
        som_train.extract_file_features(model, params, tmp_path, 44100)


def test_corpus_artifacts_are_read_back_by_both_packages(tmp_path, pair):
    _, _, model, params = pair
    audio_dir = tmp_path / "wavs"
    _write_corpus(audio_dir)
    clusters_path, data_path = som_train.train_som_for_corpus(
        model, params, audio_dir, tmp_path / "som", 44100, grid=(2, 2),
        iters=60)
    port = som.SomClusters(clusters_path, data_path)
    ref = jsom.SomClusters(clusters_path, data_path)
    ids = port.cluster_ids()
    assert ids == ref.cluster_ids() and ids
    assert sum(len(port.clusters[str(c)]) for c in ids) == 6
    for c in ids:
        assert port.cluster_files(c) == ref.cluster_files(c)
        np.testing.assert_array_equal(
            port.concat_audio(audio_dir, c, sr=44100),
            ref.concat_audio(audio_dir, c, sr=44100))
        np.testing.assert_array_equal(
            som.concat_audio_som(audio_dir, 44100, c, port.clusters,
                                 port.data),
            jsom.concat_audio_som(audio_dir, 44100, c, ref.clusters,
                                  ref.data))
    with pytest.raises(KeyError):
        port.cluster_files(99)


def test_som_clusters_of_hand_written_artifacts(tmp_path):
    """The reference notebook's artifacts (cells 28-29), as JAX's
    tests/test_infer.py writes them."""
    root = tmp_path / "wavs"
    root.mkdir()
    lens = {}
    for i in range(4):
        n = 1000 + i * 500
        write_wav(root / f"s{i}.wav", np.full(n, 0.2, np.float32), 22050)
        lens[i] = n
    (tmp_path / "clusters.json").write_text(
        json.dumps({"18": [0, 2], "24": [1, 3], "30": []}))
    (tmp_path / "data.json").write_text(
        json.dumps({str(i): [{"meta": i}, f"s{i}.wav"] for i in range(4)}))
    s = som.SomClusters(tmp_path / "clusters.json", tmp_path / "data.json")
    assert s.cluster_ids() == [18, 24, 30]
    assert len(s.concat_audio(root, 18)) == lens[0] + lens[2]
    assert len(som.concat_audio_som(root, 22050, 24, s.clusters,
                                    s.data)) == lens[1] + lens[3]
    with pytest.raises(ValueError, match="empty"):
        s.concat_audio(root, 30)


def _cli(monkeypatch, *argv):
    from rawaudiovae_kelsey_tpu_torch import __main__ as cli

    monkeypatch.setattr("sys.argv", ["rawaudiovae_kelsey_tpu_torch", *argv])
    cli.main()


def _run_dir(tmp_path, params):
    run = tmp_path / "run-000"
    save_config(_cfg(Config), run / "config.ini")
    save_params(run / "model" / "best_model.npz", params)
    return run


def test_som_command_on_the_cpu(tmp_path, monkeypatch, capsys, pair):
    _, _, model, params = pair
    run = _run_dir(tmp_path, params)
    _write_corpus(tmp_path / "wavs", n=8)
    out = tmp_path / "som"
    _cli(monkeypatch, "som", "--run", str(run), "--audio",
         str(tmp_path / "wavs"), "--out", str(out), "--grid", "3,2",
         "--iters", "40", "--seed", "4", "--device", "cpu")
    said = capsys.readouterr().out
    assert f"wrote {out / 'clusters.json'}" in said
    clusters = json.loads((out / "clusters.json").read_text())
    data = json.loads((out / "data-concatenated.json").read_text())
    assert sorted(i for m in clusters.values() for i in m) == list(range(8))
    assert all(0 <= int(c) < 6 for c in clusters)
    assert [data[str(i)][1] for i in range(8)] == [f"s{i}.wav"
                                                   for i in range(8)]
    # the command is the library call on the run's weights
    want = som_train.train_som_for_corpus(
        model, params, tmp_path / "wavs", tmp_path / "lib", 44100,
        grid=(3, 2), iters=40, seed=4)
    assert want[0].read_bytes() == (out / "clusters.json").read_bytes()


def test_som_command_refuses_without_a_gpu(tmp_path, monkeypatch, pair):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    run = _run_dir(tmp_path, pair[3])
    with pytest.raises(SystemExit, match="som: --device cuda but no CUDA "
                                         "device"):
        _cli(monkeypatch, "som", "--run", str(run), "--audio",
             str(tmp_path))

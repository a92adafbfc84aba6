"""The port's latent-space API (rawaudiovae_kelsey_tpu_torch/infer/api.py,
infer/audio_utils.py) and its ``tutorial`` command against the JAX
package's, on the CPU.

The same weights (``compat.params_from_jax``) and the same audio, made from
``np.random.default_rng``, go through both packages' ``encode_trajectory``,
``decode_trajectory``, ``reconstruct`` and both interpolations for the three
families, with ``backend = pallas``: the JAX side runs its Pallas kernels in
interpret mode, the port's wrappers their plain versions (CPU tensors).
Where noise enters, parity is held at ``deterministic=True``; tolerance fp32
``atol=1e-6``, as tests/test_model_parity.py.  The port's own noise (a
``torch.Generator`` per seed, not threefry) is held to its contracts: the
same seed gives the same bits, each α step its own draw, and ``z − mu``
over 10⁵ draws has the moments of ``N(0, exp(logvar))``.
"""

import numpy as np
import pytest
import torch

import jax

from rawaudiovae_kelsey_tpu.config import Config as JConfig
from rawaudiovae_kelsey_tpu.infer import api as japi
from rawaudiovae_kelsey_tpu.infer import audio_utils as jaudio
from rawaudiovae_kelsey_tpu.models import build_model as jbuild_model
from rawaudiovae_kelsey_tpu_torch.compat import params_from_jax
from rawaudiovae_kelsey_tpu_torch.config import Config, save_config
from rawaudiovae_kelsey_tpu_torch.infer import api, audio_utils
from rawaudiovae_kelsey_tpu_torch.io import read_wav, write_wav
from rawaudiovae_kelsey_tpu_torch.models import build_model
from rawaudiovae_kelsey_tpu_torch.train import save_params

SEG, HOP, UNITS, LATENT = 64, 16, 128, 8
ATOL = 1e-6
ARCHS = {
    "dense": {},
    "deep": dict(hidden_dims="96,48"),
    "conv1d": dict(conv_channels="4,8", conv_kernel=5, conv_stride=4),
}


def _cfg(cls, arch):
    cfg = cls()
    cfg.audio.segment_length = SEG
    cfg.audio.hop_length = HOP
    cfg.vae.n_units = UNITS
    cfg.vae.latent_dim = LATENT
    cfg.vae.arch = arch
    for k, v in ARCHS[arch].items():
        setattr(cfg.vae, k, v)
    cfg.tpu.backend = "pallas"
    cfg.tpu.precision = "highest"
    return cfg


@pytest.fixture(scope="module", params=list(ARCHS))
def pair(request):
    """(JAX model, its params, port model, the same params) of one
    family."""
    arch = request.param
    jmodel = jbuild_model(_cfg(JConfig, arch))
    jparams = jax.device_get(jmodel.init(jax.random.PRNGKey(3)))
    model = build_model(_cfg(Config, arch), "cpu")
    return jmodel, jparams, model, params_from_jax(jparams)


@pytest.fixture(scope="module")
def dense():
    model = build_model(_cfg(Config, "dense"), "cpu")
    return model, model.init(torch.Generator().manual_seed(0))


def _audio(n, seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / 44100.0
    return (0.4 * np.sin(2 * np.pi * 330 * (seed + 1) * t)
            + 0.1 * rng.standard_normal(n)).astype(np.float32)


def _same(got, want, atol=ATOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_allclose(got, want, atol=atol, rtol=0)


def _trajectories(pair, n=SEG * 9 + 5):
    jmodel, jparams, model, params = pair
    a, b = _audio(n, 1), _audio(n, 2)
    return [api.encode_trajectory(model, params, x) for x in (a, b)]


# -------------------------------------------------------- encode / decode --

@pytest.mark.parametrize("form,hop", [("wave", None), ("wave", HOP),
                                      ("frames", None)])
def test_encode_trajectory_matches_jax(pair, form, hop):
    jmodel, jparams, model, params = pair
    audio = _audio(SEG * 20 + 17)
    x = audio if form == "wave" else api.frame_audio(audio, SEG)
    # batch 7: the JAX side pads its tail batch, the port's stays ragged
    want = japi.encode_trajectory(jmodel, jparams, x, batch_size=7, hop=hop)
    got = api.encode_trajectory(model, params, x, batch_size=7, hop=hop)
    for g, w in zip(got, want):
        _same(g, w)
    # the batch size does not change the rows
    whole = api.encode_trajectory(model, params, x, hop=hop)
    for g, w in zip(got, whole):
        _same(g, w)


def test_decode_trajectory_matches_jax(pair):
    jmodel, jparams, model, params = pair
    z = np.random.default_rng(4).standard_normal((23, LATENT)).astype(
        np.float32)
    want = japi.decode_trajectory(jmodel, jparams, z, batch_size=5)
    got = api.decode_trajectory(model, params, z, batch_size=5)
    _same(got, want)
    assert got.shape == (23, SEG) and np.abs(got).max() <= 1.0


def test_reconstruct_matches_jax(pair):
    jmodel, jparams, model, params = pair
    audio = _audio(SEG * 11 + 3, 5)
    _same(api.reconstruct(model, params, audio, deterministic=True,
                          batch_size=4),
          japi.reconstruct(jmodel, jparams, audio, deterministic=True,
                           batch_size=4))
    # seed None is z = mu too, as key=None is
    _same(api.reconstruct(model, params, audio),
          japi.reconstruct(jmodel, jparams, audio))


# ---------------------------------------------------------- interpolation --

@pytest.mark.parametrize("alphas", [None, [0.0, 0.25, 1.0, 1.5]])
def test_interpolate_stepwise_matches_jax(pair, alphas):
    jmodel, jparams, model, params = pair
    (mu_a, lv_a), (mu_b, lv_b) = _trajectories(pair)
    want = japi.interpolate_stepwise(jmodel, jparams, mu_a, lv_a, mu_b, lv_b,
                                     alphas, deterministic=True, batch_size=6)
    got = api.interpolate_stepwise(model, params, mu_a, lv_a, mu_b, lv_b,
                                   alphas, deterministic=True, batch_size=6)
    _same(got, want)
    steps = 6 if alphas is None else len(alphas)
    assert got.shape == (steps * len(mu_a), SEG)


@pytest.mark.parametrize("alfa", ["sine", "gentle", "zeros"])
def test_interpolate_timevarying_matches_jax(pair, alfa):
    jmodel, jparams, model, params = pair
    (mu_a, lv_a), (mu_b, lv_b) = _trajectories(pair)
    curve = {"sine": api.sine_alfa(2000, cycles=3),
             "gentle": api.sine_alfa(20000, cycles=1),
             "zeros": np.zeros(10, np.float32)}[alfa]
    want = japi.interpolate_timevarying(jmodel, jparams, mu_a, lv_a, mu_b,
                                        lv_b, curve, deterministic=True)
    got = api.interpolate_timevarying(model, params, mu_a, lv_a, mu_b, lv_b,
                                      curve, deterministic=True)
    _same(got, want)


# ---------------------------------------------------------------- noise --

def test_stochastic_paths_repeat_for_a_seed(dense):
    model, params = dense
    audio = _audio(SEG * 8)
    (mu_a, lv_a), (mu_b, lv_b) = (api.encode_trajectory(model, params, x)
                                  for x in (audio, _audio(SEG * 8, 9)))
    calls = {
        "reconstruct": lambda s: api.reconstruct(model, params, audio,
                                                 seed=s),
        "stepwise": lambda s: api.interpolate_stepwise(
            model, params, mu_a, lv_a, mu_b, lv_b, seed=s),
        "timevarying": lambda s: api.interpolate_timevarying(
            model, params, mu_a, lv_a, mu_b, lv_b, api.sine_alfa(100, 2),
            seed=s),
    }
    for name, call in calls.items():
        a, b, c = call(3), call(3), call(4)
        np.testing.assert_array_equal(a, b, err_msg=name)
        assert not np.array_equal(a, c), name
        assert np.all(np.isfinite(a)), name
    mu = np.ones((5, LATENT), np.float32)
    lv = np.full((5, LATENT), -2.0, np.float32)
    np.testing.assert_array_equal(api.sample_z(None, mu, lv), mu)
    np.testing.assert_array_equal(api.sample_z(1, mu, lv, True), mu)
    np.testing.assert_array_equal(api.sample_z(1, mu, lv, device="cpu"),
                                  api.sample_z(1, mu, lv, device="cpu"))
    assert not np.array_equal(api.sample_z(1, mu, lv, device="cpu"), mu)


def test_each_alpha_step_draws_its_own_noise(dense):
    model, params = dense
    mu, lv = api.encode_trajectory(model, params, _audio(SEG * 6))
    alphas = [0.5, 0.5, 0.5]
    n = len(mu)
    det = api.interpolate_stepwise(model, params, mu, lv, mu, lv, alphas,
                                   deterministic=True)
    np.testing.assert_array_equal(det[:n], det[n:2 * n])
    out = api.interpolate_stepwise(model, params, mu, lv, mu, lv, alphas,
                                   seed=11)
    blocks = [out[i * n:(i + 1) * n] for i in range(3)]
    assert not np.array_equal(blocks[0], blocks[1])
    assert not np.array_equal(blocks[1], blocks[2])
    for i, block in enumerate(blocks):
        z = api.sample_z(11, mu, lv, device=model.device, step=i)
        np.testing.assert_array_equal(
            block, api.decode_trajectory(model, params, z))


def test_noise_moments():
    rng = np.random.default_rng(0)
    mu = rng.standard_normal((12500, LATENT)).astype(np.float32)
    lv = rng.uniform(-3, 1, (12500, LATENT)).astype(np.float32)
    z = api.sample_z(7, mu, lv, device="cpu")
    eps = (z.astype(np.float64) - mu) / np.exp(0.5 * lv.astype(np.float64))
    assert eps.size >= 10 ** 5
    assert abs(eps.mean()) < 0.015
    assert abs(eps.std() - 1.0) < 0.01
    assert abs(np.mean(eps ** 3)) < 0.05
    assert abs(np.mean(eps ** 4) - 3.0) < 0.1
    # per latent dim too: no dim is scaled by another's variance
    assert np.all(np.abs(eps.std(axis=0) - 1.0) < 0.03)


# --------------------------------------------------------------- errors --

def _raises_alike(jcall, call):
    with pytest.raises(ValueError) as want:
        jcall()
    with pytest.raises(ValueError) as got:
        call()
    assert str(got.value) == str(want.value)


def test_errors_are_the_jax_errors(pair):
    jmodel, jparams, model, params = pair
    wave_2ch = _audio(SEG * 4).reshape(-1, 2)
    cube = _audio(SEG * 3).reshape(3, 1, SEG)
    for x in (wave_2ch, cube):
        _raises_alike(lambda: japi.encode_trajectory(jmodel, jparams, x),
                      lambda: api.encode_trajectory(model, params, x))
    with pytest.raises(ValueError, match=r"wave\[:, 0\]"):
        api.encode_trajectory(model, params, wave_2ch)
    empty = np.zeros(0, np.float32)
    _raises_alike(lambda: japi.encode_trajectory(jmodel, jparams, empty),
                  lambda: api.encode_trajectory(model, params, empty))
    z0 = np.zeros((0, LATENT), np.float32)
    _raises_alike(lambda: japi.decode_trajectory(jmodel, jparams, z0),
                  lambda: api.decode_trajectory(model, params, z0))
    mu = np.zeros((10, LATENT), np.float32)
    short = mu[:2]
    bad_lv = np.zeros((1, LATENT), np.float32)
    for jfn, fn, extra in (
            (japi.interpolate_stepwise, api.interpolate_stepwise, ()),
            (japi.interpolate_timevarying, api.interpolate_timevarying,
             (np.zeros(4),))):
        # unequal trajectories, and a logvar that would broadcast
        for args in ((short, short, mu, mu), (mu, bad_lv, mu, bad_lv)):
            _raises_alike(
                lambda: jfn(jmodel, jparams, *args, *extra,
                            deterministic=True),
                lambda: fn(model, params, *args, *extra, deterministic=True))
    with pytest.raises(ValueError, match="match_audio_size"):
        api.interpolate_stepwise(model, params, short, short, mu, mu)
    with pytest.raises(ValueError, match="logvar"):
        api.interpolate_stepwise(model, params, mu, bad_lv, mu, bad_lv,
                                 deterministic=True)


# ---------------------------------------------------------- audio utils --

@pytest.mark.parametrize("lengths", [(10, 4), (4, 10), (7, 7), (1, 9)])
@pytest.mark.parametrize("mode", ["repeat", "crop"])
def test_match_audio_size_matches_jax(lengths, mode):
    rng = np.random.default_rng(sum(lengths))
    a, b = (rng.standard_normal(n).astype(np.float32) for n in lengths)
    got = audio_utils.match_audio_size(a, b, mode)
    want = jaudio.match_audio_size(a, b, mode)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
        assert g.dtype == w.dtype == np.float32
    with pytest.raises(ValueError, match="unknown mode"):
        audio_utils.match_audio_size(a, b[:-1] if len(b) > 1 else b[:0],
                                     "stretch")


@pytest.fixture
def wav_folder(tmp_path):
    d = tmp_path / "wavs"
    d.mkdir()
    rng = np.random.default_rng(8)
    for i, (n, sr) in enumerate(((5000, 44100), (3000, 22050), (7000, 44100),
                                 (2500, 44100))):
        write_wav(d / f"f{i}.wav",
                  rng.uniform(-0.5, 0.5, n).astype(np.float32), sr)
    return d


@pytest.mark.parametrize("seed", [0, 1, 17])
@pytest.mark.parametrize("resample", [False, True])
def test_concat_random_audio_matches_jax(wav_folder, seed, resample):
    got = audio_utils.concat_random_audio(wav_folder, 0.6, 44100, seed=seed,
                                          resample=resample)
    want = jaudio.concat_random_audio(wav_folder, 0.6, 44100, seed=seed,
                                      resample=resample)
    assert len(got) == int(0.6 * 44100)
    np.testing.assert_array_equal(got, want)
    with pytest.raises(FileNotFoundError):
        audio_utils.concat_random_audio(wav_folder / "none", 0.1, 44100)


# ------------------------------------------------------------- tutorial --

def _tiny_run(tmp_path, params):
    run = tmp_path / "run-000"
    save_config(_cfg(Config, "dense"), run / "config.ini")
    save_params(run / "model" / "last_model.npz", params)
    audio = tmp_path / "audio"
    audio.mkdir()
    for i in range(3):
        write_wav(audio / f"src{i}.wav", _audio(3000 + 700 * i, i), 44100)
    return run, audio


def _cli(monkeypatch, *argv):
    from rawaudiovae_kelsey_tpu_torch import __main__ as cli

    monkeypatch.setattr("sys.argv", ["rawaudiovae_kelsey_tpu_torch", *argv])
    cli.main()


def test_tutorial_command_on_the_cpu(tmp_path, monkeypatch, capsys, dense):
    run, audio = _tiny_run(tmp_path, dense[1])
    out = tmp_path / "tut"
    _cli(monkeypatch, "tutorial", "--run", str(run), "--audio", str(audio),
         "--out", str(out), "--duration", "0.2", "--device", "cpu")
    said = capsys.readouterr().out
    assert "best_model.npz not found; using last_model.npz" in said
    assert f"trajectories: ({int(0.2 * 44100) // SEG + 1}, {LATENT})" in said
    for name in ("source_a.wav", "source_b.wav", "morph_stepwise.wav",
                 "morph_timevarying.wav", "morph_gentle.wav",
                 "recon_ola.wav", "stretch_effect.wav"):
        w, sr = read_wav(out / name)
        assert sr == 44100 and w.size > 0, name
        assert np.all(np.isfinite(w)) and float(np.abs(w).max()) > 0, name
    assert (out / "comparison.png").read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"
    # the stepwise morph is six decoded trajectories of the source
    src, _ = read_wav(out / "source_a.wav")
    morph, _ = read_wav(out / "morph_stepwise.wav")
    assert len(morph) == 6 * (-(-len(src) // SEG)) * SEG


def test_tutorial_command_refuses_without_a_gpu(tmp_path, monkeypatch,
                                                dense):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    run, audio = _tiny_run(tmp_path, dense[1])
    with pytest.raises(SystemExit, match="tutorial: --device cuda but no "
                                         "CUDA device"):
        _cli(monkeypatch, "tutorial", "--run", str(run), "--audio",
             str(audio), "--out", str(tmp_path / "o"))
    assert not (tmp_path / "o").exists()


def test_example_commands_exit_cleanly_without_their_script(monkeypatch,
                                                            capsys):
    from pathlib import Path

    from rawaudiovae_kelsey_tpu_torch import __main__ as cli

    real = Path.exists
    monkeypatch.setattr(Path, "exists", lambda p: False if p.name.endswith(
        "_torch.py") else real(p))
    for cmd in ("tutorial", "export"):
        with pytest.raises(SystemExit) as e:
            cli.example(cmd, [])
        assert e.value.code == 2
        assert "not found" in capsys.readouterr().err

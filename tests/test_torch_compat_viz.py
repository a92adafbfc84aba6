"""The port's interop with the reference implementation's PyTorch
checkpoints (rawaudiovae_kelsey_tpu_torch/compat/torch_import.py), its
plotting (observe/viz.py), what they add to ``eval`` (``--params <torch
ckpt>``, ``--plot``), and the port's live-session example, against the JAX
package's, on the CPU.

The checkpoints are written here with ``torch.save`` in the reference's three
forms: a ``{'epoch', 'state_dict', 'optimizer'}`` dict (train.py:206-239), a
bare state_dict, and a whole-module pickle of a ``rawvae.model.VAE``
(train.py:243-244) read without the reference package.  Both importers must
give equal arrays; the port's are tensors on the device asked for.
"""

import json
import sys
import types

import numpy as np
import pytest
import torch

from rawaudiovae_kelsey_tpu.compat import torch_import as jimport
from rawaudiovae_kelsey_tpu.eval import cli as jeval
from rawaudiovae_kelsey_tpu.observe import viz as jviz
from rawaudiovae_kelsey_tpu_torch.compat import torch_import
from rawaudiovae_kelsey_tpu_torch.config import Config, save_config
from rawaudiovae_kelsey_tpu_torch.eval import cli as peval
from rawaudiovae_kelsey_tpu_torch.io import write_wav
from rawaudiovae_kelsey_tpu_torch.models import build_model
from rawaudiovae_kelsey_tpu_torch.models.vae import LAYERS
from rawaudiovae_kelsey_tpu_torch.observe import viz
from rawaudiovae_kelsey_tpu_torch.train import save_params

SEG, HOP, UNITS, LATENT, SR = 64, 16, 128, 8, 44100
PNG = b"\x89PNG\r\n\x1a\n"


class RefVAE(torch.nn.Module):
    """rawvae/model.py:5-17's layers (nn.Linear, weight (out, in))."""

    def __init__(self):
        super().__init__()
        self.fc1 = torch.nn.Linear(SEG, UNITS)
        self.fc21 = torch.nn.Linear(UNITS, LATENT)
        self.fc22 = torch.nn.Linear(UNITS, LATENT)
        self.fc3 = torch.nn.Linear(LATENT, UNITS)
        self.fc4 = torch.nn.Linear(UNITS, SEG)


def _reference_module(seed=0):
    torch.manual_seed(seed)
    return RefVAE()


@pytest.fixture
def checkpoints(tmp_path):
    """The reference's three checkpoint forms of one set of weights."""
    ref = _reference_module(3)
    sd = ref.state_dict()
    paths = {"dict": tmp_path / "ckpt_00500", "state_dict": tmp_path / "sd.pt",
             "module": tmp_path / "best_model.pt"}
    torch.save({"epoch": 4, "state_dict": sd,
                "optimizer": torch.optim.Adam(ref.parameters()).state_dict()},
               paths["dict"])
    torch.save(sd, paths["state_dict"])
    # a whole-module pickle of rawvae.model.VAE, as the reference saved it;
    # the stand-in package is gone again before it is read back
    pkg, mod = types.ModuleType("rawvae"), types.ModuleType("rawvae.model")

    class VAE(RefVAE):
        pass

    VAE.__module__, VAE.__qualname__ = "rawvae.model", "VAE"
    mod.VAE, pkg.model = VAE, mod
    saved = {k: sys.modules.get(k) for k in ("rawvae", "rawvae.model")}
    sys.modules.update({"rawvae": pkg, "rawvae.model": mod})
    try:
        whole = VAE()
        whole.load_state_dict(sd)
        torch.save(whole, paths["module"])
    finally:
        for k, v in saved.items():
            if v is None:
                sys.modules.pop(k, None)
            else:
                sys.modules[k] = v
    return sd, paths


@pytest.mark.parametrize("form", ["dict", "state_dict", "module"])
def test_load_torch_checkpoint_matches_jax(checkpoints, form, monkeypatch):
    sd, paths = checkpoints
    for k in ("rawvae", "rawvae.model"):
        monkeypatch.delitem(sys.modules, k, raising=False)
    got = torch_import.load_torch_checkpoint(paths[form], "cpu")
    for k in ("rawvae", "rawvae.model"):
        monkeypatch.delitem(sys.modules, k, raising=False)
    want = jimport.load_torch_checkpoint(paths[form])
    assert sorted(got) == sorted(want) == sorted(LAYERS)
    for name in LAYERS:
        for k in ("w", "b"):
            t = got[name][k]
            assert isinstance(t, torch.Tensor) and t.dtype == torch.float32
            assert t.device.type == "cpu" and t.is_contiguous()
            np.testing.assert_array_equal(t.numpy(), want[name][k])
        np.testing.assert_array_equal(got[name]["w"].numpy(),
                                      sd[f"{name}.weight"].numpy().T)


def test_state_dict_round_trip_matches_jax():
    sd = _reference_module(1).state_dict()
    got = torch_import.state_dict_to_params(sd)
    want = jimport.state_dict_to_params(sd)
    for name in LAYERS:
        for k in ("w", "b"):
            np.testing.assert_array_equal(got[name][k].numpy(),
                                          want[name][k])
    back, jback = (torch_import.params_to_state_dict(got),
                   jimport.params_to_state_dict(want))
    assert sorted(back) == sorted(jback) == sorted(sd)
    for k, v in back.items():
        assert isinstance(v, np.ndarray)
        np.testing.assert_array_equal(v, jback[k])
        np.testing.assert_array_equal(v, sd[k].numpy())
    # numpy state dicts are read as well, and the params are copies
    np_sd = {k: v.numpy().copy() for k, v in sd.items()}
    params = torch_import.state_dict_to_params(np_sd)
    np_sd["fc1.bias"][:] = 99.0
    with torch.no_grad():
        sd["fc1.bias"].fill_(99.0)
    assert float(params["fc1"]["b"].max()) < 1.0
    assert float(got["fc1"]["b"].max()) < 1.0
    with pytest.raises(KeyError, match="fc4"):
        torch_import.state_dict_to_params(
            {k: v for k, v in sd.items() if not k.startswith("fc4")})


def test_imported_params_run_the_port_model(checkpoints):
    sd, paths = checkpoints
    ref = RefVAE()
    ref.load_state_dict(sd)
    params = torch_import.load_torch_checkpoint(paths["dict"])
    model = build_model(_cfg(), "cpu")
    x = torch.from_numpy(np.random.default_rng(0).uniform(
        -1, 1, (9, SEG)).astype(np.float32))
    mu, logvar = model.encode(params, x)
    with torch.no_grad():
        h = torch.relu(ref.fc1(x))
        torch.testing.assert_close(mu, ref.fc21(h), atol=1e-6, rtol=0)
        torch.testing.assert_close(logvar, ref.fc22(h), atol=1e-6, rtol=0)
        want = torch.tanh(ref.fc4(torch.relu(ref.fc3(mu))))
    torch.testing.assert_close(model.decode(params, mu), want, atol=1e-6,
                               rtol=0)


# ----------------------------------------------------------------- plots --

@pytest.mark.parametrize("n,center", [(5000, True), (3000, False), (1, True),
                                      (100, True)])
def test_stft_and_db_match_jax(n, center):
    audio = np.random.default_rng(n).uniform(-1, 1, n).astype(np.float32)
    got = viz.stft_mag(audio, n_fft=256, hop=64, center=center)
    want = jviz.stft_mag(audio, n_fft=256, hop=64, center=center)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(viz.amplitude_to_db(got),
                                  jviz.amplitude_to_db(want))


def test_save_comparison_writes_a_png(tmp_path):
    rng = np.random.default_rng(0)
    a = rng.uniform(-1, 1, 8000).astype(np.float32)
    path = viz.save_comparison(a, 0.5 * a, SR, tmp_path / "plots" / "c.png")
    data = path.read_bytes()
    assert data[:8] == PNG and len(data) > 10_000


# ------------------------------------------------------------------ eval --

def _cfg():
    cfg = Config()
    cfg.audio.segment_length = SEG
    cfg.audio.hop_length = HOP
    cfg.vae.n_units = UNITS
    cfg.vae.latent_dim = LATENT
    cfg.tpu.backend = "xla"
    return cfg


@pytest.fixture
def run(tmp_path, checkpoints):
    """A run directory whose best_model.npz holds the checkpoints'
    weights."""
    sd, paths = checkpoints
    run = tmp_path / "run-000"
    save_config(_cfg(), run / "config.ini")
    save_params(run / "model" / "best_model.npz",
                torch_import.state_dict_to_params(sd))
    rng = np.random.default_rng(4)
    (run / "audio_logs").mkdir()
    write_wav(run / "audio_logs" / "test_original.wav",
              rng.uniform(-0.4, 0.4, 1500).astype(np.float32), SR)
    return run, paths


def _last_json(capsys):
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("{")]
    return json.loads(lines[-1])


def test_eval_reads_reference_checkpoints(run, capsys):
    run, paths = run
    capsys.readouterr()
    peval.main(["--run", str(run), "--deterministic", "--device", "cpu"])
    by_npz = _last_json(capsys)
    for form in ("dict", "state_dict", "module"):
        peval.main(["--run", str(run), "--deterministic", "--device", "cpu",
                    "--params", str(paths[form])])
        got = _last_json(capsys)
        assert got["params"] == str(paths[form])
        assert got["recon_mse"] == pytest.approx(by_npz["recon_mse"],
                                                 rel=1e-6)
        jeval.main(["--run", str(run), "--deterministic", "--params",
                    str(paths[form])])
        assert got["recon_mse"] == pytest.approx(
            _last_json(capsys)["recon_mse"], rel=1e-6)


def test_eval_plot(run, capsys):
    run, _ = run
    out = run / "audio_logs" / "eval_comparison.png"
    peval.main(["--run", str(run), "--deterministic", "--device", "cpu"])
    assert not out.exists()
    peval.main(["--run", str(run), "--deterministic", "--device", "cpu",
                "--plot", "--write-wav"])
    assert out.read_bytes()[:8] == PNG
    assert (run / "audio_logs" / "eval_reconstruction.wav").exists()
    assert _last_json(capsys)["frames"] == -(-1500 // SEG)


# ---------------------------------------------------- live-session example

def _live(monkeypatch, capsys, *argv):
    import runpy
    from pathlib import Path

    script = Path(__file__).resolve().parents[1] / "examples" / \
        "live_session_torch.py"
    monkeypatch.setattr("sys.argv", [str(script), *argv])
    runpy.run_path(str(script), run_name="__main__")
    return capsys.readouterr().out


@pytest.mark.parametrize("samples,chunk_ms", [(30, 0.5), (5000, 20.0)])
def test_live_session_example(run, tmp_path, monkeypatch, capsys, samples,
                              chunk_ms):
    """Input shorter than one segment finalizes nothing before the close:
    the example reports it instead of formatting a missing time."""
    run, _ = run
    wav = tmp_path / "in.wav"
    write_wav(wav, np.random.default_rng(1).uniform(
        -0.5, 0.5, samples).astype(np.float32), SR)
    out = tmp_path / "live"
    said = _live(monkeypatch, capsys, "--run", str(run), "--audio", str(wav),
                 "--out", str(out), "--chunk-ms", str(chunk_ms),
                 "--deterministic", "--device", "cpu")
    short = samples < SEG
    assert ("no audio before the close" in said) == short
    assert ("first audio after" in said) == (not short)
    from rawaudiovae_kelsey_tpu_torch.io import read_wav

    got, _ = read_wav(out / "live_reconstruct.wav")
    assert len(got) == -(-samples // SEG) * SEG


def test_live_session_example_refuses_without_a_gpu(run, tmp_path,
                                                    monkeypatch, capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    run, _ = run
    with pytest.raises(SystemExit, match="live_session: --device cuda but "
                                         "no CUDA device"):
        _live(monkeypatch, capsys, "--run", str(run), "--audio",
              str(tmp_path))

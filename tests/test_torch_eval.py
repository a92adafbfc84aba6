"""The port's ``eval`` command (rawaudiovae_kelsey_tpu_torch/eval/cli.py)
against the JAX package's, on run directories written by each package's
streaming trainer on a scratch dataset, on the CPU.

At z = mu (``--deterministic``) the metric is a function of the weights and
the test audio alone, so both commands must print the same reconstruction
MSE for the same run, whichever package wrote it: rel 1e-6 (the same fp32
forward through two frameworks, reduced in float64).
"""

import json

import numpy as np
import pytest

from rawaudiovae_kelsey_tpu.config import Config as JConfig
from rawaudiovae_kelsey_tpu.eval import cli as jeval
from rawaudiovae_kelsey_tpu_torch.config import Config
from rawaudiovae_kelsey_tpu_torch.eval import cli as peval
from rawaudiovae_kelsey_tpu_torch.io import write_wav

SEG, HOP, UNITS, LATENT, BATCH, SR = 64, 16, 96, 16, 32, 44100


@pytest.fixture
def folder(tmp_path):
    rng = np.random.default_rng(3)
    (tmp_path / "audio").mkdir()
    (tmp_path / "test_audio").mkdir()
    for i, n in enumerate((700, 500, 333)):
        wave = (0.5 * np.sin(np.linspace(0, 9 * (i + 1), n))).astype(
            np.float32)
        write_wav(tmp_path / "audio" / f"train{i}.wav", wave, SR)
    for i in range(2):
        wave = rng.uniform(-0.3, 0.3, 300 + 50 * i).astype(np.float32)
        write_wav(tmp_path / "test_audio" / f"test{i}.wav", wave, SR)
    return tmp_path


def small_cfg(cfg, folder, description):
    cfg.dataset.datapath = str(folder)
    cfg.audio.segment_length = SEG
    cfg.audio.hop_length = HOP
    cfg.vae.n_units = UNITS
    cfg.vae.latent_dim = LATENT
    cfg.training.batch_size = BATCH
    cfg.training.total_num_frames = 4 * BATCH
    cfg.training.checkpoint_interval = 0
    cfg.training.learning_rate = 1e-3
    cfg.extra.description = description
    cfg.tpu.precision = "highest"
    cfg.tpu.backend = "xla"
    cfg.tpu.device_resident = "never"
    return cfg


def _last_json(capsys):
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("{")]
    return json.loads(lines[-1])


@pytest.fixture
def runs(folder):
    """A run directory written by each package."""
    from rawaudiovae_kelsey_tpu.train.stream import train as jtrain
    from rawaudiovae_kelsey_tpu_torch.train.stream import train as ptrain

    jctx = jtrain(small_cfg(JConfig(), folder, "eval_jax"), verbose=False)
    pctx = ptrain(small_cfg(Config(), folder, "eval_port"), verbose=False,
                  device="cpu")
    return {"jax": jctx.workspace.workdir, "port": pctx.workspace.workdir}


@pytest.mark.parametrize("written_by", ["jax", "port"])
@pytest.mark.parametrize("which", ["best", "last"])
def test_eval_gives_the_jax_mse_at_z_equals_mu(runs, capsys, written_by,
                                               which):
    run = runs[written_by]
    capsys.readouterr()
    jeval.main(["--run", str(run), "--deterministic", "--params", which])
    want = _last_json(capsys)
    peval.main(["--run", str(run), "--deterministic", "--params", which,
                "--device", "cpu"])
    got = _last_json(capsys)
    assert got["frames"] == want["frames"] == 11     # 650 samples / 64, padded
    assert got["sampling"] == want["sampling"] == "deterministic"
    assert got["params"] == want["params"]
    assert 0 < got["recon_mse"] < 1
    assert got["recon_mse"] == pytest.approx(want["recon_mse"], rel=1e-6)


def test_eval_options(runs, capsys):
    run = runs["port"]
    capsys.readouterr()
    # an explicit npz path; the reconstruction written beside the fixture
    peval.main(["--run", str(run), "--deterministic", "--device", "cpu",
                "--params", str(run / "model" / "last_model.npz"),
                "--write-wav"])
    by_path = _last_json(capsys)
    assert (run / "audio_logs" / "eval_reconstruction.wav").exists()
    peval.main(["--run", str(run), "--deterministic", "--device", "cpu",
                "--params", "last"])
    assert _last_json(capsys)["recon_mse"] == by_path["recon_mse"]
    # sampled latents: seeded, repeatable, and not the z = mu number
    peval.main(["--run", str(run), "--device", "cpu", "--seed", "5"])
    a = _last_json(capsys)
    peval.main(["--run", str(run), "--device", "cpu", "--seed", "5"])
    b = _last_json(capsys)
    assert a["sampling"] == "stochastic"
    assert a["recon_mse"] == b["recon_mse"] != by_path["recon_mse"]
    # without the fixture's ground truth the test folder is read again
    (run / "audio_logs" / "test_original.wav").unlink()
    peval.main(["--run", str(run), "--deterministic", "--device", "cpu",
                "--params", "last"])
    assert _last_json(capsys)["recon_mse"] == pytest.approx(
        by_path["recon_mse"], rel=1e-3)     # 16-bit wav vs decoded floats
    # any other path is a reference PyTorch checkpoint: this one holds the
    # same weights as last_model.npz
    import torch

    from rawaudiovae_kelsey_tpu_torch.compat import params_to_state_dict
    from rawaudiovae_kelsey_tpu_torch.train import load_params

    template = {name: {"w": torch.zeros(a, b), "b": torch.zeros(b)}
                for name, (a, b) in (("fc1", (SEG, UNITS)),
                                     ("fc21", (UNITS, LATENT)),
                                     ("fc22", (UNITS, LATENT)),
                                     ("fc3", (LATENT, UNITS)),
                                     ("fc4", (UNITS, SEG)))}
    params = load_params(run / "model" / "last_model.npz", template)
    torch.save({"epoch": 1, "state_dict": {
        k: torch.from_numpy(v) for k, v in params_to_state_dict(
            params).items()}}, run / "model.pt")
    peval.main(["--run", str(run), "--deterministic", "--device", "cpu",
                "--params", str(run / "model.pt")])
    assert _last_json(capsys)["recon_mse"] == pytest.approx(
        by_path["recon_mse"], rel=1e-3)

"""The port's command line (rawaudiovae_kelsey_tpu_torch/__main__.py) against
the JAX package's: the ``validate`` command gives the same report and exit
code on the same folder; every command the docstring documents is
dispatched and every command it calls unported is one of the JAX CLI's; and
``data_parallel = 0``, which the JAX package reads as "all devices", says
that one device is used when several are visible.
"""

import re
import sys

import numpy as np
import pytest
import torch

import rawaudiovae_kelsey_tpu.__main__ as jcli
import rawaudiovae_kelsey_tpu_torch.__main__ as cli
from rawaudiovae_kelsey_tpu_torch.config import Config
from rawaudiovae_kelsey_tpu_torch.io.wavio import write_wav
from rawaudiovae_kelsey_tpu_torch.train import epoch, stream

SR = 8000


def _run(module, argv, monkeypatch, capsys):
    """``(exit code, stdout)`` of ``module.main()`` under ``argv``."""
    monkeypatch.setattr(sys, "argv", ["prog", *argv])
    code = 0
    try:
        module.main()
    except SystemExit as e:
        code = e.code
    return code, capsys.readouterr().out


def _folder(tmp_path, corrupt=False):
    rng = np.random.default_rng(0)
    t = np.arange(SR) / SR
    write_wav(tmp_path / "a.wav", (0.3 * np.sin(440 * t)).astype(np.float32),
              SR)
    write_wav(tmp_path / "b.wav",
              (0.1 * rng.standard_normal(SR // 2)).astype(np.float32),
              SR // 2)                                   # needs resampling
    write_wav(tmp_path / "quiet.wav", np.zeros(SR, np.float32), SR)
    write_wav(tmp_path / "loud.wav", np.ones(SR, np.float32), SR)
    if corrupt:
        (tmp_path / "broken.wav").write_bytes(b"RIFF\x00\x00not a wav")
    return tmp_path


@pytest.mark.parametrize("deep", [False, True])
@pytest.mark.parametrize("corrupt", [False, True])
def test_validate_matches_the_jax_cli(tmp_path, monkeypatch, capsys, deep,
                                      corrupt):
    folder = _folder(tmp_path, corrupt)
    argv = ["validate", str(folder), "--sr", str(SR)] + (
        ["--deep"] if deep else [])
    want = _run(jcli, argv, monkeypatch, capsys)
    got = _run(cli, argv, monkeypatch, capsys)
    assert got == want
    code, out = got
    assert code == (1 if corrupt else 0)
    assert f"{5 if corrupt else 4} files" in out and "resampled" in out
    assert ("CORRUPT: broken.wav" in out) == corrupt
    assert ("silent: quiet.wav" in out) == deep
    assert ("clipped: loud.wav" in out) == deep


def test_validate_needs_a_folder(monkeypatch, capsys):
    code, _ = _run(cli, ["validate"], monkeypatch, capsys)
    assert code == 2                                     # argparse's usage


def _commands(doc):
    """Names listed under ``Commands:`` in a CLI docstring."""
    block = doc.split("Commands:")[1]
    return re.findall(r"^  (\w+) ", block, re.M)


def test_docstring_names_only_real_commands(monkeypatch, capsys):
    documented = _commands(cli.__doc__)
    assert documented == ["train", "stream", "eval", "serve", "validate"]
    jax_commands = set(_commands(jcli.__doc__))
    m = re.search(r"Not ported yet[^:]*:\s*([\w, \n]+)\.", cli.__doc__)
    unported = [w for w in re.split(r"[,\s]+", m.group(1)) if w]
    assert unported and set(unported) <= jax_commands
    # documented and unported together are the JAX CLI's commands
    assert set(documented) | set(unported) == jax_commands
    assert not set(documented) & set(unported)
    # every documented command is dispatched (it parses its own arguments:
    # --help exits 0), every unported one is refused with exit code 2
    for cmd in documented:
        code, out = _run(cli, [cmd, "--help"], monkeypatch, capsys)
        assert code == 0 and "usage:" in out, cmd
    for cmd in unported + ["generate", "bench"]:
        code, out = _run(cli, [cmd], monkeypatch, capsys)
        assert code == 2 and "unknown command" in out, cmd


@pytest.mark.parametrize("count,device,data_parallel,says", [
    (4, "cuda", 0, True), (2, "cuda:1", 0, True), (1, "cuda", 0, False),
    (4, "cpu", 0, False), (4, "cuda", 1, False)])
def test_data_parallel_zero_on_several_gpus_says_one_is_used(
        monkeypatch, capsys, count, device, data_parallel, says):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: count)
    cfg = Config()
    cfg.tpu.data_parallel = data_parallel
    epoch.check_supported(cfg, device)
    out = capsys.readouterr().out
    assert (f"{count} CUDA devices are visible and one is used" in out) \
        == says
    assert out.count("\n") == (1 if says else 0)
    cfg.tpu.data_parallel = 2
    with pytest.raises(NotImplementedError, match="data_parallel = 2"):
        epoch.check_supported(cfg, device)


@pytest.mark.parametrize("trainer", [epoch, stream])
def test_both_trainers_say_it_before_they_set_up(tmp_path, monkeypatch,
                                                 capsys, trainer):
    class Reached(Exception):
        pass

    def setup(cfg, device):
        raise Reached

    monkeypatch.setattr(torch.cuda, "device_count", lambda: 8)
    monkeypatch.setattr(trainer.L, "setup", setup)
    cfg = Config()
    cfg.dataset.datapath = str(tmp_path)
    with pytest.raises(Reached):
        trainer.train(cfg, device="cuda")
    assert "8 CUDA devices are visible and one is used" in \
        capsys.readouterr().out

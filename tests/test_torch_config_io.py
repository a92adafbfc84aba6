"""Config, WAV I/O, framing and resynthesis of the port against the JAX
package: the port copies these pure-Python modules, so both must give equal
values and identical bytes."""

import dataclasses
from pathlib import Path

import numpy as np
import pytest

from rawaudiovae_kelsey_tpu import config as jconfig
from rawaudiovae_kelsey_tpu.infer import api as japi
from rawaudiovae_kelsey_tpu.infer import synthesis as jsynth
from rawaudiovae_kelsey_tpu.io.resample import resample as jresample
from rawaudiovae_kelsey_tpu.io import wavio as jwavio
from rawaudiovae_kelsey_tpu_torch import config
from rawaudiovae_kelsey_tpu_torch.infer import api, synthesis
from rawaudiovae_kelsey_tpu_torch.io import wavio
from rawaudiovae_kelsey_tpu_torch.io.resample import resample

CONFIGS = sorted((Path(__file__).resolve().parents[1] / "configs")
                 .glob("*.ini"))


def _asdict(cfg):
    d = {f.name: dataclasses.asdict(getattr(cfg, f.name))
         for f in dataclasses.fields(cfg) if f.name != "unknown"}
    d["unknown"] = dict(cfg.unknown)
    return d


def _shared(cfg):
    """The port's values of the keys both packages have: each port-only
    key (``config/ini.py`` ``PORT_ONLY``, the Oobleck VAE's) is at its
    default on a config the JAX package reads too, and is taken out."""
    d = _asdict(cfg)
    for (section, key), default in config.ini.PORT_ONLY.items():
        assert d[section.lower()].pop(key) == default, (section, key)
    return d


@pytest.mark.parametrize("ini", CONFIGS, ids=lambda p: p.name)
def test_every_config_parses_to_equal_values(ini):
    assert _shared(config.load_config(ini)) == \
        _asdict(jconfig.load_config(ini))


def test_default_config_selects_the_dense_kernel_path():
    cfg = config.load_config(
        Path(__file__).resolve().parents[1] / "configs" / "default.ini")
    assert cfg.tpu.backend == "pallas" and cfg.vae.arch == "dense"
    assert cfg.vae.device == "tpu"      # dead reference key, still accepted
    assert (cfg.audio.segment_length, cfg.vae.n_units,
            cfg.vae.latent_dim) == (1024, 2048, 256)


def test_saved_config_round_trips_through_both_packages(tmp_path):
    cfg = config.load_config(CONFIGS[0])
    cfg.unknown[("extra", "custom_key")] = "kept # verbatim"
    config.save_config(cfg, tmp_path / "config.ini")
    assert _asdict(jconfig.load_config(tmp_path / "config.ini")) == \
        _shared(config.load_config(tmp_path / "config.ini")) == _shared(cfg)


def test_config_validation_rejects_what_jax_rejects(tmp_path):
    bad = tmp_path / "bad.ini"
    bad.write_text("[tpu]\nbackend = triton\n")
    with pytest.raises(ValueError, match="backend"):
        config.load_config(bad)
    with pytest.raises(ValueError, match="backend"):
        jconfig.load_config(bad)


@pytest.mark.parametrize("subtype", ["float32", "pcm16"])
def test_wav_bytes_identical(subtype):
    rng = np.random.default_rng(0)
    for samples in (rng.uniform(-1, 1, 3001).astype(np.float32),
                    rng.uniform(-1, 1, (500, 2)).astype(np.float32)):
        data = wavio.encode_wav_bytes(samples, 22050, subtype)
        assert data == jwavio.encode_wav_bytes(samples, 22050, subtype)
        got, sr = wavio.decode_wav_bytes(data)
        want, jsr = jwavio.decode_wav_bytes(data)
        assert sr == jsr == 22050
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(wavio.to_mono(got, "mean"),
                                      jwavio.to_mono(want, "mean"))
    assert wavio.wav_header_bytes(77, 44100) == \
        jwavio.wav_header_bytes(77, 44100)


def test_wav_files_identical(tmp_path):
    samples = np.sin(np.linspace(0, 30, 4000)).astype(np.float32)
    wavio.write_wav(tmp_path / "a.wav", samples, 44100)
    jwavio.write_wav(tmp_path / "b.wav", samples, 44100)
    assert (tmp_path / "a.wav").read_bytes() == \
        (tmp_path / "b.wav").read_bytes()
    assert wavio.wav_info(tmp_path / "a.wav") == \
        jwavio.wav_info(tmp_path / "a.wav")


@pytest.mark.parametrize("n,hop", [(5000, None), (5000, 128), (1023, None),
                                   (1023, 128), (8192, 256)])
def test_frame_audio_identical(n, hop):
    audio = np.random.default_rng(n).uniform(-1, 1, n).astype(np.float32)
    got = api.frame_audio(audio, 1024, hop)
    want = japi.frame_audio(audio, 1024, hop)
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def test_alfa_curves_identical():
    np.testing.assert_array_equal(api.sine_alfa(500, 3.0),
                                  japi.sine_alfa(500, 3.0))
    curve = japi.sine_alfa(500, 3.0)
    for length in (37, 500, 2000):
        np.testing.assert_array_equal(api.stretch_alfa(curve, length),
                                      japi.stretch_alfa(curve, length))


def test_resample_identical():
    x = np.random.default_rng(1).uniform(-1, 1, 4410).astype(np.float32)
    for sr in (44100, 48000, 22050):
        np.testing.assert_array_equal(resample(x, sr, 44100),
                                      jresample(x, sr, 44100))


@pytest.mark.parametrize("hop", [128, 256, 1024])
def test_resynthesis_identical(hop):
    frames = np.random.default_rng(hop).uniform(
        -1, 1, (23, 1024)).astype(np.float32)
    np.testing.assert_array_equal(synthesis.overlap_add(frames, hop),
                                  jsynth.overlap_add(frames, hop))
    np.testing.assert_array_equal(synthesis.flat_concat(frames),
                                  jsynth.flat_concat(frames))
    stream = synthesis.OverlapAddStream(hop)
    pieces = [stream.add(frames[i:i + 5]) for i in range(0, 23, 5)]
    pieces.append(stream.finish())
    np.testing.assert_array_equal(np.concatenate(pieces),
                                  jsynth.overlap_add(frames, hop))

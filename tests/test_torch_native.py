"""The port's C++ wav codec binding (rawaudiovae_kelsey_tpu_torch/io/
native.py) against the JAX package's (rawaudiovae_kelsey_tpu/io/native.py)
and against the port's NumPy codec, on wavs written here from a numpy
seed: 8/16/24/32-bit PCM and float32, mono and stereo, both mixdown modes,
and a malformed file.  All comparisons are bit for bit: the two bindings
run the same source, and each conversion is one rounding of the same value
(a stereo mean is a sum of two and a halving, exact in either order).

The port builds its own library from ``native/tpuaudio.cc`` into
``build/native/``; nothing under ``native/`` may change.
"""

import hashlib
import struct

import numpy as np
import pytest

from rawaudiovae_kelsey_tpu.io import native as jnative
from rawaudiovae_kelsey_tpu_torch.io import WavFormatError, load, native
from rawaudiovae_kelsey_tpu_torch.observe import tb

REPO = native.SOURCE.parents[1]
FRAMES = 1001
# (format tag, bits) → numpy dtype of the raw samples written
PCM = {8: np.uint8, 16: np.int16, 32: np.int32}


def _native_tree():
    return {p.name: hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted((REPO / "native").iterdir()) if p.is_file()}


@pytest.fixture(scope="module")
def native_before():
    """The ``native/`` folder as it was before the port built anything."""
    return _native_tree()


@pytest.fixture(scope="module")
def built(native_before):
    if not native.native_available():
        pytest.fail("the port could not build native/tpuaudio.cc with g++")
    return native.library_path()


def _raw_wav(payload: bytes, tag: int, channels: int, bits: int,
             rate: int = 44100) -> bytes:
    block = channels * bits // 8
    fmt = struct.pack("<HHIIHH", tag, channels, rate, rate * block, block,
                      bits)
    chunks = (b"fmt " + struct.pack("<I", len(fmt)) + fmt + b"data"
              + struct.pack("<I", len(payload)) + payload)
    riff = b"WAVE" + chunks
    return b"RIFF" + struct.pack("<I", len(riff)) + riff


def _payload(kind: str, channels: int, seed: int) -> tuple:
    """(format tag, bits, little-endian payload bytes) of FRAMES random
    frames of ``kind``, full scale, the extremes included."""
    rng = np.random.default_rng(seed)
    shape = (FRAMES, channels)
    if kind == "float32":
        x = rng.uniform(-1.0, 1.0, shape).astype("<f4")
        return 3, 32, x.tobytes()
    bits = int(kind[3:])
    if bits == 24:
        v = rng.integers(-(1 << 23), 1 << 23, shape, dtype=np.int64)
        v.flat[:2] = [-(1 << 23), (1 << 23) - 1]
        b = (v & 0xFFFFFF).astype("<u4").view(np.uint8).reshape(-1, 4)
        return 1, 24, b[:, :3].tobytes()
    info = np.iinfo(PCM[bits])
    v = rng.integers(info.min, int(info.max) + 1, shape, dtype=np.int64)
    v.flat[:2] = [info.min, info.max]
    return 1, bits, v.astype(np.dtype(PCM[bits]).newbyteorder("<")).tobytes()


KINDS = ["pcm8", "pcm16", "pcm24", "pcm32", "float32"]


@pytest.mark.parametrize("mono", ["mean", "first"])
@pytest.mark.parametrize("channels", [1, 2])
@pytest.mark.parametrize("kind", KINDS)
def test_decode_mono_equals_jax_and_the_numpy_codec(tmp_path, built, kind,
                                                    channels, mono):
    tag, bits, payload = _payload(kind, channels, seed=bits_seed(kind))
    path = tmp_path / f"{kind}_{channels}.wav"
    path.write_bytes(_raw_wav(payload, tag, channels, bits, rate=22050))
    got, sr = native.decode_mono(path, mono=mono)
    assert sr == 22050 and got.dtype == np.float32
    assert got.shape == (FRAMES,)
    want, jsr = jnative.decode_mono(path, mono=mono)
    ref, rsr = native.decode_mono(path, mono=mono, force_fallback=True)
    assert jsr == rsr == 22050
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, ref)
    assert np.abs(got).max() <= 1.0


def bits_seed(kind: str) -> int:
    return KINDS.index(kind) + 11


def test_float_mono_is_copied_as_written(tmp_path, built):
    from rawaudiovae_kelsey_tpu_torch.io import write_wav

    wave = (0.5 * np.sin(np.linspace(0, 50, 12345))).astype(np.float32)
    write_wav(tmp_path / "m.wav", wave, 44100)
    got, sr = native.decode_mono(tmp_path / "m.wav")
    assert sr == 44100
    np.testing.assert_array_equal(got, wave)


def test_a_malformed_file_raises_the_numpy_codecs_error(tmp_path, built):
    bad = tmp_path / "bad.wav"
    bad.write_bytes(b"RIFF\x00\x00\x00\x00JUNK")
    with pytest.raises(WavFormatError, match="bad.wav"):
        native.decode_mono(bad)
    # a depth the C++ codec has no case for: the NumPy codec decides
    odd = tmp_path / "odd.wav"
    odd.write_bytes(_raw_wav(b"\x00" * 60, 1, 1, 12))
    with pytest.raises(WavFormatError):
        native.decode_mono(odd)
    with pytest.raises(ValueError, match="unknown mono mode"):
        native.decode_mono(bad, mono="left")


def test_load_decodes_through_the_native_codec(tmp_path, built, monkeypatch):
    tag, bits, payload = _payload("pcm16", 2, seed=5)
    path = tmp_path / "s.wav"
    path.write_bytes(_raw_wav(payload, tag, 2, bits, rate=44100))
    calls = []
    real = native.decode_mono

    def spy(p, mono="mean", force_fallback=False):
        calls.append(mono)
        return real(p, mono=mono, force_fallback=force_fallback)

    monkeypatch.setattr(native, "decode_mono", spy)
    wave, sr = load(path, mono="first")
    assert calls == ["first"] and sr == 44100
    np.testing.assert_array_equal(wave, real(path, mono="first")[0])


@pytest.mark.parametrize("size", [0, 1, 4096, 4097, 100_000])
def test_native_crc32c_equals_the_table(built, size):
    data = np.random.default_rng(size).integers(
        0, 256, size, dtype=np.uint8).tobytes()
    want = tb._crc32c_py(data)
    assert native.native_crc32c(data) == want
    assert tb.crc32c(data) == want
    assert jnative.native_crc32c(data) in (None, want)


def test_the_library_is_built_under_build_and_native_is_untouched(
        built, native_before):
    assert built.exists()
    assert built.parent == REPO / "build" / "native"
    assert built.name.startswith("libtpuaudio_") and built.suffix == ".so"
    # the committed library is not the one loaded
    assert built.resolve() != (REPO / "native" / "libtpuaudio.so").resolve()
    assert _native_tree() == native_before


def test_a_failed_build_falls_back_and_is_remembered(tmp_path, monkeypatch):
    runs = []

    def failing(*args, **kw):
        runs.append(args)
        raise native.subprocess.CalledProcessError(1, "g++")

    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native.subprocess, "run", failing)
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_lib_tried", False)
    assert not native.native_available()
    assert not native.native_available()
    assert len(runs) == 1                    # tried once for the process
    assert native.native_crc32c(b"x" * 5000) is None
    assert not list((tmp_path / "build").glob("*"))
    # the NumPy codec still decodes
    from rawaudiovae_kelsey_tpu_torch.io import write_wav

    wave = np.linspace(-0.5, 0.5, 77).astype(np.float32)
    write_wav(tmp_path / "a.wav", wave, 16000)
    got, sr = native.decode_mono(tmp_path / "a.wav")
    assert sr == 16000
    np.testing.assert_array_equal(got, wave)

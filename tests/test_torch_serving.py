"""The serving slice as a whole: the port's InferenceServer / LiveSession /
HttpInferenceServer against the JAX package's, same params, same audio.

Both servers run ``deterministic=True`` (z = mu): JAX's threefry noise
cannot be reproduced in PyTorch, so that is where parity is held.  Both use
``backend = pallas``: the JAX side runs its Pallas kernels in interpret
mode on the CPU, the port's wrappers their plain versions (CPU tensors).
Tolerance ``atol=1e-5``: the fp32 model differs by ~1e-6
(tests/test_model_parity.py), and overlap-add divides by window sums.
"""

import http.client
import io

import jax
import numpy as np
import pytest
import torch

from rawaudiovae_kelsey_tpu.config import Config as JConfig
from rawaudiovae_kelsey_tpu.infer.http import (
    HttpInferenceServer as JHttpInferenceServer,
)
from rawaudiovae_kelsey_tpu.infer.server import (
    InferenceServer as JInferenceServer,
)
from rawaudiovae_kelsey_tpu.models import build_model as jbuild_model
from rawaudiovae_kelsey_tpu_torch.compat import params_from_jax
from rawaudiovae_kelsey_tpu_torch.config import Config
from rawaudiovae_kelsey_tpu_torch.infer import (
    HttpInferenceServer,
    InferenceServer,
)
from rawaudiovae_kelsey_tpu_torch.io.wavio import (
    decode_wav_bytes,
    encode_wav_bytes,
)
from rawaudiovae_kelsey_tpu_torch.models import build_model

SEG, UNITS, LATENT = 256, 512, 64
BATCH = 64
ATOL = 1e-5
TIMEOUT = 120


def _configs():
    jcfg, cfg = JConfig(), Config()
    for c in (jcfg, cfg):
        c.audio.segment_length = SEG
        c.vae.n_units, c.vae.latent_dim = UNITS, LATENT
        c.tpu.backend = "pallas"
    return jcfg, cfg


@pytest.fixture(scope="module")
def models():
    jcfg, cfg = _configs()
    jmodel = jbuild_model(jcfg)
    jparams = jax.device_get(jmodel.init(jax.random.PRNGKey(11)))
    model = build_model(cfg, "cpu")
    return jmodel, jparams, model, params_from_jax(jparams)


@pytest.fixture(scope="module")
def servers(models):
    jmodel, jparams, model, params = models
    pair = {}
    for quantize in (False, True):
        j = JInferenceServer(jmodel, jparams, batch_size=BATCH,
                             deterministic=True, quantize=quantize).start()
        t = InferenceServer(model, params, batch_size=BATCH,
                            deterministic=True, quantize=quantize).start()
        pair[quantize] = (j, t)
    yield pair
    for j, t in pair.values():
        j.stop()
        t.stop()


def _audio(n, seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / 44100.0
    return (0.4 * np.sin(2 * np.pi * 330 * t)
            + 0.05 * rng.standard_normal(n)).astype(np.float32)


def _same(got, want, atol=ATOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_allclose(got, want, atol=atol, rtol=0)


@pytest.mark.parametrize("quantize", [False, True])
@pytest.mark.parametrize("hop,ola", [(None, False), (128, True),
                                     (64, False)])
def test_reconstruct_matches_jax(servers, quantize, hop, ola):
    j, t = servers[quantize]
    audio = _audio(9000)
    _same(t.reconstruct(audio, hop=hop, ola=ola).result(TIMEOUT),
          j.reconstruct(audio, hop=hop, ola=ola).result(TIMEOUT))


def test_encode_decode_match_jax(servers):
    j, t = servers[False]
    audio = _audio(20000, seed=1)    # 79 frames: two device batches
    (mu, lv), (jmu, jlv) = (s.encode(audio).result(TIMEOUT) for s in (t, j))
    _same(mu, jmu)
    _same(lv, jlv)
    _same(t.decode(mu).result(TIMEOUT), j.decode(jmu).result(TIMEOUT))
    _, (_, tq) = None, servers[True]
    _same(tq.decode(mu).result(TIMEOUT),
          servers[True][0].decode(jmu).result(TIMEOUT))


@pytest.mark.parametrize("mode", ["stepwise", "alfa"])
def test_interpolate_matches_jax(servers, mode):
    j, t = servers[False]
    a, b = _audio(6000, seed=2), _audio(7000, seed=3)
    kw = ({"alphas": [0.0, 0.3, 1.0]} if mode == "stepwise"
          else {"alfa": np.sin(np.linspace(-3, 3, 50)).astype(np.float32),
                "hop": 128, "ola": True})
    _same(t.interpolate(a, b, **kw).result(TIMEOUT),
          j.interpolate(a, b, **kw).result(TIMEOUT))


@pytest.mark.parametrize("hop,ola", [(None, False), (128, True)])
def test_reconstruct_stream_matches_jax_and_whole(servers, hop, ola):
    j, t = servers[False]
    audio = _audio(12000, seed=4)
    n, gen = t.reconstruct_stream(audio, hop=hop, ola=ola, chunk_frames=10,
                                  timeout=TIMEOUT)
    jn, jgen = j.reconstruct_stream(audio, hop=hop, ola=ola,
                                    chunk_frames=10, timeout=TIMEOUT)
    got, want = np.concatenate(list(gen)), np.concatenate(list(jgen))
    assert n == jn
    _same(got, want)
    np.testing.assert_array_equal(
        got, t.reconstruct(audio, hop=hop, ola=ola).result(TIMEOUT))


@pytest.mark.parametrize("target", [False, True])
def test_live_session_matches_jax(servers, target):
    j, t = servers[False]
    audio = _audio(11000, seed=5)
    kw = {"hop": 128, "ola": True, "timeout": TIMEOUT}
    if target:
        kw.update(target=_audio(3000, seed=6), alpha=0.3)
    outs = []
    for server in (t, j):
        sess = server.live_session(**kw)
        pieces = [sess.feed(audio[i:i + 1700]) for i in range(0, 11000, 1700)]
        pieces.append(sess.close())
        outs.append(np.concatenate(pieces))
    _same(outs[0], outs[1])
    if not target:   # chunked live input == the one-shot path, bit for bit
        np.testing.assert_array_equal(
            outs[0], t.reconstruct(audio, hop=128, ola=True).result(TIMEOUT))


def test_noise_is_seeded_per_tick_and_warmup_free(models):
    _, _, model, params = models
    audio = _audio(5000, seed=7)
    runs = []
    for warm in (False, True, False):
        s = InferenceServer(model, params, batch_size=BATCH, seed=3)
        with s:
            if warm:
                s.warmup()
            runs.append(s.reconstruct(audio).result(TIMEOUT))
    np.testing.assert_array_equal(runs[0], runs[1])
    np.testing.assert_array_equal(runs[0], runs[2])
    with InferenceServer(model, params, batch_size=BATCH, seed=4) as s:
        other = s.reconstruct(audio).result(TIMEOUT)
    with InferenceServer(model, params, batch_size=BATCH,
                         deterministic=True) as s:
        mean = s.reconstruct(audio).result(TIMEOUT)
    assert not np.array_equal(runs[0], other)
    assert not np.array_equal(runs[0], mean)
    assert np.isfinite(runs[0]).all() and runs[0].shape == mean.shape


def test_stochastic_interpolate_and_morph_are_reproducible(models):
    _, _, model, params = models
    a, b = _audio(4000, seed=8), _audio(4000, seed=9)
    outs = []
    for _ in range(2):
        with InferenceServer(model, params, batch_size=BATCH, seed=1) as s:
            sess = s.live_session(target=b, alpha=0.5, session_seed=2,
                                  timeout=TIMEOUT)
            outs.append((s.interpolate(a, b).result(TIMEOUT),
                         np.concatenate([sess.feed(a), sess.close()])))
    for x, y in zip(*outs):
        np.testing.assert_array_equal(x, y)


def test_server_lifecycle(models):
    _, _, model, params = models
    s = InferenceServer(model, params, batch_size=BATCH)
    with pytest.raises(RuntimeError, match="not started"):
        s.reconstruct(_audio(3000))
    with s:
        assert s.warmup() is s
        assert s.reconstruct(_audio(100)).result(TIMEOUT).shape == (SEG,)
    with pytest.raises(RuntimeError, match="not started"):
        s.encode(_audio(3000))
    s.start()  # restartable
    try:
        assert s.decode(np.zeros((3, LATENT))).result(TIMEOUT).shape == \
            (3, SEG)
    finally:
        s.stop()


def _post(port, path, body):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=TIMEOUT)
    try:
        conn.request("POST", path, body=body)
        resp = conn.getresponse()
        return resp.status, resp.read()
    finally:
        conn.close()


@pytest.mark.parametrize("query", ["", "?hop=128&ola=1"])
def test_http_reconstruct_matches_jax(models, query):
    jmodel, jparams, model, params = models
    body = encode_wav_bytes(_audio(9000, seed=10), 44100)
    outs = []
    for server in (HttpInferenceServer(model, params, port=0,
                                       batch_size=BATCH, deterministic=True,
                                       warmup=True),
                   JHttpInferenceServer(jmodel, jparams, port=0,
                                        batch_size=BATCH,
                                        deterministic=True)):
        with server:
            status, data = _post(server.port, "/reconstruct" + query, body)
        assert status == 200
        outs.append(decode_wav_bytes(data))
    (got, sr), (want, jsr) = outs
    assert sr == jsr == 44100
    _same(got, want)


def test_http_endpoints_of_the_port(models):
    _, _, model, params = models
    audio = _audio(9000, seed=12)
    with HttpInferenceServer(model, params, port=0, batch_size=BATCH,
                             deterministic=True) as server:
        conn = http.client.HTTPConnection("127.0.0.1", server.port,
                                          timeout=TIMEOUT)
        conn.request("GET", "/healthz")
        info = __import__("json").loads(conn.getresponse().read())
        conn.close()
        assert info["status"] == "ok" and info["latent_dim"] == LATENT
        status, data = _post(server.port, "/encode",
                             encode_wav_bytes(audio, 44100))
        assert status == 200
        with np.load(io.BytesIO(data)) as npz:
            mu = npz["mu"]
        buf = io.BytesIO()
        np.savez(buf, z=mu)
        status, data = _post(server.port, "/decode", buf.getvalue())
        assert status == 200
        frames, _ = decode_wav_bytes(data)
        assert frames.shape == (len(mu) * SEG, 1)
        status, _ = _post(server.port, "/reconstruct?hop=100", b"")
        assert status == 400


def test_serve_command_refuses_to_run_without_a_gpu(tmp_path, monkeypatch):
    from rawaudiovae_kelsey_tpu_torch import __main__ as cli

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(SystemExit, match="no CUDA device"):
        cli.serve(["--run", str(tmp_path)])

#!/usr/bin/env python
"""Live session on the PyTorch port (the counterpart of
``examples/live_session.py``) — the chunked-input analog of the reference
tutorial's interactive encode→morph→listen loop (tutorial.ipynb cells 14-22,
36-37), which re-ran a whole clip per iteration.  Here audio is fed
in small chunks (as a live instrument or microphone would deliver it) and
reconstructed/morphed output streams back with cross-chunk overlap-add
continuity.

Two transports, same semantics:

  * library (default): ``InferenceServer.live_session`` fed in-process;
  * ``--http``: a loopback ``HttpInferenceServer`` driven through the real
    ``POST /session/open → /session/<id>/feed → /session/<id>/close``
    endpoints.

With ``--target`` the session morphs: every live frame's latent is lerped
toward the target clip's trajectory with weight ``--alpha`` (tutorial cell
16/36 lerp semantics, applied causally per live frame).

The session runs on a CUDA device (``--device cpu`` runs the plain PyTorch
path on the CPU).  Input shorter than one segment yields no audio before the
close: the time to first audio is then reported as none.

Usage:
    python examples/live_session_torch.py --run <workdir> \
        --audio <wav-or-folder> [--target morph.wav --alpha 0.6] \
        [--chunk-ms 250] [--hop 512 --ola] [--http] [--out live_out/] \
        [--device cuda]
"""

from __future__ import annotations

import argparse
import os
import sys
import time
from pathlib import Path

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

from rawaudiovae_kelsey_tpu_torch.infer import (  # noqa: E402
    HttpInferenceServer,
    InferenceServer,
    concat_random_audio,
)
from rawaudiovae_kelsey_tpu_torch.infer.runs import (  # noqa: E402
    load_run,
    resolve_device,
)
from rawaudiovae_kelsey_tpu_torch.io import read_wav, write_wav  # noqa: E402
from rawaudiovae_kelsey_tpu_torch.io.resample import resample  # noqa: E402
from rawaudiovae_kelsey_tpu_torch.io.wavio import (  # noqa: E402
    decode_wav_bytes,
    encode_wav_bytes,
)


def _load_wave(path: Path, sr: int, duration: float, seed: int) -> np.ndarray:
    """A wav file (resampled to the model rate) or a random concat from a
    folder of wavs (tutorial cells 24-25)."""
    if path.is_dir():
        return concat_random_audio(path, duration, sr, seed=seed)
    wave, file_sr = read_wav(path)
    if wave.ndim > 1:
        wave = wave.mean(axis=1)
    if file_sr != sr:
        wave = resample(wave, file_sr, sr)
    return wave.astype(np.float32)


def _feed_library(server, wave, chunk_n, *, hop, ola, target, alpha):
    """In-process session: feed chunks, collect finalized pieces."""
    pieces, first_audio_s = [], None
    t0 = time.perf_counter()
    with server.live_session(hop=hop, ola=ola, target=target,
                             alpha=alpha) as sess:
        for i in range(0, len(wave), chunk_n):
            piece = sess.feed(wave[i:i + chunk_n])
            if piece.size and first_audio_s is None:
                first_audio_s = time.perf_counter() - t0
            pieces.append(piece)
        pieces.append(sess.close())
    return np.concatenate(pieces), first_audio_s, time.perf_counter() - t0


def _feed_http(model, params, sr, wave, chunk_n, *, hop, ola, target, alpha,
               deterministic):
    """The same session through the real HTTP endpoints on a loopback
    server (what a DAW plugin or remote client would speak)."""
    import http.client
    import io
    import json

    def post(port, path, body):
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
        conn.request("POST", path, body=body)
        resp = conn.getresponse()
        data = resp.read()
        conn.close()
        return resp.status, data

    with HttpInferenceServer(model, params, sampling_rate=sr, port=0,
                             deterministic=deterministic) as srv:
        open_path = f"/session/open?alpha={alpha}"
        if hop:
            open_path += f"&hop={hop}&ola={int(bool(ola))}"
        body = b""
        if target is not None:
            buf = io.BytesIO()
            np.savez(buf, target=target, sr=sr)
            body = buf.getvalue()
        status, data = post(srv.port, open_path, body)
        assert status == 200, data
        sid = json.loads(data)["session"]

        pieces, first_audio_s = [], None
        t0 = time.perf_counter()
        for i in range(0, len(wave), chunk_n):
            status, piece = post(srv.port, f"/session/{sid}/feed",
                                 encode_wav_bytes(wave[i:i + chunk_n], sr))
            assert status == 200, piece
            samples, _ = decode_wav_bytes(piece, name="<feed>")
            if samples.size and first_audio_s is None:
                first_audio_s = time.perf_counter() - t0
            pieces.append(samples)
        status, tail = post(srv.port, f"/session/{sid}/close", b"")
        assert status == 200, tail
        samples, _ = decode_wav_bytes(tail, name="<close>")
        pieces.append(samples)
        return np.concatenate(pieces), first_audio_s, time.perf_counter() - t0


def main() -> None:
    ap = argparse.ArgumentParser(prog="live_session")
    ap.add_argument("--run", type=Path, required=True,
                    help="run workspace containing model/best_model.npz")
    ap.add_argument("--audio", type=Path, required=True,
                    help="live-input wav file, or a folder to random-concat")
    ap.add_argument("--config", type=Path, default=None,
                    help="INI (defaults to <run>/config.ini)")
    ap.add_argument("--target", type=Path, default=None,
                    help="morph target wav (omit for plain reconstruction)")
    ap.add_argument("--alpha", type=float, default=0.5)
    ap.add_argument("--chunk-ms", type=float, default=250.0,
                    help="milliseconds of audio per feed")
    ap.add_argument("--hop", type=int, default=0,
                    help="overlapping analysis hop (0 = non-overlapping)")
    ap.add_argument("--ola", action="store_true",
                    help="windowed overlap-add resynthesis (needs --hop)")
    ap.add_argument("--http", action="store_true",
                    help="drive the /session HTTP endpoints on a loopback "
                         "server instead of the in-process library path")
    ap.add_argument("--deterministic", action="store_true",
                    help="z = mu (bit-identical to the one-shot path)")
    ap.add_argument("--duration", type=float, default=4.0,
                    help="seconds to concat when --audio is a folder")
    ap.add_argument("--out", type=Path, default=Path("live_out"))
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", type=str, default="cuda",
                    help="torch device to serve on (default: cuda)")
    args = ap.parse_args()

    device = resolve_device(args.device, "live_session")
    cfg, model, params = load_run(args.run, args.config, device)
    sr = cfg.audio.sampling_rate
    args.out.mkdir(parents=True, exist_ok=True)

    wave = _load_wave(args.audio, sr, args.duration, args.seed)
    target = (_load_wave(args.target, sr, args.duration, args.seed + 1)
              if args.target else None)
    chunk_n = max(1, int(args.chunk_ms / 1e3 * sr))
    hop = args.hop or None
    mode = "morph" if target is not None else "reconstruct"
    print(f"live session ({'http' if args.http else 'library'}, {mode}): "
          f"{len(wave) / sr:.2f}s of audio in "
          f"{-(-len(wave) // chunk_n)} chunks of {args.chunk_ms:.0f} ms")

    if args.http:
        out, first_s, wall = _feed_http(
            model, params, sr, wave, chunk_n, hop=hop, ola=args.ola,
            target=target, alpha=args.alpha,
            deterministic=args.deterministic)
    else:
        with InferenceServer(model, params,
                             deterministic=args.deterministic) as server:
            out, first_s, wall = _feed_library(
                server, wave, chunk_n, hop=hop, ola=args.ola,
                target=target, alpha=args.alpha)

    write_wav(args.out / "live_input.wav", wave, sr)
    write_wav(args.out / f"live_{mode}.wav", out, sr)
    rt = (out.size / sr) / wall if wall > 0 else float("inf")
    # input shorter than one segment finalizes nothing before the close:
    # there is no first audio to time
    first = ("no audio before the close" if first_s is None
             else f"first audio after {first_s * 1e3:.0f} ms")
    print(f"{first}; {out.size / sr:.2f}s finalized in {wall:.2f}s "
          f"({rt:.1f}x realtime)")
    print(f"wrote {args.out / 'live_input.wav'} and "
          f"{args.out / ('live_' + mode + '.wav')}")


if __name__ == "__main__":
    main()

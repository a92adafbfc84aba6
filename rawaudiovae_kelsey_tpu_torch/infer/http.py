"""HTTP front-end for the batched inference service.

Turns :class:`InferenceServer` (BASELINE config #5) into an actual network
service with zero extra dependencies (stdlib ``http.server``, threading
server so concurrent requests coalesce into device batches underneath).

Endpoints (bodies are WAV bytes via our own codec unless noted):

  GET  /healthz                    → {"status": "ok", model info}
  POST /reconstruct[?hop=N&ola=1]  → wav in, resynthesized wav out
       [&stream=1&chunk=N]           progressive WAV: payload bytes go out
                                     per decoded chunk, so first audio
                                     decouples from clip length
  POST /encode[?hop=N]             → wav in, npz{mu, logvar} out
  POST /decode                     → npz{z} in, wav of decoded frames out
  POST /interpolate[?alphas=0,0.5,1 | ?mode=sine&cycles=C][&hop=N&ola=1]
       → npz{a, b[, alfa][, sr]} in (two waveforms; optional per-frame α
         curve; optional source sampling rate), interpolated wav out.
         Stepwise by default (the tutorial's α grid); an ``alfa`` array in
         the body or ``mode=sine`` selects time-varying interpolation.

Stateful live sessions (chunked INPUT audio with cross-chunk overlap-add
continuity — the live analog of the reference tutorial's interactive
encode→morph→listen loop, cells 14-22/36-37):

  POST /session/open[?hop=N&ola=1&alpha=A]
       → {"session": id, ...}.  Empty body = reconstruct mode; an
         npz{target[, sr]} body = morph mode (every live frame's latent is
         lerped toward the target clip's trajectory with weight alpha).
  POST /session/<id>/feed   → wav chunk in, wav out (the samples this
         chunk finalized; possibly zero while the buffer is shorter than
         one segment).  Chunk sampling rate must match the model's — a
         stateful stream cannot be resampled per chunk without breaking
         continuity at chunk edges.
  POST /session/<id>/close  → wav out (the padded tail), session deleted.

With a deterministic backend, the concatenation of every feed response
plus the close response is bit-identical to POST /reconstruct of the
concatenated input (LiveSession's framing/stitching contract).

Run:  python -m rawaudiovae_kelsey_tpu_torch serve --run <workdir> [--port 8422]
"""

from __future__ import annotations

import io
import json
import secrets
import threading
import time
from concurrent.futures import TimeoutError as FuturesTimeoutError
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional
from urllib.parse import parse_qs, urlparse

import numpy as np

from rawaudiovae_kelsey_tpu_torch.infer.api import sine_alfa
from rawaudiovae_kelsey_tpu_torch.infer.server import InferenceServer
from rawaudiovae_kelsey_tpu_torch.io.resample import resample
from rawaudiovae_kelsey_tpu_torch.io.wavio import (
    WavFormatError,
    decode_wav_bytes,
    encode_wav_bytes,
    encode_wav_payload,
    to_mono,
    wav_header_bytes,
)


def _npz_bytes(**arrays) -> bytes:
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    return buf.getvalue()


class _SessionRegistry:
    """Live-session table: id → LiveSession, capacity-capped and
    TTL-evicted (an abandoned session must not pin its buffers forever).
    Eviction happens lazily under the registry lock on every operation;
    evicted/closed ids answer 404 to later feeds."""

    def __init__(self, max_sessions: int = 64, ttl_s: float = 900.0):
        self.max_sessions = max_sessions
        self.ttl_s = ttl_s
        self._d: dict = {}          # sid -> [session, last_used_monotonic]
        self._lock = threading.Lock()
        self._seq = 0
        self._seed_seq = 0

    def _evict_expired(self) -> None:
        now = time.monotonic()
        for sid in [s for s, (_, t) in self._d.items()
                    if now - t > self.ttl_s]:
            sess, _ = self._d.pop(sid)
            sess.abort()

    def open(self, sess) -> Optional[str]:
        """Register; returns the id, or None when at capacity."""
        with self._lock:
            self._evict_expired()
            if len(self._d) >= self.max_sessions:
                return None
            self._seq += 1
            sid = f"{self._seq:x}-{secrets.token_hex(8)}"
            self._d[sid] = [sess, time.monotonic()]
            return sid

    def get(self, sid: str):
        with self._lock:
            self._evict_expired()
            entry = self._d.get(sid)
            if entry is None:
                return None
            entry[1] = time.monotonic()
            return entry[0]

    def pop(self, sid: str):
        with self._lock:
            entry = self._d.pop(sid, None)
            return None if entry is None else entry[0]

    def reserve_seed(self) -> int:
        """Unique per call (incremented under the lock): two concurrent
        opens must never share a session RNG stream — a read-only
        ``self._seq + 1`` handed both the same seed."""
        with self._lock:
            self._seed_seq += 1
            return self._seed_seq

    def abort_all(self) -> None:
        with self._lock:
            for sess, _ in self._d.values():
                sess.abort()
            self._d.clear()


class _Handler(BaseHTTPRequestHandler):
    # set by serve(): the backing batched server + audio params
    backend: InferenceServer = None
    sessions: _SessionRegistry = None
    sampling_rate: int = 44100
    request_timeout_s: float = 120.0
    max_body_bytes: int = 256 << 20  # one request can't exhaust host RAM

    def log_message(self, fmt, *args):  # quiet by default
        pass

    # ---------------------------------------------------------------- util --
    def _send(self, code: int, body: bytes, ctype: str) -> None:
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _send_json(self, code: int, obj) -> None:
        self._send(code, json.dumps(obj).encode(), "application/json")

    class _TooLarge(Exception):
        pass

    def _read_body(self) -> bytes:
        length = int(self.headers.get("Content-Length", 0))
        if length > self.max_body_bytes:
            raise self._TooLarge(length)
        return self.rfile.read(length)

    def _body_as_wave(self, strict_sr: bool = False) -> np.ndarray:
        samples, sr = decode_wav_bytes(self._read_body(), name="<request>")
        wave = to_mono(samples, "mean")
        if sr != self.sampling_rate:
            if strict_sr:
                # session feeds are a stateful stream: per-chunk polyphase
                # resampling has edge state this handler doesn't keep, so a
                # mismatched chunk would glitch at every boundary — reject
                raise ValueError(
                    f"session chunks must be {self.sampling_rate} Hz "
                    f"(got {sr}); resample client-side before feeding")
            # resample mismatched uploads to the model's rate rather than
            # silently reconstructing pitch-shifted garbage
            wave = resample(wave, sr, self.sampling_rate)
        return wave

    def _handle_session(self, parsed, q, hop: Optional[int],
                        ola: bool) -> None:
        """Routes /session/open, /session/<id>/feed, /session/<id>/close."""
        parts = parsed.path.strip("/").split("/")
        if parts == ["session", "open"]:
            alpha = float(q.get("alpha", ["0.5"])[0])
            body = self._read_body()
            target = None
            if body:
                with np.load(io.BytesIO(body)) as npz:
                    if "target" not in npz:
                        self._send_json(400, {
                            "error": "session/open body must be empty "
                                     "(reconstruct) or an npz with a "
                                     "'target' waveform (morph)"})
                        return
                    target = np.asarray(npz["target"],
                                        np.float32).reshape(-1)
                    src_sr = int(npz["sr"]) if "sr" in npz else None
                if src_sr is not None and src_sr != self.sampling_rate:
                    # one-shot resample is stateless — safe for the target
                    target = resample(target, src_sr, self.sampling_rate)
            sess = self.backend.live_session(
                hop=hop, ola=ola, target=target, alpha=alpha,
                timeout=self.request_timeout_s,
                session_seed=self.sessions.reserve_seed())
            sid = self.sessions.open(sess)
            if sid is None:
                sess.abort()
                self._send_json(429, {
                    "error": f"session table full "
                             f"({self.sessions.max_sessions}); close or "
                             "abandon existing sessions"})
                return
            self._send_json(200, {
                "session": sid,
                "mode": "morph" if target is not None else "reconstruct",
                "hop": hop, "ola": bool(ola and hop), "alpha": alpha,
                "segment_length": self.backend.model.segment_length,
                "sampling_rate": self.sampling_rate,
            })
            return
        if len(parts) == 3 and parts[0] == "session" \
                and parts[2] in ("feed", "close"):
            sid, op = parts[1], parts[2]
            sess = self.sessions.get(sid)
            if sess is None:
                self._send_json(404, {
                    "error": "unknown, closed, or expired session"})
                return
            if op == "feed":
                wave = self._body_as_wave(strict_sr=True)
                try:
                    piece = sess.feed(wave)
                except RuntimeError as e:
                    # closed under our feet (close/eviction race) — the
                    # session is gone, tell the client so, not a 500
                    self._send_json(404, {"error": f"session: {e}"})
                    return
                self._send(200, encode_wav_bytes(piece, self.sampling_rate),
                           "audio/wav")
                return
            out = sess.close()
            self.sessions.pop(sid)
            self._send(200, encode_wav_bytes(out, self.sampling_rate),
                       "audio/wav")
            return
        self._send_json(404, {"error": "unknown session path; use "
                                       "/session/open, /session/<id>/feed, "
                                       "/session/<id>/close"})

    def _stream_reconstruct(self, wave, hop, ola, q) -> None:
        """``/reconstruct?stream=1[&chunk=N]``: progressive WAV response.
        The clip is split into ``chunk`` frames per device dispatch
        (default: the backend batch size), all chunks pipeline through the
        coalescing queue up front, and payload bytes go out as each chunk
        decodes — first audio lands after ~one chunk's device time instead
        of the whole clip's.  The output length is known from the input, so
        the response carries an exact Content-Length and a spec-complete
        WAV header (no chunked transfer coding needed); a mid-stream
        failure can only truncate the body, which clients detect from the
        declared length."""
        chunk = int(q.get("chunk", ["0"])[0])
        n, gen = self.backend.reconstruct_stream(
            wave, hop=hop, ola=ola, chunk_frames=chunk,
            timeout=self.request_timeout_s,
        )
        seg = self.backend.model.segment_length
        total = 0 if n == 0 else (
            (n - 1) * hop + seg if (ola and hop) else n * seg)
        header = wav_header_bytes(total, self.sampling_rate)
        self.send_response(200)
        self.send_header("Content-Type", "audio/wav")
        self.send_header("Content-Length", str(len(header) + 4 * total))
        self.end_headers()
        # Past this point the 200 + Content-Length are on the wire: letting
        # an exception reach do_POST's handlers would write a SECOND status
        # line + JSON into the declared body (the client decodes it as
        # audio).  Truncate instead — close the connection so the short
        # read against the declared length is the error signal.
        try:
            self.wfile.write(header)
            for piece in gen:
                self.wfile.write(encode_wav_payload(piece))
                self.wfile.flush()
        except Exception as e:  # noqa: BLE001 — headers already sent
            self.close_connection = True
            self.log_error("mid-stream failure (truncating): %s",
                           str(e) or type(e).__name__)

    # ------------------------------------------------------------ handlers --
    def do_GET(self):  # noqa: N802 (http.server API)
        if urlparse(self.path).path == "/healthz":
            m = self.backend.model
            self._send_json(200, {
                "status": "ok",
                "model": m.name,
                "segment_length": m.segment_length,
                "latent_dim": m.latent_dim,
                "sampling_rate": self.sampling_rate,
            })
        else:
            self._send_json(404, {"error": "unknown path"})

    def do_POST(self):  # noqa: N802
        parsed = urlparse(self.path)
        try:
            q = parse_qs(parsed.query)
            hop = int(q["hop"][0]) if "hop" in q else None
            ola = q.get("ola", ["0"])[0] in ("1", "true")
            seg = self.backend.model.segment_length
            if hop is not None and (hop <= 0 or seg % hop):
                self._send_json(400, {
                    "error": f"hop must be a positive divisor of "
                             f"segment_length {seg}; got {hop}"})
                return
            if parsed.path.startswith("/session"):
                self._handle_session(parsed, q, hop, ola)
            elif parsed.path == "/reconstruct":
                wave = self._body_as_wave()
                if q.get("stream", ["0"])[0] in ("1", "true"):
                    self._stream_reconstruct(wave, hop, ola, q)
                    return
                out = self.backend.reconstruct(wave, hop=hop, ola=ola).result(
                    self.request_timeout_s
                )
                self._send(200, encode_wav_bytes(out, self.sampling_rate),
                           "audio/wav")
            elif parsed.path == "/encode":
                wave = self._body_as_wave()
                mu, logvar = self.backend.encode(wave, hop=hop).result(
                    self.request_timeout_s
                )
                self._send(200, _npz_bytes(mu=mu, logvar=logvar),
                           "application/octet-stream")
            elif parsed.path == "/interpolate":
                with np.load(io.BytesIO(self._read_body())) as npz:
                    if "a" not in npz or "b" not in npz:
                        self._send_json(400, {
                            "error": "npz body must contain waveform "
                                     "arrays 'a' and 'b'"})
                        return
                    wave_a = np.asarray(npz["a"], np.float32).reshape(-1)
                    wave_b = np.asarray(npz["b"], np.float32).reshape(-1)
                    alfa = (np.asarray(npz["alfa"], np.float32).reshape(-1)
                            if "alfa" in npz else None)
                    src_sr = int(npz["sr"]) if "sr" in npz else None
                if src_sr is not None and src_sr != self.sampling_rate:
                    wave_a = resample(wave_a, src_sr, self.sampling_rate)
                    wave_b = resample(wave_b, src_sr, self.sampling_rate)
                alphas = None
                if "alphas" in q:
                    alphas = [float(s) for s in q["alphas"][0].split(",")]
                if q.get("mode", [""])[0] == "sine" and alfa is None:
                    cycles = float(q.get("cycles", ["1.0"])[0])
                    alfa = sine_alfa(cycles=cycles)
                out = self.backend.interpolate(
                    wave_a, wave_b, alphas=alphas, alfa=alfa,
                    hop=hop, ola=ola,
                ).result(self.request_timeout_s)
                self._send(200, encode_wav_bytes(out, self.sampling_rate),
                           "audio/wav")
            elif parsed.path == "/decode":
                with np.load(io.BytesIO(self._read_body())) as npz:
                    z = npz["z"]
                frames = self.backend.decode(z).result(self.request_timeout_s)
                self._send(
                    200,
                    encode_wav_bytes(frames.reshape(-1), self.sampling_rate),
                    "audio/wav",
                )
            else:
                self._send_json(404, {"error": "unknown path"})
        except WavFormatError as e:
            self._send_json(400, {"error": f"bad wav body: {e}"})
        except (ValueError, TypeError) as e:
            self._send_json(400, {"error": f"bad request: {e}"})
        except KeyError as e:
            self._send_json(400, {"error": f"missing array {e} in npz body"})
        except self._TooLarge as e:
            self._send_json(413, {
                "error": f"body of {e} bytes exceeds the "
                         f"{self.max_body_bytes}-byte limit"})
        except FuturesTimeoutError:
            # str(TimeoutError()) is "" — say what actually happened
            self._send_json(504, {
                "error": f"inference timed out after "
                         f"{self.request_timeout_s:g}s (server overloaded "
                         "or first-compile in progress)"})
        except Exception as e:  # noqa: BLE001
            self._send_json(500, {"error": str(e) or type(e).__name__})


class HttpInferenceServer:
    """Owns the batched backend + the threading HTTP server."""

    def __init__(self, model, params, sampling_rate: int = 44100,
                 host: str = "127.0.0.1", port: int = 8422,
                 batch_size: int = 256, deterministic: bool = False,
                 quantize: bool = False, warmup: bool = False):
        self.backend = InferenceServer(
            model, params, batch_size=batch_size,
            deterministic=deterministic, quantize=quantize,
        )
        # warmup=True compiles the batched paths before serving begins —
        # the port is already bound, so early clients queue in the listen
        # backlog instead of being refused.  Off by default: CPU tests pay
        # three needless compiles otherwise.
        self._warmup = warmup
        self.sessions = _SessionRegistry()
        handler = type("BoundHandler", (_Handler,), {
            "backend": self.backend,
            "sessions": self.sessions,
            "sampling_rate": sampling_rate,
        })
        self.httpd = ThreadingHTTPServer((host, port), handler)
        self.port = self.httpd.server_address[1]
        self._thread: Optional[threading.Thread] = None

    def start(self) -> "HttpInferenceServer":
        self.backend.start()
        if self._warmup:
            self.backend.warmup()
        self._thread = threading.Thread(
            target=self.httpd.serve_forever, daemon=True
        )
        self._thread.start()
        return self

    def stop(self) -> None:
        self.httpd.shutdown()
        self.httpd.server_close()
        # open sessions hold only host-side numpy state — abort (no device
        # work) BEFORE stopping the backend so a racing feed gets a clean
        # "session closed" instead of hanging on a dead queue
        self.sessions.abort_all()
        self.backend.stop()
        if self._thread is not None:
            self._thread.join(timeout=10)

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()

    def serve_forever(self) -> None:
        self.backend.start()  # idempotent — safe after __enter__/start()
        if self._warmup and (self._thread is None
                             or not self._thread.is_alive()):
            print("warming up (compiling batched inference paths)...")
            self.backend.warmup()
        print(f"serving on http://{self.httpd.server_address[0]}:{self.port}")
        try:
            if self._thread is not None and self._thread.is_alive():
                # already serving on the background thread (context-manager
                # use); a second serve_forever loop would fight over the
                # same socket — just block until shutdown
                while self._thread.is_alive():
                    self._thread.join(timeout=1.0)
            else:
                self.httpd.serve_forever()
        except KeyboardInterrupt:
            pass
        finally:
            self.stop()

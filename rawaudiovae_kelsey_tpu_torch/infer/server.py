"""Batched inference service — the PyTorch counterpart of the JAX package's
``infer/server.py``, with the same coalescing queue, futures, per-kind
batching, fixed-``batch_size`` padding and ``warmup`` / ``stop`` semantics.

Concurrent callers submit waveforms; a worker thread coalesces outstanding
requests of the same kind into fixed-shape device batches, runs them on
the model's device, and resolves per-request futures with NumPy results
(``.cpu().numpy()``).

Noise: the non-deterministic path draws eps from a ``torch.Generator`` on
the device, seeded from ``seed`` and the batch tick (ticks start at 1;
warmup uses tick 0, so served noise is the same with and without warmup).
JAX's threefry stream cannot be reproduced, so the noise differs from the
JAX server's — a declared divergence; with ``deterministic=True`` (z = mu)
both servers compute the same thing.
"""

from __future__ import annotations

import queue
import threading
import time as _time
from concurrent.futures import Future
from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np
import torch

from rawaudiovae_kelsey_tpu_torch.infer.api import frame_audio, stretch_alfa
from rawaudiovae_kelsey_tpu_torch.infer.synthesis import (
    OverlapAddStream,
    flat_concat,
    overlap_add,
)
from rawaudiovae_kelsey_tpu_torch.models.registry import ModelDef
from rawaudiovae_kelsey_tpu_torch.models.vae import reparameterize


def seeded_generator(device: torch.device, *words: int) -> torch.Generator:
    """A generator on ``device`` seeded from a tuple of ints (the analog of
    folding words into a threefry key): distinct tuples give independent
    streams, equal tuples the same one."""
    state = np.random.SeedSequence([w & 0xFFFFFFFF for w in words])
    seed = int(state.generate_state(1, np.uint64)[0]) & ((1 << 63) - 1)
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    return g


@dataclass
class _Request:
    kind: str                   # "encode" | "decode" | "reconstruct"
    frames: np.ndarray
    future: Future
    # resynthesis options for "reconstruct"
    hop: Optional[int] = None
    ola: bool = False
    raw: bool = False           # resolve with decoded FRAMES, not a waveform
                                # (reconstruct_stream's cross-chunk OLA
                                # stitches on the consumer side)


class InferenceServer:
    def __init__(self, model: ModelDef, params, batch_size: int = 256,
                 max_wait_ms: float = 2.0, deterministic: bool = False,
                 seed: int = 0, quantize: bool = False):
        self.model = model
        self.params = params
        self.device = model.device
        if self.device.type == "cuda" and self.device.index is None:
            # the worker thread pins this exact device (a bare "cuda" names
            # whichever device is current in the constructing thread)
            self.device = torch.device("cuda", torch.cuda.current_device())
        self.batch_size = batch_size
        self.max_wait_s = max_wait_ms / 1e3
        self.deterministic = deterministic
        self.seed = seed
        self._tick = 0
        self._q: "queue.Queue[_Request]" = queue.Queue()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # serializes submit-vs-stop so a request can't slip into the queue
        # after stop() drained it (the caller would hang on its future)
        self._lock = threading.Lock()

        if quantize and model.name == "dense":
            # int8 weight-only decoder (ops/quant.py): 4x fewer weight bytes
            # on the serving-critical decode path
            from rawaudiovae_kelsey_tpu_torch.ops.quant import (
                quantize_decoder,
                quantized_decoder_fwd,
            )

            qparams = quantize_decoder(params)
            self._decode_fn = lambda z: quantized_decoder_fwd(qparams, z)  # noqa: E731
        else:
            self._decode_fn = lambda z: model.decode(params, z)  # noqa: E731

    # ------------------------------------------------------ device paths --
    def _encode(self, x: torch.Tensor):
        with torch.inference_mode():
            return self.model.encode(self.params, x)

    def _decode(self, z: torch.Tensor) -> torch.Tensor:
        with torch.inference_mode():
            return self._decode_fn(z)

    def _reconstruct(self, tick: int, x: torch.Tensor) -> torch.Tensor:
        with torch.inference_mode():
            mu, logvar = self.model.encode(self.params, x)
            gen = (None if self.deterministic
                   else seeded_generator(self.device, self.seed, tick))
            z = reparameterize(mu, logvar, gen, self.deterministic)
            return self._decode_fn(z)

    def _sample(self, tick_words: Tuple[int, ...], mu: np.ndarray,
                logvar: np.ndarray) -> np.ndarray:
        """z = mu + eps·std on the device, eps from a generator seeded with
        ``tick_words`` (host arrays in, host array out)."""
        with torch.inference_mode():
            gen = seeded_generator(self.device, *tick_words)
            z = reparameterize(
                torch.from_numpy(np.ascontiguousarray(mu, np.float32))
                .to(self.device),
                torch.from_numpy(np.ascontiguousarray(logvar, np.float32))
                .to(self.device), gen)
            return z.cpu().numpy()

    # ------------------------------------------------------------- public --
    def start(self) -> "InferenceServer":
        """Idempotent and restartable: a live worker is reused (a second
        concurrent worker would race the RNG tick), and start() after
        stop() brings the server back up."""
        with self._lock:
            if self._thread is not None and self._thread.is_alive():
                return self
            self._stop.clear()
            self._thread = threading.Thread(target=self._worker, daemon=True)
            self._thread.start()
        return self

    def warmup(self) -> "InferenceServer":
        """Run the three batched paths once at their coalesced shapes so the
        first real request doesn't absorb one-time costs (on CUDA: building
        and loading the kernel library, allocator growth).  Values are
        fetched, not just enqueued.  The RNG tick is NOT consumed — the
        warmup reconstruct uses tick 0, which no real batch uses."""
        seg = self.model.segment_length
        x = torch.zeros((self.batch_size, seg), device=self.device)
        z = torch.zeros((self.batch_size, self.model.latent_dim),
                        device=self.device)
        mu, logvar = self._encode(x)
        mu.cpu(), logvar.cpu()
        self._decode(z).cpu()
        self._reconstruct(0, x).cpu()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=10)
        # fail any still-queued requests so callers blocked on result()
        # don't hang forever (the lock excludes in-flight submits)
        with self._lock:
            try:
                while True:
                    req = self._q.get_nowait()
                    if not req.future.done():
                        req.future.set_exception(
                            RuntimeError("inference server stopped")
                        )
            except queue.Empty:
                pass

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()

    def encode(self, audio: np.ndarray,
               hop: Optional[int] = None) -> "Future[Tuple[np.ndarray, np.ndarray]]":
        """→ Future of (mu, logvar) trajectories."""
        frames = self._to_frames(audio, hop)
        return self._submit(_Request("encode", frames, Future()))

    def decode(self, z: np.ndarray) -> "Future[np.ndarray]":
        """→ Future of decoded frames (N, segment)."""
        z = np.asarray(z, np.float32).reshape(-1, self.model.latent_dim)
        return self._submit(_Request("decode", z, Future()))

    def reconstruct(self, audio: np.ndarray, hop: Optional[int] = None,
                    ola: bool = False) -> "Future[np.ndarray]":
        """→ Future of a resynthesized waveform.  ``hop`` enables the
        overlapping-encode stretch mode; ``ola=True`` applies windowed
        overlap-add instead of flat concat."""
        frames = self._to_frames(audio, hop)
        return self._submit(_Request("reconstruct", frames, Future(),
                                     hop=hop, ola=ola))

    def reconstruct_stream(self, audio: np.ndarray,
                           hop: Optional[int] = None, ola: bool = False,
                           chunk_frames: int = 0,
                           timeout: Optional[float] = None):
        """Chunked long-clip resynthesis: yields waveform pieces as they
        decode, so first audio arrives after ~one chunk's device time
        instead of the whole clip's.

        Returns ``(n_frames, generator)``.  EVERY chunk request is
        submitted up front — they pipeline through the same coalescing
        queue and device batches as ordinary traffic — and the generator
        yields each chunk's samples in order.  With ``deterministic=True``
        the concatenation of the yielded pieces is bit-identical to
        ``reconstruct(...)``'s result: flat-concat chunks split exactly on
        frame boundaries, and the OLA mode resolves raw decoded frames and
        stitches them through :class:`OverlapAddStream` (same float64
        accumulation order).

        ``chunk_frames`` defaults to the server batch size.  RNG note: the
        non-deterministic reparameterization draws per DEVICE BATCH, so a
        streamed clip's noise differs from the same clip submitted whole.
        """
        frames = self._to_frames(audio, hop)
        n = len(frames)
        step = int(chunk_frames) if chunk_frames else self.batch_size
        step = max(1, step)
        raw = bool(ola and hop)
        futs = [
            self._submit(_Request("reconstruct", frames[i:i + step],
                                  Future(), hop=hop, ola=ola, raw=raw))
            for i in range(0, n, step)
        ]

        def gen():
            if not raw:
                for f in futs:
                    yield f.result(timeout)
                return
            stitch = OverlapAddStream(hop)
            for f in futs:
                piece = stitch.add(f.result(timeout))
                if piece.size:
                    yield piece
            tail = stitch.finish()
            if tail.size:
                yield tail

        return n, gen()

    def live_session(self, *, hop: Optional[int] = None, ola: bool = False,
                     target: Optional[np.ndarray] = None, alpha: float = 0.5,
                     timeout: Optional[float] = None,
                     session_seed: int = 0) -> "LiveSession":
        """Open a stateful chunked-input session (see :class:`LiveSession`).
        ``target`` switches the session to morph mode (each live frame's
        latent lerped toward the target clip's trajectory with weight
        ``alpha``)."""
        return LiveSession(self, hop=hop, ola=ola, target=target,
                           alpha=alpha, timeout=timeout,
                           session_seed=session_seed)

    def interpolate(self, audio_a: np.ndarray, audio_b: np.ndarray, *,
                    alphas=None, alfa: Optional[np.ndarray] = None,
                    hop: Optional[int] = None,
                    ola: bool = False) -> "Future[np.ndarray]":
        """→ Future of a latent-interpolation resynthesis of two waveforms
        (the reference tutorial's interpolation loops, cells 16-17 stepwise
        / 36-37 time-varying): encode both, lerp the (mu, logvar)
        trajectories, decode, resynthesize.

        ``alphas`` (iterable of floats) selects the stepwise mode — one
        decoded trajectory per α, concatenated; default grid is the
        reference's ``np.arange(0, 1.1, 0.2)`` (cell 17).  ``alfa`` (an
        array) selects the time-varying mode — the curve is stretched to
        the trajectory length (cell 37) and may extrapolate outside [0, 1]
        exactly like the reference's raw sine.  The two are mutually
        exclusive.  Sources are trimmed to the shorter trajectory.

        The request decomposes into the encode and decode kinds through the
        same coalescing queue, so interpolate traffic batches with every
        other caller's encodes and decodes."""
        if alphas is not None and alfa is not None:
            raise ValueError(
                "pass either alphas (stepwise grid) or alfa (time-varying "
                "curve), not both")
        fa = self._to_frames(np.asarray(audio_a, np.float32), hop)
        fb = self._to_frames(np.asarray(audio_b, np.float32), hop)
        n = min(len(fa), len(fb))
        outer: Future = Future()
        if n == 0:
            outer.set_result(np.zeros(0, np.float32))
            return outer
        enc_a = self._submit(_Request("encode", fa[:n], Future()))
        enc_b = self._submit(_Request("encode", fb[:n], Future()))

        remaining = [2]
        join_lock = threading.Lock()

        def _resynthesize(dec: Future) -> None:
            if outer.done():
                return
            try:
                frames = dec.result()
                if ola and hop:
                    outer.set_result(overlap_add(frames, hop))
                else:
                    outer.set_result(flat_concat(frames))
            except BaseException as e:  # noqa: BLE001 — delivered to caller
                outer.set_exception(e)

        def _mix_and_decode(_: Future) -> None:
            with join_lock:
                remaining[0] -= 1
                if remaining[0]:
                    return
            if outer.done():
                return
            try:
                mu_a, logvar_a = enc_a.result()
                mu_b, logvar_b = enc_b.result()
                if alfa is not None:
                    a = stretch_alfa(np.asarray(alfa, np.float32), n)[:, None]
                    mixes = [((1.0 - a) * mu_a + a * mu_b,
                              (1.0 - a) * logvar_a + a * logvar_b)]
                else:
                    grid = (np.arange(0.0, 1.1, 0.2) if alphas is None
                            else np.asarray(alphas, np.float32))
                    mixes = [((1.0 - g) * mu_a + g * mu_b,
                              (1.0 - g) * logvar_a + g * logvar_b)
                             for g in grid]
                zs = []
                for mu, logvar in mixes:
                    if self.deterministic:
                        zs.append(np.asarray(mu, np.float32))
                    else:
                        # runs on the worker thread (futures fire callbacks
                        # in the resolving thread), so the tick is
                        # serialized with reconstruct's
                        self._tick += 1
                        zs.append(self._sample((self.seed, self._tick),
                                               mu, logvar))
                dec = self.decode(np.concatenate(zs, axis=0))
                dec.add_done_callback(_resynthesize)
            except BaseException as e:  # noqa: BLE001 — delivered to caller
                if not outer.done():
                    outer.set_exception(e)

        enc_a.add_done_callback(_mix_and_decode)
        enc_b.add_done_callback(_mix_and_decode)
        return outer

    # ------------------------------------------------------------ worker ---
    def _to_frames(self, audio: np.ndarray, hop: Optional[int]) -> np.ndarray:
        audio = np.asarray(audio, np.float32)
        if audio.ndim == 1:
            return frame_audio(audio, self.model.segment_length, hop)
        # validate pre-framed input HERE, in the caller's thread: a bad
        # width inside the worker's np.concatenate would poison every
        # innocent request coalesced into the same group
        seg = self.model.segment_length
        if audio.ndim != 2 or audio.shape[1] != seg:
            raise ValueError(
                f"pre-framed input must be (n, {seg}); got {audio.shape}"
            )
        return audio

    def _empty_result(self, req: _Request):
        """Zero frames (e.g. hop-mode audio shorter than one segment) is a
        well-defined empty answer; resolving it here keeps the behavior
        identical whether or not the request would have coalesced."""
        lat, seg = self.model.latent_dim, self.model.segment_length
        if req.kind == "encode":
            return (np.zeros((0, lat), np.float32),
                    np.zeros((0, lat), np.float32))
        if req.kind == "decode":
            return np.zeros((0, seg), np.float32)
        return np.zeros(0, np.float32)  # reconstruct → empty waveform

    def _submit(self, req: _Request) -> Future:
        if len(req.frames) == 0:
            req.future.set_result(self._empty_result(req))
            return req.future
        with self._lock:
            if (self._stop.is_set() or self._thread is None
                    or not self._thread.is_alive()):
                raise RuntimeError("server not started")
            self._q.put(req)
        return req.future

    def _worker(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.set_device(self.device)
        carry: Optional[_Request] = None  # kind-mismatched head, served next
        while not self._stop.is_set():
            if carry is not None:
                first, carry = carry, None
            else:
                try:
                    first = self._q.get(timeout=0.1)
                except queue.Empty:
                    continue
            group: List[_Request] = [first]
            rows = len(first.frames)
            # coalesce same-kind requests up to one device batch; the
            # deadline SHRINKS so max_wait_ms bounds the added latency of
            # the first request
            deadline = _time.monotonic() + self.max_wait_s
            while rows < self.batch_size:
                left = deadline - _time.monotonic()
                if left <= 0:
                    break
                try:
                    nxt = self._q.get(timeout=left)
                except queue.Empty:
                    break
                if nxt.kind != first.kind:
                    # different kind: HEADS the next group (requeueing at
                    # the back would let sustained same-kind traffic starve
                    # it indefinitely)
                    carry = nxt
                    break
                group.append(nxt)
                rows += len(nxt.frames)
            try:
                self._run_group(group)
            except BaseException as e:  # noqa: BLE001 — delivered to callers
                for r in group:
                    if not r.future.done():
                        r.future.set_exception(e)
        if carry is not None and not carry.future.done():
            carry.future.set_exception(
                RuntimeError("inference server stopped"))

    def _run_group(self, group: List[_Request]) -> None:
        kind = group[0].kind
        all_frames = np.concatenate([r.frames for r in group], axis=0)
        outs = self._run_batched(kind, all_frames)
        # split results back per request
        offsets = np.cumsum([0] + [len(r.frames) for r in group])
        for r, lo, hi in zip(group, offsets[:-1], offsets[1:]):
            if r.future.done():  # caller cancelled/timed out — skip
                continue
            if kind == "encode":
                r.future.set_result((outs[0][lo:hi], outs[1][lo:hi]))
            elif kind == "decode":
                r.future.set_result(outs[0][lo:hi])
            else:  # reconstruct → resynthesize
                frames = outs[0][lo:hi]
                if r.raw:
                    r.future.set_result(frames)
                elif r.ola and r.hop:
                    r.future.set_result(overlap_add(frames, r.hop))
                else:
                    r.future.set_result(flat_concat(frames))

    def _run_batched(self, kind: str, frames: np.ndarray):
        B = self.batch_size
        n = len(frames)
        parts: List[Tuple[np.ndarray, ...]] = []
        for i in range(0, n, B):
            chunk = frames[i:i + B]
            pad = B - len(chunk)
            if pad:
                chunk = np.concatenate(
                    [chunk, np.zeros((pad, chunk.shape[1]), np.float32)], 0
                )
            x = torch.from_numpy(np.ascontiguousarray(chunk, np.float32)) \
                .to(self.device)
            if kind == "encode":
                mu, logvar = self._encode(x)
                parts.append((mu.cpu().numpy()[:B - pad],
                              logvar.cpu().numpy()[:B - pad]))
            elif kind == "decode":
                parts.append((self._decode(x).cpu().numpy()[:B - pad],))
            else:
                self._tick += 1
                parts.append(
                    (self._reconstruct(self._tick, x).cpu().numpy()[:B - pad],)
                )
        return tuple(np.concatenate(cols, axis=0) for cols in zip(*parts))


class LiveSession:
    """Stateful chunked-input resynthesis with cross-chunk continuity.
    Feed arbitrary-length waveform chunks in order; each :meth:`feed`
    returns the output samples made FINAL by that chunk (cross-chunk
    overlap-add continuity via :class:`OverlapAddStream`), and
    :meth:`close` flushes the padded tail.

    Framing is incremental and boundary-exact: frames are cut at the same
    global offsets ``frame_audio`` would cut them for the concatenated
    input, no matter how the input was chunked.  With a ``deterministic``
    server the concatenation of every returned piece is therefore
    bit-identical to the one-shot path on the same audio
    (``InferenceServer.reconstruct(concat, hop=hop, ola=ola)``).

    Modes:
      * reconstruct (default): encode → reparameterize → decode per frame,
        through the server's coalescing queue.
      * morph (``target`` given): the target clip is encoded once at open;
        live frame ``i``'s ``(mu, logvar)`` is lerped toward target frame
        ``i % len(target)`` with weight ``alpha``, then reparameterized and
        decoded.  Morph noise comes from a session-local generator seeded
        from (server seed, session seed, feed count), not the server tick.

    Thread safety: feed/close serialize on a per-session lock.
    """

    def __init__(self, server: InferenceServer, *,
                 hop: Optional[int] = None, ola: bool = False,
                 target: Optional[np.ndarray] = None, alpha: float = 0.5,
                 timeout: Optional[float] = None, session_seed: int = 0):
        from rawaudiovae_kelsey_tpu_torch.data.framing import (
            nonoverlapping_frames,
            overlapping_frames,
        )

        self._overlapping_frames = overlapping_frames
        self._nonoverlapping_frames = nonoverlapping_frames
        self.server = server
        self.seg = server.model.segment_length
        self.hop = int(hop) if hop else None
        if self.hop is not None and (self.hop <= 0 or self.seg % self.hop):
            raise ValueError(
                f"hop must be a positive divisor of segment_length "
                f"{self.seg}; got {hop}")
        self.stride = self.hop or self.seg
        self.ola = bool(ola and self.hop)
        self.alpha = float(alpha)
        self.timeout = timeout
        self._buf = np.zeros(0, np.float32)
        self._stitch = OverlapAddStream(self.hop) if self.ola else None
        self._lock = threading.Lock()
        self._closed = False
        self._frame_idx = 0   # global frame counter (target indexing)
        self._feeds = 0       # per-feed RNG counter (morph mode)
        self._session_word = 0x5E55 ^ (session_seed & 0x7FFFFFFF)
        self._target = None
        if target is not None:
            target = np.asarray(target, np.float32).reshape(-1)
            frames = self.server._to_frames(target, self.hop)
            if len(frames) == 0:
                raise ValueError(
                    "morph target is shorter than one segment "
                    f"({self.seg} samples)")
            fut = self.server._submit(_Request("encode", frames, Future()))
            self._target = fut.result(timeout)  # (mu_t, logvar_t)

    # ------------------------------------------------------------- public --
    @property
    def closed(self) -> bool:
        return self._closed

    def feed(self, samples: np.ndarray) -> np.ndarray:
        """Append samples; return the output samples this chunk finalized
        (possibly empty while the buffer is shorter than one segment)."""
        with self._lock:
            if self._closed:
                raise RuntimeError("session closed")
            samples = np.asarray(samples, np.float32).reshape(-1)
            if samples.size:
                self._buf = (np.concatenate([self._buf, samples])
                             if self._buf.size else samples)
            if len(self._buf) < self.seg:
                return np.zeros(0, np.float32)
            n_new = (len(self._buf) - self.seg) // self.stride + 1
            frames = np.ascontiguousarray(
                np.lib.stride_tricks.sliding_window_view(
                    self._buf, self.seg)[::self.stride][:n_new])
            self._buf = self._buf[n_new * self.stride:].copy()
            return self._emit(self._process(frames))

    def close(self) -> np.ndarray:
        """Flush: frame the padded residual exactly as the one-shot path
        pads the clip tail, decode it, and drain the stitcher."""
        with self._lock:
            if self._closed:
                return np.zeros(0, np.float32)
            self._closed = True
            if self.hop is not None:
                tail = self._overlapping_frames(self._buf, self.seg,
                                                self.hop)
            elif self._buf.size:
                tail = self._nonoverlapping_frames(self._buf, self.seg)
            else:
                tail = np.zeros((0, self.seg), np.float32)
            self._buf = np.zeros(0, np.float32)
            out = self._emit(self._process(np.ascontiguousarray(tail)))
            if self._stitch is not None:
                fin = self._stitch.finish()
                out = np.concatenate([out, fin]) if out.size else fin
            return out

    def abort(self) -> None:
        """Drop the session without device work (registry eviction path)."""
        with self._lock:
            self._closed = True
            self._buf = np.zeros(0, np.float32)
            self._stitch = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        if not self._closed:
            self.close()

    # ------------------------------------------------------------ private --
    def _process(self, frames: np.ndarray) -> np.ndarray:
        """Frames in → decoded frames out, through the coalescing queue."""
        if len(frames) == 0:
            return np.zeros((0, self.seg), np.float32)
        if self._target is None:
            fut = self.server._submit(_Request(
                "reconstruct", frames, Future(), hop=self.hop,
                ola=self.ola, raw=True))
            out = fut.result(self.timeout)
        else:
            mu, logvar = self.server._submit(
                _Request("encode", frames, Future())).result(self.timeout)
            mu_t, lv_t = self._target
            idx = (self._frame_idx + np.arange(len(frames))) % len(mu_t)
            a = self.alpha
            mu_mix = (1.0 - a) * mu + a * mu_t[idx]
            lv_mix = (1.0 - a) * logvar + a * lv_t[idx]
            if self.server.deterministic:
                z = np.asarray(mu_mix, np.float32)
            else:
                self._feeds += 1
                z = self.server._sample(
                    (self.server.seed, self._session_word, self._feeds),
                    mu_mix, lv_mix)
            out = self.server._submit(
                _Request("decode", z, Future())).result(self.timeout)
        self._frame_idx += len(frames)
        return out

    def _emit(self, out_frames: np.ndarray) -> np.ndarray:
        if self._stitch is not None:
            return self._stitch.add(out_frames)
        return flat_concat(out_frames)

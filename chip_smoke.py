#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py          # from the repository root

Drives ``rawaudiovae_kelsey_tpu_torch`` (never JAX) through its serving
and training paths on the card, in phases; each prints what it found, and
any failure exits non-zero with a traceback (no phase is caught):

1. the card (``nvidia-smi`` name and power limit); requires CUDA;
2. builds the CUDA kernels from ``rawaudiovae_kelsey_tpu_torch/csrc``;
3. the serving kernels against their plain PyTorch versions at full width
   (1024/2048/256), batch 256 (the server's) and a ragged batch of 100,
   fp32 with TF32 off, and both times at batch 256;
3b. the training kernels — the four backward kernels in fp32 and bf16, the
   two forward kernels in bf16 — against their plain versions at full
   width, batch 8192 (the training microbatch), a ragged 1000 and 1, and
   both times at 8192;
4. the serving path: ``configs/default.ini`` (backend = pallas, dense
   1024/2048/256) → a run workspace with seeded random weights saved in the
   JAX npz layout → the HTTP server on 127.0.0.1 (warmup, deterministic)
   → real requests (healthz, reconstruct plain and hop+OLA, encode, decode,
   interpolate), then again with ``quantize=True``.  Responses are checked
   for shape and finiteness, /reconstruct against the plain-version path on
   the same card, and every serving kernel's launch counter must have risen;
5. the training path: a synthetic wav corpus (one full batch of 131072
   frames and a ragged one per epoch) → ``configs/default.ini`` (bf16,
   pallas, microbatch 8192) with only the datapath, epochs, checkpoint
   interval and best-model gate changed → ``python -m
   rawaudiovae_kelsey_tpu_torch train`` in-process → finite, falling
   losses, the workspace's artifacts, every training kernel launched; a
   ``--resume`` run that takes one more epoch; one step from the trained
   state through the kernels and through the plain ops, same noise, in
   bf16 and in fp32 (which launches the fp32 backward kernels); training
   frames/s of both backends and the device's busy share.

``launches`` in the kernel line: the wrapper's count over the path where
that dtype runs — fp32 forward kernels: serving (phase 4); bf16 forward
kernels: the training run (its fp32 test-set reconstructions included);
bf16 backward kernels: the training run; fp32 backward kernels: the fp32
step of phase 5.

The line before the last is one JSON object describing each kernel; the
last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import http.client
import io
import json
import statistics
import struct
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
BATCH = 256              # InferenceServer's default batch
RAGGED = 100             # a batch that is no multiple of any tile
SR = 44100
CLIP_S = 3.0
# fp32 kernel vs fp32 plain (cuBLAS, TF32 off) on the same card: the same
# products, summed over K <= 2048 in another order.  Expected error is
# O(sqrt(K) * 2^-24 * |partial sums|) ~ 1e-6; 1e-4 leaves 100x headroom
# while any indexing or masking fault shows as O(1e-2..1).
KERNEL_ATOL = 1e-4
# the HTTP path returns float32 WAV bytes: no further rounding
HTTP_ATOL = 1e-4
# phase 3b.  The backward kernels contract the batch (K up to 8192) in
# fp32: their outputs are held relative to the output's largest value,
# 1e-4 * max|plain| (measured ~1e-6 relative).  bf16 outputs (activations,
# dz) may flip by one bf16 ulp (2^-8 relative) where the two fp32 sums
# straddle a rounding boundary, and a rounded hidden cotangent (dh, dh3)
# can carry one more into what follows: 2^-6 * max|plain| for every output
# of a bf16 call.  An indexing or masking fault shows as O(max|plain|).
TRAIN_BATCH, TRAIN_RAGGED = 8192, 1000
GRAD_REL = 1e-4
BF16_REL = 2.0 ** -6


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def cuda_time_ms(fn, iters: int = 50, warmup: int = 5) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def time_both(kernel, plain, iters: int):
    """Mean ms of ``kernel()`` and ``plain()`` and each one's runs, timed
    plain, kernel, kernel, plain: drift in clocks hits both alike."""
    t_plain = [cuda_time_ms(plain, iters)]
    t_kern = [cuda_time_ms(kernel, iters), cuda_time_ms(kernel, iters)]
    t_plain.append(cuda_time_ms(plain, iters))
    return statistics.mean(t_kern), statistics.mean(t_plain), t_kern, t_plain


def max_err(got, want) -> float:
    return max(float((g - w).abs().max()) for g, w in zip(got, want))


def phase_kernels(gen_params):
    """Phase 3: each kernel against its plain version on the card."""
    from rawaudiovae_kelsey_tpu_torch.ops import mlp, quant

    dev = torch.device("cuda")
    p = gen_params(1234)
    qp = quant.quantize_decoder(p)
    enc_w = [p[n][k] for n in ("fc1", "fc21", "fc22") for k in ("w", "b")]
    dec_w = [p[n][k] for n in ("fc3", "fc4") for k in ("w", "b")]
    g = torch.Generator(device=dev).manual_seed(99)
    cases = {
        "encoder_fwd": (
            lambda b: torch.rand((b, 1024), generator=g, device=dev) * 2 - 1,
            lambda x: mlp.encoder_fwd(*enc_w, x),
            lambda x: mlp.encoder_fwd_ref(*enc_w, x),
            "rawaudiovae_kelsey_tpu_torch/csrc/mlp.cu",
            "rawaudiovae_kelsey_tpu/ops/pallas_mlp.py:246"),
        "decoder_fwd": (
            lambda b: torch.randn((b, 256), generator=g, device=dev),
            lambda z: mlp.decoder_fwd(*dec_w, z),
            lambda z: mlp.decoder_fwd_ref(*dec_w, z),
            "rawaudiovae_kelsey_tpu_torch/csrc/mlp.cu",
            "rawaudiovae_kelsey_tpu/ops/pallas_mlp.py:294"),
        "quantized_decoder_fwd": (
            lambda b: torch.randn((b, 256), generator=g, device=dev),
            lambda z: (quant.quantized_decoder_fwd(qp, z),),
            lambda z: (quant.quantized_decode_ref(qp, z),),
            "rawaudiovae_kelsey_tpu_torch/csrc/quant.cu",
            "rawaudiovae_kelsey_tpu/ops/quant.py:74"),
    }
    rows = {}
    for name, (make, kernel, plain, source, replaces) in cases.items():
        err = 0.0
        for b in (BATCH, RAGGED, 1):
            x = make(b)
            got = kernel(x)
            torch.cuda.synchronize()
            want = plain(x)
            torch.cuda.synchronize()
            for t, w in zip(got, want):
                check(t.shape == w.shape and bool(torch.isfinite(t).all()),
                      f"{name} batch {b}: shape {tuple(t.shape)} vs "
                      f"{tuple(w.shape)} or non-finite")
            e = max_err(got, want)
            print(f"  {name:<22} batch {b:>3}: max |kernel - plain| = {e:.3e}")
            check(e <= KERNEL_ATOL,
                  f"{name} batch {b}: error {e:.3e} > {KERNEL_ATOL}")
            err = max(err, e)
        x = make(BATCH)
        ms, plain_ms, t_kern, t_plain = time_both(
            lambda: kernel(x), lambda: plain(x), 50)
        print(f"  {name:<22} batch {BATCH}: kernel {ms:.4f} ms, plain "
              f"{plain_ms:.4f} ms (runs {t_kern} / {t_plain})")
        rows[name] = {"name": name, "route": "cuda", "source": source,
                      "replaces": replaces, "max_abs_err": err, "ms": ms,
                      "plain_ms": plain_ms}
    return rows


def rel_err(got, want) -> float:
    """max |got - want| over max |want|, across the outputs of one call."""
    return max(float((g.float() - w.float()).abs().max())
               / max(float(w.float().abs().max()), 1e-30)
               for g, w in zip(got, want))


def phase_train_kernels(gen_params):
    """Phase 3b: the training kernels against their plain versions."""
    from rawaudiovae_kelsey_tpu_torch.ops import mlp

    dev = torch.device("cuda")
    p32 = gen_params(4321)
    g = torch.Generator(device=dev).manual_seed(77)
    bwd = "rawaudiovae_kelsey_tpu_torch/csrc/bwd.cu"
    fwd = "rawaudiovae_kelsey_tpu_torch/csrc/mlp.cu"
    tpu = "rawaudiovae_kelsey_tpu/ops/pallas_mlp.py"

    def inputs(b, dt):
        def rnd(n, relu=False):
            t = torch.randn((b, n), generator=g, device=dev)
            return (t.clamp_min(0) if relu else t).to(dt)
        p = {n: {k: t.to(dt) for k, t in q.items()} for n, q in p32.items()}
        return p, dict(x=rnd(1024) * 0.3, h=rnd(2048, True), dmu=rnd(256),
                       dlv=rnd(256), da=rnd(1024) * 1e-3,
                       h3=rnd(2048, True), z=rnd(256))

    cases = {
        "grad_accum": (
            lambda p, t: mlp.grad_accum(t["h3"], t["da"]),
            lambda p, t: mlp.grad_accum_ref(t["h3"], t["da"]),
            bwd, f"{tpu}:453", ("fp32", "bf16")),
        "enc_bwd_dw1": (
            lambda p, t: mlp.enc_bwd_dw1(t["x"], t["h"], t["dmu"], t["dlv"],
                                         p["fc21"]["w"], p["fc22"]["w"]),
            lambda p, t: mlp.enc_bwd_dw1_ref(t["x"], t["h"], t["dmu"],
                                             t["dlv"], p["fc21"]["w"],
                                             p["fc22"]["w"]),
            bwd, f"{tpu}:542", ("fp32", "bf16")),
        "grad_accum2": (
            lambda p, t: mlp.grad_accum2(t["h"], t["dmu"], t["dlv"]),
            lambda p, t: mlp.grad_accum2_ref(t["h"], t["dmu"], t["dlv"]),
            bwd, f"{tpu}:624", ("fp32", "bf16")),
        "dec_bwd_fused": (
            lambda p, t: mlp.dec_bwd_fused(t["da"], t["h3"], t["z"],
                                           p["fc4"]["w"], p["fc3"]["w"]),
            lambda p, t: mlp.dec_bwd_fused_ref(t["da"], t["h3"], t["z"],
                                               p["fc4"]["w"], p["fc3"]["w"]),
            bwd, f"{tpu}:695", ("fp32", "bf16")),
        "encoder_fwd": (
            lambda p, t: mlp.encoder_fwd(
                *[p[n][k] for n in ("fc1", "fc21", "fc22")
                  for k in ("w", "b")], t["x"]),
            lambda p, t: mlp.encoder_fwd_ref(
                *[p[n][k] for n in ("fc1", "fc21", "fc22")
                  for k in ("w", "b")], t["x"]),
            fwd, f"{tpu}:246", ("bf16",)),
        "decoder_fwd": (
            lambda p, t: mlp.decoder_fwd(
                *[p[n][k] for n in ("fc3", "fc4") for k in ("w", "b")],
                t["z"]),
            lambda p, t: mlp.decoder_fwd_ref(
                *[p[n][k] for n in ("fc3", "fc4") for k in ("w", "b")],
                t["z"]),
            fwd, f"{tpu}:294", ("bf16",)),
    }
    dtypes = {"fp32": torch.float32, "bf16": torch.bfloat16}
    rows = {}
    for name, (kernel, plain, source, replaces, kinds) in cases.items():
        for kind in kinds:
            dt = dtypes[kind]
            tol = BF16_REL if dt == torch.bfloat16 else GRAD_REL
            err = 0.0
            for b in (TRAIN_BATCH, TRAIN_RAGGED, 1):
                p, t = inputs(b, dt)
                got = kernel(p, t)
                torch.cuda.synchronize()
                want = plain(p, t)
                torch.cuda.synchronize()
                for a, w in zip(got, want):
                    check(a.shape == w.shape and a.dtype == w.dtype
                          and bool(torch.isfinite(a).all()),
                          f"{name}[{kind}] batch {b}: shape/dtype "
                          f"{tuple(a.shape)} {a.dtype} vs {tuple(w.shape)} "
                          f"{w.dtype}, or non-finite")
                e = rel_err(got, want)
                err = max(err, max_err(got, want))
                print(f"  {name + '[' + kind + ']':<22} batch {b:>4}: max "
                      f"|kernel - plain| / max|plain| = {e:.3e} (tolerance "
                      f"{tol:.3e})")
                check(e <= tol, f"{name}[{kind}] batch {b}: relative error "
                      f"{e:.3e} > {tol:.3e}")
            p, t = inputs(TRAIN_BATCH, dt)
            ms, plain_ms, t_kern, t_plain = time_both(
                lambda: kernel(p, t), lambda: plain(p, t), 20)
            print(f"  {name + '[' + kind + ']':<22} batch {TRAIN_BATCH}: "
                  f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms (runs "
                  f"{t_kern} / {t_plain})")
            rows[f"{name}[{kind}]"] = {
                "name": f"{name}[{kind}]", "route": "cuda", "source": source,
                "replaces": replaces, "max_abs_err": err, "ms": ms,
                "plain_ms": plain_ms}
    return rows


def read_scalars(log_dir: Path, tag: str) -> dict:
    """{step: value} of one scalar tag from TensorBoard event files
    (TFRecord framing, the Event / Summary / Value protos decoded by hand:
    the card's machine has no tensorboard)."""
    def varint(buf, i):
        n = shift = 0
        while True:
            b = buf[i]
            i += 1
            n |= (b & 0x7F) << shift
            shift += 7
            if b < 0x80:
                return n, i

    def fields(buf):
        i = 0
        while i < len(buf):
            key, i = varint(buf, i)
            num, wire = key >> 3, key & 7
            if wire == 0:
                v, i = varint(buf, i)
            elif wire == 1:
                v, i = buf[i:i + 8], i + 8
            elif wire == 5:
                v, i = buf[i:i + 4], i + 4
            else:
                n, i = varint(buf, i)
                v, i = buf[i:i + n], i + n
            yield num, v

    out = {}
    for f in sorted(Path(log_dir).glob("events.out.tfevents.*")):
        data, i = f.read_bytes(), 0
        while i < len(data):
            (n,) = struct.unpack_from("<Q", data, i)
            event = data[i + 12:i + 12 + n]
            i += 12 + n + 4
            ev = dict(fields(event))
            for num, summary in fields(ev.get(5, b"")):
                val = dict(fields(summary))
                if num == 1 and val.get(1) == tag.encode():
                    out[ev.get(2, 0)] = struct.unpack("<f", val[2])[0]
    return out


def busy_share(fn) -> str:
    """The device's busy share of the wall time of ``fn()``: the union of
    CUDA kernel and copy intervals in a torch.profiler trace."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    # device activity only: recording every host op would slow the host
    # and understate the share
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events()
                   if e.device_type == DeviceType.CUDA)
    if not spans:
        return "not measured (the profiler saw no device activity)"
    busy, (lo, hi) = 0.0, spans[0]
    for a, b in spans[1:]:
        if a > hi:
            busy, lo = busy + hi - lo, a
        hi = max(hi, b)
    busy += hi - lo
    return (f"{100 * busy / wall_us:.1f} % ({busy / 1e3:.1f} ms of "
            f"{wall_us / 1e3:.1f} ms wall)")


def write_corpus(root: Path, frames: int, hop: int, seg: int) -> None:
    """``frames`` overlapping training frames of synthetic audio in
    ``root/audio`` (four files) and 3 s in ``root/test_audio``."""
    from rawaudiovae_kelsey_tpu_torch.io import write_wav

    rng = np.random.default_rng(5)
    n = (frames - 1) * hop + seg
    t = np.arange(n) / SR
    wave = (0.3 * np.sin(2 * np.pi * 110 * t * (1 + 0.5 * np.sin(t)))
            + 0.1 * np.sin(2 * np.pi * 1650 * t)
            + 0.02 * rng.standard_normal(n)).astype(np.float32)
    (root / "audio").mkdir(parents=True)
    (root / "test_audio").mkdir()
    cuts = np.linspace(0, n, 5).astype(int) // hop * hop
    cuts[-1] = n
    for k in range(4):
        write_wav(root / "audio" / f"train{k}.wav",
                  wave[cuts[k]:cuts[k + 1]], SR)
    write_wav(root / "test_audio" / "test.wav", wave[:int(3 * SR)], SR)


def phase_train(data: Path):
    """Phase 5: the training path of configs/default.ini."""
    from rawaudiovae_kelsey_tpu_torch import ops
    from rawaudiovae_kelsey_tpu_torch.config import load_config, save_config
    from rawaudiovae_kelsey_tpu_torch.config.workspace import iter_runs
    from rawaudiovae_kelsey_tpu_torch.data.corpus import build_corpus
    from rawaudiovae_kelsey_tpu_torch.data.datasets import AudioFrameDataset
    from rawaudiovae_kelsey_tpu_torch.models import build_model
    from rawaudiovae_kelsey_tpu_torch.parallel import build_train_step
    from rawaudiovae_kelsey_tpu_torch.train import (
        TrainState,
        latest_checkpoint,
        restore_checkpoint,
    )
    from rawaudiovae_kelsey_tpu_torch.train.cli import main as train_cli

    cfg = load_config(ROOT / "configs" / "default.ini")
    check(cfg.tpu.precision == "bfloat16" and cfg.tpu.backend == "pallas"
          and cfg.tpu.microbatch_size == 8192
          and cfg.training.batch_size == 131072,
          "configs/default.ini is not the bf16 pallas microbatch-8192 "
          "batch-131072 trainer")
    batch, seg, hop = (cfg.training.batch_size, cfg.audio.segment_length,
                       cfg.audio.hop_length)
    frames = batch + 3 * cfg.tpu.microbatch_size + 1234   # full + ragged
    t0 = time.perf_counter()
    write_corpus(data, frames, hop, seg)
    print(f"  corpus: {frames} frames ({frames * hop / SR:.0f} s of audio) "
          f"written in {time.perf_counter() - t0:.1f} s")
    epochs = 3
    cfg.dataset.datapath = str(data)
    cfg.training.epochs = epochs
    cfg.training.checkpoint_interval = 1
    cfg.training.save_best_model_after = 0
    ini = data / "train.ini"
    save_config(cfg, ini)

    for w in ops.KERNEL_WRAPPERS:
        w.launches = 0
    t0 = time.perf_counter()
    train_cli(["--config", str(ini)])
    train_s = time.perf_counter() - t0
    launches = {w.__name__: w.launches for w in ops.KERNEL_WRAPPERS}
    print(f"  train command: {epochs} epochs in {train_s:.1f} s (ingest, "
          f"checkpoints and reconstructions included)")
    print(f"  kernel launches in the training run: {launches}")
    for w in ops.TRAINING_KERNELS:
        check(launches[w.__name__] > 0,
              f"{w.__name__} was never launched by the training run")

    runs = iter_runs(data / cfg.extra.description)
    check(len(runs) == 1, f"expected one run dir, found {runs}")
    ws = runs[0]
    n_batches = -(-(frames) // batch)
    losses = read_scalars(ws / "logs", "Loss/Batch")
    totals = read_scalars(ws / "logs", "Loss/train_total")
    check(sorted(losses) == list(range(epochs * n_batches)),
          f"Loss/Batch steps {sorted(losses)}")
    check(all(np.isfinite(v) for v in losses.values()), "non-finite loss")
    tot = [totals[e] for e in range(epochs)]
    print(f"  epoch losses {tot}; per batch "
          f"{[round(losses[k], 6) for k in sorted(losses)]}")
    check(tot[-1] < tot[0], f"the epoch loss did not fall: {tot}")
    want = ["config.ini", "model/best_model.npz", "model/last_model.npz",
            f"model/checkpoints/ckpt_{epochs:05d}.npz",
            f"model/checkpoints/ckpt_{epochs:05d}.json",
            f"audio_logs/test_reconst_{epochs:05d}.wav"]
    for rel in want:
        check((ws / rel).is_file(), f"workspace lacks {rel}")
    check(list((ws / "logs").glob("events.out.tfevents.*")),
          "workspace lacks a TB event file")
    print(f"  workspace {ws.name}: " + ", ".join(want) + ", a TB event file")

    # resume: the last checkpoint, one more epoch
    cfg.training.epochs = epochs + 1
    save_config(cfg, ini)
    train_cli(["--config", str(ini), "--resume"])
    runs = iter_runs(data / cfg.extra.description)
    check(len(runs) == 2, f"the resume made no new run dir: {runs}")
    resumed = read_scalars(runs[1] / "logs", "Loss/Batch")
    check(sorted(resumed) == list(range(epochs * n_batches,
                                        (epochs + 1) * n_batches)),
          f"the resumed run logged steps {sorted(resumed)}")
    meta = json.loads((runs[1] / "model" / "checkpoints"
                       / f"ckpt_{epochs + 1:05d}.json").read_text())
    check(meta["step"] == (epochs + 1) * n_batches, f"resumed meta {meta}")
    print(f"  resume: one more epoch, steps {sorted(resumed)}, losses "
          f"{[round(resumed[k], 6) for k in sorted(resumed)]}")

    # one step from the trained state: kernels vs plain, same noise
    dev = torch.device("cuda")
    dataset = AudioFrameDataset(build_corpus(data / "audio", SR)[0], seg,
                                hop, SR)
    x = torch.from_numpy(next(dataset.batches(batch, seed=99))).to(dev)
    ckpt = latest_checkpoint(runs[1] / "model" / "checkpoints")

    def noise(step, i, shape):
        g = torch.Generator().manual_seed(1000 * step + (i or 0))
        return torch.randn(shape, generator=g)

    step_rows = {}
    for precision, rel_tol in (("bfloat16", 5e-2), ("highest", 1e-3)):
        cfg.tpu.precision = precision
        out = {}
        for backend in ("pallas", "xla"):
            cfg.tpu.backend = backend
            model = build_model(cfg, dev)
            state, _ = restore_checkpoint(ckpt, TrainState.create(
                model.init(torch.Generator().manual_seed(0)), 0))
            before = {n: {k: t.clone() for k, t in q.items()}
                      for n, q in state.params.items()}
            if backend == "pallas" and precision == "highest":
                for w in ops.KERNEL_WRAPPERS:
                    w.launches = 0
            state, m = build_train_step(model, cfg, noise=noise)(state, x)
            if backend == "pallas" and precision == "highest":
                step_rows = {w.__name__: w.launches
                             for w in ops.KERNEL_WRAPPERS}
            delta = torch.cat([(state.params[n][k] - before[n][k]).ravel()
                               for n in sorted(before)
                               for k in sorted(before[n])])
            out[backend] = (float(m["loss"]), delta)
        (lk, dk), (lx, dx) = out["pallas"], out["xla"]
        upd = float((dk - dx).norm() / dx.norm())
        print(f"  one {precision} step, kernels vs plain: loss {lk:.7f} vs "
              f"{lx:.7f}; |update difference| / |update| = {upd:.3e} "
              f"(tolerance {rel_tol:g}); max |param difference| = "
              f"{float((dk - dx).abs().max()):.3e}")
        check(abs(lk / lx - 1) <= rel_tol and upd <= rel_tol,
              f"{precision} step: kernels and plain disagree")
    print(f"  kernel launches in the fp32 step: {step_rows}")
    for w in ops.TRAINING_KERNELS:
        check(step_rows[w.__name__] > 0,
              f"{w.__name__} was never launched by the fp32 step")

    # training rate of both backends on one device-resident batch, and the
    # device's busy share over kernel steps
    cfg.tpu.precision = "bfloat16"
    rates = {}
    steps = {}
    for backend in ("pallas", "xla"):
        cfg.tpu.backend = backend
        model = build_model(cfg, dev)
        state = TrainState.create(model.init(torch.Generator().manual_seed(0)),
                                  0)
        steps[backend] = (build_train_step(model, cfg), state)
        steps[backend][0](state, x)                       # warmup
    order = ("xla", "pallas", "pallas", "xla")
    times = {"xla": [], "pallas": []}
    for backend in order:
        step, state = steps[backend]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(2):
            step(state, x)
        torch.cuda.synchronize()
        times[backend].append((time.perf_counter() - t0) / 2)
    for backend, ts in times.items():
        rates[backend] = batch / statistics.mean(ts)
        print(f"  training rate, {backend}: {rates[backend]:,.0f} frames/s "
              f"(step {statistics.mean(ts) * 1e3:.1f} ms; runs "
              f"{[round(t * 1e3, 1) for t in ts]} ms)")
    step, state = steps["pallas"]
    print(f"  device busy share over 2 kernel steps: "
          f"{busy_share(lambda: [step(state, x) for _ in range(2)])}")
    return launches, step_rows


def http_request(port, method, path, body=None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=300)
    try:
        conn.request(method, path, body=body)
        resp = conn.getresponse()
        data = resp.read()
        check(resp.status == 200,
              f"{method} {path}: HTTP {resp.status} {data[:300]!r}")
        return data
    finally:
        conn.close()


def npz_bytes(**arrays) -> bytes:
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    return buf.getvalue()


def phase_serve(run_dir, audio, quantize):
    """One server's worth of real requests; returns the responses and the
    median /reconstruct latency."""
    from rawaudiovae_kelsey_tpu_torch.config import load_config
    from rawaudiovae_kelsey_tpu_torch.infer.http import HttpInferenceServer
    from rawaudiovae_kelsey_tpu_torch.io.wavio import (
        decode_wav_bytes,
        encode_wav_bytes,
    )
    from rawaudiovae_kelsey_tpu_torch.models import build_model
    from rawaudiovae_kelsey_tpu_torch.train import load_params

    # what `python -m rawaudiovae_kelsey_tpu_torch serve --run <run_dir>
    # [--quantize]` does, with port 0 and deterministic sampling
    cfg = load_config(run_dir / "config.ini")
    model = build_model(cfg, "cuda")
    check(model.backend == "pallas", f"backend {model.backend}")
    params = load_params(run_dir / "model" / "best_model.npz",
                         model.init(torch.Generator().manual_seed(0)))
    server = HttpInferenceServer(
        model, params, sampling_rate=cfg.audio.sampling_rate, port=0,
        batch_size=BATCH, deterministic=True, quantize=quantize, warmup=True)
    t0 = time.perf_counter()
    server.start()
    print(f"  server up (warmup included) in "
          f"{time.perf_counter() - t0:.2f} s, port {server.port}")
    seg, lat = cfg.audio.segment_length, cfg.vae.latent_dim
    body = encode_wav_bytes(audio, SR)
    out = {}
    try:
        info = json.loads(http_request(server.port, "GET", "/healthz"))
        check(info["status"] == "ok" and info["segment_length"] == seg
              and info["latent_dim"] == lat, f"healthz {info}")
        lat_ms = []
        for _ in range(5):
            t0 = time.perf_counter()
            data = http_request(server.port, "POST", "/reconstruct", body)
            lat_ms.append((time.perf_counter() - t0) * 1e3)
        out["flat"], sr = decode_wav_bytes(data)
        check(sr == SR, f"reconstruct sr {sr}")
        data = http_request(server.port, "POST",
                            "/reconstruct?hop=128&ola=1", body)
        out["ola"], _ = decode_wav_bytes(data)
        with np.load(io.BytesIO(http_request(server.port, "POST",
                                             "/encode", body))) as npz:
            out["mu"], out["logvar"] = npz["mu"], npz["logvar"]
        z = out["mu"][:7]
        out["decode"], _ = decode_wav_bytes(http_request(
            server.port, "POST", "/decode", npz_bytes(z=z)))
        out["interp"], _ = decode_wav_bytes(http_request(
            server.port, "POST", "/interpolate?alphas=0,0.5,1",
            npz_bytes(a=audio, b=audio[::-1].copy())))
    finally:
        server.stop()
    n_frames = -(-len(audio) // seg)
    n_hop = (len(audio) + (-len(audio) % 128)) // 128 - seg // 128 + 1
    shapes = {
        "flat": (n_frames * seg, 1), "ola": ((n_hop - 1) * 128 + seg, 1),
        "mu": (n_frames, lat), "logvar": (n_frames, lat),
        "decode": (7 * seg, 1), "interp": (3 * n_frames * seg, 1),
    }
    for k, shape in shapes.items():
        check(out[k].shape == shape, f"{k}: shape {out[k].shape} != {shape}")
        check(bool(np.isfinite(out[k]).all()), f"{k}: non-finite values")
    label = "int8" if quantize else "fp32"
    print(f"  {label}: healthz ok; reconstruct {out['flat'].shape[0]} "
          f"samples, hop+OLA {out['ola'].shape[0]}, encode {out['mu'].shape}"
          f", decode {out['decode'].shape[0]}, interpolate "
          f"{out['interp'].shape[0]}; all finite")
    print(f"  {label}: POST /reconstruct of {CLIP_S:g} s of audio: "
          f"median {statistics.median(lat_ms):.2f} ms (runs "
          f"{[round(t, 2) for t in lat_ms]})")
    return out, statistics.median(lat_ms)


def main() -> int:
    check(torch.cuda.is_available(), "no CUDA device (torch.cuda."
          "is_available() is false)")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    sys.path.insert(0, str(ROOT))
    check((ROOT / "rawaudiovae_kelsey_tpu_torch").is_dir(),
          f"the port's package is not beside {Path(__file__).name}: run "
          "from a checkout of the repository")
    from rawaudiovae_kelsey_tpu_torch.config import load_config, save_config
    from rawaudiovae_kelsey_tpu_torch.infer.api import frame_audio
    from rawaudiovae_kelsey_tpu_torch.infer.synthesis import overlap_add
    from rawaudiovae_kelsey_tpu_torch.models import DenseVAE
    from rawaudiovae_kelsey_tpu_torch import ops
    from rawaudiovae_kelsey_tpu_torch.ops import _build
    from rawaudiovae_kelsey_tpu_torch.train import save_params

    print("phase 1: card")
    print(smi.stdout.strip())
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    print(f"  torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")

    print("phase 2: build")
    t0 = time.perf_counter()
    lib = _build.build()
    _build.library()
    print(f"  built {lib.name} in {time.perf_counter() - t0:.2f} s")
    for line in lib.with_suffix(".log").read_text().splitlines():
        if "registers" in line or "spill" in line:
            print(f"  ptxas: {line.strip()}")

    # plain versions in true fp32: TF32 off for matmuls and convolutions
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    def gen_params(seed):
        g = torch.Generator().manual_seed(seed)
        return DenseVAE(1024, 2048, 256, g, "cuda").params()

    print("phase 3: serving kernels against their plain versions")
    with torch.inference_mode():
        rows = phase_kernels(gen_params)

    print("phase 3b: training kernels against their plain versions")
    with torch.inference_mode():
        train_rows = phase_train_kernels(gen_params)

    print("phase 4: the serving path (configs/default.ini)")
    cfg = load_config(ROOT / "configs" / "default.ini")
    check(cfg.tpu.backend == "pallas" and cfg.vae.arch == "dense"
          and (cfg.audio.segment_length, cfg.vae.n_units,
               cfg.vae.latent_dim) == (1024, 2048, 256),
          "configs/default.ini is not the dense 1024/2048/256 pallas model")
    rng = np.random.default_rng(0)
    t = np.arange(int(CLIP_S * SR)) / SR
    audio = (0.3 * np.sin(2 * np.pi * 220 * t)
             + 0.2 * np.sin(2 * np.pi * 1375 * t)
             + 0.05 * rng.standard_normal(t.size)).astype(np.float32)
    with tempfile.TemporaryDirectory() as tmp:
        run_dir = Path(tmp) / "run-001"
        save_config(cfg, run_dir / "config.ini")
        params = gen_params(7)
        save_params(run_dir / "model" / "best_model.npz", params)
        for w in ops.KERNEL_WRAPPERS:
            w.launches = 0
        fp32, fp32_ms = phase_serve(run_dir, audio, False)
        int8, int8_ms = phase_serve(run_dir, audio, True)
        launches = {w.__name__: w.launches for w in ops.SERVING_KERNELS}
    print(f"  kernel launches in the serving path: {launches}")
    for name, n in launches.items():
        check(n > 0, f"{name} was never launched by the serving path")

    # the same requests through the plain versions on the same card
    frames = frame_audio(audio, 1024)
    hop_frames = frame_audio(audio, 1024, 128)
    qp = ops.quantize_decoder(params)
    with torch.inference_mode():
        def plain(fr, quantize):
            x = torch.from_numpy(np.ascontiguousarray(fr)).cuda()
            mu, _, _ = ops.encoder_fwd_ref(
                *[params[n][k] for n in ("fc1", "fc21", "fc22")
                  for k in ("w", "b")], x)
            if quantize:
                y = ops.quantized_decode_ref(qp, mu)
            else:
                y, _ = ops.decoder_fwd_ref(
                    *[params[n][k] for n in ("fc3", "fc4")
                      for k in ("w", "b")], mu)
            return y.cpu().numpy()

        for label, out, q in (("fp32", fp32, False), ("int8", int8, True)):
            e_flat = float(np.abs(out["flat"][:, 0]
                                  - plain(frames, q).reshape(-1)).max())
            e_ola = float(np.abs(out["ola"][:, 0] - overlap_add(
                plain(hop_frames, q), 128)).max())
            print(f"  {label}: /reconstruct vs plain path: max err "
                  f"{e_flat:.3e} (flat), {e_ola:.3e} (hop+OLA)")
            check(max(e_flat, e_ola) <= HTTP_ATOL,
                  f"{label} /reconstruct differs from the plain path")

    for name, row in rows.items():
        row["launches"] = launches[name]
    print(f"  /reconstruct latency: fp32 {fp32_ms:.2f} ms, int8 "
          f"{int8_ms:.2f} ms")

    print("phase 5: the training path (configs/default.ini)")
    with tempfile.TemporaryDirectory() as tmp:
        train_launches, step_launches = phase_train(Path(tmp) / "data")
    for key, row in train_rows.items():
        name, kind = key[:-1].split("[")
        counts = step_launches if kind == "fp32" else train_launches
        row["launches"] = counts[name]
        check(row["launches"] > 0, f"{key}: no launch on its main path")
    rows.update(train_rows)
    print(json.dumps({"kernels": list(rows.values())}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

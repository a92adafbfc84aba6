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
3c. the fp32 input-gradient kernels (``matmul_nt``, ``matmul_nt_mask``,
   ``matmul_nt2_mask``) in fp32 and bf16 at batch 8192, 1000 and 1, with
   the one PyTorch call ``a @ w.t()`` timed beside ``matmul_nt``; the
   in-kernel sampler at (4096, 256), (1000, 256) and (1, 256): its Philox
   words bit for bit, ``z``, determinism, both seed words, moments over a
   million samples, its backward; ``dx`` through ``mlp.encode``;
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
   bf16, in fp32 at ``high`` (the fp32 "split" kernels) and at ``highest``
   (the fp32 "primitive" kernels); training frames/s of both backends and
   the device's busy share;
6. the device-resident path: ``configs/perf_bf16.ini`` uncut (batch 4096,
   bf16, block shuffle, ``rng = tpu_prng``, ``device_resident = always``)
   on the corpus of phase 5, with only the datapath, epochs, checkpoint
   interval and best-model gate changed, so that a boundary fires mid-run;
   a ``--resume`` for one more epoch; the sampler launched once per step
   and the host loader never built; one resident epoch against a host-fed
   loop fed the same bf16 batches (equal losses, bit for bit); one
   resident epoch at ``highest`` through the primitive kernels against the
   plain backend; ``dx`` through the model's encoder in fp32 and bf16; the
   corpus layout under a small budget and the ``always`` error under none;
   resident and host-fed epoch frames/s of both backends and the device's
   busy share over a resident epoch.

``launches`` in the kernel line: the wrapper's count over the path where
that dtype runs, set to 0 just before it — fp32 forward kernels: serving
(phase 4); bf16 forward kernels: the training run of phase 5 (its fp32
test-set reconstructions included); bf16 "split" backward kernels: that
run; fp32 "split" backward kernels: the ``high`` step of phase 5; fp32
``matmul_nt*``: the ``highest`` resident epoch of phase 6; bf16
``matmul_nt`` / ``matmul_nt2_mask``: the bf16 ``dx`` of phase 6 (no path
of the package runs ``matmul_nt_mask`` in bf16; phase 3c still holds it
against its plain version); the sampler: the resident training run.
``bound_ms`` is the larger of bytes moved (each input read once, each
output written once) over 3.35 TB/s and operations over the peak of the
operand type (67 TFLOP/s fp32 outside the tensor cores, 989 TFLOP/s bf16:
NVIDIA's H100 SXM data sheet), at the shapes that were timed.

The line before the last is one JSON object describing each kernel; the
last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
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


# roofline peaks of one H100 SXM (NVIDIA's data sheet, dense rates)
HBM_BYTES_S = 3.35e12
PEAK_FLOPS = {"fp32": 67e12, "bf16": 989e12}
SEG, UNITS, LATENT = 1024, 2048, 256
SAMPLER_SHAPE = (4096, 256)      # configs/perf_bf16.ini: batch x latent
# per element: ten Philox rounds of 2 mulhi + 2 mullo + 4 xor + 2 add, then
# ~30 for the bit packing, Box-Muller and the affine step; counted at the
# fp32 rate (the data sheet gives no integer rate)
SAMPLER_OPS = 130


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def bound(flops: float, moved: int, kind: str) -> dict:
    """The least time the card could take: bytes over the memory rate or
    operations over the peak rate of the operand type, whichever is
    larger."""
    by_bytes = moved / HBM_BYTES_S * 1e3
    by_ops = flops / PEAK_FLOPS[kind] * 1e3
    return {"bound_ms": max(by_bytes, by_ops),
            "bound_by": "bytes" if by_bytes >= by_ops else "operations"}


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
    # operations and operand bytes at the timed batch
    enc_flops = 2 * BATCH * (SEG * UNITS + 2 * UNITS * LATENT)
    dec_flops = 2 * BATCH * (LATENT * UNITS + UNITS * SEG)
    q_w = [t for layer in qp.values() for t in layer.values()]
    work = {"encoder_fwd": (enc_flops, enc_w),
            "decoder_fwd": (dec_flops, dec_w),
            "quantized_decoder_fwd": (dec_flops, q_w)}
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
        flops, weights = work[name]
        rows[name] = {"name": name, "route": "cuda", "source": source,
                      "replaces": replaces, "max_abs_err": err, "ms": ms,
                      "plain_ms": plain_ms,
                      **bound(flops, nbytes(x, *weights, *kernel(x)), "fp32"),
                      "library_ms": None}
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
            bwd, f"{tpu}:453", ("fp32", "bf16"),
            2 * UNITS * SEG, lambda p, t: (t["h3"], t["da"])),
        "enc_bwd_dw1": (
            lambda p, t: mlp.enc_bwd_dw1(t["x"], t["h"], t["dmu"], t["dlv"],
                                         p["fc21"]["w"], p["fc22"]["w"]),
            lambda p, t: mlp.enc_bwd_dw1_ref(t["x"], t["h"], t["dmu"],
                                             t["dlv"], p["fc21"]["w"],
                                             p["fc22"]["w"]),
            bwd, f"{tpu}:542", ("fp32", "bf16"),
            2 * (2 * LATENT * UNITS + SEG * UNITS),
            lambda p, t: (t["x"], t["h"], t["dmu"], t["dlv"],
                          p["fc21"]["w"], p["fc22"]["w"])),
        "grad_accum2": (
            lambda p, t: mlp.grad_accum2(t["h"], t["dmu"], t["dlv"]),
            lambda p, t: mlp.grad_accum2_ref(t["h"], t["dmu"], t["dlv"]),
            bwd, f"{tpu}:624", ("fp32", "bf16"),
            2 * 2 * UNITS * LATENT,
            lambda p, t: (t["h"], t["dmu"], t["dlv"])),
        "dec_bwd_fused": (
            lambda p, t: mlp.dec_bwd_fused(t["da"], t["h3"], t["z"],
                                           p["fc4"]["w"], p["fc3"]["w"]),
            lambda p, t: mlp.dec_bwd_fused_ref(t["da"], t["h3"], t["z"],
                                               p["fc4"]["w"], p["fc3"]["w"]),
            bwd, f"{tpu}:695", ("fp32", "bf16"),
            2 * (SEG * UNITS + 2 * UNITS * LATENT),
            lambda p, t: (t["da"], t["h3"], t["z"], p["fc4"]["w"],
                          p["fc3"]["w"])),
        "encoder_fwd": (
            lambda p, t: mlp.encoder_fwd(
                *[p[n][k] for n in ("fc1", "fc21", "fc22")
                  for k in ("w", "b")], t["x"]),
            lambda p, t: mlp.encoder_fwd_ref(
                *[p[n][k] for n in ("fc1", "fc21", "fc22")
                  for k in ("w", "b")], t["x"]),
            fwd, f"{tpu}:246", ("bf16",),
            2 * (SEG * UNITS + 2 * UNITS * LATENT),
            lambda p, t: (t["x"], *[p[n][k] for n in ("fc1", "fc21", "fc22")
                                    for k in ("w", "b")])),
        "decoder_fwd": (
            lambda p, t: mlp.decoder_fwd(
                *[p[n][k] for n in ("fc3", "fc4") for k in ("w", "b")],
                t["z"]),
            lambda p, t: mlp.decoder_fwd_ref(
                *[p[n][k] for n in ("fc3", "fc4") for k in ("w", "b")],
                t["z"]),
            fwd, f"{tpu}:294", ("bf16",),
            2 * (LATENT * UNITS + UNITS * SEG),
            lambda p, t: (t["z"], *[p[n][k] for n in ("fc3", "fc4")
                                    for k in ("w", "b")])),
    }
    dtypes = {"fp32": torch.float32, "bf16": torch.bfloat16}
    rows = {}
    for name, (kernel, plain, source, replaces, kinds, row_flops,
               operands) in cases.items():
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
                "plain_ms": plain_ms,
                **bound(TRAIN_BATCH * row_flops,
                        nbytes(*operands(p, t), *kernel(p, t)), kind),
                "library_ms": None}
    return rows


def phase_new_kernels(gen_params):
    """Phase 3c: the input-gradient kernels and the in-kernel sampler
    against their plain versions."""
    from rawaudiovae_kelsey_tpu_torch.ops import mlp, rng

    dev = torch.device("cuda")
    p32 = gen_params(2468)
    g = torch.Generator(device=dev).manual_seed(55)
    bwd = "rawaudiovae_kelsey_tpu_torch/csrc/bwd.cu"
    tpu = "rawaudiovae_kelsey_tpu/ops/pallas_mlp.py"

    def inputs(b, dt):
        def rnd(n, relu=False):
            t = torch.randn((b, n), generator=g, device=dev)
            return (t.clamp_min(0) if relu else t).to(dt)
        w = {n: q["w"].to(dt) for n, q in p32.items()}
        return w, dict(h=rnd(UNITS, True), dmu=rnd(LATENT), dlv=rnd(LATENT),
                       da=rnd(SEG) * 1e-3, h3=rnd(UNITS, True),
                       dh3=rnd(UNITS) * 1e-3)

    # (kernel, plain, TPU line, FLOPs per row, operands, library call)
    cases = {
        # the step's use: dz = dh3 @ w3ᵀ
        "matmul_nt": (
            lambda w, t: mlp.matmul_nt(t["dh3"], w["fc3"]),
            lambda w, t: mlp.matmul_nt_ref(t["dh3"], w["fc3"]),
            f"{tpu}:333", 2 * UNITS * LATENT,
            lambda w, t: (t["dh3"], w["fc3"]),
            lambda w, t: t["dh3"] @ w["fc3"].t()),
        "matmul_nt_mask": (
            lambda w, t: mlp.matmul_nt_mask(t["da"], w["fc4"], t["h3"]),
            lambda w, t: mlp.matmul_nt_mask_ref(t["da"], w["fc4"], t["h3"]),
            f"{tpu}:364", 2 * SEG * UNITS,
            lambda w, t: (t["da"], w["fc4"], t["h3"]), None),
        "matmul_nt2_mask": (
            lambda w, t: mlp.matmul_nt2_mask(t["dmu"], w["fc21"], t["dlv"],
                                             w["fc22"], t["h"]),
            lambda w, t: mlp.matmul_nt2_mask_ref(t["dmu"], w["fc21"],
                                                 t["dlv"], w["fc22"], t["h"]),
            f"{tpu}:398", 2 * 2 * LATENT * UNITS,
            lambda w, t: (t["dmu"], w["fc21"], t["dlv"], w["fc22"], t["h"]),
            None),
    }
    dtypes = {"fp32": torch.float32, "bf16": torch.bfloat16}
    rows = {}
    for name, (kernel, plain, replaces, row_flops, operands,
               library) in cases.items():
        for kind, dt in dtypes.items():
            tol = BF16_REL if dt == torch.bfloat16 else GRAD_REL
            err = 0.0
            for b in (TRAIN_BATCH, TRAIN_RAGGED, 1):
                w, t = inputs(b, dt)
                got = kernel(w, t)
                torch.cuda.synchronize()
                want = plain(w, t)
                check(got.shape == want.shape and got.dtype == want.dtype
                      and bool(torch.isfinite(got).all()),
                      f"{name}[{kind}] batch {b}: shape, dtype or non-finite")
                e = rel_err((got,), (want,))
                err = max(err, max_err((got.float(),), (want.float(),)))
                print(f"  {name + '[' + kind + ']':<22} batch {b:>4}: max "
                      f"|kernel - plain| / max|plain| = {e:.3e} (tolerance "
                      f"{tol:.3e})")
                check(e <= tol, f"{name}[{kind}] batch {b}: relative error "
                      f"{e:.3e} > {tol:.3e}")
            w, t = inputs(TRAIN_BATCH, dt)
            ms, plain_ms, t_kern, t_plain = time_both(
                lambda: kernel(w, t), lambda: plain(w, t), 20)
            library_ms = None
            if library is not None:
                library_ms = cuda_time_ms(lambda: library(w, t), 20)
            print(f"  {name + '[' + kind + ']':<22} batch {TRAIN_BATCH}: "
                  f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms (runs "
                  f"{t_kern} / {t_plain})"
                  + (f", a @ w.t() {library_ms:.4f} ms"
                     if library_ms is not None else ""))
            rows[f"{name}[{kind}]"] = {
                "name": f"{name}[{kind}]", "route": "cuda", "source": bwd,
                "replaces": replaces, "max_abs_err": err, "ms": ms,
                "plain_ms": plain_ms,
                **bound(TRAIN_BATCH * row_flops,
                        nbytes(*operands(w, t), kernel(w, t)), kind),
                "library_ms": library_ms}
    # matmul_nt at its other shape, dx = dh @ w1ᵀ (8192 x 2048 by 1024 x 2048)
    w, t = inputs(TRAIN_BATCH, torch.float32)
    dh = t["h"] * 1e-3
    e = rel_err((mlp.matmul_nt(dh, w["fc1"]),),
                (mlp.matmul_nt_ref(dh, w["fc1"]),))
    check(e <= GRAD_REL, f"matmul_nt at the dx shape: {e:.3e}")
    ms, plain_ms, _, _ = time_both(lambda: mlp.matmul_nt(dh, w["fc1"]),
                                   lambda: mlp.matmul_nt_ref(dh, w["fc1"]),
                                   20)
    print(f"  matmul_nt[fp32] at the dx shape, batch {TRAIN_BATCH}: error "
          f"{e:.3e}, kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")

    # the sampler
    name = "reparameterize_prng[fp32]"
    err = 0.0
    for i, (b, lat) in enumerate((SAMPLER_SHAPE, (TRAIN_RAGGED, 256),
                                  (1, 256))):
        seed = (0x9E3779B9 + i, 0x7F4A7C15)
        same = torch.equal(rng.philox_words(seed, b, lat, dev),
                           rng.philox_words_ref(seed, b, lat, dev))
        check(same, f"sampler ({b}, {lat}): the kernel's Philox words "
              "differ from the plain version's")
        mu = torch.randn((b, lat), generator=g, device=dev)
        logvar = torch.randn((b, lat), generator=g, device=dev) * 0.5
        z = rng.reparameterize_prng(seed, mu, logvar)
        torch.cuda.synchronize()
        want = rng.reparameterize_prng_ref(seed, mu, logvar)
        check(bool(torch.isfinite(z).all()), f"sampler ({b}, {lat}): "
              "non-finite z")
        excess = float(((z - want).abs() / (1 + want.abs())).max())
        check(excess <= 1e-5, f"sampler ({b}, {lat}): |z - plain| / (1 + "
              f"|z|) = {excess:.3e} > 1e-5")
        check(torch.equal(z, rng.reparameterize_prng(seed, mu, logvar)),
              f"sampler ({b}, {lat}): two launches with one seed differ")
        check(not torch.equal(z, rng.reparameterize_prng(
            (seed[0], seed[1] ^ 1), mu, logvar)),
            f"sampler ({b}, {lat}): the high seed word is ignored")
        e = float((z - want).abs().max())
        err = max(err, e)
        print(f"  {name:<22} ({b}, {lat}): words equal bit for bit; max |z "
              f"- plain| = {e:.3e}, / (1 + |z|) = {excess:.3e}; "
              f"deterministic; both seed words used")
    zeros = torch.zeros(SAMPLER_SHAPE, device=dev)
    eps = rng.reparameterize_prng((2024, 1), zeros, zeros)
    mean, var = float(eps.mean()), float(eps.var())
    check(eps.numel() >= 1_000_000 and bool(torch.isfinite(eps).all()),
          "sampler: non-finite eps")
    check(abs(mean) < 5e-3 and abs(var - 1) < 1e-2,
          f"sampler moments: mean {mean:.3e}, var {var:.6f}")
    print(f"  {name:<22} {eps.numel()} samples: mean {mean:.3e}, variance "
          f"{var:.6f}, max |eps| {float(eps.abs().max()):.3f}")
    mu = torch.randn(SAMPLER_SHAPE, generator=g, device=dev)
    logvar = torch.randn(SAMPLER_SHAPE, generator=g, device=dev) * 0.5
    cot = torch.randn(SAMPLER_SHAPE, generator=g, device=dev)
    with torch.enable_grad():
        a, b = mu.clone().requires_grad_(), logvar.clone().requires_grad_()
        ga = torch.autograd.grad(
            (rng.reparameterize((7, 8), a, b) * cot).sum(), (a, b))
        gp = torch.autograd.grad(
            (rng.reparameterize_prng_ref((7, 8), a, b) * cot).sum(), (a, b))
    e = rel_err(ga, gp)
    check(e <= 1e-5, f"sampler backward vs autograd of the plain version: "
          f"{e:.3e}")
    print(f"  {name:<22} backward vs autograd through the plain version: "
          f"relative error {e:.3e}")
    ms, plain_ms, t_kern, t_plain = time_both(
        lambda: rng.reparameterize_prng((7, 8), mu, logvar),
        lambda: rng.reparameterize_prng_ref((7, 8), mu, logvar), 20)
    print(f"  {name:<22} {SAMPLER_SHAPE}: kernel {ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms (runs {t_kern} / {t_plain})")
    n = mu.numel()
    rows[name] = {
        "name": name, "route": "cuda",
        "source": "rawaudiovae_kelsey_tpu_torch/csrc/rng.cu",
        "replaces": "rawaudiovae_kelsey_tpu/ops/rng.py:69",
        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
        **bound(SAMPLER_OPS * n, 3 * 4 * n, "fp32"), "library_ms": None}

    # dx: the encoder's input gradient through the autograd Function
    enc = {n: {k: t.clone() for k, t in q.items()} for n, q in p32.items()}
    x = (torch.rand((TRAIN_RAGGED, SEG), generator=g, device=dev) * 2 - 1)
    cmu = torch.randn((TRAIN_RAGGED, LATENT), generator=g, device=dev)
    clv = torch.randn((TRAIN_RAGGED, LATENT), generator=g, device=dev)
    before = (mlp.matmul_nt2_mask.launches, mlp.matmul_nt.launches)
    with torch.enable_grad():
        xx = x.clone().requires_grad_()
        mu, lv = mlp.encode(enc, xx)
        (dx,) = torch.autograd.grad((mu * cmu).sum() + (lv * clv).sum(), xx)
    rose = (mlp.matmul_nt2_mask.launches - before[0],
            mlp.matmul_nt.launches - before[1])
    check(rose == (1, 1), f"dx: matmul_nt2_mask / matmul_nt rose by {rose}")
    _, _, h = mlp.encoder_fwd_ref(
        *[enc[n][k] for n in ("fc1", "fc21", "fc22") for k in ("w", "b")], x)
    want = mlp.matmul_nt_ref(mlp.matmul_nt2_mask_ref(
        cmu, enc["fc21"]["w"], clv, enc["fc22"]["w"], h), enc["fc1"]["w"])
    e = rel_err((dx,), (want,))
    check(e <= GRAD_REL, f"dx vs the plain composition: {e:.3e}")
    print(f"  dx through mlp.encode, batch {TRAIN_RAGGED}: relative error "
          f"{e:.3e}; rows 6 and 4 launched once each")
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
    epochs = 2
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

    # `high` runs the fp32 "split" kernels, `highest` the fp32 "primitive"
    step_counts = {}
    for precision, rel_tol in (("bfloat16", 5e-2), ("high", 1e-3),
                               ("highest", 1e-3)):
        cfg.tpu.precision = precision
        out = {}
        for backend in ("pallas", "xla"):
            cfg.tpu.backend = backend
            model = build_model(cfg, dev)
            state, _ = restore_checkpoint(ckpt, TrainState.create(
                model.init(torch.Generator().manual_seed(0)), 0))
            before = {n: {k: t.clone() for k, t in q.items()}
                      for n, q in state.params.items()}
            if backend == "pallas":
                for w in ops.KERNEL_WRAPPERS:
                    w.launches = 0
            state, m = build_train_step(model, cfg, noise=noise)(state, x)
            if backend == "pallas":
                step_counts[precision] = {w.__name__: w.launches
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
    step_rows = step_counts["high"]
    print(f"  kernel launches in the fp32 `high` step: {step_rows}")
    print(f"  kernel launches in the fp32 `highest` step: "
          f"{step_counts['highest']}")
    for w in ops.TRAINING_KERNELS:
        check(step_rows[w.__name__] > 0,
              f"{w.__name__} was never launched by the fp32 `high` step")
    for w in ops.PRIMITIVE_KERNELS:
        check(step_counts["highest"][w.__name__] > 0,
              f"{w.__name__} was never launched by the `highest` step")

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


def tee_stdout(fn):
    """Run ``fn()``, echo what it printed, and return it as text."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        try:
            fn()
        finally:
            sys.__stdout__.write(buf.getvalue())
            sys.__stdout__.flush()
    return buf.getvalue()


def phase_resident(data: Path, card: str):
    """Phase 6: the device-resident path of configs/perf_bf16.ini."""
    from rawaudiovae_kelsey_tpu_torch import ops
    from rawaudiovae_kelsey_tpu_torch.config import load_config, save_config
    from rawaudiovae_kelsey_tpu_torch.config.workspace import iter_runs
    from rawaudiovae_kelsey_tpu_torch.data.corpus import build_corpus
    from rawaudiovae_kelsey_tpu_torch.data.datasets import AudioFrameDataset
    from rawaudiovae_kelsey_tpu_torch.data.loader import (
        feed_dtype,
        prefetch_to_device,
    )
    from rawaudiovae_kelsey_tpu_torch.models import build_model
    from rawaudiovae_kelsey_tpu_torch.ops import mlp
    from rawaudiovae_kelsey_tpu_torch.parallel import build_train_step
    from rawaudiovae_kelsey_tpu_torch.parallel import resident as R
    from rawaudiovae_kelsey_tpu_torch.train import TrainState, epoch
    from rawaudiovae_kelsey_tpu_torch.train.cli import main as train_cli

    dev = torch.device("cuda")
    base = load_config(ROOT / "configs" / "perf_bf16.ini")
    t = base.tpu
    check((t.precision, t.backend, t.device_resident, t.resident_shuffle,
           t.rng, base.training.batch_size, base.audio.segment_length,
           base.vae.n_units, base.vae.latent_dim)
          == ("bfloat16", "best", "always", "block", "tpu_prng", 4096, SEG,
              UNITS, LATENT),
          "configs/perf_bf16.ini is not the resident bf16 block-shuffle "
          "tpu_prng batch-4096 trainer")
    batch, seg, hop = base.training.batch_size, SEG, base.audio.hop_length
    corpus, n_samples = build_corpus(data / "audio", SR)
    dataset = AudioFrameDataset(corpus, seg, hop, SR)
    n_frames = len(dataset)
    n_batches = n_frames // batch
    layout = R.choose_layout(n_samples, seg, hop, 2,
                             int(t.resident_budget_gb * (1 << 30)))
    print(f"  corpus: {n_frames} frames ({n_frames * seg * 2 / 1e6:.0f} MB "
          f"in bf16), layout {layout}, {n_batches} batches an epoch")
    check(layout == "frames" and n_batches == 38, "unexpected corpus size")

    def config(**changes):
        cfg = load_config(ROOT / "configs" / "perf_bf16.ini")
        cfg.dataset.datapath = str(data)
        cfg.training.save_best_model_after = 0
        for key, value in changes.items():
            section, name = key.split("__")
            setattr(getattr(cfg, section), name, value)
        return cfg

    # the host loader must never be built on this path
    built = []
    real_prefetch = epoch.prefetch_to_device
    epoch.prefetch_to_device = lambda *a, **k: (
        built.append(1), real_prefetch(*a, **k))[1]

    # --- the trainer: 4 epochs, a boundary after epoch 2, then a resume
    epochs = 4
    cfg = config(training__epochs=epochs, training__checkpoint_interval=2)
    ini = data / "resident.ini"
    save_config(cfg, ini)
    for w in ops.KERNEL_WRAPPERS:
        w.launches = 0
    t0 = time.perf_counter()
    out = tee_stdout(lambda: train_cli(["--config", str(ini)]))
    train_s = time.perf_counter() - t0
    launches = {w.__name__: w.launches for w in ops.KERNEL_WRAPPERS}
    print(f"  train command: {epochs} resident epochs in {train_s:.1f} s "
          f"(ingest, upload, checkpoints and reconstructions included)")
    print(f"  kernel launches in the resident run: {launches}")
    steps = epochs * n_batches
    check(launches["reparameterize_prng"] == steps,
          f"the sampler launched {launches['reparameterize_prng']} times "
          f"in {steps} steps")
    for w in ops.TRAINING_KERNELS:
        check(launches[w.__name__] >= steps,
              f"{w.__name__}: {launches[w.__name__]} launches in {steps} "
              "steps")
    check(not built, "the resident run built the host loader")
    for line in ("Device-resident corpus (frames layout)", "[drain] 3 epochs",
                 "[drain] 1 epochs", "====> Resident epochs e2e: 4 epochs",
                 "Checkpoint - Epoch 2"):
        check(line in out, f"the resident run did not print {line!r}")
    runs = iter_runs(data / cfg.extra.description)
    check(len(runs) == 1, f"expected one run dir, found {runs}")
    ws = runs[0]
    losses = read_scalars(ws / "logs", "Loss/Batch")
    totals = read_scalars(ws / "logs", "Loss/train_total")
    check(sorted(losses) == list(range(steps)),
          f"Loss/Batch has {len(losses)} points, expected {steps}")
    check(all(np.isfinite(v) for v in losses.values()), "non-finite loss")
    tot = [totals[e] for e in range(epochs)]
    print(f"  epoch losses {tot}")
    check(tot[-1] < tot[0], f"the epoch loss did not fall: {tot}")
    want = ["config.ini", "model/best_model.npz", "model/last_model.npz",
            "model/checkpoints/ckpt_00002.npz",
            f"model/checkpoints/ckpt_{epochs:05d}.npz",
            "audio_logs/test_reconst_00002.wav",
            f"audio_logs/test_reconst_{epochs:05d}.wav"]
    for rel in want:
        check((ws / rel).is_file(), f"workspace lacks {rel}")
    meta = json.loads((ws / "model" / "checkpoints"
                       / "ckpt_00002.json").read_text())
    check(meta["step"] == 3 * n_batches and meta["epoch"] == 2,
          f"the boundary checkpoint is not the boundary state: {meta}")
    print(f"  workspace {ws.name}: " + ", ".join(want))

    cfg.training.epochs = epochs + 1
    save_config(cfg, ini)
    out = tee_stdout(lambda: train_cli(["--config", str(ini), "--resume"]))
    check(f"Resuming at epoch {epochs}" in out, "the resume did not resume")
    runs = iter_runs(data / cfg.extra.description)
    resumed = read_scalars(runs[1] / "logs", "Loss/Batch")
    check(sorted(resumed) == list(range(steps, steps + n_batches)),
          f"the resumed run logged steps {sorted(resumed)}")
    print(f"  resume: one more epoch, steps {steps}..{steps + n_batches - 1},"
          f" epoch loss {sum(resumed.values()):.6f}")
    check(not built, "the resumed resident run built the host loader")

    # --- one epoch, resident against a host-fed loop fed the same bf16
    # batches: same state, same permutation, same (seeded) noise
    cfg = config(tpu__rng="threefry")
    model = build_model(cfg, dev)
    check(model.backend == "pallas", f"backend {model.backend}")
    data_dev = R.put_resident(corpus, cfg, "frames", dev)
    blk = R.pick_block_rows(n_frames, n_batches, batch)
    check(blk == 32, f"block rows {blk}")

    def perm(epoch_, n):
        return torch.randperm(n, generator=torch.Generator().manual_seed(
            1234 + epoch_))

    def fresh():
        return TrainState.create(
            model.init(torch.Generator().manual_seed(0)), 11)

    run, nb = R.build_resident_epoch(model, cfg, None, n_samples,
                                     layout="frames", perm=perm)
    _, res_losses = run(fresh(), data_dev, 0)
    n_shuffle = n_frames // blk
    sel = perm(0, n_shuffle)[: nb * batch // blk]
    host_frames = data_dev.cpu()
    host_batches = host_frames[: n_shuffle * blk].view(
        n_shuffle, blk, seg)[sel].view(nb, batch, seg)
    step = build_train_step(model, cfg)
    state = fresh()
    fed = []
    for xb in host_batches.unbind(0):
        state, m = step(state, xb.to(dev))
        fed.append(m["loss"].float())
    fed = torch.stack(fed)
    same = torch.equal(res_losses[0], fed)
    print(f"  one epoch, resident vs host-fed on the same bf16 batches: "
          f"losses {'equal bit for bit' if same else 'DIFFER'} "
          f"({float(fed[0]):.7f} .. {float(fed[-1]):.7f})")
    check(same, "the resident epoch's losses differ from the host-fed "
          f"loop's: max |d| {float((res_losses[0] - fed).abs().max()):.3e}")
    del host_frames, host_batches

    # --- one resident epoch at `highest`: the primitive kernels against
    # the plain backend (the sampler gives both the same noise)
    deltas, prim = {}, {}
    for backend in ("pallas", "xla"):
        cfg = config(tpu__precision="highest", tpu__backend=backend)
        model = build_model(cfg, dev)
        state = fresh()
        before = torch.cat([t.ravel().clone() for _, t in sorted(
            (f"{n}.{k}", t) for n, q in state.params.items()
            for k, t in q.items())])
        run, _ = R.build_resident_epoch(model, cfg, None, n_samples)
        d32 = R.put_resident(corpus, cfg, "frames", dev)
        if backend == "pallas":
            for w in ops.KERNEL_WRAPPERS:
                w.launches = 0
        state, ls = run(state, d32, 0)
        torch.cuda.synchronize()
        if backend == "pallas":
            prim = {w.__name__: w.launches for w in ops.KERNEL_WRAPPERS}
        after = torch.cat([t.ravel() for _, t in sorted(
            (f"{n}.{k}", t) for n, q in state.params.items()
            for k, t in q.items())])
        deltas[backend] = (after - before, ls[0])
        del d32
    per_step = {k: v / n_batches for k, v in prim.items() if v}
    print(f"  `highest` resident epoch, launches per step: {per_step}")
    check(per_step == {"encoder_fwd": 1, "decoder_fwd": 1,
                       "matmul_nt2_mask": 1, "matmul_nt_mask": 1,
                       "matmul_nt": 1, "grad_accum": 5,
                       "reparameterize_prng": 1},
          f"unexpected launches per `highest` step: {per_step}")
    (dk, lk), (dx, lx) = deltas["pallas"], deltas["xla"]
    upd = float((dk - dx).norm() / dx.norm())
    print(f"  `highest` resident epoch, kernels vs plain: first loss "
          f"{float(lk[0]):.7f} vs {float(lx[0]):.7f}, last {float(lk[-1]):.7f}"
          f" vs {float(lx[-1]):.7f}; |update difference| / |update| = "
          f"{upd:.3e} (tolerance 1e-3)")
    check(bool(torch.isfinite(lk).all()) and float(lk[-1]) < float(lk[0]),
          "the `highest` resident epoch did not train")
    check(upd <= 1e-3, "`highest` resident epoch: kernels and plain disagree")

    # --- dx through the model's encoder, fp32 and bf16
    cfg = config()
    model = build_model(cfg, dev)
    params = model.init(torch.Generator().manual_seed(3))
    g = torch.Generator(device=dev).manual_seed(3)
    dx_counts = {}
    for kind, dt in (("fp32", torch.float32), ("bf16", torch.bfloat16)):
        p = {n: {k: v.to(dt) for k, v in q.items()}
             for n, q in params.items()}
        x = (torch.rand((batch, seg), generator=g, device=dev) * 2 - 1).to(dt)
        cmu = torch.randn((batch, LATENT), generator=g, device=dev).to(dt)
        clv = torch.randn((batch, LATENT), generator=g, device=dev).to(dt)
        for w in ops.KERNEL_WRAPPERS:
            w.launches = 0
        xx = x.clone().requires_grad_()
        mu, lv = model.encode(p, xx)
        (dx,) = torch.autograd.grad(
            (mu.float() * cmu.float()).sum() + (lv.float() * clv.float())
            .sum(), xx)
        dx_counts[kind] = {w.__name__: w.launches
                           for w in ops.KERNEL_WRAPPERS}
        _, _, h = mlp.encoder_fwd_ref(
            *[p[n][k] for n in ("fc1", "fc21", "fc22") for k in ("w", "b")],
            x)
        want = mlp.matmul_nt_ref(mlp.matmul_nt2_mask_ref(
            cmu, p["fc21"]["w"], clv, p["fc22"]["w"], h), p["fc1"]["w"])
        e = rel_err((dx,), (want,))
        tol = GRAD_REL if kind == "fp32" else BF16_REL
        print(f"  dx through model.encode [{kind}], batch {batch}: relative "
              f"error {e:.3e} (tolerance {tol:.3e}); launches "
              f"matmul_nt2_mask {dx_counts[kind]['matmul_nt2_mask']}, "
              f"matmul_nt {dx_counts[kind]['matmul_nt']}")
        check(e <= tol and dx_counts[kind]["matmul_nt2_mask"] == 1
              and dx_counts[kind]["matmul_nt"] == 1, f"dx [{kind}]")

    # --- the corpus layout under a small budget; the error under none
    cfg = config(training__epochs=1, training__checkpoint_interval=0,
                 tpu__resident_budget_gb=0.1, extra__description="perf_corpus")
    save_config(cfg, ini)
    out = tee_stdout(lambda: train_cli(["--config", str(ini)]))
    check("Device-resident corpus (corpus layout)" in out
          and "[drain] 1 epochs" in out,
          "a 0.1 GB budget did not take the corpus layout")
    cfg.tpu.resident_budget_gb = 0.001
    cfg.extra.description = "perf_nofit"
    save_config(cfg, ini)
    try:
        train_cli(["--config", str(ini)])
    except ValueError as e:
        check("device_resident=always" in str(e), f"unexpected error: {e}")
        print(f"  resident_budget_gb = 0.001: ValueError, as it must "
              f"({str(e)[:60]}...)")
    else:
        check(False, "device_resident = always ran on a corpus that does "
              "not fit")
    check(not built, "a resident run built the host loader")
    epoch.prefetch_to_device = real_prefetch

    # --- epoch rates: resident and host-fed, kernels and plain
    engines = {}
    for backend in ("pallas", "xla"):
        cfg = config(tpu__backend=backend)
        model = build_model(cfg, dev)
        run, _ = R.build_resident_epoch(model, cfg, None, n_samples)
        engines[backend] = (cfg, run, build_train_step(model, cfg),
                            TrainState.create(model.init(
                                torch.Generator().manual_seed(0)), 5))

    def resident_epoch(backend, e):
        cfg, run, _, state = engines[backend]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run(state, data_dev, e)
        torch.cuda.synchronize()
        return n_batches * batch / (time.perf_counter() - t0)

    def hostfed_epoch(backend, e):
        cfg, _, step, state = engines[backend]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        feed = prefetch_to_device(
            dataset.batches(batch, shuffle=True, seed=cfg.tpu.seed + e),
            dev, depth=cfg.tpu.prefetch, cast_dtype=feed_dtype(cfg))
        try:
            for xb in feed:
                step(state, xb)
        finally:
            feed.close()
        torch.cuda.synchronize()
        return n_frames / (time.perf_counter() - t0)

    rates = {(b, k): [] for b in engines for k in ("resident", "host-fed")}
    for backend in engines:                                   # warm-up
        resident_epoch(backend, 0)
        hostfed_epoch(backend, 0)
    for e, backend in enumerate(("xla", "pallas", "pallas", "xla"), 1):
        rates[backend, "resident"].append(resident_epoch(backend, e))
        rates[backend, "host-fed"].append(hostfed_epoch(backend, e))
    for (backend, kind), rs in rates.items():
        label = "kernels" if backend == "pallas" else "plain"
        print(f"  epoch rate, {kind}, {label}: {statistics.mean(rs):,.0f} "
              f"frames/s (runs {[round(r) for r in rs]}) [{card}]")
    _, run, _, state = engines["pallas"]
    print(f"  device busy share over one resident epoch, kernels: "
          f"{busy_share(lambda: run(state, data_dev, 9))} [{card}]")
    return launches, prim, dx_counts


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

    print("phase 3c: the input-gradient kernels and the sampler against "
          "their plain versions")
    with torch.no_grad():
        new_rows = phase_new_kernels(gen_params)

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
    card = smi.stdout.strip()
    with tempfile.TemporaryDirectory() as tmp:
        train_launches, step_launches = phase_train(Path(tmp) / "data")
        print("phase 6: the device-resident path (configs/perf_bf16.ini)")
        resident_launches, primitive_launches, dx_launches = phase_resident(
            Path(tmp) / "data", card)
    for key, row in train_rows.items():
        name, kind = key[:-1].split("[")
        counts = step_launches if kind == "fp32" else train_launches
        row["launches"] = counts[name]
        check(row["launches"] > 0, f"{key}: no launch on its main path")
    rows.update(train_rows)
    # no path of the package runs matmul_nt_mask on bf16 operands (the bf16
    # step takes the fused dec_bwd_fused): phase 3c held it against its
    # plain version, and it stays out of the line of path kernels
    del new_rows["matmul_nt_mask[bf16]"]
    for key, row in new_rows.items():
        name, kind = key[:-1].split("[")
        if name == "reparameterize_prng":
            row["launches"] = resident_launches[name]
        elif kind == "fp32":
            row["launches"] = primitive_launches[name]
        else:
            row["launches"] = dx_launches["bf16"][name]
        check(row["launches"] > 0, f"{key}: no launch on its main path")
    rows.update(new_rows)
    print(card)
    print(json.dumps({"kernels": list(rows.values())}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

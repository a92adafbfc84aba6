"""Decomposition probe: where a train step's time goes — the port's
counterpart of the JAX repository's ``benchmarks/deep_step_probe.py``.

One train step of the deep model (segment 4096, hidden 4096/2048/1024/512,
latent 256, batch 4096, bf16; ``--arch`` takes the other two families) is
split into its phases, each timed alone, beside an analytic roofline:

* ``full``  — loss, gradients and the Adam update: the real step
  (``parallel/step.py`` ``build_train_step``);
* ``grads`` — loss and gradients only (``make_loss_fn`` + autograd);
* ``adam``  — the optimizer update only, on fixed gradients: pure optimizer
  bandwidth, which at its least reads ``g, m, v, p`` and writes ``m, v, p``
  — 7 fp32 streams over the parameters (1.568 GB a deep step).

Eager PyTorch runs the phases back to back on one stream, so ``full ≈ grads
+ adam`` is expected; how far ``adam`` sits above its 7-stream bound is what
the one-pass update of ``probes/adam_fusion.py`` can win.  The analytic rows
use one H100's data-sheet peaks (3.35 TB/s, 989 TFLOP/s bf16, 67 TFLOP/s
fp32).

    python -m rawaudiovae_kelsey_tpu_torch.probes.deep_step
        [--arch deep] [--batch 4096] [--precision bfloat16] [--backend xla]
        [--pairs 10] [--steps 5] [--device cuda] [--seed 0]
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import List, Optional

import numpy as np
import torch

from rawaudiovae_kelsey_tpu_torch.models import build_model
from rawaudiovae_kelsey_tpu_torch.parallel import (
    build_train_step,
    make_loss_fn,
)
from rawaudiovae_kelsey_tpu_torch.probes import common
from rawaudiovae_kelsey_tpu_torch.train import TrainState, build_optimizer
from rawaudiovae_kelsey_tpu_torch.tree import leaves, tree_map, unflatten


def main(argv: Optional[List[str]] = None) -> dict:
    ap = argparse.ArgumentParser(prog="deep_step")
    ap.add_argument("--arch", type=str, default="deep", choices=common.ARCHS)
    ap.add_argument("--batch", type=int, default=4096)
    ap.add_argument("--precision", type=str, default="bfloat16")
    ap.add_argument("--backend", type=str, default="xla")
    ap.add_argument("--pairs", type=int, default=10,
                    help="alternating rounds of the three phases")
    ap.add_argument("--steps", type=int, default=5,
                    help="steps timed together in one sample")
    ap.add_argument("--device", type=str, default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(sys.argv[1:] if argv is None else argv)

    device = common.resolve_device(args.device, "deep_step")
    cfg = common.build_cfg(args.arch, args.batch, args.precision,
                           args.backend)
    model = build_model(cfg, device)
    opt = build_optimizer(cfg)
    params = model.init(torch.Generator().manual_seed(args.seed))
    state = TrainState.create(params, args.seed)
    adam_state = state.clone()
    one_step = build_train_step(model, cfg, opt)
    loss_fn = make_loss_fn(model, cfg)
    batch = torch.from_numpy(
        np.random.default_rng(args.seed)
        .uniform(-1, 1, (args.batch, model.segment_length))
        .astype(np.float32)).to(device)
    eps = torch.randn((args.batch, model.latent_dim), device=device,
                      generator=torch.Generator(device=device)
                      .manual_seed(args.seed))

    grad_params = tree_map(lambda t: t.detach().clone().requires_grad_(),
                           params)
    grad_leaves = leaves(grad_params)

    def grads_only():
        loss, _ = loss_fn(grad_params, eps, batch)
        return [g.float() for g in torch.autograd.grad(loss, grad_leaves)]

    # fixed gradients for the optimizer-only phase: one real backward's
    grads0 = unflatten(params, grads_only())

    times = common.alternate({
        "full": lambda: one_step(state, batch),
        "grads": grads_only,
        "adam": lambda: opt.update(adam_state, grads0),
    }, args.pairs, args.steps, device, clock="host")

    n_params = sum(p.numel() for p in leaves(params))
    flops = args.batch * common.flops_per_frame(args.arch)
    work = "bfloat16" if args.precision == "bfloat16" else "float32"
    ops_floor = flops / common.H100_PEAK_FLOPS[work] * 1e3
    adam_bytes = 7 * 4 * n_params          # read g, m, v, p; write m, v, p
    adam_floor = adam_bytes / common.H100_HBM_BYTES_S * 1e3
    t_full, t_grads, t_adam = (times[k]["median"]
                               for k in ("full", "grads", "adam"))
    card = common.device_name(device)
    print(f"{args.arch} step decomposition  B={args.batch} "
          f"{args.precision}/{model.backend}  params={n_params / 1e6:.1f}M  "
          f"on {card}")
    print(f"  full step : {common.fmt(times['full'])}   "
          f"({args.batch / t_full / 1e3:.3f} M frames/s, "
          f"{ops_floor / t_full:.1%} of the {work} peak)")
    print(f"  grads only: {common.fmt(times['grads'])}   "
          f"(operations bound {ops_floor:.3f} ms)")
    print(f"  adam only : {common.fmt(times['adam'])}   "
          f"(7-stream fp32 bound {adam_floor:.3f} ms at "
          f"{common.H100_HBM_BYTES_S / 1e12:.2f} TB/s: "
          f"{t_adam / adam_floor:.2f}x)")
    print(f"  grads+adam: {t_grads + t_adam:8.3f} ms vs full {t_full:.3f} ms"
          f" -> overlap/residual {t_grads + t_adam - t_full:+.3f} ms")
    print(f"  share of the full step above the operations bound: "
          f"{(t_full - ops_floor) / t_full:.1%} "
          f"(the adam bound alone is {adam_floor / t_full:.1%})")
    out = {"probe": "deep_step", "device": card, "arch": args.arch,
           "batch": args.batch, "precision": args.precision,
           "backend": model.backend, "params": n_params, "ms": times,
           "ops_bound_ms": ops_floor, "adam_bytes": adam_bytes,
           "adam_bound_ms": adam_floor, "pairs": args.pairs,
           "steps": args.steps,
           "frames_per_s": args.batch / t_full * 1e3}
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()

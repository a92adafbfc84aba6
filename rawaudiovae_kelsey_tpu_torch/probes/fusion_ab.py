"""A/B probe: the backward-fusion modes of the dense kernels inside the full
train step — the port's counterpart of the JAX repository's
``benchmarks/fusion_ab.py``.

``ops/mlp.py`` ``BWD_FUSION`` picks the dense model's backward under
``backend = pallas``: "full", one call a chain (``enc_bwd_full``,
``dec_bwd_full``), or "split", two a chain (``enc_bwd_dw1`` +
``grad_accum2``, ``dec_bwd_fused`` + ``grad_accum``); "primitive" may be
named too.  The probe builds the dense model (segment 1024, units 2048,
latent 256: ``configs/default.ini``'s widths) once a mode, with the switch
forced while the model is built (it is read then, ``models/registry.py``
``backward_fusion``), and one step a model from the same initial state and
Adam; runs them on the same batch, which lives on the device, as
alternating pairs of ``--steps`` steps timed by the host clock ending in a
synchronise (``probes/common.py`` ``alternate``), and reports each mode's
frames/s as the median and the 10th-90th percentile over the pairs, with
its backward kernels' launches a step.

    python -m rawaudiovae_kelsey_tpu_torch.probes.fusion_ab
        [--precision bfloat16|high] [--modes split full] [--batch 4096]
        [--pairs 10] [--steps 10] [--device cuda] [--seed 0]

The JAX probe times a ``lax.scan`` of 100 steps in one compiled program,
best of three windows of 8; eager PyTorch dispatches each step from the
host, as the port's trainers do.  JAX's "auto" rule (split at one pass,
full at three) is its TPU measurement; this probe measures the rule on the
card.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import List, Optional

import numpy as np
import torch

from rawaudiovae_kelsey_tpu_torch.models import build_model
from rawaudiovae_kelsey_tpu_torch.ops import mlp
from rawaudiovae_kelsey_tpu_torch.parallel import build_train_step
from rawaudiovae_kelsey_tpu_torch.probes import common
from rawaudiovae_kelsey_tpu_torch.train import TrainState, build_optimizer

# the dense backward's kernels, whose launches a step tell the modes apart
BACKWARD = (mlp.enc_bwd_full, mlp.dec_bwd_full, mlp.enc_bwd_dw1,
            mlp.grad_accum2, mlp.dec_bwd_fused, mlp.grad_accum,
            mlp.matmul_nt2_mask, mlp.matmul_nt_mask, mlp.matmul_nt)


def rates(batch: int, ms: dict) -> dict:
    """Frames/s of a step's ms summary (``common.summary``): the median,
    and the 10th and 90th percentile (the 90th and 10th of the times)."""
    return {"median": batch / ms["median"] * 1e3,
            "p10": batch / ms["p90"] * 1e3, "p90": batch / ms["p10"] * 1e3}


def main(argv: Optional[List[str]] = None) -> dict:
    ap = argparse.ArgumentParser(prog="fusion_ab")
    ap.add_argument("--precision", type=str, default="bfloat16",
                    choices=["bfloat16", "high", "highest", "float32"])
    ap.add_argument("--modes", nargs="+", default=["split", "full"],
                    choices=mlp.BACKWARD_MODES)
    ap.add_argument("--batch", type=int, default=4096)
    ap.add_argument("--pairs", type=int, default=10,
                    help="alternating rounds of the modes")
    ap.add_argument("--steps", type=int, default=10,
                    help="steps timed together in one sample")
    ap.add_argument("--device", type=str, default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(sys.argv[1:] if argv is None else argv)

    device = common.resolve_device(args.device, "fusion_ab")
    cfg = common.build_cfg("dense", args.batch, args.precision, "pallas")
    saved, models = mlp.BWD_FUSION, {}
    try:
        for mode in args.modes:
            mlp.BWD_FUSION = mode
            models[mode] = build_model(cfg, device)
    finally:
        mlp.BWD_FUSION = saved
    opt = build_optimizer(cfg)
    first = TrainState.create(
        models[args.modes[0]].init(torch.Generator().manual_seed(args.seed)),
        args.seed)
    states = {mode: first.clone() for mode in args.modes}
    steps = {mode: build_train_step(models[mode], cfg, optimizer=opt)
             for mode in args.modes}
    batch = torch.from_numpy(
        np.random.default_rng(args.seed)
        .uniform(-1, 1, (args.batch, models[args.modes[0]].segment_length))
        .astype(np.float32)).to(device)

    # one step each (a warm-up): the backward kernels it launched
    launches = {}
    for mode in args.modes:
        before = [w.launches for w in BACKWARD]
        steps[mode](states[mode], batch)
        launches[mode] = {w.__name__: w.launches - n
                          for w, n in zip(BACKWARD, before)
                          if w.launches > n}
    common.sync(device)

    times = common.alternate(
        {mode: (lambda mode=mode: steps[mode](states[mode], batch))
         for mode in args.modes},
        args.pairs, args.steps, device, clock="host")
    common.sync(device)

    frames = {mode: rates(args.batch, times[mode]) for mode in args.modes}
    card = common.device_name(device)
    print(f"dense/pallas, batch {args.batch}, {args.precision}, backward "
          f"fusion {' / '.join(args.modes)}, on {card}:")
    for mode in args.modes:
        f = frames[mode]
        print(f"  {args.precision} {mode:<9}: step {common.fmt(times[mode])}"
              f"  {f['median'] / 1e6:.3f} M frames/s (p10 "
              f"{f['p10'] / 1e6:.3f}, p90 {f['p90'] / 1e6:.3f})  backward "
              f"launches a step {launches[mode]}")
    if len(args.modes) == 2:
        a, b = args.modes
        print(f"  {a} against {b}: "
              f"{(frames[a]['median'] / frames[b]['median'] - 1) * 100:+.1f}"
              "% frames/s")
    out = {"probe": "fusion_ab", "device": card, "arch": "dense",
           "backend": "pallas", "precision": args.precision,
           "batch": args.batch, "modes": args.modes, "ms": times,
           "frames_per_s": frames, "launches_per_step": launches,
           "pairs": args.pairs, "steps": args.steps}
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()

"""A/B probe: the one-pass Adam kernel against the plain Adam, inside the
full train step — the port's counterpart of the JAX repository's
``benchmarks/adam_fusion_ab.py``.

``train/optim.py`` runs Adam as a dozen tensor operations a leaf;
``ops/adam.py`` ``fused_adam_apply`` does the whole tree in ONE launch of
the tree kernel a step (``adam_tree``; one more a further 48 leaves, and no
model here has that many), bit for bit the same numbers.  The probe builds
the real model and the real step twice —
``build_train_step(model, cfg, optimizer=...)`` with ``Adam`` and with
``FusedAdam`` — from the same initial state, runs them on the same batch
and the same noise as alternating pairs of ``--steps`` steps, reports both
rates, and then checks that the two states (params, both moments, count)
are equal bit for bit: a difference exits non-zero.

    python -m rawaudiovae_kelsey_tpu_torch.probes.adam_fusion
        [--arch deep|dense|conv1d] [--backend xla|pallas] [--batch 4096]
        [--pairs 10] [--steps 10] [--device cuda] [--seed 0]

Each step is one dispatch from the host, the context of the real trainers
(the JAX probe's ``shallow`` mode); its ``--mode scan`` times a
``lax.scan`` of steps inside one compiled program and has no counterpart in
eager PyTorch.  For ``conv1d`` the probe asks cuDNN for its deterministic
algorithms, so that the two runs of the same backward give the same bits.
The rule for a later change: wire ``FusedAdam`` into ``build_optimizer``
only where it wins by more than 3 %.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import List, Optional

import numpy as np
import torch

from rawaudiovae_kelsey_tpu_torch.models import build_model
from rawaudiovae_kelsey_tpu_torch.ops import adam as adam_ops
from rawaudiovae_kelsey_tpu_torch.parallel import build_train_step
from rawaudiovae_kelsey_tpu_torch.probes import common
from rawaudiovae_kelsey_tpu_torch.train import TrainState, build_optimizer
from rawaudiovae_kelsey_tpu_torch.tree import flatten, leaves


def differing_leaves(a: TrainState, b: TrainState) -> List[str]:
    """Names of the leaves (``params.enc.0.w``, ``mu...``) whose bits
    differ between the two states (fp32 compared as its 32-bit pattern, so
    that -0 is not +0 and a NaN equals itself), and ``count`` if the counts
    do."""
    bad = [f"{field}.{name}"
           for field in ("params", "mu", "nu")
           for (name, ta), (_, tb) in zip(flatten(getattr(a, field)),
                                          flatten(getattr(b, field)))
           if not torch.equal(ta.view(torch.int32), tb.view(torch.int32))]
    if (a.count, a.step) != (b.count, b.step):
        bad.append("count")
    return bad


def main(argv: Optional[List[str]] = None) -> dict:
    ap = argparse.ArgumentParser(prog="adam_fusion")
    ap.add_argument("--arch", type=str, default="deep", choices=common.ARCHS)
    ap.add_argument("--backend", type=str, default="xla",
                    choices=["xla", "pallas"])
    ap.add_argument("--batch", type=int, default=4096)
    ap.add_argument("--pairs", type=int, default=10,
                    help="alternating rounds of the two optimizers")
    ap.add_argument("--steps", type=int, default=10,
                    help="steps timed together in one sample")
    ap.add_argument("--device", type=str, default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(sys.argv[1:] if argv is None else argv)

    device = common.resolve_device(args.device, "adam_fusion")
    if args.arch == "conv1d" and device.type == "cuda":
        torch.backends.cudnn.deterministic = True
    cfg = common.build_cfg(args.arch, args.batch, "bfloat16", args.backend)
    model = build_model(cfg, device)
    plain_opt = build_optimizer(cfg)
    optimizers = {"plain": plain_opt, "fused": adam_ops.FusedAdam(plain_opt)}
    first = TrainState.create(
        model.init(torch.Generator().manual_seed(args.seed)), args.seed)
    states = {name: first.clone() for name in optimizers}
    steps = {name: build_train_step(model, cfg, optimizer=opt)
             for name, opt in optimizers.items()}
    batch = torch.from_numpy(
        np.random.default_rng(args.seed)
        .uniform(-1, 1, (args.batch, model.segment_length))
        .astype(np.float32)).to(device)

    # launches of the tree kernel a step, under each optimizer
    per_step = {}
    for name in optimizers:
        before = adam_ops.adam_tree.launches
        steps[name](states[name], batch)
        per_step[name] = adam_ops.adam_tree.launches - before
    common.sync(device)

    times = common.alternate(
        {name: (lambda name=name: steps[name](states[name], batch))
         for name in optimizers},
        args.pairs, args.steps, device, clock="host")
    common.sync(device)

    n_leaves = len(leaves(first.params))
    bad = differing_leaves(states["plain"], states["fused"])
    rate = {name: args.batch / times[name]["median"] * 1e3
            for name in optimizers}
    gain = (rate["fused"] / rate["plain"] - 1) * 100
    card = common.device_name(device)
    print(f"{args.arch}/{model.backend} shallow, batch {args.batch}, bf16, "
          f"{n_leaves} leaves, on {card}:")
    for name in optimizers:
        print(f"  {name:<5} adam: step {common.fmt(times[name])}  "
              f"{rate[name] / 1e6:.3f}M frames/s  "
              f"(adam_tree launches a step: {per_step[name]})")
    print(f"  fused against plain: {gain:+.1f}% frames/s")
    print(f"  states after {states['plain'].step} steps each: "
          + ("equal bit for bit" if not bad else f"DIFFER in {bad}"))
    out = {"probe": "adam_fusion", "device": card, "arch": args.arch,
           "backend": model.backend, "batch": args.batch, "leaves": n_leaves,
           "ms": times, "frames_per_s": rate, "gain_percent": gain,
           "adam_tree_launches_per_step": per_step,
           "steps_each": states["plain"].step, "states_equal": not bad,
           "pairs": args.pairs, "steps": args.steps}
    print(json.dumps(out))
    if bad:
        raise SystemExit(f"adam_fusion: the two states differ in {bad}")
    return out


if __name__ == "__main__":
    main()

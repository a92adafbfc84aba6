"""A/B probe: the fused backward of one large linear layer against the plain
one — the port's counterpart of the JAX repository's
``benchmarks/deep_bwd_probe.py``.

The deep model's backward (``ops/linear.py`` ``PallasLinear.backward``) is
plain PyTorch: it writes the cotangent ``da = act'(y) · dy`` (B × n) to
device memory and reads it back for ``dx``, ``dW`` and ``db``.  The
candidates, ``dw_fused`` and ``dx_fused`` (``ops/linear_bwd.py``), form
``da`` inside both products.  The probe first holds the fused pair against
the plain backward (bf16: within 2⁻⁶ · max|plain|, fp32: 1e-4 · max|plain|),
then times, as alternating pairs: the plain backward, the fused pair, and
each kernel alone.

    python -m rawaudiovae_kelsey_tpu_torch.probes.deep_bwd
        [--batch 4096] [--k 4096] [--n 4096] [--act relu] [--dtype bfloat16]
        [--all] [--pairs 10] [--launches 5] [--device cuda] [--seed 0]

``--all`` runs the four large layer shapes of ``configs/deep_wide.ini``.
The rule for a later change: wire the pair into ``PallasLinear.backward``
only where it beats the plain backward by more than 3 %.

The JAX probe's in-jit dependency chain (``_time_chained``) exists to hide a
remote dispatch latency and has no counterpart here.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Dict, List, Optional

import torch

from rawaudiovae_kelsey_tpu_torch.ops import linear_bwd
from rawaudiovae_kelsey_tpu_torch.probes import common

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
# fused against plain: sums in another order (fp32), one flipped bf16 ulp and
# one more carried from a rounded cotangent (bf16)
PARITY_REL = {"bfloat16": 2.0 ** -6, "float32": 1e-4}


def operands(batch: int, k: int, n: int, dtype: torch.dtype,
             device: torch.device, generator: torch.Generator):
    """``x, y, dy, w`` of the JAX probe's scales (unit normal x and y;
    cotangent and weights 0.01 · normal), drawn from ``generator``."""
    def normal(shape, scale=1.0):
        t = torch.randn(shape, generator=generator, device=device)
        return (t * scale).to(dtype)

    return (normal((batch, k)), normal((batch, n)),
            normal((batch, n), 0.01), normal((k, n), 0.01))


def parity(x, y, dy, w, act: str, tol: float) -> Dict[str, float]:
    """Max error of the fused pair against the plain backward, relative to
    each output's largest value; raises when one exceeds ``tol``."""
    want = linear_bwd.plain_bwd(x, y, dy, w, act)
    got = linear_bwd.fused_bwd(x, y, dy, w, act)
    errs = {}
    for name, a, b in zip(("dx", "dw", "db"), want, got):
        if a.shape != b.shape or a.dtype != b.dtype:
            raise RuntimeError(f"parity {name}: {tuple(b.shape)} {b.dtype} "
                               f"against {tuple(a.shape)} {a.dtype}")
        a, b = a.float(), b.float()
        err = float((a - b).abs().max()) / max(1e-30, float(a.abs().max()))
        print(f"parity {name}: rel max err {err:.2e} (tolerance {tol:.2e})")
        if not err <= tol:
            raise RuntimeError(f"parity {name}: {err:.3e} > {tol:.3e}")
        errs[name] = err
    return errs


def run_shape(batch: int, k: int, n: int, act: str, dtype_name: str,
              device: torch.device, generator: torch.Generator, pairs: int,
              launches: int) -> dict:
    """Parity, then the timings, of one layer shape."""
    x, y, dy, w = operands(batch, k, n, DTYPES[dtype_name], device, generator)
    errs = parity(x, y, dy, w, act, PARITY_REL[dtype_name])
    counts = [linear_bwd.dw_fused.launches, linear_bwd.dx_fused.launches]
    linear_bwd.fused_bwd(x, y, dy, w, act)
    per_bwd = [linear_bwd.dw_fused.launches - counts[0],
               linear_bwd.dx_fused.launches - counts[1]]
    times = common.alternate({
        "plain": lambda: linear_bwd.plain_bwd(x, y, dy, w, act),
        "fused": lambda: linear_bwd.fused_bwd(x, y, dy, w, act),
        "dw_fused": lambda: linear_bwd.dw_fused(x, y, dy, act),
        "dx_fused": lambda: linear_bwd.dx_fused(y, dy, w, act),
    }, pairs, launches, device)
    flops = 2 * batch * k * n * 2                     # the dx and dW products
    t_plain, t_fused = times["plain"]["median"], times["fused"]["median"]
    print(f"shape B={batch} k={k} n={n} act={act} dtype={dtype_name}")
    print(f"plain bwd: {common.fmt(times['plain'])}  "
          f"{flops / t_plain / 1e9:6.1f} TFLOP/s")
    print(f"fused bwd: {common.fmt(times['fused'])}  "
          f"{flops / t_fused / 1e9:6.1f} TFLOP/s "
          f"({t_plain / t_fused * 100:.1f}% of plain's speed; > 100 = fused "
          "wins)")
    print(f"  dw_fused alone: {common.fmt(times['dw_fused'])}")
    print(f"  dx_fused alone: {common.fmt(times['dx_fused'])}")
    return {"batch": batch, "k": k, "n": n, "act": act, "dtype": dtype_name,
            "parity": errs, "ms": times, "flops": flops,
            "fused_over_plain": t_fused / t_plain,
            "launches_per_fused_bwd": {"dw_fused": per_bwd[0],
                                       "dx_fused": per_bwd[1]}}


def main(argv: Optional[List[str]] = None) -> dict:
    ap = argparse.ArgumentParser(prog="deep_bwd")
    ap.add_argument("--batch", type=int, default=4096)
    ap.add_argument("--k", type=int, default=4096)
    ap.add_argument("--n", type=int, default=4096)
    ap.add_argument("--act", type=str, default="relu",
                    choices=["relu", "tanh", "none"])
    ap.add_argument("--dtype", type=str, default="bfloat16",
                    choices=sorted(DTYPES))
    ap.add_argument("--all", action="store_true",
                    help="the four large layer shapes of the deep model")
    ap.add_argument("--pairs", type=int, default=10,
                    help="alternating rounds of the variants")
    ap.add_argument("--launches", type=int, default=5,
                    help="calls timed together in one sample")
    ap.add_argument("--device", type=str, default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(sys.argv[1:] if argv is None else argv)

    device = common.resolve_device(args.device, "deep_bwd")
    generator = torch.Generator(device=device).manual_seed(args.seed)
    shapes = common.DEEP_SHAPES if args.all else ((args.k, args.n),)
    card = common.device_name(device)
    print(f"deep_bwd on {card}")
    with torch.no_grad():
        results = [run_shape(args.batch, k, n, args.act, args.dtype, device,
                             generator, args.pairs, args.launches)
                   for k, n in shapes]
    out = {"probe": "deep_bwd", "device": card, "pairs": args.pairs,
           "launches": args.launches, "shapes": results}
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()

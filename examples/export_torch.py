#!/usr/bin/env python
"""Export on the PyTorch port — the script form of the reference's
export-onnx.ipynb, the counterpart of ``examples/export.py``.

Loads a checkpoint on a CUDA device (``--device cpu`` on the CPU) and
exports:
  * a real ``rawaudiovae.onnx`` (export-onnx.ipynb cell 11 parity: fixed
    (segment,) input, stochastic reparameterize, outputs recon/mu/logvar) +
    a dynamic-batch deterministic variant — dense family only
  * the plain forward as a ``torch.export`` program (stochastic — noise
    drawn in the graph — and deterministic), the counterpart of the JAX
    script's StableHLO
  * torch-layout npz weights

Usage:
    python examples/export_torch.py --run <workdir> [--config <ini>] [--out out/]
    python examples/export_torch.py --torch-ckpt ckpt_00500 --config configs/default.ini
    python -m rawaudiovae_kelsey_tpu_torch export --run <workdir> --onnx   # ONNX only
"""

from __future__ import annotations

import argparse
import os
import sys
from pathlib import Path

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from rawaudiovae_kelsey_tpu_torch.infer import (  # noqa: E402
    export_npz,
    export_onnx,
    export_program,
)
from rawaudiovae_kelsey_tpu_torch.infer.runs import (  # noqa: E402
    load_run,
    resolve_device,
)


def main() -> None:
    ap = argparse.ArgumentParser(prog="export")
    ap.add_argument("--run", type=Path, default=None)
    ap.add_argument("--config", type=Path, default=None)
    ap.add_argument("--torch-ckpt", type=Path, default=None)
    ap.add_argument("--out", type=Path, default=Path("export_out"))
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--onnx", action="store_true",
                    help="emit only the .onnx artifacts")
    ap.add_argument("--device", type=str, default="cuda",
                    help="torch device to load and trace on (default: cuda)")
    args = ap.parse_args()
    if args.run is None and (args.torch_ckpt is None or args.config is None):
        ap.error("give --run, or --torch-ckpt with --config")

    device = resolve_device(args.device, "export")
    _, model, params = load_run(args.run, args.config, device,
                                args.torch_ckpt or "best")
    paths = []
    if model.name == "dense":
        # reference-parity graph (fixed (segment,) input, stochastic)
        paths.append(export_onnx(model, params,
                                 args.out / "rawaudiovae.onnx"))
        # dynamic-batch deterministic variant (quirk #13/#18 extensions)
        paths.append(export_onnx(model, params,
                                 args.out / "rawaudiovae_det.onnx",
                                 batch="batch", deterministic=True))
    elif args.onnx:
        raise SystemExit(
            f"--onnx covers the dense reference family only (this run is "
            f"{model.name!r}); drop --onnx for program + npz export"
        )
    if not args.onnx:
        paths.append(export_program(
            model, params, args.out / "rawaudiovae.pt2",
            batch=args.batch, deterministic=False))
        paths.append(export_program(
            model, params, args.out / "rawaudiovae_det.pt2",
            batch=args.batch, deterministic=True))
        paths.append(export_npz(model, params,
                                args.out / "rawaudiovae_weights.npz"))
    for p in paths:
        print(f"exported {p} ({p.stat().st_size:,} bytes)")


if __name__ == "__main__":
    main()

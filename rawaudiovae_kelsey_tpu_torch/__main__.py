"""CLI of the PyTorch port:  python -m rawaudiovae_kelsey_tpu_torch <command>

Commands:
  train     the epoch trainer (the ``python train.py`` flow) on a CUDA device:
            train --config <ini> [--resume] [--device cuda]
  stream    the streaming trainer (the ``python train_iterable.py`` flow) on a
            CUDA device:
            stream --config <ini> [--resume] [--device cuda]
  eval      reconstruction MSE of a trained run against its test audio:
            eval --run <workdir> [--deterministic] [--device cuda]
  serve     HTTP inference service (batched encode/decode/reconstruct) on a
            CUDA device:
            serve --run <workdir> [--quantize] [--device cuda] [--port 8422]
  validate  dataset audit of a wav folder (needs no device):
            validate <folder> [--sr 44100] [--deep]

``train``, ``stream``, ``eval`` and ``serve`` refuse to start without a CUDA
device unless ``--device cpu`` is given.  Not ported yet, of the commands of
``python -m rawaudiovae_kelsey_tpu``: tutorial, export, som.
"""

from __future__ import annotations

import sys


def serve(argv) -> None:
    import argparse
    from pathlib import Path

    import torch

    from rawaudiovae_kelsey_tpu_torch.config import load_config
    from rawaudiovae_kelsey_tpu_torch.infer.http import HttpInferenceServer
    from rawaudiovae_kelsey_tpu_torch.models import build_model
    from rawaudiovae_kelsey_tpu_torch.train import load_params

    ap = argparse.ArgumentParser(prog="serve")
    ap.add_argument("--run", type=Path, required=True)
    ap.add_argument("--config", type=Path, default=None)
    ap.add_argument("--params", type=str, default="best")
    ap.add_argument("--device", type=str, default="cuda",
                    help="torch device to serve on (default: cuda)")
    ap.add_argument("--host", type=str, default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8422)
    ap.add_argument("--batch-size", type=int, default=256)
    ap.add_argument("--deterministic", action="store_true")
    ap.add_argument("--quantize", action="store_true")
    ap.add_argument("--no-warmup", action="store_true",
                    help="skip the warmup pass of the batched paths")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(
            "serve: --device cuda but no CUDA device is available (pass "
            "--device cpu to serve the plain PyTorch path on the CPU)")
    cfg = load_config(args.config or args.run / "config.ini")
    model = build_model(cfg, device)
    template = model.init(torch.Generator().manual_seed(0))
    params = load_params(
        args.run / "model" / f"{args.params}_model.npz", template
    )
    HttpInferenceServer(
        model, params, sampling_rate=cfg.audio.sampling_rate,
        host=args.host, port=args.port, batch_size=args.batch_size,
        deterministic=args.deterministic, quantize=args.quantize,
        warmup=not args.no_warmup,
    ).serve_forever()


def validate(argv) -> None:
    import argparse
    from pathlib import Path

    from rawaudiovae_kelsey_tpu_torch.data.validate import validate_dataset

    ap = argparse.ArgumentParser(prog="validate")
    ap.add_argument("folder", type=Path)
    ap.add_argument("--sr", type=int, default=44100)
    ap.add_argument("--deep", action="store_true",
                    help="full decode audit (silent/clipped/non-finite)")
    args = ap.parse_args(argv)
    report = validate_dataset(args.folder, args.sr, deep=args.deep)
    print(report.summary())
    sys.exit(0 if report.ok else 1)


def main() -> None:
    argv = sys.argv[1:]
    if not argv or argv[0] in ("-h", "--help"):
        print(__doc__)
        return
    cmd, rest = argv[0], argv[1:]
    if cmd == "serve":
        serve(rest)
    elif cmd == "train":
        from rawaudiovae_kelsey_tpu_torch.train.cli import main as train

        train(rest)
    elif cmd == "stream":
        from rawaudiovae_kelsey_tpu_torch.train.cli import main_stream

        main_stream(rest)
    elif cmd == "eval":
        from rawaudiovae_kelsey_tpu_torch.eval.cli import main as evaluate

        evaluate(rest)
    elif cmd == "validate":
        validate(rest)
    else:
        print(f"unknown command {cmd!r}\n{__doc__}")
        sys.exit(2)


if __name__ == "__main__":
    main()

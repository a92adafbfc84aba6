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
  tutorial  the creative pipeline (examples/tutorial_torch.py): sources →
            encode → interpolate → decode → wavs and a comparison plot:
            tutorial --run <workdir> --audio <wav-folder> [--out out/]
            [--torch-ckpt <ckpt>] [--device cuda]
  export    ONNX + exported program + npz (examples/export_torch.py):
            export --run <workdir> [--out out/] [--onnx] [--device cuda]
  som       train a SOM over a wav folder's latents; writes the
            clusters.json/data-concatenated.json artifacts the tutorial's
            cluster workflow consumes:
            som --run <workdir> --audio <wav-folder> [--out som/]
            [--grid 8,8] [--iters 200] [--seed 0] [--device cuda]

Every command but ``validate`` refuses to start without a CUDA device unless
``--device cpu`` is given.  ``train`` and ``stream`` train on every visible
card under ``[tpu] data_parallel = 0`` (one rank a card, started by the
command; ``data_parallel = n`` asks for n) and join a torchrun group where
one is set up (``train/cli.py``).  ``tutorial`` and ``export`` run the example
scripts of a source checkout (they do not ship in an installed wheel).
"""

from __future__ import annotations

import sys


def serve(argv) -> None:
    import argparse
    from pathlib import Path

    from rawaudiovae_kelsey_tpu_torch.infer.http import HttpInferenceServer
    from rawaudiovae_kelsey_tpu_torch.infer.runs import (
        load_run,
        resolve_device,
    )

    ap = argparse.ArgumentParser(prog="serve")
    ap.add_argument("--run", type=Path, required=True)
    ap.add_argument("--config", type=Path, default=None)
    ap.add_argument("--params", type=str, default="best",
                    help="best | last | explicit path (.npz or torch ckpt)")
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
    device = resolve_device(args.device, "serve")
    cfg, model, params = load_run(args.run, args.config, device, args.params)
    HttpInferenceServer(
        model, params, sampling_rate=cfg.audio.sampling_rate,
        host=args.host, port=args.port, batch_size=args.batch_size,
        deterministic=args.deterministic, quantize=args.quantize,
        warmup=not args.no_warmup,
    ).serve_forever()


def som(argv) -> None:
    import argparse
    from pathlib import Path

    from rawaudiovae_kelsey_tpu_torch.infer import train_som_for_corpus
    from rawaudiovae_kelsey_tpu_torch.infer.runs import (
        load_run,
        resolve_device,
    )

    ap = argparse.ArgumentParser(prog="som")
    ap.add_argument("--run", type=Path, required=True)
    ap.add_argument("--audio", type=Path, required=True)
    ap.add_argument("--config", type=Path, default=None)
    ap.add_argument("--params", type=str, default="best")
    ap.add_argument("--out", type=Path, default=Path("som"))
    ap.add_argument("--grid", type=str, default="8,8")
    ap.add_argument("--iters", type=int, default=200)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", type=str, default="cuda",
                    help="torch device to encode and fit on (default: cuda)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device, "som")
    cfg, model, params = load_run(args.run, args.config, device, args.params)
    gy, gx = (int(t) for t in args.grid.split(","))
    c, d = train_som_for_corpus(
        model, params, args.audio, args.out, cfg.audio.sampling_rate,
        grid=(gy, gx), iters=args.iters, seed=args.seed,
        mono=cfg.dataset.mono,
    )
    print(f"wrote {c}\nwrote {d}")


def example(cmd: str, argv) -> None:
    """Run ``examples/<cmd>_torch.py`` of the source checkout with
    ``argv``."""
    import runpy
    from pathlib import Path

    script = (Path(__file__).resolve().parents[1] / "examples"
              / f"{cmd}_torch.py")
    if not script.exists():
        # installed as a wheel: examples/ lives in the source tree, not in
        # site-packages
        print(f"{cmd}: {script} not found — the example scripts ship in the "
              "repository, not in installed wheels; run from a source "
              f"checkout or invoke examples/{cmd}_torch.py directly.",
              file=sys.stderr)
        sys.exit(2)
    saved = sys.argv
    sys.argv = [str(script), *argv]
    try:
        runpy.run_path(str(script), run_name="__main__")
    finally:
        sys.argv = saved


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
    elif cmd == "som":
        som(rest)
    elif cmd in ("tutorial", "export"):
        example(cmd, rest)
    else:
        print(f"unknown command {cmd!r}\n{__doc__}")
        sys.exit(2)


if __name__ == "__main__":
    main()

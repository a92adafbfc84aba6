"""The ``train`` command of the PyTorch port — the counterpart of the JAX
package's ``train/cli.py`` epoch entry point (``python train.py --config
default.ini``):

    python -m rawaudiovae_kelsey_tpu_torch train --config x.ini [--resume]
        [--device cuda]

It trains on a CUDA device and refuses to start without one unless
``--device cpu`` asks for the plain PyTorch path on the CPU.  The streaming
trainer (``train_iterable.py``) is not ported yet.
"""

from __future__ import annotations

import argparse
import sys

import torch

from rawaudiovae_kelsey_tpu_torch.config import load_config


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(prog="train")
    parser.add_argument("--config", type=str, default="./default.ini",
                        help="path to the config file")
    parser.add_argument("--resume", action="store_true",
                        help="resume from the latest checkpoint of the most "
                             "recent run")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device to train on (default: cuda)")
    args = parser.parse_args(sys.argv[1:] if argv is None else argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(
            "train: --device cuda but no CUDA device is available (pass "
            "--device cpu to train with the plain PyTorch path on the CPU)")
    try:
        cfg = load_config(args.config)
    except FileNotFoundError:
        print(f"Config File Not Found at {args.config}")
        sys.exit(1)
    if args.resume:
        cfg.training.resume = True
    from rawaudiovae_kelsey_tpu_torch.train.epoch import train

    train(cfg, device=device)


if __name__ == "__main__":
    main()

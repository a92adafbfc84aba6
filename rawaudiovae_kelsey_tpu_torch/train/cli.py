"""The training commands of the PyTorch port — the counterparts of the JAX
package's ``train/cli.py`` entry points (``python train.py --config
default.ini`` and ``python train_iterable.py --config x.ini``):

    python -m rawaudiovae_kelsey_tpu_torch train --config x.ini [--resume]
        [--device cuda]
    python -m rawaudiovae_kelsey_tpu_torch stream --config x.ini [--resume]
        [--device cuda]

Both train on a CUDA device and refuse to start without one unless
``--device cpu`` asks for the plain PyTorch path on the CPU.
"""

from __future__ import annotations

import argparse
import sys

import torch

from rawaudiovae_kelsey_tpu_torch.config import load_config


def _parse(argv, prog: str):
    """``(cfg, device)`` of a training command's arguments."""
    parser = argparse.ArgumentParser(prog=prog)
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
            f"{prog}: --device cuda but no CUDA device is available (pass "
            "--device cpu to train with the plain PyTorch path on the CPU)")
    try:
        cfg = load_config(args.config)
    except FileNotFoundError:
        print(f"Config File Not Found at {args.config}")
        sys.exit(1)
    if args.resume:
        cfg.training.resume = True
    return cfg, device


def main(argv=None) -> None:
    cfg, device = _parse(argv, "train")
    from rawaudiovae_kelsey_tpu_torch.train.epoch import train

    train(cfg, device=device)


def main_stream(argv=None) -> None:
    cfg, device = _parse(argv, "stream")
    from rawaudiovae_kelsey_tpu_torch.train.stream import train

    train(cfg, device=device)


if __name__ == "__main__":
    main()

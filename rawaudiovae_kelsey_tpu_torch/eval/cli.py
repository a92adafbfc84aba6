"""Evaluation command: reconstruction quality of a trained run — the JAX
package's ``eval/cli.py``, ported.

Computes the quality metric of BASELINE.json — reconstruction MSE against
the held-out test set (what the reference only ever assessed by ear via
``test_reconst_*.wav``) — and optionally writes the reconstruction wav.

    python -m rawaudiovae_kelsey_tpu_torch eval --run <workdir> \\
        [--config <ini>] [--params best|last|<path.npz>] [--deterministic] \\
        [--seed 0] [--write-wav] [--device cuda]

Prints one JSON line: {"recon_mse": ..., "frames": ..., "params": ...}.
The run directory may come from either package: both write the same
``config.ini`` and params-only npz.  It runs on a CUDA device and refuses to
start without one unless ``--device cpu`` is given.  With
``--deterministic`` (z = mu) both packages give the same number; without
it the latent is sampled from a ``torch.Generator`` seeded by ``--seed``,
which is not the JAX package's threefry stream.  The comparison plot
(``--plot``) and the reference's torch checkpoints as ``--params`` are not
ported.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np
import torch

from rawaudiovae_kelsey_tpu_torch.config import load_config
from rawaudiovae_kelsey_tpu_torch.data.datasets import TestFrameDataset
from rawaudiovae_kelsey_tpu_torch.eval.fixtures import (
    concat_test_audio,
    reconstruction_mse,
)
from rawaudiovae_kelsey_tpu_torch.infer.synthesis import flat_concat
from rawaudiovae_kelsey_tpu_torch.io import load, write_wav
from rawaudiovae_kelsey_tpu_torch.models import build_model, vae
from rawaudiovae_kelsey_tpu_torch.train import load_params


def reconstruct(model, params, frames: np.ndarray, deterministic: bool,
                seed: int = 0, batch_size: int = 256) -> np.ndarray:
    """``(N, segment)`` frames → their reconstructions, in batches on the
    model's device; z = mu when ``deterministic``."""
    if len(frames) == 0:
        raise ValueError("no frames to process — the test audio is empty")
    device = model.device
    generator = None
    if not deterministic:
        generator = torch.Generator(device=device).manual_seed(seed)
    outs = []
    with torch.inference_mode():
        for i in range(0, len(frames), batch_size):
            x = torch.from_numpy(
                np.ascontiguousarray(frames[i:i + batch_size], np.float32)
            ).to(device)
            mu, logvar = model.encode(params, x)
            z = vae.reparameterize(mu, logvar, generator, deterministic)
            outs.append(model.decode(params, z).float().cpu().numpy())
    return np.concatenate(outs, axis=0)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="eval")
    ap.add_argument("--run", type=Path, required=True)
    ap.add_argument("--config", type=Path, default=None)
    ap.add_argument("--params", type=str, default="best",
                    help="best | last | explicit path (.npz)")
    ap.add_argument("--deterministic", action="store_true",
                    help="z = mu (default samples, like the reference eval)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--write-wav", action="store_true")
    ap.add_argument("--device", type=str, default="cuda",
                    help="torch device to evaluate on (default: cuda)")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(
            "eval: --device cuda but no CUDA device is available (pass "
            "--device cpu to evaluate with the plain PyTorch path on the "
            "CPU)")

    cfg = load_config(args.config or args.run / "config.ini")
    model = build_model(cfg, device)
    template = model.init(torch.Generator().manual_seed(0))

    if args.params in ("best", "last"):
        path = args.run / "model" / f"{args.params}_model.npz"
        if args.params == "best" and not path.exists():
            # best_model only appears after save_best_model_after
            path = args.run / "model" / "last_model.npz"
            print(f"best_model.npz not found; evaluating {path.name}")
    elif str(args.params).endswith(".npz"):
        path = Path(args.params)
    else:
        raise NotImplementedError(
            f"--params {args.params}: the reference's torch checkpoints are "
            "not read by the PyTorch package yet (ROADMAP.md queue A); pass "
            "best, last or an .npz path")
    params = load_params(path, template)

    # ground truth: the fixture's concatenated test audio
    orig_path = args.run / "audio_logs" / "test_original.wav"
    if orig_path.exists():
        original, sr = load(orig_path, sr=None)
    else:
        test_dir = cfg.dataset.datapath_path / cfg.dataset.test_dataset
        original = concat_test_audio(test_dir, cfg.audio.sampling_rate,
                                     mono=cfg.dataset.mono)
        sr = cfg.audio.sampling_rate

    ds = TestFrameDataset(original, cfg.audio.segment_length, sr)
    recon = flat_concat(reconstruct(model, params, ds.frames,
                                    args.deterministic, args.seed))
    padded = ds.audio  # zero-padded ground truth, frame-aligned
    mse = reconstruction_mse(padded, recon)

    if args.write_wav:
        write_wav(args.run / "audio_logs" / "eval_reconstruction.wav",
                  recon, sr)

    print(json.dumps({
        "recon_mse": mse,
        "frames": len(ds),
        "sampling": "deterministic" if args.deterministic else "stochastic",
        "params": str(path),
    }))


if __name__ == "__main__":
    main()

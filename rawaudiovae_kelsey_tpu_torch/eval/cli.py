"""Evaluation command: reconstruction quality of a trained run — the JAX
package's ``eval/cli.py``, ported.

Computes the quality metric of BASELINE.json — reconstruction MSE against
the held-out test set (what the reference only ever assessed by ear via
``test_reconst_*.wav``) — and optionally writes the reconstruction wav and
the comparison plot.

    python -m rawaudiovae_kelsey_tpu_torch eval --run <workdir> \\
        [--config <ini>] [--params best|last|<path.npz>|<torch ckpt>] \\
        [--deterministic] [--seed 0] [--write-wav] [--plot] [--device cuda]

Prints one JSON line: {"recon_mse": ..., "frames": ..., "params": ...}.
The run directory may come from either package: both write the same
``config.ini`` and params-only npz.  It runs on a CUDA device and refuses to
start without one unless ``--device cpu`` is given.  With
``--deterministic`` (z = mu) both packages give the same number; without
it the latent is sampled from a ``torch.Generator`` seeded by ``--seed``
(``infer/api.py`` ``reconstruct``), which is not the JAX package's threefry
stream.  ``--params`` takes a reference PyTorch checkpoint (a
``ckpt_NNNNN`` dict, a bare state_dict or a whole-module ``best_model.pt``)
for any path that is not an npz; ``--plot`` writes
``audio_logs/eval_comparison.png`` (needs matplotlib).
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

from rawaudiovae_kelsey_tpu_torch.data.datasets import TestFrameDataset
from rawaudiovae_kelsey_tpu_torch.eval.fixtures import (
    concat_test_audio,
    reconstruction_mse,
)
from rawaudiovae_kelsey_tpu_torch.infer.api import reconstruct
from rawaudiovae_kelsey_tpu_torch.infer.runs import (
    load_run,
    params_path,
    resolve_device,
)
from rawaudiovae_kelsey_tpu_torch.infer.synthesis import flat_concat
from rawaudiovae_kelsey_tpu_torch.io import load, write_wav


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="eval")
    ap.add_argument("--run", type=Path, required=True)
    ap.add_argument("--config", type=Path, default=None)
    ap.add_argument("--params", type=str, default="best",
                    help="best | last | explicit path (.npz or torch ckpt)")
    ap.add_argument("--deterministic", action="store_true",
                    help="z = mu (default samples, like the reference eval)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--write-wav", action="store_true")
    ap.add_argument("--plot", action="store_true")
    ap.add_argument("--device", type=str, default="cuda",
                    help="torch device to evaluate on (default: cuda)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device, "eval")

    path = params_path(args.run, args.params)
    cfg, model, params = load_run(args.run, args.config, device, path)

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
    recon = flat_concat(reconstruct(model, params, ds.frames, seed=args.seed,
                                    deterministic=args.deterministic))
    padded = ds.audio  # zero-padded ground truth, frame-aligned
    mse = reconstruction_mse(padded, recon)

    if args.write_wav:
        write_wav(args.run / "audio_logs" / "eval_reconstruction.wav",
                  recon, sr)
    if args.plot:
        from rawaudiovae_kelsey_tpu_torch.observe.viz import save_comparison

        save_comparison(padded, recon, sr,
                        args.run / "audio_logs" / "eval_comparison.png")

    print(json.dumps({
        "recon_mse": mse,
        "frames": len(ds),
        "sampling": "deterministic" if args.deterministic else "stochastic",
        "params": str(path),
    }))


if __name__ == "__main__":
    main()

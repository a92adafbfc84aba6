#!/usr/bin/env python
"""Tutorial on the PyTorch port — the script form of the reference's
tutorial.ipynb, the counterpart of ``examples/tutorial.py``.

Walks the full creative pipeline against a trained run, on a CUDA device
(``--device cpu`` runs the plain PyTorch path on the CPU):

  1. load a checkpoint (best_model.npz, or a reference torch ckpt)
  2. pick two audio sources (random-concat from a folder)
  3. match their lengths, encode both to latent trajectories
  4. stepwise interpolation (α grid), time-varying sine-α interpolation
  5. decode + resynthesize (flat concat, OLA, and the stretch effect)
  6. write wavs + a comparison plot (skipped without matplotlib)

Usage:
    python examples/tutorial_torch.py --run <workdir> --audio <wav-folder> \
        [--config <ini>] [--out out/] [--torch-ckpt <ckpt>] [--device cuda]
    python -m rawaudiovae_kelsey_tpu_torch tutorial --run <workdir> ...
"""

from __future__ import annotations

import argparse
import os
import sys
from pathlib import Path

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from rawaudiovae_kelsey_tpu_torch.infer import (  # noqa: E402
    concat_random_audio,
    decode_trajectory,
    encode_trajectory,
    flat_concat,
    interpolate_stepwise,
    interpolate_timevarying,
    match_audio_size,
    overlap_add,
    sine_alfa,
)
from rawaudiovae_kelsey_tpu_torch.infer.runs import (  # noqa: E402
    load_run,
    resolve_device,
)
from rawaudiovae_kelsey_tpu_torch.io import write_wav  # noqa: E402


def main() -> None:
    ap = argparse.ArgumentParser(prog="tutorial")
    ap.add_argument("--run", type=Path, required=True,
                    help="run workspace containing model/best_model.npz "
                         "(or a reference torch ckpt via --torch-ckpt)")
    ap.add_argument("--audio", type=Path, required=True,
                    help="folder of wav sources")
    ap.add_argument("--config", type=Path, default=None,
                    help="INI (defaults to <run>/config.ini)")
    ap.add_argument("--torch-ckpt", type=Path, default=None)
    ap.add_argument("--out", type=Path, default=Path("tutorial_out"))
    ap.add_argument("--duration", type=float, default=4.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", type=str, default="cuda",
                    help="torch device to run on (default: cuda)")
    args = ap.parse_args()

    device = resolve_device(args.device, "tutorial")
    cfg, model, params = load_run(args.run, args.config, device,
                                  args.torch_ckpt or "best")
    sr = cfg.audio.sampling_rate
    args.out.mkdir(parents=True, exist_ok=True)
    seed = args.seed

    # -- sources (tutorial cells 24-25): random concat to target duration
    src_a = concat_random_audio(args.audio, args.duration, sr, seed=seed)
    src_b = concat_random_audio(args.audio, args.duration, sr, seed=seed + 1)
    src_a, src_b = match_audio_size(src_a, src_b, mode="repeat")
    write_wav(args.out / "source_a.wav", src_a, sr)
    write_wav(args.out / "source_b.wav", src_b, sr)

    # -- encode (cell 14)
    mu_a, lv_a = encode_trajectory(model, params, src_a)
    mu_b, lv_b = encode_trajectory(model, params, src_b)
    print(f"trajectories: {mu_a.shape}")

    # -- stepwise morph (cells 16-17)
    morph = interpolate_stepwise(model, params, mu_a, lv_a, mu_b, lv_b,
                                 seed=seed)
    write_wav(args.out / "morph_stepwise.wav", flat_concat(morph), sr)

    # -- time-varying sine-α morph (cells 36-37)
    tv = interpolate_timevarying(
        model, params, mu_a, lv_a, mu_b, lv_b,
        sine_alfa(20000, cycles=500), seed=seed,
    )
    write_wav(args.out / "morph_timevarying.wav", flat_concat(tv), sr)

    # -- gentle single-cycle variant (cells 53-54)
    tv2 = interpolate_timevarying(
        model, params, mu_a, lv_a, mu_b, lv_b,
        sine_alfa(20000, cycles=1), seed=seed,
    )
    write_wav(args.out / "morph_gentle.wav", flat_concat(tv2), sr)

    # -- reconstruction + OLA (quirk #14 extension)
    mu, _ = encode_trajectory(model, params, src_a, hop=cfg.audio.hop_length)
    frames = decode_trajectory(model, params, mu)
    write_wav(args.out / "stretch_effect.wav", flat_concat(frames), sr)
    write_wav(args.out / "recon_ola.wav",
              overlap_add(frames, cfg.audio.hop_length), sr)

    # -- visual QA (cells 21-22)
    try:
        from rawaudiovae_kelsey_tpu_torch.observe.viz import save_comparison

        recon = flat_concat(decode_trajectory(model, params, mu_a))
        save_comparison(src_a, recon, sr, args.out / "comparison.png")
    except ImportError:
        print("matplotlib unavailable; skipping plots")

    print(f"wrote outputs to {args.out}/")


if __name__ == "__main__":
    main()

"""What the inference commands (``serve``, ``eval``, ``som``, ``tutorial``,
``export``) share: the device they were asked for, and a trained run's model
and weights on it."""

from __future__ import annotations

from pathlib import Path
from typing import Optional, Tuple, Union

import torch

from rawaudiovae_kelsey_tpu_torch.config import Config, load_config
from rawaudiovae_kelsey_tpu_torch.models import build_model
from rawaudiovae_kelsey_tpu_torch.models.registry import ModelDef


def resolve_device(name: str, prog: str) -> torch.device:
    """``torch.device(name)``; exits when CUDA is asked for and there is
    none, rather than carrying on on the CPU."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(
            f"{prog}: --device cuda but no CUDA device is available (pass "
            "--device cpu to run the plain PyTorch path on the CPU)")
    return device


def params_path(run: Optional[Path], which: Union[str, Path] = "best"
                ) -> Path:
    """The weights ``which`` names: ``best`` / ``last`` are the run's
    ``<which>_model.npz`` (``best`` falls back to ``last_model.npz``, which
    exists before the best-model gate opens); anything else is a path, to
    an npz or to a reference PyTorch checkpoint."""
    if which not in ("best", "last"):
        return Path(which)
    path = run / "model" / f"{which}_model.npz"
    if which == "best" and not path.exists():
        path = run / "model" / "last_model.npz"
        print(f"best_model.npz not found; using {path.name}")
    return path


def load_run(run: Optional[Path], config: Optional[Path], device,
             which: Union[str, Path] = "best"
             ) -> Tuple[Config, ModelDef, object]:
    """``(cfg, model, params)`` of a run workspace on ``device``: the INI
    (``config``, else ``<run>/config.ini``), the model it selects, and the
    weights :func:`params_path` names: an npz of either package, or a
    reference PyTorch checkpoint (any other suffix)."""
    from rawaudiovae_kelsey_tpu_torch.compat import load_torch_checkpoint
    from rawaudiovae_kelsey_tpu_torch.train import load_params

    cfg = load_config(config or run / "config.ini")
    model = build_model(cfg, device)
    path = params_path(run, which)
    if path.suffix != ".npz":
        return cfg, model, load_torch_checkpoint(path, model.device)
    template = model.init(torch.Generator().manual_seed(0))
    return cfg, model, load_params(path, template)

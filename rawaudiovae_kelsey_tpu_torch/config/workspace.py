"""Run-workspace manager — the JAX package's ``config/workspace.py``,
ported; under several ranks only rank 0 writes the config snapshot.

Reproduces the reference's workspace layout and auto-incrementing run ids
(``train.py:93-111`` / ``train_iterable.py:94-112``):

    <datapath>/<description>/run-{:03d}/
        config.ini            (snapshot at start, rewritten at end)
        model/checkpoints/    (train.py:142-145)
        logs/                 (train.py:147-149)
        audio_logs/           (tests.py:17-18)
        console_log           (train_iterable.py:117-133, streaming trainer)

The reference retried ``os.makedirs`` on collision, incrementing the run id; we
do the same atomically.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from pathlib import Path

from rawaudiovae_kelsey_tpu_torch.config.schema import Config
from rawaudiovae_kelsey_tpu_torch.config.ini import save_config


@dataclass
class Workspace:
    workdir: Path

    @property
    def model_dir(self) -> Path:
        return self.workdir / "model"

    @property
    def checkpoint_dir(self) -> Path:
        return self.model_dir / "checkpoints"

    @property
    def log_dir(self) -> Path:
        return self.workdir / "logs"

    @property
    def audio_log_dir(self) -> Path:
        return self.workdir / "audio_logs"

    @property
    def config_path(self) -> Path:
        return self.workdir / "config.ini"

    @property
    def console_log_path(self) -> Path:
        return self.workdir / "console_log"

    def snapshot_config(self, cfg: Config) -> None:
        # several ranks: ONE writer — every rank calls this (setup/finish
        # in both trainers) with rank-divergent fields (total_frames), and
        # concurrent rewrites of one file on shared storage would tear or
        # last-writer-win with the wrong values
        from rawaudiovae_kelsey_tpu_torch.parallel.mesh import is_coordinator

        if is_coordinator():
            save_config(cfg, self.config_path)


def create_workspace(cfg: Config, base: Path | None = None) -> Workspace:
    """Create ``<base>/<description>/run-NNN`` with the retry-on-collision loop
    of ``train.py:95-107``; records the absolute path into
    ``cfg.dataset.workspace`` (train.py:109)."""
    base = Path(cfg.dataset.datapath) if base is None else Path(base)
    my_runs = base / cfg.extra.description
    run_id = cfg.dataset.run_number
    while True:
        workdir = my_runs / f"run-{run_id:03d}"
        try:
            os.makedirs(workdir)
            break
        except OSError:
            if workdir.is_dir():
                run_id += 1
                continue
            raise
    cfg.dataset.workspace = str(workdir.resolve())
    ws = Workspace(workdir)
    os.makedirs(ws.checkpoint_dir, exist_ok=True)
    os.makedirs(ws.log_dir, exist_ok=True)
    return ws


def open_workspace(workdir: Path) -> Workspace:
    """Open an existing workspace (for resume — new capability; the reference
    never reloaded its checkpoints, SURVEY.md §5.3)."""
    workdir = Path(workdir)
    if not workdir.is_dir():
        raise FileNotFoundError(workdir)
    return Workspace(workdir)


def iter_runs(my_runs: Path) -> list[Path]:
    """All ``run-*`` dirs under a description dir, numerically sorted
    (lexicographic would put run-1000 before run-999).  The ONE
    enumeration both ``latest_workspace`` and resume discovery build on."""

    def run_id(p: Path) -> int:
        try:
            return int(p.name.split("-", 1)[1])
        except (IndexError, ValueError):
            return -1

    return sorted((p for p in my_runs.glob("run-*") if p.is_dir()),
                  key=run_id)


def latest_workspace(cfg: Config, base: Path | None = None) -> Workspace | None:
    """Find the highest-numbered existing run dir, if any."""
    base = Path(cfg.dataset.datapath) if base is None else Path(base)
    my_runs = base / cfg.extra.description
    if not my_runs.is_dir():
        return None
    runs = iter_runs(my_runs)
    return Workspace(runs[-1]) if runs else None

"""Dataset validation — the JAX package's ``data/validate.py``, ported
(pure NumPy).

The reference carried config keys ``check_audio`` / ``check_dataset``
(default.ini:11-12) but never read them (quirk #9).  Here they do what they
say: before ingest the trainers run

  * ``check_dataset``: a fast header scan of every wav — counts, total
    duration, sample-rate mismatches (files that will be resampled), and
    corrupt/undecodable files (which raise before training starts instead of
    mid-run);
  * ``check_audio``: a full decode pass additionally flagging silent,
    clipped, or non-finite audio.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from pathlib import Path
from typing import List

import numpy as np

from rawaudiovae_kelsey_tpu_torch.io.wavio import (
    WavFormatError,
    read_wav,
    wav_info,
)


@dataclass
class DatasetReport:
    folder: Path
    n_files: int = 0
    total_samples: int = 0
    total_duration_s: float = 0.0
    resample_needed: List[str] = field(default_factory=list)
    corrupt: List[str] = field(default_factory=list)
    silent: List[str] = field(default_factory=list)
    clipped: List[str] = field(default_factory=list)
    nonfinite: List[str] = field(default_factory=list)

    @property
    def ok(self) -> bool:
        return not (self.corrupt or self.nonfinite)

    def summary(self) -> str:
        lines = [
            f"dataset {self.folder}: {self.n_files} files, "
            f"{self.total_duration_s:,.1f}s total",
        ]
        if self.resample_needed:
            lines.append(
                f"  {len(self.resample_needed)} file(s) will be resampled"
            )
        for name, items in (("CORRUPT", self.corrupt),
                            ("non-finite", self.nonfinite),
                            ("silent", self.silent),
                            ("clipped", self.clipped)):
            if items:
                lines.append(f"  {name}: {', '.join(items[:5])}"
                             + (" ..." if len(items) > 5 else ""))
        return "\n".join(lines)


def validate_dataset(folder: Path, sampling_rate: int,
                     deep: bool = False) -> DatasetReport:
    """Header scan (``deep=False``) or full decode audit (``deep=True``)."""
    folder = Path(folder)
    report = DatasetReport(folder=folder)
    for f in sorted(folder.glob("*.wav")):
        report.n_files += 1
        try:
            if deep:
                samples, sr = read_wav(f)
                n = len(samples)
            else:
                # header scan only — KBs of I/O per file, no decode
                n, _ch, sr, _bits = wav_info(f)
        except (WavFormatError, OSError):
            report.corrupt.append(f.name)
            continue
        report.total_samples += n
        report.total_duration_s += n / max(sr, 1)
        if sr != sampling_rate:
            report.resample_needed.append(f.name)
        if deep:
            mono = samples.mean(axis=1)
            if mono.size == 0:
                # a valid wav with an empty data chunk: report as silent
                # (np.abs(...).max() would raise on the empty array)
                report.silent.append(f.name)
            elif not np.isfinite(mono).all():
                report.nonfinite.append(f.name)
            elif float(np.abs(mono).max()) < 1e-5:
                report.silent.append(f.name)
            elif float((np.abs(mono) >= 0.999).mean()) > 0.01:
                report.clipped.append(f.name)
    return report


def check_before_training(folder: Path, sampling_rate: int,
                          check_dataset: bool, check_audio: bool) -> None:
    """Trainer hook: honor the INI flags; raise on corrupt/non-finite files."""
    if not (check_dataset or check_audio):
        return
    report = validate_dataset(folder, sampling_rate, deep=check_audio)
    print(report.summary())
    if not report.ok:
        raise ValueError(
            f"dataset validation failed for {folder}: "
            f"corrupt={report.corrupt} nonfinite={report.nonfinite}"
        )

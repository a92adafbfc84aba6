"""INI ↔ dataclass bridge.

Accepts the reference's config files (``default.ini``, ``default_iterable.ini``,
``kelsey_iterable.ini``) verbatim, including inline ``#`` comments after values
(e.g. ``loss_reduction = mean # either mean ...``, default.ini:29) and keys that
the reference never read.  Unknown sections/keys are preserved and written back
on save, mirroring the reference's behavior of mutating the parsed config in
place and re-writing it into the run workspace (``train.py:136-139,304-305``).
"""

from __future__ import annotations

import configparser
import dataclasses
from pathlib import Path
from typing import Union

from rawaudiovae_kelsey_tpu_torch.config.schema import (
    AudioConfig,
    Config,
    DatasetConfig,
    ExtraConfig,
    NotesConfig,
    TPUConfig,
    TrainingConfig,
    VAEConfig,
)

# INI section name → (Config attribute, dataclass type)
_SECTIONS = {
    "audio": ("audio", AudioConfig),
    "dataset": ("dataset", DatasetConfig),
    "VAE": ("vae", VAEConfig),
    "training": ("training", TrainingConfig),
    "notes": ("notes", NotesConfig),
    "extra": ("extra", ExtraConfig),
    "tpu": ("tpu", TPUConfig),
}

# keys of the port alone (section, key) → default: save_config leaves them
# out at their defaults, so a config the JAX package can read stays one
PORT_ONLY = {("VAE", "conv_strides"): VAEConfig().conv_strides,
             ("VAE", "io_channels"): VAEConfig().io_channels}

_TRUTHY = {"1", "yes", "true", "on"}
_FALSY = {"0", "no", "false", "off", ""}


def _strip_inline_comment(raw: str) -> str:
    """Reference INIs carry inline comments: ``mean # either mean ...``."""
    for marker in (" #", "\t#", " ;", "\t;"):
        idx = raw.find(marker)
        if idx >= 0:
            raw = raw[:idx]
    return raw.strip()


# free-text string fields keep ' #'/' ;' verbatim; only enum-ish strings
# (where the reference itself wrote inline comments, e.g. default.ini:29)
# get comment stripping
_COMMENT_STRIPPED_STR_KEYS = {
    "loss_reduction", "precision", "backend", "rng", "device_resident",
    "resident_shuffle", "checkpoint_format", "feed_dtype", "mono", "arch",
}


def _coerce(raw: str, target_type: type, section: str, key: str):
    if target_type is not str or key in _COMMENT_STRIPPED_STR_KEYS:
        raw = _strip_inline_comment(raw)
    else:
        raw = raw.strip()
    if target_type is bool:
        low = raw.lower()
        if low in _TRUTHY:
            return True
        if low in _FALSY:
            return False
        raise ValueError(f"[{section}] {key}: cannot parse boolean from {raw!r}")
    if target_type is int:
        return int(raw) if raw else 0
    if target_type is float:
        return float(raw) if raw else 0.0
    return raw


def _parser() -> configparser.ConfigParser:
    # allow_no_value mirrors train.py:38; inline comments handled by _coerce
    # (configparser's inline_comment_prefixes would also eat '#' inside values).
    return configparser.ConfigParser(allow_no_value=True, interpolation=None)


def load_config(path: Union[str, Path]) -> Config:
    """Parse an INI file into a :class:`Config`.

    Missing sections/keys fall back to schema defaults, so a reference INI
    (which has no ``[tpu]`` section) loads cleanly and a minimal INI with only
    ``[dataset]`` works too.
    """
    path = Path(path)
    if not path.exists():
        raise FileNotFoundError(f"Config File Not Found at {path}")
    cp = _parser()
    # read_file, not read(): configparser.read() swallows OSError (a
    # permission-denied file or a directory) and would hand back an
    # all-defaults Config that trains the wrong thing without a word
    with open(path) as fh:
        cp.read_file(fh)

    cfg = Config()
    known_lower = {s.lower(): s for s in _SECTIONS}
    for section in cp.sections():
        mapped = _SECTIONS.get(section)
        if mapped is None:
            # a case-variant of a known section ([vae], [Training]) would
            # silently train with defaults — that's a typo, not an
            # extension section
            want = known_lower.get(section.lower())
            if want is not None and want != section:
                raise ValueError(
                    f"{path}: section [{section}] looks like a case "
                    f"variant of [{want}] — section names are "
                    "case-sensitive"
                )
            for key, raw in cp.items(section):
                cfg.unknown[(section, key)] = raw if raw is not None else ""
            continue
        attr, dc_type = mapped
        dc = getattr(cfg, attr)
        fields = {f.name: f.type for f in dataclasses.fields(dc_type)}
        for key, raw in cp.items(section):
            raw = raw if raw is not None else ""
            if key not in fields:
                cfg.unknown[(section, key)] = raw
                continue
            ftype = fields[key]
            if isinstance(ftype, str):  # from __future__ annotations
                ftype = {"int": int, "float": float, "bool": bool, "str": str}.get(
                    ftype, str
                )
            setattr(dc, key, _coerce(raw, ftype, section, key))
    # legacy alias: early snapshots named the npz format "msgpack"
    if cfg.tpu.checkpoint_format == "msgpack":
        cfg.tpu.checkpoint_format = "npz"
    cfg.validate()
    return cfg


def save_config(cfg: Config, path: Union[str, Path]) -> None:
    """Write a :class:`Config` back to INI (the workspace snapshot of
    ``train.py:136-139``), preserving unknown keys; the port-only keys
    (:data:`PORT_ONLY`) only where they differ from their defaults."""
    cp = _parser()
    for section, (attr, _) in _SECTIONS.items():
        cp.add_section(section)
        dc = getattr(cfg, attr)
        for f in dataclasses.fields(dc):
            val = getattr(dc, f.name)
            key = (section, f.name)
            if key in PORT_ONLY and PORT_ONLY[key] == val:
                continue
            if isinstance(val, bool):
                val = "True" if val else "False"
            cp.set(section, f.name, str(val))
    for (section, key), raw in cfg.unknown.items():
        if not cp.has_section(section):
            cp.add_section(section)
        cp.set(section, key, raw)
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    # tmp+rename: the snapshot is rewritten mid-run (start and end), and a
    # crash mid-write must never leave a torn config.ini behind
    tmp = path.with_name(path.name + ".tmp")
    with open(tmp, "w") as fh:
        cp.write(fh)
    tmp.rename(path)

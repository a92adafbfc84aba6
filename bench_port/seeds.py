"""The seed rules of a run, copied from the program and frozen here, and
the benchmark's own streams.

A run draws its epoch permutations and its per-step noise from device
generators seeded by these hashes of the run's seed (the program's
``parallel/resident.py`` ``perm_seed`` and ``parallel/step.py``
``noise_seed``); the reference draws the same numbers again by the same
rules.  The weights and the corpus come from streams of their own,
disjoint from the run's by a tag.
"""

from __future__ import annotations

_MASK = (1 << 64) - 1

WEIGHTS_TAG = 0x57E1
CORPUS_TAG = 0xC0A5


def mix64(z: int) -> int:
    """splitmix64's finalizer: a bijection of 64-bit integers."""
    z = (z + 0x9E3779B97F4A7C15) & _MASK
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK
    return z ^ (z >> 31)


def noise_seed(seed: int, step: int) -> int:
    """The generator seed of step ``step``'s noise (no microbatches)."""
    return mix64(mix64(seed & _MASK) ^ (step & _MASK)) >> 1


def perm_seed(seed: int, epoch: int) -> int:
    """The generator seed of epoch ``epoch``'s permutation of the frames."""
    return mix64(mix64(mix64(seed & _MASK) ^ 0x5EED) ^ (epoch & _MASK)) >> 1


def stream_seed(seed: int, tag: int) -> int:
    """The generator seed of the benchmark's stream ``tag``."""
    return mix64(mix64(seed & _MASK) ^ tag) >> 1

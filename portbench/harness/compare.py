"""The numbers that decide ``correct``: gaps between what the program's
timed path produced and what the plain reference computes from the same
inputs and weights."""

from __future__ import annotations

import statistics
from typing import Dict, Iterable, Optional, Sequence

import numpy as np

# a leaf whose reference gradient is under this share of the median leaf's
# is nought up to rounding (a key projection's bias under softmax): Adam
# moves it by its rounding alone, so its change is not compared
UNMOVED = 1e-3


def relative_gap(program: Sequence[float], reference: Sequence[float]) -> float:
    """The largest |program - reference| / |reference| over pairs."""
    p, r = np.asarray(program, float), np.asarray(reference, float)
    if p.shape != r.shape:
        return float("inf")
    return float(np.max(np.abs(p - r) / np.abs(r)))


def leaf_gap(program: Dict[str, float], reference: Dict[str, float],
             leaves: Optional[Iterable[str]] = None) -> float:
    """The worst leaf's | |program| - |reference| | over the larger of
    that leaf's reference norm and the median leaf's: norms of the same
    leaf compared, not the norm of their difference."""
    names = list(reference if leaves is None else leaves)
    if set(names) - set(program):
        return float("inf")
    median = statistics.median(reference[k] for k in names)
    return max(abs(program[k] - reference[k]) / max(reference[k], median) for k in names)


def moved(raw_grad: Dict[str, float]) -> list:
    """The leaves whose reference gradient is not nought to rounding."""
    median = statistics.median(raw_grad.values())
    return [k for k, v in raw_grad.items() if v >= UNMOVED * median]


def row_gap(program: np.ndarray, reference: np.ndarray) -> float:
    """The largest relative L2 distance of a row of ``program`` from the
    same row of ``reference``."""
    if program.shape != reference.shape:
        return float("inf")
    num = np.linalg.norm(program - reference, axis=-1)
    return float(np.max(num / np.linalg.norm(reference, axis=-1)))

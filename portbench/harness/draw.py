"""Draws from ``--seed``: derived seeds and the weights.

Every stream (weights, cohort sizes, cohort values, epoch order, cores) has
a seed of its own derived from ``--seed`` and a tag, so one stream's length
never shifts another's draws.  ``--seed`` may be any whole number, also
beyond 32 bits or negative.
"""

from __future__ import annotations

import hashlib
import math
from typing import Dict, List, Tuple

import torch

# (name, shape, kind, a, b): "uniform" over [a, b), "normal" with mean a and
# standard deviation b
WeightSpec = List[Tuple[str, Tuple[int, ...], str, float, float]]


def derive(seed: int, tag: str) -> int:
    """A 63-bit seed for the stream ``tag`` of ``seed``."""
    digest = hashlib.sha256(f"{int(seed)}:{tag}".encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 1


def generator(seed: int, tag: str, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(derive(seed, tag))


def weights(spec: WeightSpec, seed: int, device) -> Dict[str, torch.Tensor]:
    """The tensors of ``spec`` on ``device``, float32, from one uniform draw
    of all their elements at once: a uniform leaf is an affine map of its
    share, a normal one its inverse CDF (``erfinv``)."""
    total = sum(math.prod(shape) for _, shape, *_ in spec)
    u = torch.rand(total, generator=generator(seed, "weights", device), device=device)
    out: Dict[str, torch.Tensor] = {}
    at = 0
    for name, shape, kind, a, b in spec:
        n = math.prod(shape)
        x = u[at:at + n]
        at += n
        if kind == "uniform":
            leaf = a + (b - a) * x
        elif kind == "normal":
            # keep the draw inside (0, 1) so erfinv stays finite
            z = torch.erfinv((2.0 * x - 1.0).clamp(-1.0 + 1e-7, 1.0 - 1e-7)) * math.sqrt(2.0)
            leaf = a + b * z
        else:
            raise ValueError(f"weight {name}: unknown kind {kind!r}")
        out[name] = leaf.reshape(shape)
    return out


"""Deterministic seeding (counterpart of
``multimodal_fusion_tpu.utils.seeding``).

The reference seeds python, numpy and torch (``downstream_survival/
main.py:244-255``).  The port's random draws on the device come from
explicit ``torch.Generator``s; the host-side components (splitters,
samplers, fixtures) read python's and numpy's global streams.
"""

from __future__ import annotations

import random

import numpy as np
import torch


def seed_everything(seed: int) -> None:
    """Seed python's, numpy's and torch's global RNGs with ``seed``."""
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)

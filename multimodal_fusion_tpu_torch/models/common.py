"""Shared model building blocks (counterpart of
``multimodal_fusion_tpu.models.common``)."""

from __future__ import annotations

import torch
from torch import nn


def torch_linear(in_dim: int, out_dim: int, generator: torch.Generator) -> nn.Linear:
    """``nn.Linear`` with torch's default fan-in init (weight and bias
    uniform in +-1/sqrt(in_dim)), drawn from ``generator`` on its device.

    The JAX package draws the same distribution from numpy streams seeded
    by nnx keys, which cannot be reproduced here: parity with it comes from
    converting weights (``models.vit.vit_params_from_jax``)."""
    layer = nn.utils.skip_init(nn.Linear, in_dim, out_dim, device=generator.device)
    bound = 1.0 / (in_dim ** 0.5)
    with torch.no_grad():
        layer.weight.uniform_(-bound, bound, generator=generator)
        layer.bias.uniform_(-bound, bound, generator=generator)
    return layer

"""Shared model building blocks (counterpart of
``multimodal_fusion_tpu.models.common``)."""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from multimodal_fusion_tpu_torch.ops.layer_norm import layer_norm


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


def torch_linear_no_bias(in_dim: int, out_dim: int, generator: torch.Generator) -> nn.Linear:
    """``nn.Linear(in_dim, out_dim, bias=False)`` with torch's default
    fan-in bound 1/sqrt(in_dim), drawn from ``generator``."""
    layer = nn.utils.skip_init(nn.Linear, in_dim, out_dim, bias=False, device=generator.device)
    bound = 1.0 / (in_dim ** 0.5)
    with torch.no_grad():
        layer.weight.uniform_(-bound, bound, generator=generator)
    return layer


def dropout(x: torch.Tensor, rate: float, generator: Optional[torch.Generator],
            train: bool) -> torch.Tensor:
    """Inverted dropout with a Bernoulli mask drawn from ``generator``;
    identity when not training, at rate 0 or without a generator (the
    JAX package's ``dropout`` draws from a key instead)."""
    if not train or rate <= 0.0 or generator is None:
        return x
    keep = 1.0 - rate
    mask = torch.rand(x.shape, generator=generator, device=generator.device) < keep
    return torch.where(mask.to(x.device), x / keep, 0.0)


class LayerNorm(nn.Module):
    """flax ``nnx.LayerNorm``: epsilon 1e-6 and the one-pass variance
    E[x^2] - E[x]^2 clipped at 0 (``nn.LayerNorm`` takes 1e-5 and two
    passes), scale folded into rsqrt(var + eps) as flax does.  The norm is
    ``ops.layer_norm.layer_norm``: kernel K5 on CUDA tensors, unless
    ``impl`` is set to ``"plain"`` (the composite ops, for tracing)."""

    def __init__(self, dim: int, eps: float = 1e-6, device=None):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim, device=device))
        self.bias = nn.Parameter(torch.zeros(dim, device=device))
        self.impl = "auto"

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return layer_norm(x, self.weight, self.bias, self.eps, impl=self.impl)

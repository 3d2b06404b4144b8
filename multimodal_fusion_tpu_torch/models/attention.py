"""CLAM attention scorers (counterpart of
``multimodal_fusion_tpu.models.attention``).

- AttnNet:      score = W2( tanh(W1 x) )
- AttnNetGated: score = W_c( tanh(W_a x) * sigmoid(W_b x) )

(reference ``downstream_survival/models/clam_mlp.py:8-49``).  Scores are
computed per instance over the padded bag axis; the masked softmax over
the bag happens in the caller.  Parameters carry the reference's
``state_dict`` names (``attention_a.0``, ``attention_b.0``,
``attention_c``; ``module.0`` and ``module.3``), so
``multimodal_fusion_tpu.utils.torch_import`` loads them unchanged.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from multimodal_fusion_tpu_torch.models.common import dropout, torch_linear


class AttnNet(nn.Module):
    """Plain attention scorer: Linear -> tanh -> [dropout] -> Linear.

    The second Linear is ``module.3``, the reference's index when its
    Dropout is present (index 2 without it); the JAX importer pairs a
    Sequential's Linears by position, so either loads there."""

    def __init__(self, L: int, D: int, n_classes: int, dropout_rate: float,
                 generator: torch.Generator):
        super().__init__()
        self.module = nn.ModuleDict({"0": torch_linear(L, D, generator),
                                     "3": torch_linear(D, n_classes, generator)})
        self.dropout_rate = dropout_rate

    def forward(self, x: torch.Tensor, *, generator: Optional[torch.Generator] = None,
                train: bool = False) -> torch.Tensor:
        a = torch.tanh(self.module["0"](x))
        a = dropout(a, self.dropout_rate, generator, train)
        return self.module["3"](a)


class AttnNetGated(nn.Module):
    """Gated attention scorer: (tanh branch * sigmoid branch) -> Linear."""

    def __init__(self, L: int, D: int, n_classes: int, dropout_rate: float,
                 generator: torch.Generator):
        super().__init__()
        self.attention_a = nn.Sequential(torch_linear(L, D, generator))
        self.attention_b = nn.Sequential(torch_linear(L, D, generator))
        self.attention_c = torch_linear(D, n_classes, generator)
        self.dropout_rate = dropout_rate

    def forward(self, x: torch.Tensor, *, generator: Optional[torch.Generator] = None,
                train: bool = False) -> torch.Tensor:
        a = dropout(torch.tanh(self.attention_a[0](x)), self.dropout_rate, generator, train)
        b = dropout(torch.sigmoid(self.attention_b[0](x)), self.dropout_rate, generator, train)
        return self.attention_c(a * b)

"""Cross-modal alignment model (counterpart of the model half of
``multimodal_fusion_tpu.models.alignment``).

Reference: ``alignment/alignment_model.py:16-126``: per modality a stack of
``num_layers`` Linear(feature_dim, feature_dim) with no nonlinearity, and an
MLP match predictor (Linear -> ReLU -> Dropout -> Linear -> Sigmoid) over
the concatenation of all modalities for the match / mismatch BCE.
Parameters carry the reference ``state_dict`` names:
``alignment_layers.<name>.<i>`` and ``mlp_predictor.mlp.{0,3}``.  The
alignment dataset, trainer and CLI come with alignment pretraining (ROADMAP
Queue 1 item 14).
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from multimodal_fusion_tpu_torch.models.common import dropout, torch_linear
from multimodal_fusion_tpu_torch.models.svd_gate import AlignmentStack


class MLPMatchPredictor(nn.Module):
    def __init__(self, input_dim: int, hidden_dim: int, generator: torch.Generator,
                 dropout_rate: float = 0.1):
        super().__init__()
        # dropout 0.1, the reference's (alignment_model.py:110)
        self.mlp = nn.ModuleDict({"0": torch_linear(input_dim, hidden_dim, generator),
                                  "3": torch_linear(hidden_dim, 1, generator)})
        self.rate = dropout_rate

    def forward(self, x: torch.Tensor, *, generator: Optional[torch.Generator] = None,
                train: bool = False) -> torch.Tensor:
        h = dropout(F.relu(self.mlp["0"](x)), self.rate, generator, train)
        return torch.sigmoid(self.mlp["3"](h))


class MultiModalAlignmentModel(nn.Module):
    def __init__(self, modality_names: Sequence[str], feature_dim: int = 1024,
                 num_layers: int = 1, *, generator: torch.Generator, predictor_hidden: int = 512):
        super().__init__()
        self.modality_names = list(modality_names)
        self.feature_dim = feature_dim
        self.num_layers = num_layers  # reference default 1 (alignment_model.py:24)
        self.alignment_layers = nn.ModuleDict({
            name: AlignmentStack(feature_dim, num_layers, generator) for name in self.modality_names
        })
        self.mlp_predictor = MLPMatchPredictor(feature_dim * len(self.modality_names),
                                               predictor_hidden, generator)

    def forward(self, features: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """Each known modality through its stack; other names pass through."""
        return {name: self.alignment_layers[name](x) if name in self.alignment_layers else x
                for name, x in features.items()}

    def predict_match(self, fused: torch.Tensor, *, generator: Optional[torch.Generator] = None,
                      train: bool = False) -> torch.Tensor:
        return self.mlp_predictor(fused, generator=generator, train=train)

"""Cross-modal alignment model (counterpart of the model half of
``multimodal_fusion_tpu.models.alignment``).

Reference: ``alignment/alignment_model.py:16-126``: per modality a stack of
``num_layers`` Linear(feature_dim, feature_dim) with no nonlinearity, and an
MLP match predictor (Linear -> ReLU -> Dropout -> Linear -> Sigmoid) over
the concatenation of all modalities for the match / mismatch BCE.
Parameters carry the reference ``state_dict`` names:
``alignment_layers.<name>.<i>`` and ``mlp_predictor.mlp.{0,3}``; a
checkpoint written by ``train.checkpoint.save_model`` holds them under
``params/``, which :func:`infer_alignment_arch` and
:func:`infer_alignment_markers` read.  The trainer is
``train.alignment``.
"""

from __future__ import annotations

import re
from typing import Dict, Optional, Sequence

import numpy as np
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


_LAYER_KEY = re.compile(r"params/alignment_layers\.([^.]+)\.(\d+)\.weight$")


def _layer_keys(checkpoint_path, data):
    if data is None:
        with np.load(checkpoint_path, allow_pickle=False) as opened:
            return _layer_keys(checkpoint_path, opened)
    found = [(m, data[k].shape) for k in data.files if (m := _LAYER_KEY.match(k))]
    if not found:
        raise ValueError(f"{checkpoint_path} does not look like an alignment model checkpoint "
                         "(no params/alignment_layers.<marker>.<i>.weight keys)")
    return found


def infer_alignment_arch(checkpoint_path, data=None) -> tuple:
    """(num_layers, feature_dim) of a saved MultiModalAlignmentModel, read
    from its ``params/alignment_layers.<marker>.<i>.weight`` keys.  Pass an
    already-open ``data`` NpzFile to avoid re-reading the file."""
    found = _layer_keys(checkpoint_path, data)
    return max(int(m.group(2)) for m, _ in found) + 1, int(found[0][1][0])


def infer_alignment_markers(checkpoint_path, data=None) -> list:
    """Sorted marker names of a saved MultiModalAlignmentModel."""
    return sorted({m.group(1) for m, _ in _layer_keys(checkpoint_path, data)})

"""FBP (counterpart of ``multimodal_fusion_tpu.models.fbp``): pairwise
bilinear modality interactions and a two-level linear MoE.

Reference: ``downstream_survival/models/fbp.py:8-124``.  The bilinear form
is torch's ``nn.Bilinear(D, D, D)``, out_o = x1 W_o x2^T + b_o with weight
[D, D, D], written as the einsum ``...i,oij,...j->...o``; then two
bias-free M -> 1 layers mix the pairs and the modalities.  The CLAM
features are detached before the fusion (reference :82,87).  Parameters
carry the reference ``state_dict`` names: ``modality_bilinear_fusion_layer``,
``modality_moe_fusion_layer``, ``moe_fusion_layer``,
``fusion_prediction_layer``.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from multimodal_fusion_tpu_torch.config import ModelConfig
from multimodal_fusion_tpu_torch.models.base import Case, Result
from multimodal_fusion_tpu_torch.models.clam_mlp import ClamMLP
from multimodal_fusion_tpu_torch.models.common import torch_linear, torch_linear_no_bias
from multimodal_fusion_tpu_torch.models.ps3 import modality_tokens


class Bilinear(nn.Module):
    """``nn.Bilinear``: weight [out, in1, in2], bias [out], both uniform in
    +-1/sqrt(in1) as torch initialises them."""

    def __init__(self, in1: int, in2: int, out: int, generator: torch.Generator):
        super().__init__()
        bound = 1.0 / (in1 ** 0.5)
        dev = generator.device
        self.weight = nn.Parameter(torch.empty((out, in1, in2), device=dev).uniform_(
            -bound, bound, generator=generator))
        self.bias = nn.Parameter(torch.empty((out,), device=dev).uniform_(
            -bound, bound, generator=generator))

    def forward(self, x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
        return torch.einsum("...i,oij,...j->...o", x1, self.weight, x2) + self.bias


class FBP(ClamMLP):
    def __init__(self, config: ModelConfig, generator: torch.Generator):
        super().__init__(config, generator)
        self.modality_order = sorted(self.used_modality)
        M, D = len(self.modality_order), self.output_dim
        self.modality_bilinear_fusion_layer = Bilinear(D, D, D, generator)
        self.modality_moe_fusion_layer = torch_linear_no_bias(M, 1, generator)
        self.moe_fusion_layer = torch_linear_no_bias(M, 1, generator)
        self.fusion_prediction_layer = torch_linear(D, self.n_classes, generator)

    def forward(self, case: Case, label: Optional[torch.Tensor] = None, *,
                generator: Optional[torch.Generator] = None, train: bool = False) -> Result:
        h, aux = modality_tokens(self, case, label, generator=generator, train=train)  # [G, M, D]
        # every pair (i, j) by broadcasting: [G, i, j, D]
        pw = self.modality_bilinear_fusion_layer(h[:, :, None, :], h[:, None, :, :])
        pw = self.modality_moe_fusion_layer(pw.transpose(2, 3))[..., 0]  # over j: [G, i, D]
        fused = self.moe_fusion_layer(pw.transpose(1, 2))[..., 0]  # over i: [G, D]
        logits = self.fusion_prediction_layer(fused)
        probs, preds = self.classify(logits)
        aux["Y_prob"] = probs
        aux["Y_hat"] = preds
        return self.make_result(logits, probs, preds, **aux)

"""AUC-CLAM: CLAM with the AUCM margin loss as its window group loss
(counterpart of ``multimodal_fusion_tpu.models.auc_clam``).

Reference: ``downstream_survival/models/auc_clam.py:52-333``: the CLAM
structure, the per-case logit margin (logits[:, 1] - logits[:, 0]) and
libauc's AUCMLoss over the window.  The window's stacked results take the
place of the reference's stateful ``self.group_logits`` list.
"""

from __future__ import annotations

import torch
from torch import nn

from multimodal_fusion_tpu_torch.config import ModelConfig
from multimodal_fusion_tpu_torch.models.base import Result
from multimodal_fusion_tpu_torch.models.clam import CLAM
from multimodal_fusion_tpu_torch.ops.losses import aucm_loss


class AUCCLAM(CLAM):
    # validation adds one AUCM group loss over the whole evaluated set, as
    # the reference's group_logits guard does (trainer.py:906-912); see
    # SurvivalTrainer._eval_summary
    stashes_group_logits = True

    def __init__(self, config: ModelConfig, generator: torch.Generator):
        super().__init__(config, generator)
        # stored but never applied, as in the reference (auc_clam.py:316)
        self.auc_loss_weight = config.get("auc_loss_weight", 1.0)
        self.auc_margin = config.get("auc_margin", 1.0)
        dev = generator.device
        self.auc_a = nn.Parameter(torch.zeros((), device=dev))
        self.auc_b = nn.Parameter(torch.zeros((), device=dev))
        self.auc_alpha = nn.Parameter(torch.zeros((), device=dev))

    def has_group_loss(self) -> bool:
        return True

    def _aucm(self, window_results: Result, a, b, alpha) -> torch.Tensor:
        logits = window_results["logits"]  # [G, C]
        margins = logits[:, 1] - logits[:, 0]
        return aucm_loss(margins, window_results["label"], a, b, alpha, self.auc_margin)

    def group_loss_fn(self, window_results: Result) -> torch.Tensor:
        return self._aucm(window_results, self.auc_a, self.auc_b, self.auc_alpha)

    def frozen_group_loss_fn(self):
        """``group_loss_fn`` bound to detached copies of a, b and alpha as
        they are now: the validation group loss reads the values the model
        was built with, as the JAX trainer's does."""
        a, b, alpha = (p.detach().clone() for p in (self.auc_a, self.auc_b, self.auc_alpha))
        return lambda window_results: self._aucm(window_results, a, b, alpha)

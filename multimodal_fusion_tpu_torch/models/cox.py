"""Cox survival head on the flagship fusion trunk (counterpart of
``multimodal_fusion_tpu.models.cox``).

The whole SVDGateRandomClam trunk (CLAM branches, alignment, TCP gate) plus
a linear log-risk head.  The Cox partial likelihood needs the window's risk
set, so it rides the group-loss slot beside the SVD loss.  It reads
``time`` (follow-up) and ``event`` (1 = event) per case, which the survival
trainer puts into the window results when the dataset CSV has ``time`` and
``event`` columns.
"""

from __future__ import annotations

from typing import Optional

import torch

from multimodal_fusion_tpu_torch.config import ModelConfig
from multimodal_fusion_tpu_torch.models.base import Case, Result
from multimodal_fusion_tpu_torch.models.common import torch_linear
from multimodal_fusion_tpu_torch.models.svd_gate import SVDGateRandomClam
from multimodal_fusion_tpu_torch.ops.losses import cox_ph_loss


class CoxSVDGateClam(SVDGateRandomClam):
    def __init__(self, config: ModelConfig, generator: torch.Generator):
        super().__init__(config, generator)
        self.risk_head = torch_linear(self.output_dim * len(self.used_modality), 1, generator)
        # without the SVD there is no aligned_features_stack: the risk comes
        # from the logits through a head of its own
        self.risk_head_logits = torch_linear(self.n_classes, 1, generator)
        self.cox_weight = config.get("cox_weight", 1.0)

    def forward(self, case: Case, label: Optional[torch.Tensor] = None, *,
                generator: Optional[torch.Generator] = None, train: bool = False,
                drop_prob: Optional[float] = None) -> Result:
        out = super().forward(case, label, generator=generator, train=train, drop_prob=drop_prob)
        if "aligned_features_stack" in out:
            h = out["aligned_features_stack"].flatten(1)  # [G, M * output_dim]
            out["risk"] = self.risk_head(h)[:, 0]  # [G] log-risk
        else:
            out["risk"] = self.risk_head_logits(out["logits"])[:, 0]
        return out

    def group_loss_fn(self, window_results: Result) -> torch.Tensor:
        loss = super().group_loss_fn(window_results)
        if "time" in window_results and "event" in window_results:
            loss = loss + self.cox_weight * cox_ph_loss(
                window_results["risk"], window_results["time"], window_results["event"])
        return loss

    def has_group_loss(self) -> bool:
        return True

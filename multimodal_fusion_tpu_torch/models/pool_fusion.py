"""SVDPool and MDLM fusion variants (counterpart of
``multimodal_fusion_tpu.models.pool_fusion``).

Reference: ``downstream_survival/models/svd_pool.py:8-213`` (SVD alignment,
then mean / max / sum pooling over the modality axis, one Linear head, the
base loss per case and the rank-1 SVD group loss) and ``mdlm.py:9-64`` (a
linear head on each CLAM modality, then a late-fusion Linear that takes the
tabular channels raw).

Parameter names follow the reference ``state_dict``: SVDPool's head is
``fusion_prediction`` (one Linear, replacing the trunk's two) beside
``alignment_layers.<ch>.<i>``; MDLM adds ``prediction_head_dict.<ch>``
(one per modality, the tabular ones unused, as in the reference) and
``late_fusion_layer`` and, like the reference, has no tabular transfer
layers (its forward reads those channels raw; the JAX model builds them and
never uses them).
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from multimodal_fusion_tpu_torch.config import ModelConfig
from multimodal_fusion_tpu_torch.models.base import Case, Result, process_case
from multimodal_fusion_tpu_torch.models.clam_mlp import CLAM_CHANNELS, ClamMLP
from multimodal_fusion_tpu_torch.models.common import torch_linear
from multimodal_fusion_tpu_torch.models.svd_gate import AlignmentStack
from multimodal_fusion_tpu_torch.ops.losses import rank1_svd_loss


class SVDPool(ClamMLP):
    def __init__(self, config: ModelConfig, generator: torch.Generator):
        super().__init__(config, generator)
        self.alignment_channels = sorted(config.get("alignment_channels") or self.used_modality)
        missing = [m for m in self.used_modality if m not in self.alignment_channels]
        if missing:
            # the reference fails the same way (svd_pool.py:59-61 looks up an
            # alignment layer for every modality), but inside the step
            raise ValueError(
                "svd_pool aligns every used modality; alignment_channels "
                f"{self.alignment_channels} is missing {missing} — list all "
                "modalities or omit the option"
            )
        self.tau1 = config.get("tau1", 0.1)
        self.tau2 = config.get("tau2", 0.1)
        self.lambda1 = config.get("lambda1", 1.0)
        self.loss2_chunk_size = config.get("loss2_chunk_size")
        self.return_svd_features = config.get("return_svd_features", False)
        num_layers = config.get("alignment_layer_num", 2)
        self.alignment_layers = nn.ModuleDict({
            ch: AlignmentStack(self.output_dim, num_layers, generator)
            for ch in self.alignment_channels
        })
        self.pooling_strategy = config.get("pooling_strategy", "mean")
        if self.pooling_strategy not in ("mean", "max", "sum"):
            raise ValueError(f"Unsupported pooling strategy: {self.pooling_strategy}")
        self.fusion_prediction = torch_linear(self.output_dim, self.n_classes, generator)

    def align_forward(self, features: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        return {ch: self.alignment_layers[ch](features[ch]) for ch in sorted(features)}

    def forward(self, case: Case, label: Optional[torch.Tensor] = None, *,
                generator: Optional[torch.Generator] = None, train: bool = False) -> Result:
        features, aux = self.compute_branch_features(case, label, generator=generator, train=train)
        if self.return_svd_features:
            return {"features": dict(features), "aligned_features": self.align_forward(features)}
        features = self.align_forward(features)
        stacked = torch.stack([features[ch] for ch in sorted(features)], dim=1)  # [G, M, D]
        aux["aligned_features_stack"] = stacked
        if self.pooling_strategy == "mean":
            h = stacked.mean(dim=1)
        elif self.pooling_strategy == "max":
            h = stacked.amax(dim=1)
        else:
            h = stacked.sum(dim=1)
        logits = self.fusion_prediction(h)
        probs, preds = self.classify(logits)
        aux["Y_prob"] = probs
        aux["Y_hat"] = preds
        return self.make_result(logits, probs, preds, **aux)

    def loss_fn(self, logits, labels, result):
        # the base loss alone per case (reference svd_pool.py:178-182)
        return self.base_loss(logits, labels)

    def has_group_loss(self) -> bool:
        return True

    def group_loss_fn(self, window_results: Result) -> torch.Tensor:
        """Rank-1 SVD loss over the window's [G, D, M] aligned features."""
        feats = window_results["aligned_features_stack"].transpose(1, 2)
        loss, _ = rank1_svd_loss(feats, self.tau1, self.tau2, self.lambda1, self.loss2_chunk_size)
        return loss


class MDLM(ClamMLP):
    def __init__(self, config: ModelConfig, generator: torch.Generator):
        super().__init__(config, generator)
        self.modality_order = sorted(self.used_modality)
        for ch in list(self.transfer_layer):
            if ch not in CLAM_CHANNELS:
                del self.transfer_layer[ch]
        # a head per modality, as the reference builds them; a tabular
        # channel's head is never used
        self.prediction_head_dict = nn.ModuleDict({
            ch: torch_linear(self.output_dim, self.n_classes, generator)
            for ch in self.modality_order
        })
        # the late fusion, sized up front: a CLAM modality gives n_classes
        # values, a tabular channel its raw width (the reference sizes it at
        # the first forward, mdlm.py:52-56)
        fused_dim = sum(self.n_classes if ch in CLAM_CHANNELS else config.channel_input_dims[ch]
                        for ch in self.modality_order)
        self.late_fusion_layer = torch_linear(fused_dim, self.n_classes, generator)

    def forward(self, case: Case, label: Optional[torch.Tensor] = None, *,
                generator: Optional[torch.Generator] = None, train: bool = False) -> Result:
        inputs, in_masks = process_case(case, self.channels_used_in_model)
        aux: Result = {}
        tokens = []
        for ch in self.modality_order:
            if ch in CLAM_CHANNELS:
                res = self.segment(self.clam_forward, ch, inputs[ch], in_masks.get(ch), label,
                                   generator=generator, train=train)
                for rk, rv in res.items():
                    aux[f"{ch}_{rk}"] = rv
                tokens.append(self.prediction_head_dict[ch](res["features"]))
            else:
                tokens.append(inputs[ch].squeeze(-2))  # raw tabular (reference mdlm.py:49)
        logits = self.late_fusion_layer(torch.cat(tokens, dim=1))
        probs, preds = self.classify(logits)
        aux["Y_prob"] = probs
        aux["Y_hat"] = preds
        return self.make_result(logits, probs, preds, **aux)

"""ClamMLP, the multimodal fusion trunk (counterpart of
``multimodal_fusion_tpu.models.clam_mlp``).

A CLAM branch over ``wsi=features`` and one over the concatenated
``tma=features`` bags, static per-channel transfer layers for the tabular
channels, and a concat fusion MLP (reference
``downstream_survival/models/clam_mlp.py:51-403``).  As in the JAX package,
the transfer layers are sized statically from ``config.channel_input_dims``
and both bag branches are built whatever the channels.

The parameters carry the reference's ``state_dict`` names:
``attention_net.<ch>``, ``transfer_layer.<ch>`` (bag and tabular
channels), ``classifiers.<ch>``, ``instance_classifiers.<ch>.0`` and
``fusion_prediction.{0,1}``.  A branch's four modules therefore live in
those dicts; :class:`ClamBranch` gathers them back into one view.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch
from torch import nn

from multimodal_fusion_tpu_torch.config import ModelConfig, model_size_dims
from multimodal_fusion_tpu_torch.models.base import (
    BaseModel,
    Case,
    Result,
    derive_used_modalities,
    process_case,
)
from multimodal_fusion_tpu_torch.models.clam import (
    ClamAttentionCore,
    attention_pool,
    clam_instance_loss,
)
from multimodal_fusion_tpu_torch.models.common import torch_linear
from multimodal_fusion_tpu_torch.ops.masked import masked_softmax

CLAM_CHANNELS = ("tma=features", "wsi=features")


class ClamBranch(NamedTuple):
    """One CLAM branch: attention core, transfer layer, bag classifier and
    instance classifier (reference clam_mlp.py:144-167)."""

    core: ClamAttentionCore
    transfer: nn.Linear
    classifier: nn.Linear
    instance_classifiers: nn.ModuleList

    @classmethod
    def build(cls, config: ModelConfig, generator: torch.Generator) -> "ClamBranch":
        core = ClamAttentionCore(config, generator)
        out_dim = config.get("output_dim", 1024)
        transfer = torch_linear(core.size[1], out_dim, generator)
        classifier = torch_linear(out_dim, config.n_classes, generator)
        return cls(core, transfer, classifier,
                   nn.ModuleList([torch_linear(core.size[1], 2, generator)]))


class ClamMLP(BaseModel):
    def __init__(self, config: ModelConfig, generator: torch.Generator):
        super().__init__(config)
        self.size = model_size_dims(config.input_dim, config.model_size)
        self.model_size = config.model_size
        self.output_dim = config.get("output_dim", 1024)
        self.subtyping = config.get("subtyping", False)
        self.inst_number = config.get("inst_number", 8)
        self.gate = config.get("gate", True)
        self.base_weight = config.get("base_weight", 0.7)
        self.attention_only = config.get("attention_only", False)
        self.channels_used_in_model = list(config.channels_used_in_model)
        if config.inst_loss_fn not in (None, "ce"):
            raise ValueError(f"Unsupported instance loss: {config.inst_loss_fn}")
        self.used_modality = derive_used_modalities(self.channels_used_in_model)
        hg = [ch for ch in self.used_modality if ch.startswith("hypergraph=")]
        if hg:
            raise ValueError(
                f"{type(self).__name__} does not consume hypergraph channels {hg}; use "
                "model_type=cust_omics for hypergraph inputs"
            )

        branches = {ch: ClamBranch.build(config, generator) for ch in CLAM_CHANNELS}
        self.attention_net = nn.ModuleDict({ch: b.core for ch, b in branches.items()})
        self.transfer_layer = nn.ModuleDict({ch: b.transfer for ch, b in branches.items()})
        self.classifiers = nn.ModuleDict({ch: b.classifier for ch, b in branches.items()})
        self.instance_classifiers = nn.ModuleDict(
            {ch: b.instance_classifiers for ch, b in branches.items()})
        for ch in self.used_modality:
            if ch in CLAM_CHANNELS:
                continue
            in_dim = config.channel_input_dims.get(ch)
            if in_dim is None:
                raise ValueError(
                    f"channel_input_dims missing entry for tabular channel {ch!r}; "
                    "static shapes are required (no lazy layer creation)"
                )
            self.transfer_layer[ch] = torch_linear(in_dim, self.output_dim, generator)
        self.fusion_prediction = nn.Sequential(
            torch_linear(self.output_dim * len(self.used_modality), self.size[1], generator),
            torch_linear(self.size[1], config.n_classes, generator),
        )

    def clam_branch(self, channel: str) -> ClamBranch:
        return ClamBranch(self.attention_net[channel], self.transfer_layer[channel],
                          self.classifiers[channel], self.instance_classifiers[channel])

    # ------------------------------------------------------------------

    def clam_forward(self, channel: str, x: torch.Tensor, mask: Optional[torch.Tensor],
                     label: torch.Tensor, *, generator: Optional[torch.Generator] = None,
                     train: bool = False) -> Result:
        """One CLAM branch over the window -> features [G, output_dim],
        clam_loss [G], ... (reference clam_mlp.py:257-323)."""
        branch = self.clam_branch(channel)
        scores, h = branch.core(x, generator=generator, train=train)
        A_raw = scores[..., 0]  # [G, N]
        M = branch.transfer(attention_pool(masked_softmax(A_raw, mask), h))  # [G, output_dim]
        logits = branch.classifier(M)
        probs, preds = self.classify(logits)
        out: Result = {"attention_weights": A_raw, "Y_prob": probs, "Y_hat": preds, "features": M}
        if self.base_weight < 1:
            out["total_inst_loss"] = clam_instance_loss(
                A_raw, h, mask, label, branch.instance_classifiers,
                self.inst_number, self.n_classes, self.subtyping,
                subtyping_divisor=len(CLAM_CHANNELS),
            )
        out["clam_loss"] = self.clam_loss(logits, label, out)
        return out

    def clam_loss(self, logits, label, branch_result) -> torch.Tensor:
        base = self.base_loss(logits, label)
        if self.base_weight < 1:
            return base * self.base_weight + branch_result["total_inst_loss"] * (1 - self.base_weight)
        return base

    def compute_branch_features(self, case: Case, label: torch.Tensor, *,
                                generator: Optional[torch.Generator] = None,
                                train: bool = False) -> Tuple[Dict[str, torch.Tensor], Result]:
        """Every used modality to its feature [G, output_dim]."""
        if label is None:
            raise ValueError(f"{type(self).__name__} needs the window's labels "
                             "(its branch losses read them)")
        inputs, in_masks = process_case(case, self.channels_used_in_model)
        features: Dict[str, torch.Tensor] = {}
        aux: Result = {}
        for ch in self.used_modality:
            if ch in CLAM_CHANNELS:
                res = self.segment(self.clam_forward, ch, inputs[ch], in_masks.get(ch), label,
                                   generator=generator, train=train)
                for rk, rv in res.items():
                    aux[f"{ch}_{rk}"] = rv
                features[ch] = res["features"]
            else:  # tabular [G, 1, D_c] -> [G, output_dim]
                features[ch] = self.transfer_layer[ch](inputs[ch]).squeeze(-2)
        return features, aux

    # ------------------------------------------------------------------

    def forward(self, case: Case, label: Optional[torch.Tensor] = None, *,
                generator: Optional[torch.Generator] = None, train: bool = False) -> Result:
        features, aux = self.compute_branch_features(case, label, generator=generator, train=train)
        logits = self.fusion_prediction(torch.cat([features[ch] for ch in self.used_modality], dim=1))
        probs, preds = self.classify(logits)
        aux["Y_prob"] = probs
        aux["Y_hat"] = preds
        return self.make_result(logits, probs, preds, **aux)

    def loss_fn(self, logits, labels, result):
        total = self.base_loss(logits, labels)
        for ch in CLAM_CHANNELS:
            k = f"{ch}_clam_loss"
            if k in result:
                total = total + result[k]
        return total


class ClamMLPDetach(ClamMLP):
    """CLAM branch features detached before fusion
    (reference clam_mlp_detach.py:8-72)."""

    def compute_branch_features(self, case, label, *, generator=None, train=False):
        features, aux = super().compute_branch_features(case, label, generator=generator,
                                                        train=train)
        for ch in CLAM_CHANNELS:
            if ch in features:
                features[ch] = features[ch].detach()
        return features, aux

"""Gate MIL family: confidence-gated per-channel MIL fusion (counterpart of
``multimodal_fusion_tpu.models.gate_mil``).

Reference semantics: ``downstream_survival/models/gate_shared_mil.py:15-204``
(one module set shared by every channel), ``gate_mil.py:6-105`` (a set per
channel), ``gate_mil_detach.py`` (confidence head and fusion on detached
features), ``gate_auc_mil.py:8-208`` (+ the AUCM group loss).

The JAX package's quirks are kept: the reference's "sample attention" is a
softmax over a [N, 1] column, constant 1 per instance, so the MIL pool is
a masked **sum** over instances; GateMIL multiplies the confidence in twice
(``h*conf*conf``, reference gate_mil.py:79-81) where the shared variant
applies ``h*conf`` once; every channel, ``=mask`` channels included, is a
gated slot with its own share of the nC divisor.

Parameters carry the reference's ``state_dict`` names:
``ChannelFeatureWeightor[.<ch>].0``, ``TCPClassifier[.<ch>].{0,3,6}``,
``TCPConfidenceLayer[.<ch>].{0,1,2}`` (no channel level when shared) and
``classifiers.{0,3,6,9}``.  The reference's SampleAtt layers are dead (the
constant softmax) and have no counterpart.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from multimodal_fusion_tpu_torch.config import ModelConfig, model_size_dims
from multimodal_fusion_tpu_torch.models.auc_clam import AUCMGroupLoss
from multimodal_fusion_tpu_torch.models.base import BaseModel, Case, Result
from multimodal_fusion_tpu_torch.models.common import dropout, torch_linear
from multimodal_fusion_tpu_torch.ops.losses import cross_entropy
from multimodal_fusion_tpu_torch.ops.masked import masked_mean


def positive_swish(x: torch.Tensor, c: float = 0.3) -> torch.Tensor:
    return x * torch.sigmoid(x) + c


def _add_indexed(module: nn.Module, dims, generator) -> None:
    """Linear children of ``module`` under the reference Sequential's
    indices: ``dims`` maps an index to (in, out)."""
    for i, (a, b) in dims.items():
        module.add_module(str(i), torch_linear(a, b, generator))


class FeatureWeightor(nn.Sequential):
    """Linear(D, D) -> sigmoid (reference gate_shared_mil.py:50)."""

    def __init__(self, dim: int, generator: torch.Generator):
        super().__init__(torch_linear(dim, dim, generator), nn.Sigmoid())


class GateTCPClassifier(nn.Module):
    """D -> s1 -> ReLU -> Dropout -> s2 -> ReLU -> Dropout -> C (reference
    :52-60): children ``0``, ``3``, ``6``."""

    def __init__(self, dim: int, s1: int, s2: int, n_classes: int, rate: float,
                 generator: torch.Generator):
        super().__init__()
        _add_indexed(self, {0: (dim, s1), 3: (s1, s2), 6: (s2, n_classes)}, generator)
        self.rate = rate

    def forward(self, x, *, generator=None, train=False):
        h = dropout(F.relu(self._modules["0"](x)), self.rate, generator, train)
        h = dropout(F.relu(self._modules["3"](h)), self.rate, generator, train)
        return self._modules["6"](h)


class GateTCPConfidence(nn.Sequential):
    """D -> s1 -> s2 -> 1 -> Dropout -> PositiveSwish, no activation between
    (reference :61)."""

    def __init__(self, dim: int, s1: int, s2: int, rate: float, generator: torch.Generator):
        super().__init__(torch_linear(dim, s1, generator), torch_linear(s1, s2, generator),
                         torch_linear(s2, 1, generator))
        self.rate = rate

    def forward(self, x, *, generator=None, train=False):
        return positive_swish(dropout(super().forward(x), self.rate, generator, train))


class FusionClassifier(nn.Module):
    """nC*D -> D -> s1 -> s2 -> C with ReLU and Dropout between (reference
    :67-79): children ``0``, ``3``, ``6``, ``9``."""

    def __init__(self, in_dim: int, dim: int, s1: int, s2: int, n_classes: int, rate: float,
                 generator: torch.Generator):
        super().__init__()
        _add_indexed(self, {0: (in_dim, dim), 3: (dim, s1), 6: (s1, s2), 9: (s2, n_classes)},
                     generator)
        self.rate = rate

    def forward(self, x, *, generator=None, train=False):
        for i in ("0", "3", "6"):
            x = dropout(F.relu(self._modules[i](x)), self.rate, generator, train)
        return self._modules["9"](x)


class GateSharedMIL(BaseModel):
    """One feature weightor, TCP classifier and confidence head shared by
    every channel (reference gate_shared_mil.py)."""

    shared = True
    detach = False
    double_confidence = False

    def __init__(self, config: ModelConfig, generator: torch.Generator):
        super().__init__(config)
        self.channels_used_in_model = [c for c in config.channels_used_in_model
                                       if c != "wsi=reconstructed"]
        self.confidence_weight = config.get("confidence_weight", 1)
        size = model_size_dims(config.input_dim, config.get("model_size", "small"))
        D = config.input_dim

        def make(kind):
            if kind == "fw":
                return FeatureWeightor(D, generator)
            if kind == "cls":
                return GateTCPClassifier(D, size[1], size[2], self.n_classes, self.dropout_rate,
                                         generator)
            return GateTCPConfidence(D, size[1], size[2], self.dropout_rate, generator)

        for name, kind in (("ChannelFeatureWeightor", "fw"), ("TCPClassifier", "cls"),
                           ("TCPConfidenceLayer", "conf")):
            setattr(self, name, make(kind) if self.shared else nn.ModuleDict(
                {c: make(kind) for c in self.channels_used_in_model}))
        self.classifiers = FusionClassifier(len(self.channels_used_in_model) * D, D, size[1],
                                            size[2], self.n_classes, self.dropout_rate, generator)

    def _modules_for(self, channel: str):
        if self.shared:
            return self.ChannelFeatureWeightor, self.TCPClassifier, self.TCPConfidenceLayer
        return (self.ChannelFeatureWeightor[channel], self.TCPClassifier[channel],
                self.TCPConfidenceLayer[channel])

    def forward(self, case: Case, label: Optional[torch.Tensor] = None, *,
                generator: Optional[torch.Generator] = None, train: bool = False) -> Result:
        if label is None:
            raise ValueError(f"{type(self).__name__} needs the window's labels "
                             "(its confidence losses read them)")
        chans = case["channels"]
        raw_masks = case.get("masks", {})
        rows = torch.arange(label.shape[0], device=label.device)
        fw_loss = logits_loss = conf_loss = 0.0
        slots = []
        for ch in self.channels_used_in_model:
            if ch == "wsi=reconstructed" or ch not in chans:
                continue
            weightor, classifier, confidence_head = self._modules_for(ch)
            x = chans[ch]  # [G, N, D]
            mask = raw_masks.get(ch)
            fw = weightor(x)
            x = fw * x
            # "sample attention" == a masked sum over the instances
            h = (x * mask[..., None].to(x.dtype) if mask is not None else x).sum(dim=1)  # [G, D]
            tcp_logits = classifier(h, generator=generator, train=train)
            confidence = confidence_head(h.detach() if self.detach else h, generator=generator,
                                         train=train)  # [G, 1]
            p_target = torch.softmax(tcp_logits, dim=1)[rows, label]
            logits_loss = logits_loss + cross_entropy(tcp_logits, label, reduction="none")
            conf_loss = conf_loss + (confidence[:, 0] - p_target) ** 2
            fw_loss = fw_loss + masked_mean(fw, mask, dim=1).mean(dim=-1)
            if self.detach:
                slots.append(h.detach() * confidence.detach())
            elif self.double_confidence:
                slots.append((h * confidence) * confidence)
            else:
                slots.append(h * confidence)
        nC = len(self.channels_used_in_model)
        logits = self.classifiers(torch.cat(slots, dim=1), generator=generator, train=train)
        probs, preds = self.classify(logits)
        return self.make_result(logits, probs, preds, feature_weight_loss=fw_loss / nC,
                                confidence_logits_loss=logits_loss / nC,
                                confidence_loss=conf_loss / nC)

    def loss_fn(self, logits, labels, result):
        base = self.base_loss(logits, labels)
        conf_total = (result["confidence_loss"] + result["confidence_logits_loss"]) * self.confidence_weight
        return base + conf_total + result["feature_weight_loss"]


class GateMIL(GateSharedMIL):
    """A module set per channel; the fused slot is h*conf*conf (reference
    gate_mil.py)."""

    shared = False
    double_confidence = True


class GateMILDetach(GateSharedMIL):
    """A module set per channel; the confidence head and the fusion read
    detached features (reference gate_mil_detach.py:80-95)."""

    shared = False
    detach = True


class GateAUCMIL(AUCMGroupLoss, GateMIL):
    """GateMIL + the AUCM margin group loss over the window (reference
    gate_auc_mil.py:28-35,169-180)."""

    def __init__(self, config: ModelConfig, generator: torch.Generator):
        super().__init__(config, generator)
        self._init_aucm(config, generator.device)

"""SVD / CLIP gate-random CLAM family, the flagship fusion models
(counterpart of ``multimodal_fusion_tpu.models.svd_gate``).

Reference semantics:
- SVDGateRandomClam: downstream_survival/models/svd_gate_random_clam.py:8-315
- SVDGateRandomClamDetach: svd_gate_random_clam_detach.py:8-140
- ClipGateRandomClam(+Detach): clip_gate_random_clam(_detach).py
- DeepSuperviseSVDGateRandomClam(+Detach): deep_supervise_svd_gate_random*.py

The reference's quirks are kept, as the JAX package keeps them:
``gated_forward`` overwrites the per-channel TCP losses each iteration and
then adds the value to itself, so the losses are 2x the LAST sorted
channel's; ``loss_fn`` sums every result entry ending in ``_loss`` (which
counts ``total_inst_loss`` twice and ``random_partial_loss`` beside the
hinge).  Every loss is per case [G].

``group_loss_fn`` is the window group loss the trainer adds to the sum of
the case losses: the rank-1 SVD loss over ``aligned_features_stack``
[G, M, output_dim], or the CLIP loss in the Clip variants.  Parameters
carry the reference's ``state_dict`` names (``TCPClassifier.<ch>.{0,3}``,
``TCPConfidenceLayer.<ch>.{0,1,2}``, ``alignment_layers.<ch>.<i>``,
``Classifier.<ch>.{0,3}``, ``clip_logit_scale``);
``models.jax_params.survival_params_from_jax`` carries the JAX models'
parameters across.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from multimodal_fusion_tpu_torch.config import ModelConfig
from multimodal_fusion_tpu_torch.models.base import Case, Result
from multimodal_fusion_tpu_torch.models.clam_mlp import CLAM_CHANNELS, ClamMLP
from multimodal_fusion_tpu_torch.models.common import dropout, torch_linear
from multimodal_fusion_tpu_torch.ops.losses import cross_entropy, rank1_svd_loss


class TCPClassifier(nn.Module):
    """Linear -> ReLU -> Dropout -> Linear, children ``0`` and ``3``
    (reference svd_gate_random_clam.py:44-49)."""

    def __init__(self, in_dim: int, hidden: int, n_classes: int, rate: float,
                 generator: torch.Generator):
        super().__init__()
        self.add_module("0", torch_linear(in_dim, hidden, generator))
        self.add_module("3", torch_linear(hidden, n_classes, generator))
        self.rate = rate

    def forward(self, x, *, generator=None, train=False):
        h = dropout(F.relu(self._modules["0"](x)), self.rate, generator, train)
        return self._modules["3"](h)


class TCPConfidence(nn.Sequential):
    """Linear -> Linear -> Linear -> Dropout, no nonlinearity (reference
    :51-56)."""

    def __init__(self, in_dim: int, h1: int, h2: int, rate: float, generator: torch.Generator):
        super().__init__(torch_linear(in_dim, h1, generator), torch_linear(h1, h2, generator),
                         torch_linear(h2, 1, generator))
        self.rate = rate

    def forward(self, x, *, generator=None, train=False):
        return dropout(super().forward(x), self.rate, generator, train)


class AlignmentStack(nn.Sequential):
    """num_layers stacked Linear(dim, dim), no nonlinearity (reference
    :63-68)."""

    def __init__(self, dim: int, num_layers: int, generator: torch.Generator):
        super().__init__(*[torch_linear(dim, dim, generator) for _ in range(num_layers)])


class SVDGateRandomClam(ClamMLP):
    def __init__(self, config: ModelConfig, generator: torch.Generator):
        super().__init__(config, generator)
        self.enable_dynamic_gate = config.get("enable_dynamic_gate", True)
        self.enable_svd = config.get("enable_svd", True)
        self.enable_random_loss = config.get("enable_random_loss", True)
        self.weight_random_loss = config.get("weight_random_loss", 0.1)
        self.return_svd_features = config.get("return_svd_features", False)
        if self.enable_dynamic_gate:
            self.TCPClassifier = nn.ModuleDict({
                ch: TCPClassifier(self.output_dim, self.size[1], self.n_classes, self.dropout_rate,
                                  generator)
                for ch in self.used_modality
            })
            self.TCPConfidenceLayer = nn.ModuleDict({
                ch: TCPConfidence(self.output_dim, self.size[1], self.size[2], self.dropout_rate,
                                  generator)
                for ch in self.used_modality
            })
        if self.enable_svd:
            self.alignment_channels = sorted(config.get("alignment_channels") or self.used_modality)
            self.tau1 = config.get("tau1", 0.1)
            self.tau2 = config.get("tau2", 0.1)
            self.lambda1 = config.get("lambda1", 1.0)
            self.loss2_chunk_size = config.get("loss2_chunk_size")
            num_layers = config.get("alignment_layer_num", 2)
            self.alignment_layers = nn.ModuleDict({
                ch: AlignmentStack(self.output_dim, num_layers, generator)
                for ch in self.alignment_channels
            })

    # ------------------------------------------------------------------

    def gated_forward(self, features: Dict[str, torch.Tensor], label: torch.Tensor, *,
                      generator=None, train=False
                      ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor, torch.Tensor]:
        """TCP dynamic gate.  The losses replicate the reference bug: each
        channel overwrites them and then doubles them, so they come out 2x
        the last sorted channel's (reference svd_gate_random_clam.py:74-89)."""
        gated: Dict[str, torch.Tensor] = {}
        logits_loss = confidence_loss = None
        rows = torch.arange(label.shape[0], device=label.device)
        for ch in sorted(features):
            feat = features[ch]
            logits = self.TCPClassifier[ch](feat, generator=generator, train=train)
            logits_loss = cross_entropy(logits, label, reduction="none")  # overwrite (ref bug)
            confidence = self.TCPConfidenceLayer[ch](feat, generator=generator, train=train)
            p_target = torch.softmax(logits, dim=1)[rows, label]
            confidence_loss = (confidence[:, 0] - p_target) ** 2
            gated[ch] = feat * confidence
            logits_loss = logits_loss + logits_loss  # double (ref bug)
            confidence_loss = confidence_loss + confidence_loss
        return gated, logits_loss, confidence_loss

    def align_forward(self, features: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        return {ch: self.alignment_layers[ch](features[ch]) for ch in sorted(features)}

    def _random_partial_loss(self, features: Dict[str, torch.Tensor], label: torch.Tensor,
                             generator: Optional[torch.Generator]) -> torch.Tensor:
        """Zero a random 1..M-1 of each case's modalities, fuse the rest,
        CE on the partial fusion (reference :244-255)."""
        keys_sorted = sorted(features)
        M = len(keys_sorted)
        G = label.shape[0]
        dev = generator.device if generator is not None else label.device
        r = torch.randint(1, max(M, 2), (G, 1), generator=generator, device=dev)
        ranks = torch.rand((G, M), generator=generator, device=dev).argsort(dim=1)
        keep = (ranks >= r).to(device=label.device, dtype=features[keys_sorted[0]].dtype)
        h_partial = torch.cat([features[ch] * keep[:, i:i + 1] for i, ch in enumerate(keys_sorted)],
                              dim=1)
        logits = self.fusion_prediction(self._fusion_input(h_partial))
        return self.base_loss(logits, label)

    def _fusion_input(self, h: torch.Tensor) -> torch.Tensor:
        """Hook for the detach variants (identity here)."""
        return h

    def _final_features(self, features: Dict[str, torch.Tensor], *, generator=None,
                        drop_prob: Optional[float] = None) -> torch.Tensor:
        return torch.cat([features[ch] for ch in sorted(features)], dim=1)

    def _deep_supervise(self, features, label, *, generator=None, train=False):
        """Overridden by the deep-supervise subclasses; returns (features,
        aux) so the detach variant can detach after its heads ran."""
        return features, {}

    # ------------------------------------------------------------------

    def forward(self, case: Case, label: Optional[torch.Tensor] = None, *,
                generator: Optional[torch.Generator] = None, train: bool = False,
                drop_prob: Optional[float] = None) -> Result:
        features, aux = self.compute_branch_features(case, label, generator=generator, train=train)
        features, ds_out = self._deep_supervise(features, label, generator=generator, train=train)
        aux.update(ds_out)

        if self.enable_svd:
            if self.return_svd_features:
                return {"features": dict(features), "aligned_features": self.align_forward(features)}
            features = self.align_forward(features)
            # the window-level SVD group loss reads [G, M, output_dim]
            aux["aligned_features_stack"] = torch.stack([features[ch] for ch in sorted(features)],
                                                         dim=1)
        if self.enable_dynamic_gate:
            features, gll, gcl = self.gated_forward(features, label, generator=generator,
                                                    train=train)
            aux["gated_gated_logits_loss"] = gll
            aux["gated_gated_confidence_loss"] = gcl

        if self.enable_random_loss and train:
            aux["random_partial_loss"] = self._random_partial_loss(features, label, generator)

        h = self._final_features(features, generator=generator,
                                 drop_prob=None if train else drop_prob)
        logits = self.fusion_prediction(self._fusion_input(h))
        probs, preds = self.classify(logits)
        aux["Y_prob"] = probs
        aux["Y_hat"] = preds
        return self.make_result(logits, probs, preds, **aux)

    # ------------------------------------------------------------------

    def loss_fn(self, logits, labels, result):
        """base CE + every '*_loss' result entry + the MoFe hinge, per case
        (reference :269-281, quirks kept: see the module docstring)."""
        total = torch.zeros_like(logits[:, 0])
        for k, v in result.items():
            if k.endswith("_loss"):
                total = total + v
        base = self.base_loss(logits, labels)
        if self.enable_random_loss and "random_partial_loss" in result:
            total = total + torch.clamp_min(base - result["random_partial_loss"], 0.0)
        return base + total

    def has_group_loss(self) -> bool:
        return self.enable_svd

    def group_loss_fn(self, window_results: Result) -> torch.Tensor:
        """Rank-1 SVD loss over the window (reference :283-303), "svd" impl:
        the backend's singular-vector signs, as in the reference."""
        if not self.enable_svd:
            return torch.zeros((), device=window_results["label"].device)
        feats = window_results["aligned_features_stack"].transpose(1, 2)  # [G, D, M]
        loss, _ = rank1_svd_loss(feats, self.tau1, self.tau2, self.lambda1, self.loss2_chunk_size)
        return loss


class SVDGateRandomClamDetach(SVDGateRandomClam):
    """Detached CLAM features, a fusion head on detached features, and
    inference-time random modality zeroing via ``drop_prob``
    (reference svd_gate_random_clam_detach.py:8-140)."""

    # only the detach family implements inference-time modality zeroing;
    # the trainer's eval gate refuses drop_prob for every other model
    supports_drop_prob = True

    def compute_branch_features(self, case, label, *, generator=None, train=False):
        features, aux = super().compute_branch_features(case, label, generator=generator,
                                                        train=train)
        for ch in CLAM_CHANNELS:
            if ch in features:
                features[ch] = features[ch].detach()
        return features, aux

    def _fusion_input(self, h):
        return h.detach()

    def _final_features(self, features, *, generator=None, drop_prob=None):
        """Each case zeroes each modality with probability ``drop_prob``,
        drawn from ``generator``; no zeroing without either."""
        if drop_prob is None or generator is None:
            return super()._final_features(features)
        keys_sorted = sorted(features)
        G = features[keys_sorted[0]].shape[0]
        drops = torch.rand((G, len(keys_sorted)), generator=generator,
                           device=generator.device) < drop_prob
        drops = drops.to(features[keys_sorted[0]].device)
        return torch.cat([torch.where(drops[:, i:i + 1], 0.0, features[ch])
                          for i, ch in enumerate(keys_sorted)], dim=1)


class ClipGateRandomClam(SVDGateRandomClam):
    """CLIP group loss instead of SVD: a learnable logit scale, anchored on
    the last sorted modality (reference clip_gate_random_clam.py:7-122)."""

    def __init__(self, config: ModelConfig, generator: torch.Generator):
        super().__init__(config, generator)
        self.enable_clip = config.get("enable_clip", True)
        init_tau = float(config.get("clip_init_tau", 0.07))
        self.clip_logit_scale = nn.Parameter(
            torch.tensor(math.log(1.0 / init_tau), dtype=torch.float32, device=generator.device))
        self.clip_anchor_idx = -1

    def has_group_loss(self) -> bool:
        return self.enable_clip

    def group_loss_fn(self, window_results: Result) -> torch.Tensor:
        """CLIP InfoNCE over the window, anchored on the last sorted modality
        (reference clip_gate_random_clam.py:68-88).  The reference's quirk is
        kept: its anchor-skip test ``m == self.clip_anchor_idx`` compares
        0..M-1 with -1 and never fires, so the anchor-vs-anchor pair is
        included and the sum is divided by M."""
        if not self.enable_clip:
            return torch.zeros((), device=window_results["label"].device)
        feats = window_results["aligned_features_stack"].transpose(1, 2)  # [G, D, M]
        tau = torch.exp(-self.clip_logit_scale)
        feats = feats / (torch.linalg.norm(feats, dim=1, keepdim=True) + 1e-12)
        B, _, M = feats.shape
        anchor = feats[:, :, self.clip_anchor_idx]
        target = torch.arange(B, device=feats.device)
        total = torch.zeros((), dtype=feats.dtype, device=feats.device)
        for m in range(M):
            logits_xy = anchor @ feats[:, :, m].T / tau
            total = total + cross_entropy(logits_xy, target) + cross_entropy(logits_xy.T, target)
        return total / M


class ClipGateRandomClamDetach(SVDGateRandomClamDetach, ClipGateRandomClam):
    """Detach forward and the CLIP group loss (reference clip_gate_random_clam_detach.py)."""


class DeepSuperviseSVDGateRandomClam(SVDGateRandomClam):
    """Adds a supervised classifier head per tabular modality
    (reference deep_supervise_svd_gate_random.py:8-137)."""

    def __init__(self, config: ModelConfig, generator: torch.Generator):
        super().__init__(config, generator)
        self.Classifier = nn.ModuleDict({
            ch: TCPClassifier(self.output_dim, self.size[1], self.n_classes, self.dropout_rate,
                              generator)
            for ch in self.used_modality
        })

    def _deep_supervise(self, features, label, *, generator=None, train=False):
        out: Result = {}
        for ch in self.used_modality:
            if ch in CLAM_CHANNELS:
                continue
            # the head's Dropout is active in training, like the reference's
            # ClassifierCreator nn.Dropout
            logits = self.Classifier[ch](features[ch], generator=generator, train=train)
            out[f"{ch}_logits"] = logits
            out[f"{ch}_logits_loss"] = cross_entropy(logits, label, reduction="none")
        return features, out


class DeepSuperviseSVDGateRandomClamDetach(SVDGateRandomClamDetach, DeepSuperviseSVDGateRandomClam):
    """Detach variant (reference deep_supervise_svd_gate_random_detach.py)."""

    def _deep_supervise(self, features, label, *, generator=None, train=False):
        # the heads see the live tabular features (their loss trains the
        # transfer layers); only then are those detached for everything
        # downstream (reference deep_supervise_svd_gate_random_detach.py:58-61)
        features, out = DeepSuperviseSVDGateRandomClam._deep_supervise(
            self, features, label, generator=generator, train=train)
        return {ch: v if ch in CLAM_CHANNELS else v.detach() for ch, v in features.items()}, out

"""SVD-CLAM and UniversalConnections (counterpart of
``multimodal_fusion_tpu.models.extras``): dead code in the reference,
repaired and registered by the JAX package.

- SVDCLAM (reference ``svd_clam.py:92-469``): CLAM over the concatenated
  bag, whose per-marker TMA channels first pass a MultiModalAlignmentModel
  and reach the bag detached; each case adds the rank-1 SVD loss over its
  aligned marker rows and, at ``lambda2`` != 0, the match loss against
  rows shifted by a derangement.  As in the JAX package, which writes the
  model for one case, both losses run over the case's padded rows: a
  window's case is one SVD loss, computed here case by case.
- UniversalConnections (reference ``auto_connections.py:7-155``): iterative
  view-generation attention that grows the token set; it returns the token
  matrix [G, N + depth * views, token_dim], not a result dict.

The JAX package has no ``state_dict`` map for either.  SVDCLAM keeps CLAM's
names and the alignment model's reference names under ``alignment_model``
(``alignment_model.alignment_layers.<ch>.<i>``,
``alignment_model.mlp_predictor.mlp.{0,3}``); UniversalConnections keeps
the JAX package's (``q_gen.<d>``, ``Wq.<d>``, ``Wk.<d>``, ``Wv.<d>``,
``post_fc1.<d>``, ``post_fc2.<d>``) beside the ClamMLP trunk's.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from multimodal_fusion_tpu_torch.config import ModelConfig
from multimodal_fusion_tpu_torch.models.alignment import MultiModalAlignmentModel
from multimodal_fusion_tpu_torch.models.base import Case, Result
from multimodal_fusion_tpu_torch.models.clam import CLAM
from multimodal_fusion_tpu_torch.models.clam_mlp import ClamMLP
from multimodal_fusion_tpu_torch.models.common import torch_linear
from multimodal_fusion_tpu_torch.models.ps3 import modality_tokens
from multimodal_fusion_tpu_torch.ops.losses import binary_cross_entropy, rank1_svd_loss_from_dict


class SVDCLAM(CLAM):
    """CLAM + per-TMA-marker alignment layers + the rank-1 SVD loss."""

    def __init__(self, config: ModelConfig, generator: torch.Generator):
        super().__init__(config, generator)
        self.alignment_channels = sorted(
            config.get("alignment_channels")
            or [c for c in config.channels_used_in_model if c.startswith("tma=")])
        self.tau1 = config.get("tau1", 0.1)
        self.tau2 = config.get("tau2", 0.1)
        self.lambda1 = config.get("lambda1", 1.0)
        self.lambda2 = config.get("lambda2", 0.0)
        self.loss2_chunk_size = config.get("loss2_chunk_size")
        self.alignment_model = MultiModalAlignmentModel(
            self.alignment_channels, feature_dim=config.input_dim,
            num_layers=config.get("alignment_layer_num", 2), generator=generator)

    def forward(self, case: Case, label: Optional[torch.Tensor] = None, *,
                generator: Optional[torch.Generator] = None, train: bool = False) -> Result:
        chans = case["channels"]
        aligned = self.alignment_model({c: chans[c] for c in self.alignment_channels if c in chans})
        if aligned:
            # the bag reads the aligned features detached: the alignment
            # layers train through the SVD and match losses only (reference
            # svd_clam.py:227-237)
            case = dict(case, channels={**chans, **{c: v.detach() for c, v in aligned.items()}})
        out = super().forward(case, label, generator=generator, train=train)
        if not aligned:
            return out
        keys = sorted(aligned)
        G, B = aligned[keys[0]].shape[:2]
        per_case = [rank1_svd_loss_from_dict({k: aligned[k][g] for k in keys}, self.tau1,
                                             self.tau2, self.lambda1, self.loss2_chunk_size)
                    for g in range(G)]
        svd_loss = torch.stack([loss for loss, _ in per_case])
        if self.lambda2 != 0 and B > 1:
            # derangement shifts: (i mod (B - 1)) + 1 is never a multiple of
            # B, so no negative row is its own positive; B = 1 has none
            pos = torch.cat([aligned[k] for k in keys], dim=-1)
            neg = torch.cat([torch.roll(aligned[k], shifts=(i % (B - 1)) + 1, dims=1)
                             for i, k in enumerate(keys)], dim=-1)
            pred = self.alignment_model.predict_match(torch.cat([pos, neg], dim=1),
                                                      generator=generator, train=train)
            targets = torch.cat([torch.ones(B), torch.zeros(B)]).to(pred)
            svd_loss = svd_loss + self.lambda2 * torch.stack(
                [binary_cross_entropy(pred[g, :, 0], targets) for g in range(G)])
        out["svd_loss"] = svd_loss
        out["svd_values"] = torch.stack([values for _, values in per_case])
        return out

    def loss_fn(self, logits, labels, result):
        base = super().loss_fn(logits, labels, result)
        if self.base_weight < 1 and "svd_loss" in result:
            return base + result["svd_loss"]
        return base


def _xavier(dim: int, generator: torch.Generator) -> nn.Parameter:
    bound = (6.0 / (dim + dim)) ** 0.5
    return nn.Parameter(torch.empty((dim, dim), device=generator.device).uniform_(
        -bound, bound, generator=generator))


class UniversalConnections(ClamMLP):
    """Iterative view-generation attention; returns the grown token matrix."""

    def __init__(self, config: ModelConfig, generator: torch.Generator):
        super().__init__(config, generator)
        self.modality_order = self.used_modality
        self.views_num = config.get("views_num", 4)
        self.token_dim = config.get("token_dim", self.output_dim)
        self.inference_depth = config.get("inference_depth", 2)
        D, M, L = self.token_dim, self.views_num, self.inference_depth
        self.q_gen = nn.ModuleList([torch_linear(D, M * D, generator) for _ in range(L)])
        self.Wq = nn.ParameterList([_xavier(D, generator) for _ in range(L)])
        self.Wk = nn.ParameterList([_xavier(D, generator) for _ in range(L)])
        self.Wv = nn.ParameterList([_xavier(D, generator) for _ in range(L)])
        self.post_fc1 = nn.ModuleList([torch_linear(D, D, generator) for _ in range(L)])
        self.post_fc2 = nn.ModuleList([torch_linear(D, D, generator) for _ in range(L)])

    def forward(self, case: Case, label: Optional[torch.Tensor] = None, *,
                generator: Optional[torch.Generator] = None, train: bool = False) -> torch.Tensor:
        X, _ = modality_tokens(self, case, label, generator=generator, train=train)  # [G, N, D]
        G = X.shape[0]
        g = X.mean(dim=1, keepdim=True)  # global awareness [G, 1, D]
        for d in range(self.inference_depth):
            Q = self.q_gen[d](g).reshape(G, self.views_num, self.token_dim)
            S = Q @ (self.Wq[d] @ self.Wk[d].T) @ X.transpose(1, 2)  # [G, views, N]
            Z = torch.softmax(S, dim=-1) @ (X @ self.Wv[d])
            Z = self.post_fc2[d](F.gelu(self.post_fc1[d](Z), approximate="none")) + Z
            X = torch.cat([X, Z], dim=1)
        return X

"""PS3 (counterpart of ``multimodal_fusion_tpu.models.ps3``): modality
tokens -> LayerNorm -> shared QKV -> single-head self-attention over the M
tokens -> per-modality Linear -> the same LayerNorm -> concat -> fusion MLP.

Reference: ``downstream_survival/models/ps3.py:8-145``.  The CLAM features
are detached before the fusion (reference :82,87).  The attention is M x M
products scaled by 1/sqrt(output_dim), plain PyTorch as in the JAX package
(``jnp.dot``, not its attention kernel).  Parameters carry the reference
``state_dict`` names: ``token_norm``, ``qkv_proj``,
``modality_mlp_layers.<ch>``, ``modality_fusion_layer.{0,3}``.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from multimodal_fusion_tpu_torch.config import ModelConfig
from multimodal_fusion_tpu_torch.models.base import Case, Result, process_case
from multimodal_fusion_tpu_torch.models.clam_mlp import CLAM_CHANNELS, ClamMLP
from multimodal_fusion_tpu_torch.models.common import LayerNorm, dropout, torch_linear


def modality_tokens(model: ClamMLP, case: Case, label, *, generator=None, train=False):
    """Each modality of ``model.modality_order`` to a token [G, output_dim]:
    a CLAM branch's features, detached, or a tabular transfer; returns
    (tokens [G, M, output_dim], the branches' results keyed ``<ch>_<k>``)."""
    inputs, in_masks = process_case(case, model.channels_used_in_model)
    aux: Result = {}
    tokens = []
    for ch in model.modality_order:
        if ch in CLAM_CHANNELS:
            res = model.segment(model.clam_forward, ch, inputs[ch], in_masks.get(ch), label,
                                generator=generator, train=train)
            for rk, rv in res.items():
                aux[f"{ch}_{rk}"] = rv
            tokens.append(res["features"].detach())
        else:
            tokens.append(model.transfer_layer[ch](inputs[ch]).squeeze(-2))
    return torch.stack(tokens, dim=1), aux


class PS3(ClamMLP):
    def __init__(self, config: ModelConfig, generator: torch.Generator):
        super().__init__(config, generator)
        self.modality_order = sorted(self.used_modality)
        D = self.output_dim
        self.token_norm = LayerNorm(D, device=generator.device)
        self.qkv_proj = torch_linear(D, 3 * D, generator)
        self.modality_mlp_layers = nn.ModuleDict(
            {ch: torch_linear(D, D, generator) for ch in self.modality_order})
        self.modality_fusion_layer = nn.ModuleDict({
            "0": torch_linear(len(self.modality_order) * D, self.size[1], generator),
            "3": torch_linear(self.size[1], self.n_classes, generator),
        })

    def forward(self, case: Case, label: Optional[torch.Tensor] = None, *,
                generator: Optional[torch.Generator] = None, train: bool = False) -> Result:
        h, aux = modality_tokens(self, case, label, generator=generator, train=train)  # [G, M, D]
        h = self.token_norm(h)
        q, k, v = self.qkv_proj(h).split(self.output_dim, dim=-1)
        attn = torch.softmax(torch.bmm(q, k.transpose(1, 2)) / math.sqrt(self.output_dim), dim=-1)
        h = torch.bmm(attn, v)
        h = torch.stack([self.modality_mlp_layers[ch](h[:, i])
                         for i, ch in enumerate(self.modality_order)], dim=1)
        h = self.token_norm(h).flatten(1)
        hid = dropout(F.relu(self.modality_fusion_layer["0"](h)), self.dropout_rate, generator,
                      train)
        logits = self.modality_fusion_layer["3"](hid)
        probs, preds = self.classify(logits)
        aux["Y_prob"] = probs
        aux["Y_hat"] = preds
        return self.make_result(logits, probs, preds, **aux)

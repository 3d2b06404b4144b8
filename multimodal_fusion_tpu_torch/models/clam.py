"""MIL and CLAM models and the CLAM branch machinery shared by the trunk
(counterpart of ``multimodal_fusion_tpu.models.clam``).

Reference semantics: ``downstream_survival/models/mil.py:12-124`` (MIL_fc)
and ``downstream_survival/models/clam.py:51-302`` (CLAM-SB with gated
attention and the top-k / bottom-k instance clustering loss).  Bags arrive
as a padded window [G, N_pad, D] with a validity mask [G, N_pad]; the bag
softmax and the top-k instance selection are masked so padding never
leaks, and ``k = min(inst_number, N)`` (reference clam_mlp.py:193-197) is
a static k with per-slot validity.  Parameters carry the reference's
``state_dict`` names (``attention_net.0``, ``attention_net.3.*``,
``classifiers``, ``instance_classifiers.<i>``; MIL: ``fc.0``,
``classifier``).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from multimodal_fusion_tpu_torch.config import ModelConfig, model_size_dims
from multimodal_fusion_tpu_torch.models.attention import AttnNet, AttnNetGated
from multimodal_fusion_tpu_torch.models.base import BaseModel, Case, Result
from multimodal_fusion_tpu_torch.models.common import dropout, torch_linear
from multimodal_fusion_tpu_torch.ops.losses import cross_entropy
from multimodal_fusion_tpu_torch.ops.masked import masked_softmax, masked_topk


def instance_ce(instances: torch.Tensor, targets: torch.Tensor, slot_valid: torch.Tensor,
                classifier: nn.Linear) -> torch.Tensor:
    """Per-case instance CE [G] of instances [G, K, H] averaged over the
    valid slots (torch CE over the min(k, N) selected instances)."""
    nll = cross_entropy(classifier(instances), targets, reduction="none")
    w = slot_valid.to(nll.dtype)
    return (nll * w).sum(-1) / w.sum(-1).clamp_min(1.0)


class ClamAttentionCore(nn.Module):
    """fc (Linear -> ReLU -> Dropout) and the attention scorer, the
    reference's ``Sequential(Linear, ReLU, Dropout, Attn_Net_Gated)``:
    children ``0`` (fc) and ``3`` (scorer)."""

    def __init__(self, config: ModelConfig, generator: torch.Generator):
        super().__init__()
        size = model_size_dims(config.input_dim, config.model_size)
        self.size = size
        n_attn = 1 if config.n_classes == 2 else config.n_classes
        self.add_module("0", torch_linear(size[0], size[1], generator))
        self.dropout_rate = config.dropout
        attn_cls = AttnNetGated if config.get("gate", True) else AttnNet
        # the reference hard-codes Dropout(0.25) inside Attn_Net(_Gated)
        # whenever dropout is truthy (clam_mlp.py:16,36-38); the configured
        # rate applies only to the fc stack
        attn_rate = 0.25 if config.dropout else 0.0
        self.add_module("3", attn_cls(size[1], size[2], n_attn, attn_rate, generator))

    @property
    def fc(self) -> nn.Linear:
        return self._modules["0"]

    @property
    def attn(self) -> nn.Module:
        return self._modules["3"]

    def forward(self, x: torch.Tensor, *, generator: Optional[torch.Generator] = None,
                train: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
        """x [G, N, input_dim] -> (scores [G, N, n_attn], h [G, N, size1])."""
        h = dropout(F.relu(self.fc(x)), self.dropout_rate, generator, train)
        return self.attn(h, generator=generator, train=train), h


def _gather_rows(h: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Rows ``idx`` [G, k] of h [G, N, H] -> [G, k, H]."""
    return torch.gather(h, 1, idx.unsqueeze(-1).expand(-1, -1, h.shape[-1]))


def clam_instance_loss(
    A: torch.Tensor,
    h: torch.Tensor,
    mask: Optional[torch.Tensor],
    label: torch.Tensor,
    classifiers: Sequence[nn.Linear],
    inst_number: int,
    n_classes: int,
    subtyping: bool,
    subtyping_divisor: Optional[int] = None,
) -> torch.Tensor:
    """Top-k / bottom-k instance clustering loss per case [G].

    ``A`` [G, N] raw attention scores, ``h`` [G, N, size1], ``label`` [G].
    For instance classifier i: a case of class i takes the in-class loss
    (top-k positives, bottom-k negatives); any other case the out-of-class
    loss (only under subtyping: top-k negatives), else 0.  Matches
    reference clam.py:169-228 / clam_mlp.py:188-228, with min(k, N) via
    slot weights (``n_classes`` is kept for the JAX signature: a label
    outside the classes takes the out-of-class loss everywhere, as
    ``jax.nn.one_hot`` gives it)."""
    G, N = A.shape
    k = min(inst_number, N)  # static clamp to the padded bag size
    n_valid = mask.sum(-1) if mask is not None else torch.full((G,), N, device=A.device)
    slot_valid = torch.arange(k, device=A.device)[None, :] < n_valid[:, None]  # [G, k]

    _, idx_p = masked_topk(A, k, mask)
    top_p = _gather_rows(h, idx_p)
    _, idx_n = masked_topk(-A, k, mask)
    top_n = _gather_rows(h, idx_n)

    ones = torch.ones((G, k), dtype=torch.int64, device=A.device)
    in_targets = torch.cat([ones, torch.zeros_like(ones)], dim=1)
    in_instances = torch.cat([top_p, top_n], dim=1)
    in_valid = torch.cat([slot_valid, slot_valid], dim=1)
    total = torch.zeros((G,), dtype=h.dtype, device=A.device)
    for i, clf in enumerate(classifiers):
        in_loss = instance_ce(in_instances, in_targets, in_valid, clf)
        out_loss = (instance_ce(top_p, torch.zeros_like(ones), slot_valid, clf) if subtyping
                    else torch.zeros_like(in_loss))
        total = total + torch.where(label == i, in_loss, out_loss)
    if subtyping:
        # CLAM divides by its n_classes instance classifiers (clam.py:274);
        # the ClamMLP family by the NUMBER OF BAG CHANNELS (clam_mlp.py:
        # 315-316), which its callers pass as subtyping_divisor
        total = total / (subtyping_divisor or len(classifiers))
    return total


def concat_bag_channels(case: Case, channels) -> Tuple[torch.Tensor, torch.Tensor]:
    """Concat the listed raw channels along the instance axis with a joint
    validity mask [G, N] (skipping ``wsi=reconstructed`` and channels the
    window lacks)."""
    chans = case["channels"]
    raw_masks = case.get("masks", {})
    parts, masks = [], []
    for c in channels:
        if c == "wsi=reconstructed" or c not in chans:
            continue
        arr = chans[c]
        parts.append(arr)
        m = raw_masks.get(c)
        masks.append(m if m is not None else
                     torch.ones(arr.shape[:2], dtype=torch.bool, device=arr.device))
    return torch.cat(parts, dim=1), torch.cat(masks, dim=1)


def attention_pool(A: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """Attention pooling: A [G, N] . h [G, N, H] -> [G, H]."""
    return torch.bmm(A.unsqueeze(1), h).squeeze(1)


class MILFC(BaseModel):
    """Pure MIL: per-instance classifier and top-instance selection
    (reference mil.py:12-124)."""

    def __init__(self, config: ModelConfig, generator: torch.Generator):
        super().__init__(config)
        self.channels_used_in_model = list(config.channels_used_in_model)
        h1 = model_size_dims(config.input_dim, config.model_size)[1]
        self.fc = nn.Sequential(torch_linear(config.input_dim, h1, generator))
        self.classifier = torch_linear(h1, config.n_classes, generator)

    def forward(self, case: Case, label: Optional[torch.Tensor] = None, *,
                generator: Optional[torch.Generator] = None, train: bool = False) -> Result:
        h, mask = concat_bag_channels(case, self.channels_used_in_model)
        h = dropout(F.relu(self.fc[0](h)), self.dropout_rate, generator, train)
        logits = self.classifier(h)  # [G, N, C]
        y_probs = torch.softmax(logits, dim=-1)
        rows = torch.arange(logits.shape[0], device=logits.device)
        if self.n_classes == 2:
            # the instance with the highest positive-class probability
            # (reference mil.py:100-103)
            top_idx = torch.argmax(torch.where(mask, y_probs[..., 1], float("-inf")), dim=1)
            selected = logits[rows, top_idx]
            probs, preds = self.classify(selected)
        else:
            # the (instance, class) pair with the highest probability; Y_hat
            # is that class (reference mil.py:105-110)
            flat = torch.where(mask[..., None], y_probs, float("-inf")).flatten(1)
            m = torch.argmax(flat, dim=1)
            top_idx = m // self.n_classes
            selected = logits[rows, top_idx]
            probs = y_probs[rows, top_idx]
            preds = m % self.n_classes
        return self.make_result(selected, probs, preds)


class CLAM(BaseModel):
    """CLAM-SB: gated attention pooling and the instance clustering loss
    (reference clam.py:51-302)."""

    def __init__(self, config: ModelConfig, generator: torch.Generator):
        super().__init__(config)
        self.channels_used_in_model = list(config.channels_used_in_model)
        self.attention_net = ClamAttentionCore(config, generator)
        size = self.attention_net.size
        self.base_weight = config.get("base_weight", 0.7)
        self.inst_number = config.get("inst_number", 8)
        self.subtyping = config.get("subtyping", False)
        self.attention_only = config.get("attention_only", False)
        self.return_features = config.get("return_features", False)
        self.classifiers = torch_linear(size[1], config.n_classes, generator)
        self.instance_classifiers = nn.ModuleList(
            [torch_linear(size[1], 2, generator) for _ in range(config.n_classes)])

    def forward(self, case: Case, label: Optional[torch.Tensor] = None, *,
                generator: Optional[torch.Generator] = None, train: bool = False) -> Result:
        h_in, mask = concat_bag_channels(case, self.channels_used_in_model)
        scores, h = self.attention_net(h_in, generator=generator, train=train)
        A_raw = scores[..., 0]  # [G, N] (binary: one attention branch)
        if self.attention_only:
            return {"attention_weights": A_raw}
        M = attention_pool(masked_softmax(A_raw, mask), h)  # [G, size1]
        logits = self.classifiers(M)
        probs, preds = self.classify(logits)
        kwargs = {"attention_weights": A_raw}
        if self.return_features:
            kwargs["features"] = M
        if self.base_weight < 1:
            kwargs["total_inst_loss"] = clam_instance_loss(
                A_raw, h, mask, label, self.instance_classifiers,
                self.inst_number, self.n_classes, self.subtyping,
            )
        return self.make_result(logits, probs, preds, **kwargs)

    def loss_fn(self, logits, labels, result):
        base = self.base_loss(logits, labels)
        if self.base_weight < 1:
            return base * self.base_weight + result["total_inst_loss"] * (1 - self.base_weight)
        return base

"""Loss functions (counterpart of ``multimodal_fusion_tpu.ops.losses``).

Only ``cross_entropy`` is ported so far, the loss of MFMF; the SVD, volume,
CLIP, Cox and AUCM losses are ROADMAP Queue 1 item 8.
"""

from __future__ import annotations

import torch


def cross_entropy(
    logits: torch.Tensor,
    labels: torch.Tensor,
    label_smoothing: float = 0.0,
    reduction: str = "mean",
) -> torch.Tensor:
    """Softmax cross entropy with integer labels over the last axis of
    ``logits`` (torch.nn.CrossEntropyLoss, as the JAX package writes it)."""
    n_classes = logits.shape[-1]
    logp = torch.log_softmax(logits, dim=-1)
    onehot = torch.nn.functional.one_hot(labels.long(), n_classes).to(logits.dtype)
    if label_smoothing > 0.0:
        onehot = onehot * (1.0 - label_smoothing) + label_smoothing / n_classes
    nll = -(onehot * logp).sum(dim=-1)
    if reduction == "mean":
        return nll.mean()
    if reduction == "sum":
        return nll.sum()
    return nll

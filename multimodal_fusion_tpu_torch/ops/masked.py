"""Masked helpers for padded tensors (counterpart of
``multimodal_fusion_tpu.ops.masked``).

Ragged patch bags become fixed-size tensors plus a validity mask (True =
valid); reductions go through these helpers so padding never leaks into
results.  Masked scores are replaced by the finite ``NEG_INF``, so a fully
masked row degrades to a uniform average instead of NaN.  Bag sizes are
padded up a ladder of buckets, as the JAX package does, so the port's
windows have the same shapes as the JAX package's.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

NEG_INF = -1e9

BUCKETS = (64, 128, 256, 512, 1024, 2048, 4096, 8192, 16384, 32768)


def masked_softmax(logits: torch.Tensor, mask: Optional[torch.Tensor], dim: int = -1) -> torch.Tensor:
    """Softmax over ``dim`` with invalid entries receiving zero probability."""
    if mask is None:
        return torch.softmax(logits, dim=dim)
    out = torch.softmax(torch.where(mask, logits, NEG_INF), dim=dim)
    return torch.where(mask, out, 0.0)


def masked_mean(x: torch.Tensor, mask: Optional[torch.Tensor], dim: int = 0) -> torch.Tensor:
    """Mean over ``dim`` of the valid entries (at least one counted)."""
    if mask is None:
        return x.mean(dim=dim)
    w = mask.to(x.dtype)
    if x.dim() > mask.dim():
        w = w.unsqueeze(-1)
    return (x * w).sum(dim=dim) / w.sum(dim=dim).clamp_min(1.0)


def masked_max(x: torch.Tensor, mask: Optional[torch.Tensor], dim: int = 0) -> torch.Tensor:
    """Max over ``dim`` with invalid entries replaced by ``NEG_INF``."""
    if mask is None:
        return x.amax(dim=dim)
    w = mask.unsqueeze(-1) if x.dim() > mask.dim() else mask
    return torch.where(w, x, NEG_INF).amax(dim=dim)


def masked_topk(scores: torch.Tensor, k: int, mask: Optional[torch.Tensor] = None,
                largest: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """(values, indices) of the top ``k`` over the last dim, masked entries
    counted as ``NEG_INF`` (``largest=False``: the bottom k, by negation).

    Equal values come out lower index first, as ``jax.lax.top_k`` orders
    them (``torch.topk`` promises no order): a stable descending sort.
    With fewer than ``k`` valid entries the trailing slots point at masked
    entries, so callers weight slots by a validity count (the reference's
    ``k = min(inst_number, N)``, clam_mlp.py:193-197)."""
    s = scores if largest else -scores
    if mask is not None:
        s = torch.where(mask, s, NEG_INF)
    vals, idx = torch.sort(s, dim=-1, descending=True, stable=True)
    vals, idx = vals[..., :k], idx[..., :k]
    return (vals if largest else -vals), idx


def pad_to(x: torch.Tensor, n: int, dim: int = 0, value: float = 0.0) -> torch.Tensor:
    """Pad ``x`` along ``dim`` up to length ``n`` with ``value``."""
    cur = x.shape[dim]
    if cur == n:
        return x
    if cur > n:
        raise ValueError(f"cannot pad dim {dim} of length {cur} down to {n}")
    shape = list(x.shape)
    shape[dim] = n - cur
    return torch.cat([x, x.new_full(shape, value)], dim=dim)


def length_mask(n_valid: int, n_max: int, device=None) -> torch.Tensor:
    """Boolean mask [n_max] with the first ``n_valid`` entries True."""
    return torch.arange(n_max, device=device) < n_valid


def bucket_size(n: int, buckets: Sequence[int] = BUCKETS) -> int:
    """Smallest bucket >= n; above the ladder, the next multiple of 8192."""
    for b in buckets:
        if n <= b:
            return b
    return ((n + 8191) // 8192) * 8192

"""Pairwise similarity (PyTorch port of ``multimodal_fusion_tpu.ops.similarity``).

Math::

    kappa_h(i,j) = exp(-lambda_h * ||h_i - h_j||^2)   (morphological)
    kappa_g(i,j) = exp(-lambda_g * ||g_i - g_j||^2)   (spatial)
    kappa       = kappa_h * kappa_g  (one exp of the weighted sum)

Squared feature distances use the ``||a||^2 + ||b||^2 - 2 a.b`` expansion
in true float32 (``device.strict_fp32``); low-dimensional inputs
(positions) use direct per-coordinate differences, which need no clamp.
The combined similarity has one plain version, ``similarity_rect_plain``,
beside its fused CUDA kernel in ``ops.similarity_kernel``.
"""

from __future__ import annotations

from typing import Optional

import torch

from multimodal_fusion_tpu_torch.ops.similarity_kernel import similarity_rect_plain

# At or below this row width the norm expansion is replaced by direct
# per-coordinate differences (positions are 2-D everywhere).
_DIRECT_DIFF_MAX_D = 4


def pairwise_sq_dists(
    a: torch.Tensor, b: Optional[torch.Tensor] = None, *, bf16_exact: bool = False
) -> torch.Tensor:
    """Pairwise squared L2 distances between rows of ``a`` [N,D] and ``b`` [M,D].

    ``bf16_exact=True`` marks inputs whose values are exactly
    bf16-representable: the dot operands are cast back to bf16 (lossless)
    and multiplied with float32 accumulation.  Norms always accumulate from
    the float32 values.  Distances clamp at 0."""
    if b is None:
        b = a
    if 0 < a.shape[-1] <= _DIRECT_DIFF_MAX_D:
        d = None
        for p in range(a.shape[-1]):
            diff = a[:, p, None] - b[None, :, p]
            d = diff * diff if d is None else d + diff * diff
        return d
    a_sq = torch.sum(a * a, dim=-1, keepdim=True)  # [N,1]
    b_sq = torch.sum(b * b, dim=-1, keepdim=True)  # [M,1]
    if bf16_exact:
        # products of two bf16 values are exact in f32; the f32 matmul of
        # the round-tripped values is the lossless form on every device
        ab = a.to(torch.bfloat16).float() @ b.to(torch.bfloat16).float().T
    else:
        ab = a @ b.T
    return torch.clamp_min(a_sq + b_sq.T - 2.0 * ab, 0.0)


def combined_similarity(
    features: torch.Tensor,
    positions: torch.Tensor,
    lambda_h: float = 1.0,
    lambda_g: float = 1.0,
) -> torch.Tensor:
    """K = K_h * K_g as a single exp of the weighted sum of distances, in
    plain PyTorch on any device: K1's plain version on the square case."""
    return similarity_rect_plain(features, positions, features, positions, lambda_h, lambda_g)


def cross_similarity(a: torch.Tensor, b: torch.Tensor, lam: float = 1.0) -> torch.Tensor:
    """exp(-lam * ||a_i - b_j||^2) between [N,D] and [M,D] -> [N,M]
    (WSI super-patch x TMA morphological similarity)."""
    return torch.exp(-lam * pairwise_sq_dists(a, b))

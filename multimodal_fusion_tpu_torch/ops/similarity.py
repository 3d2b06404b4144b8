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


def slide_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a [B, M, K] @ b [B, K, N] -> [B, M, N] as one product per slide.
    cuBLAS picks its kernel by the batch count as well as the shape, so a
    batched product can round a slide's values otherwise than the same
    slide's product alone; a slide's build must not depend on the chunk it
    is built in."""
    out = torch.empty((a.shape[0], a.shape[1], b.shape[2]), dtype=torch.result_type(a, b),
                      device=a.device)
    for i in range(a.shape[0]):
        torch.matmul(a[i], b[i], out=out[i])
    return out


def _matmul_t(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b^T on the last two axes, a product per slide for [B, ., .]."""
    if a.dim() == 3:
        return slide_matmul(a, b.transpose(1, 2))
    return a @ b.transpose(-1, -2)


def pairwise_sq_dists(
    a: torch.Tensor, b: Optional[torch.Tensor] = None, *, bf16_exact: bool = False
) -> torch.Tensor:
    """Pairwise squared L2 distances between rows of ``a`` [N, D] and ``b``
    [M, D] -> [N, M], or per slide of [B, N, D] and [B, M, D] -> [B, N, M].

    ``bf16_exact=True`` marks inputs whose values are exactly
    bf16-representable: the dot operands are cast back to bf16 (lossless)
    and multiplied with float32 accumulation.  Norms always accumulate from
    the float32 values.  Distances clamp at 0."""
    if b is None:
        b = a
    if 0 < a.shape[-1] <= _DIRECT_DIFF_MAX_D:
        d = None
        for p in range(a.shape[-1]):
            diff = a[..., :, p, None] - b[..., None, :, p]
            d = diff * diff if d is None else d + diff * diff
        return d
    a_sq = torch.sum(a * a, dim=-1, keepdim=True)  # [..., N, 1]
    b_sq = torch.sum(b * b, dim=-1, keepdim=True)  # [..., M, 1]
    if bf16_exact:
        # products of two bf16 values are exact in f32; the f32 matmul of
        # the round-tripped values is the lossless form on every device
        ab = _matmul_t(a.to(torch.bfloat16).float(), b.to(torch.bfloat16).float())
    else:
        ab = _matmul_t(a, b)
    return torch.clamp_min(a_sq + b_sq.transpose(-1, -2) - 2.0 * ab, 0.0)


def morphological_similarity(features: torch.Tensor, lambda_h: float = 1.0) -> torch.Tensor:
    """K_h = exp(-lambda_h * ||h_i - h_j||^2) for features [N, D] -> [N, N]."""
    return torch.exp(-lambda_h * pairwise_sq_dists(features))


def spatial_similarity(positions: torch.Tensor, lambda_g: float = 1.0) -> torch.Tensor:
    """K_g = exp(-lambda_g * ||g_i - g_j||^2) for positions [N, 2|3] -> [N, N]."""
    return torch.exp(-lambda_g * pairwise_sq_dists(positions))


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
    """exp(-lam * ||a_i - b_j||^2) between [..., N, D] and [..., M, D] ->
    [..., N, M] (WSI super-patch x TMA morphological similarity)."""
    return torch.exp(-lam * pairwise_sq_dists(a, b))


def _valid_block(n: int, n_valid, device) -> torch.Tensor:
    idx = torch.arange(n, device=device)
    return (idx[:, None] < n_valid) & (idx[None, :] < n_valid)


def median_offdiag(K: torch.Tensor, n_valid: Optional[int] = None) -> torch.Tensor:
    """Median of the off-diagonal entries of an [N, N] similarity matrix as
    ``torch.median`` takes it: the LOWER of the two middle values (the
    off-diagonal count N*(N-1) is always even; numpy would interpolate,
    and the interpolated value sits above the lower middle, dropping the
    median pair from a thresholded edge set).  With padding, ``n_valid``
    leaves rows and columns >= n_valid out."""
    n = K.shape[0]
    eye = torch.eye(n, dtype=torch.bool, device=K.device)
    if n_valid is None:
        invalid = eye
        count = n * (n - 1)
    else:
        invalid = eye | ~_valid_block(n, n_valid, K.device)
        count = int(n_valid) * (int(n_valid) - 1)
    flat = torch.sort(torch.where(invalid, torch.nan, K).reshape(-1)).values  # NaNs sort last
    return flat[max(count - 1, 0) // 2]


def threshold_edge_mask(
    K: torch.Tensor, threshold, n_valid: Optional[int] = None
) -> torch.Tensor:
    """Boolean [N, N] mask of the edges with similarity >= threshold.  Self
    loops and both (i, j) / (j, i) directions are kept, as the reference's
    loop over the full N^2 grid keeps them."""
    mask = K >= threshold
    if n_valid is not None:
        mask = mask & _valid_block(K.shape[0], n_valid, K.device)
    return mask


def mean_pool(features: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Global mean feature [1, D]; with ``mask``, over the valid rows."""
    if mask is None:
        return torch.mean(features, dim=0, keepdim=True)
    w = mask.to(features.dtype)[:, None]
    return torch.sum(features * w, dim=0, keepdim=True) / torch.clamp_min(torch.sum(w), 1.0)

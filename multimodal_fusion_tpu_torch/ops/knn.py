"""K-nearest-neighbour search (port of ``multimodal_fusion_tpu.ops.knn``).

Brute force at the build's node counts (a few hundred): one [N, N]
distance matmul plus a sort.  :func:`knn_indices_blockwise` streams the key
axis in fixed-size blocks with a running top-k (O(N * block) memory) and is
the plain version of the CUDA kernel in ``ops.knn_kernel``.

Ties rank by (value, smallest index), as ``lax.top_k`` orders them: every
selection here is a stable ascending sort over candidates laid out in
index order.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from multimodal_fusion_tpu_torch.ops.similarity import pairwise_sq_dists

_BIG = 1e30


def knn_indices(
    x: torch.Tensor,
    k: int,
    mask: Optional[torch.Tensor] = None,
    include_self: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """For each row of ``x`` [N, D], its ``k`` nearest rows: (distances
    [N, k] ascending, indices [N, k]).  With ``include_self`` the self-match
    (distance pinned to exactly 0) sits in slot 0."""
    d = pairwise_sq_dists(x)
    n = x.shape[0]
    eye = torch.eye(n, dtype=torch.bool, device=x.device)
    if include_self:
        d = torch.where(eye, 0.0, d)
    if mask is not None:
        d = torch.where(~mask[None, :], _BIG, d)
        d = torch.where(~mask[:, None], _BIG, d)
    if not include_self:
        d = d + eye.to(d.dtype) * _BIG
    vals, idx = torch.sort(d, dim=1, stable=True)
    return torch.sqrt(torch.clamp_min(vals[:, :k], 0.0)), idx[:, :k]


def knn_indices_blockwise(
    x: torch.Tensor,
    k: int,
    block: int = 2048,
    include_self: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Streaming KNN: a loop over key blocks with a running top-k; never
    materialises [N, N]."""
    n, _ = x.shape
    x_sq = torch.sum(x * x, dim=-1, keepdim=True)  # [N, 1]
    rows = torch.arange(n, device=x.device)[:, None]
    best_d = torch.full((n, k), _BIG, dtype=torch.float32, device=x.device)
    best_i = torch.zeros((n, k), dtype=torch.int64, device=x.device)
    for j0 in range(0, n, block):
        keys = x[j0:j0 + block]
        keys_sq = torch.sum(keys * keys, dim=-1)
        d_blk = torch.clamp_min(x_sq + keys_sq[None, :] - 2.0 * (x @ keys.T), 0.0)
        idx_blk = j0 + torch.arange(keys.shape[0], device=x.device)[None, :].expand(n, -1)
        if include_self:
            d_blk = torch.where(idx_blk == rows, 0.0, d_blk)
        else:
            d_blk = torch.where(idx_blk == rows, _BIG, d_blk)
        # the running list holds smaller indices than this block, so a stable
        # sort over [best, block] orders ties by the smaller index
        cand_d = torch.cat([best_d, d_blk], dim=1)
        cand_i = torch.cat([best_i, idx_blk], dim=1)
        vals, sel = torch.sort(cand_d, dim=1, stable=True)
        best_d = vals[:, :k]
        best_i = torch.gather(cand_i, 1, sel[:, :k])
    return torch.sqrt(torch.clamp_min(best_d, 0.0)), best_i


def knn_edges(idx: torch.Tensor) -> torch.Tensor:
    """Expand kNN indices [N, k] into directed edge pairs [N*k, 2] (src, dst)."""
    n, k = idx.shape
    src = torch.arange(n, device=idx.device).repeat_interleave(k)
    return torch.stack([src, idx.reshape(-1)], dim=1)

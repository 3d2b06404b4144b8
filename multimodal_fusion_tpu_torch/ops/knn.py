"""K-nearest-neighbour search (port of ``multimodal_fusion_tpu.ops.knn``).

Brute force at the build's node counts (a few hundred): one [N, N]
distance matmul plus a sort.  :func:`knn_indices_blockwise` streams the key
axis in fixed-size blocks with a running top-k (O(N * block) memory) and is
the plain version of the CUDA kernel in ``ops.knn_kernel``;
:func:`knn_partials` repeats that kernel's split of the key axis into
segments and :func:`knn_merge_partials` its merge launch.

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
    """For each row of ``x`` [..., N, D], its ``k`` nearest rows: (distances
    [..., N, k] ascending, indices [..., N, k]); leading axes are slides.
    With ``include_self`` the self-match (distance pinned to exactly 0) sits
    in slot 0."""
    d = pairwise_sq_dists(x)
    n = x.shape[-2]
    eye = torch.eye(n, dtype=torch.bool, device=x.device)
    if include_self:
        d = torch.where(eye, 0.0, d)
    if mask is not None:
        d = torch.where(~mask[..., None, :], _BIG, d)
        d = torch.where(~mask[..., :, None], _BIG, d)
    if not include_self:
        d = d + eye.to(d.dtype) * _BIG
    vals, idx = torch.sort(d, dim=-1, stable=True)
    return torch.sqrt(torch.clamp_min(vals[..., :k], 0.0)), idx[..., :k]


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


def knn_merge_partials(part_d: torch.Tensor, part_i: torch.Tensor, k: int
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K2's merge launch: each row's S sorted partial lists
    ``part_d`` / ``part_i`` [S, N, k] (squared distances and indices; a
    segment with fewer than k keys pads with (inf, N)) merged into its k
    smallest by (value, smallest index), sqrt applied."""
    s, n, kp = part_d.shape
    cand_d = part_d.permute(1, 0, 2).reshape(n, s * kp)
    cand_i = part_i.permute(1, 0, 2).reshape(n, s * kp).long()
    by_index = torch.argsort(cand_i, dim=1, stable=True)
    cand_d, cand_i = torch.gather(cand_d, 1, by_index), torch.gather(cand_i, 1, by_index)
    by_value = torch.argsort(cand_d, dim=1, stable=True)[:, :k]
    return (torch.sqrt(torch.gather(cand_d, 1, by_value)), torch.gather(cand_i, 1, by_value))


def knn_partials(x: torch.Tensor, k: int, segments: int, unit: int = 1
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K2's first launch at ``segments`` > 1: the keys cut
    into ``segments`` runs of whole ``unit``-key tiles (ceil(tiles /
    segments) tiles each, so the last may be short or empty), and each
    row's k smallest squared distances per segment by (value, smallest
    index), self pinned to 0: [S, N, k] each, padded with (inf, N)."""
    n = x.shape[0]
    x_sq = torch.sum(x * x, dim=-1, keepdim=True)
    rows = torch.arange(n, device=x.device)[:, None]
    tiles = -(-n // unit)
    per = -(-tiles // segments) * unit  # keys per segment
    part_d = torch.full((segments, n, k), float("inf"), dtype=torch.float32, device=x.device)
    part_i = torch.full((segments, n, k), n, dtype=torch.int64, device=x.device)
    for s in range(segments):
        j0, j1 = min(s * per, n), min((s + 1) * per, n)
        keys = x[j0:j1]
        d_seg = torch.clamp_min(x_sq + torch.sum(keys * keys, dim=-1)[None, :] - 2.0 * (x @ keys.T), 0.0)
        idx = torch.arange(j0, j1, device=x.device)[None, :].expand(n, -1)
        d_seg = torch.where(idx == rows, 0.0, d_seg)
        vals, sel = torch.sort(d_seg, dim=1, stable=True)  # keys in index order: ties by index
        m = min(k, j1 - j0)
        part_d[s, :, :m] = vals[:, :m]
        part_i[s, :, :m] = torch.gather(idx, 1, sel[:, :m])
    return part_d, part_i


def knn_edges(idx: torch.Tensor) -> torch.Tensor:
    """Expand kNN indices [N, k] into directed edge pairs [N*k, 2] (src, dst)."""
    n, k = idx.shape
    src = torch.arange(n, device=idx.device).repeat_interleave(k)
    return torch.stack([src, idx.reshape(-1)], dim=1)

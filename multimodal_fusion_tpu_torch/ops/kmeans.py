"""KMeans in PyTorch (port of ``multimodal_fusion_tpu.ops.kmeans``).

- kmeans++ greedy seeding with ``n_local_trials = 2 + floor(log k)``,
  drawing with ``torch.multinomial`` from an explicit ``torch.Generator``
  on the run's device.
- The ``n_init`` restarts are a leading batch dimension [R, ...]; the
  lowest-inertia restart wins (first on ties).
- Lloyd iterations run until every restart has converged (center shift
  <= tol) or ``n_iters``; a converged restart keeps its centers.  Each
  iteration reads one flag back to the host.
- Distances use the ||x||^2 - 2 x.c + ||c||^2 expansion (true f32 matmul);
  center sums are one-hot matmuls, deterministic on every device.
- Empty clusters are relocated sklearn-style onto the points with the
  largest contribution to inertia, never onto padded rows; a bounded
  cascade guard refills clusters that a relocation drained.

``kmeans(init_centers=...)`` skips the seeding and starts Lloyd from given
[n_init, k, D] centers: the tests feed it the JAX side's kmeans++ draws.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch


class KMeansResult(NamedTuple):
    centers: torch.Tensor  # [K, D]
    labels: torch.Tensor  # [N] int64
    inertia: torch.Tensor  # [] float32


def _sq_dists_to_centers(x: torch.Tensor, centers: torch.Tensor) -> torch.Tensor:
    """x [N, D], centers [R, K, D] -> [R, N, K] clamped squared distances."""
    x_sq = torch.sum(x * x, dim=-1)[None, :, None]  # [1, N, 1]
    c_sq = torch.sum(centers * centers, dim=-1)[:, None, :]  # [R, 1, K]
    xc = torch.matmul(x, centers.transpose(1, 2))  # [R, N, K]
    return torch.clamp_min(x_sq - 2.0 * xc + c_sq, 0.0)


def _draw(p: torch.Tensor, num: int, generator: torch.Generator) -> torch.Tensor:
    """``num`` indices per row of the (unnormalised) weights ``p`` [R, N],
    with replacement.  An all-zero row draws index 0, as jax.random.choice
    does for an all-zero distribution."""
    total = torch.sum(p, dim=1, keepdim=True)
    fallback = torch.zeros_like(p)
    fallback[:, 0] = 1.0
    p = torch.where(total > 0, p, fallback)
    return torch.multinomial(p, num, replacement=True, generator=generator)


def kmeans_plus_plus_init(
    x: torch.Tensor,
    k: int,
    generator: torch.Generator,
    n_init: int = 1,
    mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Greedy kmeans++ seeding for ``n_init`` restarts: x [N, D] -> [n_init, k, D]."""
    n, dim = x.shape
    r = n_init
    n_local_trials = 2 + int(math.log(max(k, 2)))
    valid = mask if mask is not None else torch.ones(n, dtype=torch.bool, device=x.device)
    x_sq = torch.sum(x * x, dim=-1)  # [N]
    rows = torch.arange(r, device=x.device)

    probs0 = valid.float()[None, :].expand(r, n)
    first = _draw(probs0, 1, generator)[:, 0]  # [R]
    centers = torch.zeros((r, k, dim), dtype=torch.float32, device=x.device)
    centers[:, 0] = x[first]
    d0 = torch.clamp_min(x_sq[None, :] - 2.0 * (x[first] @ x.T) + x_sq[first][:, None], 0.0)
    closest = torch.where(valid[None, :], d0, 0.0)  # [R, N]

    for i in range(1, k):
        p = torch.where(valid[None, :], closest, 0.0)
        p = p / torch.clamp_min(torch.sum(p, dim=1, keepdim=True), 1e-30)
        cand_idx = _draw(p, n_local_trials, generator)  # [R, T]
        cand = x[cand_idx]  # [R, T, D]
        xc = torch.matmul(cand, x.T)  # [R, T, N]
        d_cand = torch.clamp_min(x_sq[None, None, :] - 2.0 * xc + x_sq[cand_idx][..., None], 0.0)
        d_cand = torch.minimum(d_cand, closest[:, None, :])
        d_cand = torch.where(valid[None, None, :], d_cand, 0.0)
        best = torch.argmin(torch.sum(d_cand, dim=2), dim=1)  # [R]
        centers[:, i] = cand[rows, best]
        closest = d_cand[rows, best]
    return centers


def _cluster_means(x, labels, weights, k, centers):
    """Weighted per-cluster means [R, K, D]; empty clusters keep ``centers``."""
    r, n = labels.shape
    onehot = torch.zeros((r, n, k), dtype=x.dtype, device=x.device).scatter_(
        2, labels[..., None], weights.to(x.dtype)[None, :, None].expand(r, n, 1).contiguous()
    )
    counts = torch.sum(onehot, dim=1)  # [R, K]
    sums = torch.matmul(onehot.transpose(1, 2), x)  # [R, K, D]
    return torch.where(
        counts[..., None] > 0, sums / torch.clamp_min(counts[..., None], 1.0), centers
    )


def _counts(labels: torch.Tensor, weights: torch.Tensor, k: int) -> torch.Tensor:
    """Weighted cluster sizes [R, K] (exact small integers in f32)."""
    out = torch.zeros((labels.shape[0], k), dtype=torch.float32, device=labels.device)
    return out.scatter_add_(1, labels, weights.float()[None, :].expand_as(labels).contiguous())


def _relocate_empty(x, centers, labels, d_min, counts, weights):
    """sklearn-style empty-cluster relocation, per restart: the i-th empty
    cluster takes the point with the i-th largest contribution to inertia.
    Donors: valid non-singleton points by contribution, then valid
    singletons, never padded rows.  No-op when k > n."""
    r, k = centers.shape[:2]
    n = x.shape[0]
    if k > n:
        return centers, labels
    valid = (weights > 0)[None, :]
    singleton = torch.gather(counts, 1, labels) <= 1
    contrib = torch.where(valid & ~singleton, d_min, torch.where(valid, -1.0, -2.0))
    # exact top-k with ties to the lower index (lax.top_k's order)
    far_idx = torch.sort(contrib, dim=1, descending=True, stable=True).indices[:, :k]
    empty = counts == 0
    rank = torch.cumsum(empty.to(torch.int64), dim=1) - 1
    n_valid = torch.sum(weights > 0)
    target = torch.gather(far_idx, 1, rank.clamp(0, k - 1))  # [R, K]
    can = empty & (rank < n_valid) & (torch.gather(contrib, 1, target) > -1.5)
    centers = torch.where(can[..., None], x[target].to(centers.dtype), centers)
    upd = torch.where(can, target, torch.full_like(target, n))  # slot n is dropped
    ext = torch.cat([labels, torch.zeros_like(labels[:, :1])], dim=1)
    ext.scatter_(1, upd, torch.arange(k, device=x.device).expand(r, k).contiguous())
    return centers, ext[:, :n].contiguous()


def _lloyd(x, centers, weights, n_iters: int, tol: float):
    """Batched Lloyd: x [N, D], centers [R, K, D], weights [N].
    Returns (centers [R, K, D], labels [R, N], inertia [R])."""
    k = centers.shape[1]
    done = torch.zeros(centers.shape[0], dtype=torch.bool, device=x.device)
    for _ in range(n_iters):
        labels = torch.argmin(_sq_dists_to_centers(x, centers), dim=-1)
        new_centers = _cluster_means(x, labels, weights, k, centers)
        shift = torch.sum((new_centers - centers) ** 2, dim=(1, 2))
        centers = torch.where(done[:, None, None], centers, new_centers)
        done = done | (shift <= tol)
        if bool(done.all()):
            break

    # relocation refinement outside the hot loop: at convergence these two
    # passes are exact no-ops (converged centers are a Lloyd fixed point)
    for _ in range(2):
        d = _sq_dists_to_centers(x, centers)
        d_min, labels = torch.min(d, dim=-1)
        counts = _counts(labels, weights, k)
        centers, labels = _relocate_empty(x, centers, labels, d_min, counts, weights)
        centers = _cluster_means(x, labels, weights, k, centers)

    d = _sq_dists_to_centers(x, centers)
    d_min, labels = torch.min(d, dim=-1)
    counts = _counts(labels, weights, k)
    centers, labels = _relocate_empty(x, centers, labels, d_min, counts, weights)

    # cascade guard: draining a 1-2 point donor can leave a fresh empty
    # cluster; each pass fills at least one while a non-singleton donor
    # exists, so <= k passes restore the invariant.  Labels stay sticky (no
    # re-argmin) and the contribution is the distance to the ASSIGNED center.
    counts = _counts(labels, weights, k)
    for _ in range(k):
        active = torch.any(counts == 0, dim=1)
        if not bool(active.any()):
            break
        d = _sq_dists_to_centers(x, centers)
        d_assigned = torch.gather(d, 2, labels[..., None])[..., 0]
        new_c, new_l = _relocate_empty(x, centers, labels, d_assigned, counts, weights)
        centers = torch.where(active[:, None, None], new_c, centers)
        labels = torch.where(active[:, None], new_l, labels)
        counts = _counts(labels, weights, k)

    d = _sq_dists_to_centers(x, centers)
    inertia = torch.sum(torch.gather(d, 2, labels[..., None])[..., 0] * weights[None, :], dim=1)
    return centers, labels, inertia


def kmeans(
    x: torch.Tensor,
    k: int,
    generator: Optional[torch.Generator] = None,
    n_iters: int = 50,
    n_init: int = 10,
    tol: float = 1e-4,
    mask: Optional[torch.Tensor] = None,
    init_centers: Optional[torch.Tensor] = None,
) -> KMeansResult:
    """KMeans with ``n_init`` batched restarts; best inertia wins.

    ``mask`` marks valid rows of a padded ``x``; masked rows carry zero
    weight.  ``init_centers`` [n_init, k, D] replaces the kmeans++ seeding
    (then ``generator`` is unused)."""
    x = x.float()
    weights = mask.float() if mask is not None else torch.ones(x.shape[0], device=x.device)
    if init_centers is None:
        if generator is None:
            raise ValueError("kmeans needs a generator or init_centers")
        init = kmeans_plus_plus_init(x, k, generator, n_init, mask)
    else:
        init = init_centers.to(device=x.device, dtype=torch.float32)
        if tuple(init.shape) != (n_init, k, x.shape[1]):
            raise ValueError(
                f"init_centers shape {tuple(init.shape)} != {(n_init, k, x.shape[1])}"
            )
    centers, labels, inertia = _lloyd(x, init, weights, n_iters, tol)
    best = int(torch.argmin(inertia))
    return KMeansResult(centers[best], labels[best], inertia[best])

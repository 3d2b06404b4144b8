"""KMeans in PyTorch (port of ``multimodal_fusion_tpu.ops.kmeans``).

- Two leading batch axes: slides [B] and the ``n_init`` restarts [R].
  ``kmeans_batched`` clusters B same-shape slides at once, ``kmeans`` one
  slide; the lowest-inertia restart of each slide wins (first on ties),
  picked on the device.  Matrix products run one per slide
  (``slide_matmul``), so a slide's arithmetic is the same in any batch.
- kmeans++ greedy seeding with ``n_local_trials = 2 + floor(log k)``.  Each
  slide draws from its own ``torch.Generator``: its uniforms are drawn up
  front (``_seeding_uniforms``) and turned into indices by inverse-CDF
  selection over the running weights (``_inverse_cdf``), so a slide's
  draws are the same whether it is clustered alone or in a batch.
- Lloyd iterations run until every restart of every slide has converged
  (center shift <= tol) or ``n_iters``; a converged restart keeps its
  centers.  Each iteration reads one flag back to the host for the batch.
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
from typing import NamedTuple, Optional, Sequence

import torch

from multimodal_fusion_tpu_torch.ops.similarity import slide_matmul


class KMeansResult(NamedTuple):
    centers: torch.Tensor  # [K, D] ([B, K, D] from kmeans_batched)
    labels: torch.Tensor  # [N] int64 ([B, N])
    inertia: torch.Tensor  # [] float32 ([B])


def _sq_dists_to_centers(x: torch.Tensor, centers: torch.Tensor) -> torch.Tensor:
    """x [B, N, D], centers [B, R, K, D] -> [B, R, N, K] clamped squared
    distances (one [N, D] x [D, R*K] product per slide)."""
    b, r, k, d = centers.shape
    x_sq = torch.sum(x * x, dim=-1)[:, None, :, None]  # [B, 1, N, 1]
    c_sq = torch.sum(centers * centers, dim=-1)[:, :, None, :]  # [B, R, 1, K]
    xc = slide_matmul(x, centers.reshape(b, r * k, d).transpose(1, 2))  # [B, N, R*K]
    xc = xc.view(b, x.shape[1], r, k).permute(0, 2, 1, 3)
    return torch.clamp_min(x_sq - 2.0 * xc + c_sq, 0.0)


def _seeding_uniforms(generators: Sequence[torch.Generator], r: int, k: int, trials: int):
    """Each slide's uniforms for kmeans++, from its own generator: [B, R]
    for the first centers and [k - 1, B, R, trials] for the candidates."""
    first = torch.stack([torch.rand((r,), generator=g, device=g.device) for g in generators])
    cand = torch.stack(
        [torch.rand((max(k - 1, 0), r, trials), generator=g, device=g.device) for g in generators],
        dim=1,
    )
    return first, cand


def _inverse_cdf(w: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """Indices [..., T] drawn from the unnormalised weights ``w`` [..., N]
    by the uniforms ``u`` [..., T] in [0, 1): the first index whose running
    sum exceeds u times the total.  An index of weight 0 is never drawn; an
    all-zero row draws index 0, as jax.random.choice does for an all-zero
    distribution."""
    c = torch.cumsum(w, dim=-1)
    idx = torch.searchsorted(c, u * c[..., -1:], right=True)
    # rounding can put u * total at the total itself: take the last index
    # that carries weight (argmax returns the first maximal running sum)
    return torch.minimum(idx, torch.argmax(c, dim=-1, keepdim=True))


def _kmeans_pp(x, k: int, generators, r: int, valid: torch.Tensor) -> torch.Tensor:
    """Greedy kmeans++ seeding: x [B, N, D], valid [B, N] -> [B, R, k, D]."""
    b, n, dim = x.shape
    trials = 2 + int(math.log(max(k, 2)))
    u_first, u_cand = _seeding_uniforms(generators, r, k, trials)
    u_first, u_cand = u_first.to(x.device), u_cand.to(x.device)
    x_sq = torch.sum(x * x, dim=-1)  # [B, N]
    bi = torch.arange(b, device=x.device)[:, None]  # [B, 1]
    ri = torch.arange(r, device=x.device)[None, :]  # [1, R]
    xt = x.transpose(1, 2)  # [B, D, N]

    weights0 = valid.float()[:, None, :].expand(b, r, n)
    first = _inverse_cdf(weights0, u_first[..., None])[..., 0]  # [B, R]
    centers = torch.zeros((b, r, k, dim), dtype=torch.float32, device=x.device)
    x_first = x[bi, first]  # [B, R, D]
    centers[:, :, 0] = x_first
    d0 = torch.clamp_min(
        x_sq[:, None, :] - 2.0 * slide_matmul(x_first, xt) + x_sq[bi, first][..., None], 0.0
    )
    closest = torch.where(valid[:, None, :], d0, 0.0)  # [B, R, N]

    for i in range(1, k):
        cand_idx = _inverse_cdf(closest, u_cand[i - 1])  # [B, R, T]
        cand = x[bi[..., None], cand_idx]  # [B, R, T, D]
        xc = slide_matmul(cand.reshape(b, r * trials, dim), xt).view(b, r, trials, n)
        d_cand = torch.clamp_min(
            x_sq[:, None, None, :] - 2.0 * xc + x_sq[bi[..., None], cand_idx][..., None], 0.0
        )
        d_cand = torch.minimum(d_cand, closest[:, :, None, :])
        d_cand = torch.where(valid[:, None, None, :], d_cand, 0.0)
        best = torch.argmin(torch.sum(d_cand, dim=-1), dim=-1)  # [B, R]
        centers[:, :, i] = cand[bi, ri, best]
        closest = d_cand[bi, ri, best]
    return centers


def kmeans_plus_plus_init(
    x: torch.Tensor,
    k: int,
    generator: torch.Generator,
    n_init: int = 1,
    mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Greedy kmeans++ seeding of one slide for ``n_init`` restarts:
    x [N, D] -> [n_init, k, D]."""
    valid = mask if mask is not None else torch.ones(x.shape[0], dtype=torch.bool, device=x.device)
    return _kmeans_pp(x.float()[None], k, [generator], n_init, valid[None])[0]


def _cluster_means(x, labels, weights, k, centers):
    """Weighted per-cluster means [B, R, K, D]; empty clusters keep
    ``centers``.  x [B, N, D], labels [B, R, N], weights [B, N]."""
    b, r, n = labels.shape
    cols = (labels + k * torch.arange(r, device=x.device)[None, :, None]).transpose(1, 2)
    onehot = torch.zeros((b, n, r * k), dtype=x.dtype, device=x.device).scatter_(
        2, cols, weights.to(x.dtype)[:, :, None].expand(b, n, r).contiguous()
    )  # [B, N, R*K]
    counts = torch.sum(onehot, dim=1).view(b, r, k)
    sums = slide_matmul(onehot.transpose(1, 2), x).view(b, r, k, x.shape[2])
    return torch.where(
        counts[..., None] > 0, sums / torch.clamp_min(counts[..., None], 1.0), centers
    )


def _counts(labels: torch.Tensor, weights: torch.Tensor, k: int) -> torch.Tensor:
    """Weighted cluster sizes [B, R, K] (exact small integers in f32)."""
    b, r, n = labels.shape
    out = torch.zeros((b, r, k), dtype=torch.float32, device=labels.device)
    return out.scatter_add_(2, labels, weights.float()[:, None, :].expand(b, r, n).contiguous())


def _relocate_empty(x, centers, labels, d_min, counts, weights):
    """sklearn-style empty-cluster relocation, per slide and restart: the
    i-th empty cluster takes the point with the i-th largest contribution
    to inertia.  Donors: valid non-singleton points by contribution, then
    valid singletons, never padded rows.  No-op when k > n."""
    b, r, k = centers.shape[:3]
    n = x.shape[1]
    if k > n:
        return centers, labels
    valid = (weights > 0)[:, None, :]  # [B, 1, N]
    singleton = torch.gather(counts, 2, labels) <= 1
    contrib = torch.where(valid & ~singleton, d_min, torch.where(valid, -1.0, -2.0))
    # exact top-k with ties to the lower index (lax.top_k's order)
    far_idx = torch.sort(contrib, dim=-1, descending=True, stable=True).indices[..., :k]
    empty = counts == 0
    rank = torch.cumsum(empty.to(torch.int64), dim=-1) - 1
    n_valid = torch.sum(weights > 0, dim=-1)[:, None, None]  # [B, 1, 1]
    target = torch.gather(far_idx, 2, rank.clamp(0, k - 1))  # [B, R, K]
    can = empty & (rank < n_valid) & (torch.gather(contrib, 2, target) > -1.5)
    bi = torch.arange(b, device=x.device)[:, None, None]
    centers = torch.where(can[..., None], x[bi, target].to(centers.dtype), centers)
    upd = torch.where(can, target, torch.full_like(target, n))  # slot n is dropped
    ext = torch.cat([labels, torch.zeros_like(labels[..., :1])], dim=-1)
    ext.scatter_(2, upd, torch.arange(k, device=x.device).expand(b, r, k).contiguous())
    return centers, ext[..., :n].contiguous()


def _lloyd_batched(x, centers, weights, n_iters: int, tol: float):
    """Batched Lloyd: x [B, N, D], centers [B, R, K, D], weights [B, N].
    Returns (centers [B, R, K, D], labels [B, R, N], inertia [B, R])."""
    k = centers.shape[2]
    done = torch.zeros(centers.shape[:2], dtype=torch.bool, device=x.device)
    for _ in range(n_iters):
        labels = torch.argmin(_sq_dists_to_centers(x, centers), dim=-1)
        new_centers = _cluster_means(x, labels, weights, k, centers)
        shift = torch.sum((new_centers - centers) ** 2, dim=(2, 3))
        centers = torch.where(done[..., None, None], centers, new_centers)
        done = done | (shift <= tol)
        if bool(done.all()):
            break

    # relocation refinement outside the hot loop: at convergence these two
    # passes are exact no-ops (converged centers are a Lloyd fixed point)
    for _ in range(2):
        d_min, labels = torch.min(_sq_dists_to_centers(x, centers), dim=-1)
        counts = _counts(labels, weights, k)
        centers, labels = _relocate_empty(x, centers, labels, d_min, counts, weights)
        centers = _cluster_means(x, labels, weights, k, centers)

    d_min, labels = torch.min(_sq_dists_to_centers(x, centers), dim=-1)
    counts = _counts(labels, weights, k)
    centers, labels = _relocate_empty(x, centers, labels, d_min, counts, weights)

    # cascade guard: draining a 1-2 point donor can leave a fresh empty
    # cluster; each pass fills at least one while a non-singleton donor
    # exists, so <= k passes restore the invariant.  Labels stay sticky (no
    # re-argmin) and the contribution is the distance to the ASSIGNED center.
    counts = _counts(labels, weights, k)
    for _ in range(k):
        active = torch.any(counts == 0, dim=-1)  # [B, R]
        if not bool(active.any()):
            break
        d = _sq_dists_to_centers(x, centers)
        d_assigned = torch.gather(d, 3, labels[..., None])[..., 0]
        new_c, new_l = _relocate_empty(x, centers, labels, d_assigned, counts, weights)
        centers = torch.where(active[..., None, None], new_c, centers)
        labels = torch.where(active[..., None], new_l, labels)
        counts = _counts(labels, weights, k)

    d = _sq_dists_to_centers(x, centers)
    inertia = torch.sum(torch.gather(d, 3, labels[..., None])[..., 0] * weights[:, None, :], dim=-1)
    return centers, labels, inertia


def _lloyd(x, centers, weights, n_iters: int, tol: float):
    """Lloyd on one slide: x [N, D], centers [R, K, D], weights [N].
    Returns (centers [R, K, D], labels [R, N], inertia [R])."""
    c, labels, inertia = _lloyd_batched(x[None], centers[None], weights[None], n_iters, tol)
    return c[0], labels[0], inertia[0]


def kmeans_batched(
    x: torch.Tensor,
    k: int,
    generators: Optional[Sequence[torch.Generator]] = None,
    n_iters: int = 50,
    n_init: int = 10,
    tol: float = 1e-4,
    mask: Optional[torch.Tensor] = None,
    init_centers: Optional[torch.Tensor] = None,
) -> KMeansResult:
    """KMeans of B same-shape slides x [B, N, D], ``n_init`` batched
    restarts each; each slide's best inertia wins.

    ``generators`` holds one generator per slide; ``mask`` [B, N] marks the
    valid rows of padded slides (masked rows carry zero weight).
    ``init_centers`` [B, n_init, k, D] replaces the kmeans++ seeding (then
    ``generators`` is unused)."""
    x = x.float()
    b, n, dim = x.shape
    valid = mask if mask is not None else torch.ones((b, n), dtype=torch.bool, device=x.device)
    if init_centers is None:
        if generators is None or len(generators) != b:
            raise ValueError(f"kmeans needs one generator per slide ({b}) or init_centers")
        init = _kmeans_pp(x, k, generators, n_init, valid)
    else:
        init = init_centers.to(device=x.device, dtype=torch.float32)
        if tuple(init.shape) != (b, n_init, k, dim):
            raise ValueError(
                f"init_centers shape {tuple(init.shape)} != {(b, n_init, k, dim)}"
            )
    centers, labels, inertia = _lloyd_batched(x, init, valid.float(), n_iters, tol)
    best = torch.argmin(inertia, dim=1)  # [B], first on ties
    bi = torch.arange(b, device=x.device)
    return KMeansResult(centers[bi, best], labels[bi, best], inertia[bi, best])


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
    """KMeans of one slide x [N, D] with ``n_init`` batched restarts; best
    inertia wins.

    ``mask`` marks valid rows of a padded ``x``; masked rows carry zero
    weight.  ``init_centers`` [n_init, k, D] replaces the kmeans++ seeding
    (then ``generator`` is unused)."""
    res = kmeans_batched(
        x[None], k, None if generator is None else [generator], n_iters, n_init, tol,
        None if mask is None else mask[None],
        None if init_centers is None else init_centers[None],
    )
    return KMeansResult(res.centers[0], res.labels[0], res.inertia[0])

"""Per-slide hypergraph build (PyTorch port of
``multimodal_fusion_tpu.hypergraph.build``).

Per slide: combined similarity (CUDA kernel K1) -> KMeans super-patches
(+ intra-cluster statistics) -> cross-modal similarity -> grouping KMeans ->
node KNN (CUDA kernel K2 once the node count reaches 4096) + hyperedge
KMeans -> cosine features, all on the run's device (``_fused_build``, which
takes a chunk of same-shape slides at once); then edge assembly, statistics
and the HDF5 write on the host (``_finalize_host``).

Statistics of the [N, N] similarity come in three modes (``_stats_modes``):
the whole K on the device up to ``FULL_STATS_MAX_N`` patches (or whenever
it is cached); above it, exact statistics streamed over row stripes of K
(``_blockwise_similarity_stats``, the median resolved by bit-pattern
bisection sweeps, ``_attach_exact_median``), or, under ``LARGE_N_STATS =
"sampled"``, statistics of a <= 2048-point subsample.

Entry points: ``process_arrays`` (in memory, no HDF5), ``process_single_file``
and ``process_dataset`` (HDF5 in and out; ``file_batch > 1`` builds chunks
of same-shape files at once), the stage-wise functions
(``aggregate_wsi_super_patches`` ... ``build_hypergraph_knn_kmeans``), and
the similarity caches and the rebuild from them
(``cache_similarity_matrices``, ``rebuild_hypergraph_from_similarity`` and
their dataset loops).  They take ``device=None``, which means CUDA; the CPU
runs only when asked for.  Random numbers come from ``torch.Generator``s on
the run's device seeded from ``seed`` (three per slide in the fused build,
one per KMeans in the stage-wise functions); ``init_centers`` replaces their
kmeans++ draws.

``mesh`` (``parallel.mesh``, the ranks of a ``torchrun`` launch) shards one
slide's patch axis over the ranks: each rank computes the K1 stripe of its
rows and the statistics are reduced over the ranks, while the O(N * D)
stages run whole on every rank (``_fused_build``), so the build equals the
unsharded one.  The JAX build turns its Pallas kernels off under a mesh
(GSPMD cannot partition a Mosaic call); the port has no such constraint and
launches K1 on the rank's stripe at every N, as it does unsharded.
"""

from __future__ import annotations

import csv
import functools
import json
import math
import os
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from multimodal_fusion_tpu_torch.device import resolve_device
from multimodal_fusion_tpu_torch.io.h5io import (
    _json_default,
    _lock_for,
    has_complete_hypergraph,
    open_h5_retrying,
    read_h5_retrying,
    write_hypergraph_group,
)
from multimodal_fusion_tpu_torch.ops.kmeans import kmeans, kmeans_batched
from multimodal_fusion_tpu_torch.ops.knn_kernel import knn_indices_auto
from multimodal_fusion_tpu_torch.ops.similarity import cross_similarity, slide_matmul
from multimodal_fusion_tpu_torch.ops.similarity_kernel import (
    combined_similarity_auto,
    sharded_combined_similarity,
    similarity_rect,
)
from multimodal_fusion_tpu_torch.parallel.mesh import all_gather_rows, all_reduce, barrier, rows_of

# Above this many patches the [N, N] f32 similarity (4 GB at 32768) is not
# materialised unless it is cached; statistics then come from LARGE_N_STATS.
FULL_STATS_MAX_N = 32768

# How statistics are computed above FULL_STATS_MAX_N: "blockwise" (exact,
# streamed over row stripes of K) or "sampled" (a <= 2048-point subsample).
LARGE_N_STATS = "blockwise"

# KMeans restarts of every clustering in the build.
N_INIT = 10


# ---------------------------------------------------------------------------
# HDF5 inputs
# ---------------------------------------------------------------------------

def load_wsi_data(h5_path) -> Tuple[np.ndarray, np.ndarray]:
    def read(f):
        if "wsi/features" not in f:
            raise ValueError(f"WSI features not found in {h5_path}")
        feats = np.asarray(f["wsi/features"], np.float32)
        if "wsi/positions" in f:
            pos = np.asarray(f["wsi/positions"], np.float32)
        else:
            pos = np.zeros((feats.shape[0], 2), np.float32)
        return feats, pos

    return read_h5_retrying(h5_path, read)


def load_tma_data(h5_path) -> Optional[np.ndarray]:
    """Flat ``tma/features`` if present; otherwise the per-marker
    ``tma/<marker>/features`` datasets concatenated in sorted marker order."""
    import h5py

    def read(f):
        if "tma" not in f:
            return None
        tma = f["tma"]
        if "features" in tma and isinstance(tma["features"], h5py.Dataset):
            return np.asarray(tma["features"], np.float32)
        parts = []
        for marker in sorted(tma.keys()):
            grp = tma[marker]
            if isinstance(grp, h5py.Group) and "features" in grp:
                parts.append(np.asarray(grp["features"], np.float32))
        return np.concatenate(parts, axis=0) if parts else None

    return read_h5_retrying(h5_path, read)


def load_similarity_matrices(h5_path):
    """The cached (wsi_internal [N, N], wsi_tma [S, T]) similarities of a
    file, each None when absent."""
    def read(f):
        wsi = wsitma = None
        if "hypergraph/similarity/wsi_internal" in f:
            wsi = np.asarray(f["hypergraph/similarity/wsi_internal"], np.float32)
        if "hypergraph/similarity/wsi_tma" in f:
            wsitma = np.asarray(f["hypergraph/similarity/wsi_tma"], np.float32)
        return wsi, wsitma

    return read_h5_retrying(h5_path, read)


def _shape_key(h5_path):
    """(N, D, P, T, D_tma) of a file, read from its HDF5 headers only; None
    when it has no TMA features (as ``load_tma_data`` would return None)."""
    import h5py

    def probe(f):
        if "wsi/features" not in f:
            raise ValueError(f"WSI features not found in {h5_path}")
        fs = f["wsi/features"].shape
        ps = f["wsi/positions"].shape if "wsi/positions" in f else (fs[0], 2)
        if "tma" not in f:
            return None
        tma = f["tma"]
        if "features" in tma and isinstance(tma["features"], h5py.Dataset):
            ts = tma["features"].shape
        else:
            # empty (0, D) parts still count: the unbatched path builds
            # with a 0-row TMA, and both paths must take the same branch
            parts = [tma[m]["features"].shape for m in sorted(tma.keys())
                     if isinstance(tma[m], h5py.Group) and "features" in tma[m]]
            if not parts:
                return None
            ts = (sum(sh[0] for sh in parts), parts[0][1])
        return tuple(fs) + tuple(ps[1:]) + tuple(ts)

    return read_h5_retrying(h5_path, probe)


# ---------------------------------------------------------------------------
# Statistics
# ---------------------------------------------------------------------------

def _matrix_stats(K: np.ndarray) -> Dict[str, float]:
    """Host statistics of a numpy matrix (the stage-wise functions')."""
    return {
        "mean": float(K.mean()),
        "std": float(K.std()),
        "min": float(K.min()),
        "max": float(K.max()),
        "median": float(np.median(K)),
    }


# Below this many elements the sort-based median is cheap; above it the
# bit-pattern bisection avoids sorting the [N, N] matrix.
_BISECT_MEDIAN_MIN_SIZE = 1 << 16
_INT32_MAX = 2**31 - 1


def _bitpattern_median_rows(K: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """EXACT median of each row of non-negative finite f32 values K [B, M]
    by bisection in bit-pattern space, no sort -> [B].  For non-negative
    IEEE floats the int32 bit pattern is order-isomorphic to the value, so
    31 compare+count passes isolate the k1 = (M+1)//2 and k2 = M//2+1
    smallest values; their f32 mean is numpy's median (``torch.median``
    would return the lower middle).  ``mask`` [B, M] marks the valid
    entries; a row with none gives NaN."""
    keys = K.float().contiguous().view(torch.int32)
    b = keys.shape[0]
    if mask is not None:
        m_cnt = torch.sum(mask, dim=1, dtype=torch.int64)
        # the sentinel sorts above every valid key and is never <= a midpoint
        keys = torch.where(mask, keys, _INT32_MAX)
        hi0 = torch.amax(torch.where(mask, keys, -1), dim=1)
    else:
        m_cnt = torch.full((b,), keys.shape[1], dtype=torch.int64, device=K.device)
        hi0 = torch.amax(keys, dim=1)
    k1 = (m_cnt + 1) // 2
    k2 = m_cnt // 2 + 1
    lo1 = torch.zeros((b,), dtype=torch.int32, device=K.device)
    lo2 = lo1.clone()
    hi1 = hi0.clone()
    hi2 = hi0.clone()
    for _ in range(31):
        m1 = lo1 + (hi1 - lo1) // 2
        m2 = lo2 + (hi2 - lo2) // 2
        c1 = torch.sum(keys <= m1[:, None], dim=1)
        c2 = torch.sum(keys <= m2[:, None], dim=1)
        lo1, hi1 = torch.where(c1 >= k1, lo1, m1 + 1), torch.where(c1 >= k1, m1, hi1)
        lo2, hi2 = torch.where(c2 >= k2, lo2, m2 + 1), torch.where(c2 >= k2, m2, hi2)
    med = (lo1.view(torch.float32) + lo2.view(torch.float32)) / 2.0
    return torch.where(m_cnt > 0, med, torch.nan)


def _bitpattern_median(K: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """EXACT median of all of K (or of its ``mask``ed entries), as
    ``_bitpattern_median_rows`` selects it."""
    return _bitpattern_median_rows(K.reshape(1, -1), None if mask is None else mask.reshape(1, -1))[0]


def _sort_median(vals: torch.Tensor) -> torch.Tensor:
    """numpy/jnp median along the last axis of ``vals``: the f32 midpoint of
    the two middle order statistics."""
    s = torch.sort(vals, dim=-1).values
    m = s.shape[-1]
    return (s[..., (m - 1) // 2] + s[..., m // 2]) * 0.5


def _matrix_stats_batch(K: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """[B, 5] = [mean, std, min, max, median] of each matrix K[b] on the
    device (std is the population std), over its ``mask[b]`` entries when a
    mask is given.  The moments and extrema reduce one matrix at a time, so
    a slide's statistics do not depend on the batch it is built in; the
    medians (exact counts) run once for the batch.  No entry gives NaNs."""
    b = K.shape[0]
    nan = torch.full((5,), torch.nan, dtype=torch.float32, device=K.device)
    if K[0].numel() == 0:
        return nan.expand(b, 5).clone()
    mom = []
    for i in range(b):
        vals = K[i] if mask is None else K[i][mask[i]]
        if vals.numel() == 0:
            mom.append(nan[:4])
            continue
        std, mean = torch.std_mean(vals, correction=0)
        mn, mx = torch.aminmax(vals)
        mom.append(torch.stack([mean, std, mn, mx]))
    flat = K.reshape(b, -1)
    if mask is not None:
        med = _bitpattern_median_rows(flat, mask.reshape(b, -1))
    elif flat.shape[1] >= _BISECT_MEDIAN_MIN_SIZE:
        med = _bitpattern_median_rows(flat)
    else:
        med = _sort_median(flat)
    return torch.cat([torch.stack(mom), med[:, None]], dim=1)


def _matrix_stats_dev(K: torch.Tensor) -> torch.Tensor:
    """[mean, std, min, max, median] of one matrix on the device."""
    return _matrix_stats_batch(K[None])[0]


def _matrix_stats_dev_masked(K: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """The statistics of one matrix's ``mask``ed entries (a padded slide's
    valid block)."""
    return _matrix_stats_batch(K[None], mask[None])[0]


def _stats_dict(v: np.ndarray) -> Dict[str, Optional[float]]:
    def _f(x) -> Optional[float]:
        x = float(x)
        # non-finite stats (empty TMA similarity) -> null, not NaN
        return x if math.isfinite(x) else None

    return {"mean": _f(v[0]), "std": _f(v[1]), "min": _f(v[2]), "max": _f(v[3]), "median": _f(v[4])}


def _unpack_triu(packed: np.ndarray, n: int) -> np.ndarray:
    K = np.empty((n, n), np.float32)
    iu = np.triu_indices(n)
    packed = packed.astype(np.float32)
    K[iu] = packed
    K[(iu[1], iu[0])] = packed
    return K


# --- exact statistics above FULL_STATS_MAX_N --------------------------------
#
# Similarities are f32 in [0, 1]; for non-negative floats the int32 bit
# pattern is order-isomorphic to the value, so the median is selected in
# bit-pattern space: the stats pass counts a 32-bin level-1 histogram over
# patterns [0, 2^30) (bin width 2^25, a superset of every pattern of a value
# in [0, 1]), and each refine sweep (``_median_level_pass``) recomputes the
# similarities and counts 32 sub-bins of one bin, the last at width 1: five
# sweeps resolve a rank.  Counts are exact int64 (bucketize + bincount:
# integer adds, the same total in any order); a pattern outside the range
# (NaN, garbage) lands in no bin, and ``_select_key`` raises when a refine
# total disagrees with its parent bin.  Every stripe of the stats pass and
# of each sweep is the same K1 launch on the same rows, so K is
# bit-identical between them.
_KEY_ONE = 0x3F800000  # int32 bit pattern of 1.0f
_MED_FANOUT = 32  # level-1 bins (inside the stats pass)
_MED_L1_SHIFT = 25  # level-1 bin width 2^25
_MED_REFINE_BINS = 32  # bins per refine sweep


def _hist_safe_block(n: int, block: int) -> int:
    """Largest stripe height <= ``block`` whose [B, n] stripe holds fewer
    than 2^31 elements (first binding above ~2.1M patches at B = 1024;
    there the passes use shorter stripes)."""
    return max(1, (2**31 - 1) // (n + block))


def _similarity_stripes(feats, pos, n_eff: int, lambda_h, lambda_g, bf16_exact: bool,
                        block: int = 1024, rows: Optional[Tuple[int, int]] = None):
    """Row stripes [<= block, n_eff] of the valid [n_eff, n_eff] block of
    the combined similarity (of its rows ``rows`` = [lo, hi) only, a mesh
    rank's share), each one K1 launch (its plain version on the CPU);
    yields (first row, stripe).  The stats pass and every refine sweep take
    their stripes from here, so they see bit-identical K."""
    fs = feats[:n_eff].to(torch.bfloat16 if bf16_exact else torch.float32)
    ps = pos[:n_eff].float()
    lo, hi = rows or (0, n_eff)
    blk = max(1, min(block, n_eff, _hist_safe_block(n_eff, block)))
    for r0 in range(lo, hi, blk):
        r1 = min(r0 + blk, hi)
        yield r0, similarity_rect(fs[r0:r1], ps[r0:r1], fs, ps, lambda_h, lambda_g, bf16_exact)


def _bin_bounds(lo_key: int, shift: int, nbins: int, device) -> torch.Tensor:
    """The nbins + 1 int32 bin boundaries lo_key + b * 2^shift."""
    return lo_key + (torch.arange(nbins + 1, dtype=torch.int32, device=device) << shift)


_LANES = 32  # one warp: the sub-bins of a bin that bincount's threads spread over


def _count_bins(K: torch.Tensor, bounds: torch.Tensor) -> torch.Tensor:
    """int64 counts [nbins + 2] of the bit patterns of the f32 stripe ``K``
    [B, N] by bin: slot 0 below ``bounds[0]``, slot b + 1 in [bounds[b],
    bounds[b + 1]), the last at or above ``bounds[-1]`` (negative and NaN
    patterns land in the two outer slots).

    Nearly every value of a stripe falls in one or two slots (a refine
    sweep counts one parent bin's values; the rest land outside), and
    bincount's threads would then all add to the same counter.  Each slot
    is counted in ``_LANES`` sub-slots by column (adjacent elements go to
    adjacent threads) and the sub-slots summed: integer sums, so the counts
    are the same whatever the lanes."""
    idx = torch.bucketize(K.view(torch.int32), bounds, out_int32=True, right=True)
    slots = bounds.numel() + 1
    lane = torch.arange(K.shape[-1], dtype=torch.int32, device=K.device) % _LANES
    spread = torch.add(lane, idx, alpha=_LANES)
    return torch.bincount(spread.reshape(-1), minlength=slots * _LANES).view(slots, _LANES).sum(1)


def _median_level_pass(feats, pos, lambda_h, lambda_g, n_valid: int, lo_key: int,
                       shift: int, nbins: int, padded: bool, block: int = 1024,
                       bf16_exact: bool = False, mesh=None) -> torch.Tensor:
    """One bisection level: int64 counts [nbins] of the valid similarity
    bit patterns in [lo_key, lo_key + nbins * 2^shift), one more sweep of
    K1 stripes; the host walks them to the target rank.  Under ``mesh``
    each rank sweeps its rows and the counts are summed over the ranks."""
    n_eff = n_valid if padded else feats.shape[0]
    bounds = _bin_bounds(lo_key, shift, nbins, feats.device)
    counts = torch.zeros(nbins + 2, dtype=torch.int64, device=feats.device)
    for _, K_blk in _similarity_stripes(feats, pos, n_eff, lambda_h, lambda_g, bf16_exact, block,
                                        _mesh_rows(mesh, feats.shape[0], n_eff)):
        counts += _count_bins(K_blk, bounds)
    return all_reduce(mesh, counts)[1:nbins + 1]


def _key_to_f32(key) -> np.float32:
    return np.int32(key).view(np.float32)


def _select_key(cnt: np.ndarray, rank: int, lo_key: int, width: int, refine) -> int:
    """Walk the bisection levels to the bit pattern at 1-indexed ``rank``
    within the range ``[lo_key, lo_key + nbins*width)`` whose per-bin
    counts are ``cnt`` (bin width ``width``).  ``refine(lo_key, shift,
    nbins) -> int64 counts`` runs one more stripe sweep."""
    while True:
        cum = np.cumsum(cnt)
        b = int(np.searchsorted(cum, rank))
        rank -= int(cum[b - 1]) if b > 0 else 0
        lo_key += b * width
        parent = int(cnt[b])
        if width == 1:
            return lo_key
        shift = max(width.bit_length() - 1 - _MED_REFINE_BINS.bit_length() + 1, 0)
        nbins = width >> shift  # always _MED_REFINE_BINS on the 2^25 descent
        cnt = refine(lo_key, shift, nbins)
        # the refine recomputes the similarities; if its keys were not
        # bit-identical to the stats pass the bin totals disagree and the
        # selection would silently read past the bin: fail loudly instead
        if int(cnt.sum()) != parent:
            raise RuntimeError(
                f"median refine pass disagrees with stats pass: range "
                f"[{lo_key}, {lo_key + width}) holds {parent} values, "
                f"refine counted {int(cnt.sum())}"
            )
        width = 1 << shift


def _exact_median_host(host: Dict, n_eff: int, refine) -> float:
    """Exact median of the n_eff^2 similarity values from the level-1
    bit-pattern histogram ``host["med_cnt"]`` the stats pass shipped.

    ``refine(lo_key, shift, nbins) -> int64 counts`` runs one bisection
    level (``_median_level_pass``); ~5 sweeps resolve each middle rank.
    Duplicate (lo_key, shift) requests are cached, so the even-count case
    costs the same sweeps as the odd one whenever both middles share a
    range.  Matches numpy's median exactly: the middle value for odd
    counts, the f32 mean of the two middles for even."""
    cnt1 = np.asarray(host["med_cnt"], np.int64)
    M = int(n_eff) * int(n_eff)
    k1, k2 = (M + 1) // 2, M // 2 + 1  # 1-indexed middle ranks
    cache: Dict[tuple, np.ndarray] = {}

    def refine_cached(lo_key, shift, nbins):
        key = (int(lo_key), int(shift), int(nbins))
        if key not in cache:
            cache[key] = refine(*key)
        return cache[key]

    v1 = _key_to_f32(_select_key(cnt1, k1, 0, 1 << _MED_L1_SHIFT, refine_cached))
    if M % 2:
        return float(v1)
    v2 = _key_to_f32(_select_key(cnt1, k2, 0, 1 << _MED_L1_SHIFT, refine_cached))
    return float((np.float32(v1) + np.float32(v2)) / np.float32(2))


def _attach_exact_median(host, n_eff, feats, pos, lambda_h, lambda_g, padded,
                         bf16_exact: bool = False, mesh=None):
    """Resolve the exact blockwise median of one slide and write it into
    ``host["K_stats"][4]`` (no-op when the build did not stream its
    statistics).  ``feats`` / ``pos`` are the slide's tensors as the build
    uploaded them and ``bf16_exact`` the build's flag: the refine sweeps
    recompute the similarities, and their bit patterns must match.  Under
    ``mesh`` each sweep runs over the rank's rows, its counts summed over
    the ranks."""
    if "med_cnt" not in host:
        return

    def refine(lo_key, shift, nbins):
        return _median_level_pass(feats, pos, lambda_h, lambda_g, n_eff, lo_key, shift, nbins,
                                  padded, bf16_exact=bf16_exact, mesh=mesh).cpu().numpy()

    host["K_stats"][4] = _exact_median_host(host, n_eff, refine)


def _mesh_rows(mesh, n_rows: int, n_eff: int) -> Optional[Tuple[int, int]]:
    """This rank's rows [lo, hi) of the valid block: its share of the patch
    axis padded to a multiple of the mesh size (``_place_for_mesh``), cut
    at ``n_eff``; None without a mesh (all rows)."""
    if mesh is None:
        return None
    share = -(-n_rows // mesh.size)
    lo = min(mesh.rank * share, n_eff)
    return lo, min(lo + share, n_eff)


def _blockwise_similarity_stats(feats, pos, lambda_h, lambda_g, labels: torch.Tensor,
                                num_clusters: int, n_valid: int, padded: bool,
                                block: int = 1024, bf16_exact: bool = False, mesh=None,
                                stripes=None):
    """EXACT statistics of the valid [n_eff, n_eff] similarity without
    materialising it: K1 stripes [<= block, n_eff] (``_similarity_stripes``),
    each folded into its moments and extrema, the intra-cluster sums and
    the level-1 bit-pattern histogram, then discarded.  Peak memory is
    O(block * N) instead of O(N^2).

    ``labels`` [N] are cluster ids, -1 on invalid rows.  The intra-cluster
    sums are the full path's one-hot products, a stripe at a time (no float
    atomics: the sums are the same on every run).  Each stripe's moments
    are one ``var_mean`` pass, combined across stripes in float64.

    Under ``mesh`` each rank folds the stripes of its rows
    (``_mesh_rows``) and the results are reduced over the ranks: SUM for
    the sums and counts, MIN / MAX for the extrema, and the moments
    combined in float64 as across stripes.  ``stripes`` replaces the K1
    stripes with given (first row, stripe) pairs (a rank's whole stripe of
    the mesh's full-statistics build).

    Returns (sum, sumsq [float64], min, max, s_cc [C], diag_c [C], level-1
    counts [_MED_FANOUT] int64) over the valid entries."""
    dev = feats.device
    n_eff = n_valid if padded else feats.shape[0]
    lab = labels[:n_eff].long()
    onehot = torch.zeros((n_eff, num_clusters), dtype=torch.float32, device=dev)
    onehot.scatter_(1, lab.clamp_min(0)[:, None], (lab >= 0).float()[:, None])
    bounds = _bin_bounds(0, _MED_L1_SHIFT, _MED_FANOUT, dev)
    hist = torch.zeros(_MED_FANOUT + 2, dtype=torch.int64, device=dev)
    s_cc = torch.zeros(num_clusters, dtype=torch.float32, device=dev)
    diag_all = torch.zeros(n_eff, dtype=torch.float32, device=dev)
    parts = [torch.tensor([0.0, 0.0, math.inf, -math.inf], dtype=torch.float32, device=dev)]
    sizes = [0]
    if stripes is None:
        stripes = _similarity_stripes(feats, pos, n_eff, lambda_h, lambda_g, bf16_exact, block,
                                      _mesh_rows(mesh, feats.shape[0], n_eff))
    for r0, K_blk in stripes:
        rows = K_blk.shape[0]
        if rows == 0:
            continue
        var, mean = torch.var_mean(K_blk, correction=0)
        mn, mx = torch.aminmax(K_blk)
        parts.append(torch.stack([mean, var, mn, mx]))
        sizes.append(rows * n_eff)
        s_cc += torch.sum(onehot[r0:r0 + rows] * (K_blk @ onehot), dim=0)
        diag_all[r0:r0 + rows] = torch.diagonal(K_blk[:, r0:r0 + rows])
        hist += _count_bins(K_blk, bounds)
    p = torch.stack(parts).double()
    c = torch.as_tensor(sizes, dtype=torch.float64, device=dev)
    local = c.sum()
    local_sum = torch.sum(c * p[:, 0])
    total, tsum = all_reduce(mesh, torch.stack([local, local_sum]))
    mean = tsum / total
    m2 = all_reduce(mesh, torch.sum(c * (p[:, 1] + (p[:, 0] - mean) ** 2)))
    diag_c = onehot.T @ diag_all
    mn = all_reduce(mesh, p[:, 2].min().float(), "min")
    mx = all_reduce(mesh, p[:, 3].max().float(), "max")
    s_cc, diag_c = all_reduce(mesh, torch.stack([s_cc, diag_c]))
    hist = all_reduce(mesh, hist)
    return (mean * total, m2 + total * mean * mean, mn, mx, s_cc, diag_c, hist[1:_MED_FANOUT + 1])


# ---------------------------------------------------------------------------
# The per-slide numeric core
# ---------------------------------------------------------------------------

def _generators(seed: int, device: torch.device) -> Tuple[torch.Generator, ...]:
    """Three independent generators on ``device`` (super-patch, grouping
    and hyperedge KMeans), where the JAX build splits one key three ways."""
    seeds = [int(s.generate_state(1)[0]) for s in np.random.SeedSequence(seed).spawn(3)]
    return tuple(torch.Generator(device=device).manual_seed(s) for s in seeds)


def _sample_rows(n_valid: Sequence[int], s: int, device) -> torch.Tensor:
    """[B, S] rows of each slide's statistics subsample: round(linspace(0, 1,
    S) * (n_valid - 1)) in float32, with jnp.linspace's grid as XLA computes
    it (i * float32(1 / (S - 1)), the last point exactly 1; torch.linspace
    differs in a few points, and then in the rows of about 1 n in 128).
    Computed on the CPU, so every device takes the same rows."""
    t = torch.zeros(1, dtype=torch.float32)
    if s > 1:
        t = torch.arange(s, dtype=torch.float32) * float(np.float32(1) / np.float32(s - 1))
        t[-1] = 1.0
    last = torch.tensor([float(n - 1) for n in n_valid], dtype=torch.float32)
    return torch.round(t[None, :] * last[:, None]).to(torch.int64).to(device)


def _fused_build(
    generators: Sequence[Sequence[torch.Generator]],
    feats: torch.Tensor,  # [B, N, D]   (N may be a padded bucket size)
    pos: torch.Tensor,  # [B, N, P]
    tma: torch.Tensor,  # [B, T, D]
    n_valid: Sequence[int],
    lambda_h: float,
    lambda_g: float,
    num_super: int,
    num_groups: int,
    k: int,
    num_hyperedges: int,
    cache_bf16: bool = True,
    full_stats: bool = True,
    ship_cache: bool = True,
    padded: bool = False,
    block_stats: bool = False,
    bf16_exact: bool = False,
    init_centers: Optional[Dict[str, torch.Tensor]] = None,
    mesh=None,
) -> Dict[str, torch.Tensor]:
    """The numeric pipeline of a chunk of B same-shape slides on the
    tensors' device; every output has a leading slide axis.  K1 (and K2
    above 4096 nodes) runs once per slide, and so does each matrix product
    (``slide_matmul``, so that a slide's outputs do not depend on its
    chunk); everything else, the three KMeans included, once for the
    chunk.  ``generators`` holds each slide's three generators
    (``_generators``).

    Statistics modes, as in the JAX build: ``full_stats`` (the whole [N, N]
    K; with ``ship_cache`` its packed upper triangle too, in bf16 under
    ``cache_bf16``), ``block_stats`` (exact statistics streamed over K1
    stripes; the median slot is NaN and ``med_cnt`` carries the level-1
    histogram for ``_attach_exact_median``), or neither (statistics of a
    <= 2048-point subsample).  ``padded``: only the first ``n_valid[b]``
    rows of slide b are real.

    ``init_centers`` maps "super", "group" and "hyperedge" to
    [B, N_INIT, k, D] starting centers for the three KMeans, replacing
    their kmeans++ draws.

    ``mesh`` (one slide, its whole rows gathered on every rank by
    ``_dispatch_build``): the O(N^2) work is sharded by rows.  Each rank
    runs K1 on its stripe of the valid block (``_mesh_rows``: one
    [N/n, N] launch in full statistics, ``sharded_combined_similarity``;
    [1024, N] stripes over its rows when streamed), its statistics are
    reduced over the ranks (``_blockwise_similarity_stats``) and the exact
    median is selected from bit-pattern counts summed over the ranks, so
    it equals the unsharded one bit for bit.  Everything O(N * D) (the
    KMeans, the super-patches, the grouping, the node KNN, the hyperedges)
    runs whole on every rank from the same generators, so its outputs are
    the unsharded build's."""
    if mesh is not None and feats.shape[0] != 1:
        raise ValueError("a mesh shards one slide's patch axis: build slides one at a time")
    if block_stats and full_stats:
        raise ValueError("block_stats streams the statistics that full_stats computes whole")
    if ship_cache and not full_stats:
        raise ValueError("the similarity cache needs the full [N, N] similarity")
    if padded and ship_cache:
        raise ValueError("a padded build cannot ship the exact-shape similarity cache")
    uploaded = feats  # as uploaded (bf16 under bf16 upload): what the stripes read
    feats = feats.float()
    pos = pos.float()
    tma = tma.float()
    b, n, _ = feats.shape
    dev = feats.device
    init = init_centers or {}
    n_valid = [int(v) for v in n_valid]
    mask = None
    if padded:
        mask = torch.arange(n, device=dev)[None, :] < torch.as_tensor(n_valid, device=dev)[:, None]

    sel = None
    if full_stats and mesh is None:  # under a mesh: the rank's stripe, below
        K = torch.empty((b, n, n), dtype=torch.float32, device=dev)
        for i in range(b):
            combined_similarity_auto(feats[i], pos[i], lambda_h, lambda_g,
                                     bf16_exact=bf16_exact, out=K[i])
    elif not (full_stats or block_stats):
        # [S, S] subsample for statistics only (valid rows only when padded)
        s = min(2048, n)
        sel = _sample_rows(n_valid if padded else [n] * b, s, dev)
        K = torch.empty((b, s, s), dtype=torch.float32, device=dev)
        for i in range(b):
            combined_similarity_auto(feats[i][sel[i]], pos[i][sel[i]], lambda_h, lambda_g,
                                     out=K[i])

    km = kmeans_batched(feats, num_super, [g[0] for g in generators], n_init=N_INIT, mask=mask,
                        init_centers=init.get("super"))
    onehot = torch.zeros((b, n, num_super), dtype=torch.float32, device=dev)
    onehot.scatter_(2, km.labels[..., None], 1.0)
    if padded:
        onehot = onehot * mask[..., None].float()
    counts = torch.sum(onehot, dim=1)  # [B, S]
    denom = torch.clamp_min(counts, 1.0)[..., None]
    onehot_t = onehot.transpose(1, 2)
    sp_feats = slide_matmul(onehot_t, feats) / denom
    sp_pos = slide_matmul(onehot_t, pos) / denom

    # intra-cluster mean off-diagonal similarity:
    # s_cc = 1_c^T K 1_c ; off-diag mean = (s_cc - sum(diag K within c)) / (n_c^2 - n_c)
    out: Dict[str, torch.Tensor] = {}
    if mesh is not None and full_stats:
        n_eff = n_valid[0] if padded else n
        lo, hi = _mesh_rows(mesh, n, n_eff)
        stripe = sharded_combined_similarity(
            mesh, feats[0, lo:hi], pos[0, lo:hi], lambda_h, lambda_g, bf16_exact=bf16_exact,
            columns=(feats[0, :n_eff], pos[0, :n_eff]))
        labels_eff = torch.where(mask, km.labels, -1) if padded else km.labels
        tsum, tsumsq, mn, mx, s_cc, diag_c, hist = _blockwise_similarity_stats(
            feats[0], pos[0], lambda_h, lambda_g, labels_eff[0], num_super, n_eff, True,
            mesh=mesh, stripes=[(lo, stripe)])
        bounds_of = functools.partial(_bin_bounds, device=dev)
        median = _exact_median_host(
            {"med_cnt": hist.cpu().numpy()}, n_eff,
            lambda lo_key, shift, nbins: all_reduce(
                mesh, _count_bins(stripe, bounds_of(lo_key, shift, nbins)))[1:nbins + 1].cpu().numpy())
        cnt = float(n_eff) ** 2
        mean = tsum / cnt
        std = torch.sqrt(torch.clamp_min(tsumsq / cnt - mean * mean, 0.0))
        K_stats = torch.stack([mean.float(), std.float(), mn, mx,
                               torch.tensor(median, dtype=torch.float32, device=dev)])[None]
        s_cc, diag_c, stat_counts = s_cc[None], diag_c[None], counts
        if ship_cache:
            K = all_gather_rows(mesh, stripe)[None]
    elif block_stats:
        labels_eff = torch.where(mask, km.labels, -1) if padded else km.labels
        parts = [
            _blockwise_similarity_stats(uploaded[i], pos[i], lambda_h, lambda_g, labels_eff[i],
                                        num_super, n_valid[i], padded, bf16_exact=bf16_exact,
                                        mesh=mesh)
            for i in range(b)
        ]
        s_cc = torch.stack([p[4] for p in parts])
        diag_c = torch.stack([p[5] for p in parts])
        out["med_cnt"] = torch.stack([p[6] for p in parts])
        stat_counts = counts
        k_stats = []
        for i, (tsum, tsumsq, mn, mx, *_) in enumerate(parts):
            cnt = float(n_valid[i] if padded else n) ** 2
            mean = tsum / cnt
            std = torch.sqrt(torch.clamp_min(tsumsq / cnt - mean * mean, 0.0))
            k_stats.append(torch.stack([mean.float(), std.float(), mn, mx,
                                        torch.tensor(torch.nan, device=dev)]))
        K_stats = torch.stack(k_stats)
    else:
        stat_onehot = onehot if full_stats else onehot[torch.arange(b, device=dev)[:, None], sel]
        KH = slide_matmul(K, stat_onehot)
        s_cc = torch.sum(stat_onehot * KH, dim=1)
        diag = torch.diagonal(K, dim1=1, dim2=2)[..., None]
        diag_c = slide_matmul(stat_onehot.transpose(1, 2), diag)[..., 0]
        stat_counts = counts if full_stats else torch.sum(stat_onehot, dim=1)
        K_stats = _matrix_stats_batch(
            K, mask[:, :, None] & mask[:, None, :] if padded and full_stats else None)
    pair_counts = stat_counts * stat_counts - stat_counts
    has_pairs = pair_counts > 0
    intra_mean_per = torch.where(
        has_pairs, (s_cc - diag_c) / torch.clamp_min(pair_counts, 1.0), torch.nan
    )
    # 0.0 (the reference's value) when every cluster is a singleton
    intra_mean = torch.where(
        torch.any(has_pairs, dim=1),
        torch.sum(torch.where(has_pairs, intra_mean_per, 0.0), dim=1)
        / torch.clamp_min(torch.sum(has_pairs, dim=1), 1),
        0.0,
    )

    sim = cross_similarity(sp_feats, tma, lambda_h)  # [B, S, T]
    group = kmeans_batched(sim, num_groups, [g[1] for g in generators], n_init=N_INIT,
                           init_centers=init.get("group"))

    all_feats = torch.cat([sp_feats, tma], dim=1)
    n_total = all_feats.shape[1]
    _, knn_idx = knn_indices_auto(all_feats, min(k + 1, n_total))
    he = kmeans_batched(all_feats, num_hyperedges, [g[2] for g in generators], n_init=N_INIT,
                        init_centers=init.get("hyperedge"))
    normed = all_feats / (torch.linalg.norm(all_feats, dim=-1, keepdim=True) + 1e-12)

    if ship_cache:
        # K is symmetric: ship the packed upper triangle (np.triu_indices order)
        K_packed = K[:, torch.ones((n, n), dtype=torch.bool, device=dev).triu_()]
        out["K"] = K_packed.to(torch.bfloat16) if cache_bf16 else K_packed
    return {
        **out,
        "K_stats": K_stats,
        "labels": km.labels,
        "counts": counts,
        "sp_feats": sp_feats,
        "sp_pos": sp_pos,
        "intra_mean": intra_mean,
        "sim": sim,
        "sim_stats": _matrix_stats_batch(sim),
        "group_labels": group.labels,
        "knn_idx": knn_idx,
        "hyperedge_labels": he.labels,
        "normed": normed,
    }


def _to_host_start(out: Dict[str, torch.Tensor]):
    """Start the device->host copies of a chunk's outputs; returns the host
    tensors and the event to wait on (None on the CPU)."""
    if not any(v.is_cuda for v in out.values()):
        return out, None
    host = {k: v.to("cpu", non_blocking=True) for k, v in out.items()}
    event = torch.cuda.Event()
    event.record()
    return host, event


def _to_host_finish(host, event) -> Dict[str, np.ndarray]:
    if event is not None:
        event.synchronize()
    return {
        k: (v.float() if v.dtype == torch.bfloat16 else v).numpy() for k, v in host.items()
    }


# ---------------------------------------------------------------------------
# Host-side assembly and persistence
# ---------------------------------------------------------------------------

def _hypergraph_arrays(
    sp_feats, sp_pos, tma_features, edge_index, edge_weights, group_labels,
    wsi_similarity_matrix=None, wsi_tma_similarity_matrix=None,
) -> Dict[str, np.ndarray]:
    arrays = {
        "wsi_super/features": sp_feats,
        "wsi_super/positions": sp_pos,
        "tma/features": tma_features,
        "edge_index": edge_index,
        "edge_weights": edge_weights,
        "group_labels": np.asarray(group_labels, np.int64),
    }
    if wsi_similarity_matrix is not None:
        arrays["similarity/wsi_internal"] = wsi_similarity_matrix
    if wsi_tma_similarity_matrix is not None:
        arrays["similarity/wsi_tma"] = wsi_tma_similarity_matrix
    return arrays


def save_hypergraph(
    h5_path, sp_feats, sp_pos, tma_features, edge_index, edge_weights,
    group_labels, stats, wsi_similarity_matrix=None, wsi_tma_similarity_matrix=None,
):
    write_hypergraph_group(
        h5_path,
        _hypergraph_arrays(
            sp_feats, sp_pos, tma_features, edge_index, edge_weights, group_labels,
            wsi_similarity_matrix, wsi_tma_similarity_matrix,
        ),
        stats=stats,
    )


def _assemble_edges(knn_idx: np.ndarray, hyperedge_labels: np.ndarray, normed: np.ndarray, num_hyperedges: int):
    """KNN pairs (self in slot 0 dropped) + KMeans-clique expansion,
    canonical dedup, cosine weights clamped at 0."""
    n_total = normed.shape[0]
    src = np.repeat(np.arange(n_total), knn_idx.shape[1] - 1)
    dst = knn_idx[:, 1:].reshape(-1)
    pairs = [np.stack([src, dst], axis=1)]
    for he in range(num_hyperedges):
        nodes = np.where(hyperedge_labels == he)[0]
        if len(nodes) > 1:
            a, b = np.meshgrid(nodes, nodes, indexing="ij")
            sel = a != b
            pairs.append(np.stack([a[sel], b[sel]], axis=1))
    und = np.unique(np.sort(np.concatenate(pairs), axis=1), axis=0)
    if und.size == 0:
        return np.empty((2, 0), np.int64), np.empty((0,), np.float32)
    w = np.einsum("ed,ed->e", normed[und[:, 0]], normed[und[:, 1]])
    return und.T.astype(np.int64), np.maximum(w, 0.0).astype(np.float32)


def _assemble_result(
    n_patches, tma_features, host, save_similarity, num_wsi_super_patches,
    num_groups, hypergraph_k, num_hyperedges,
) -> Tuple[Dict, Dict[str, np.ndarray]]:
    """(stats, hypergraph arrays) of one slide from its host outputs."""
    if (host["counts"] == 0).any():
        raise ValueError(
            "empty cluster in super-patch aggregation "
            f"(n={n_patches} < num_super_patches={num_wsi_super_patches}?)"
        )
    K_full = _unpack_triu(host["K"], n_patches) if save_similarity else None
    edge_index, edge_weights = _assemble_edges(
        host["knn_idx"], host["hyperedge_labels"], host["normed"], num_hyperedges
    )
    group_labels = host["group_labels"].astype(np.int64)
    stats = {
        "wsi_aggregation": {
            "num_original_patches": int(n_patches),
            "num_super_patches": int(num_wsi_super_patches),
            "avg_intra_cluster_similarity": float(host["intra_mean"]),
            "wsi_similarity_matrix_stats": _stats_dict(host["K_stats"]),
        },
        "similarity": _stats_dict(host["sim_stats"]),
        "grouping": {
            "method": "kmeans",
            "num_groups": int(num_groups),
            "group_sizes": np.bincount(group_labels, minlength=num_groups).tolist(),
        },
        "hypergraph": {
            "num_nodes": int(host["sp_feats"].shape[0] + tma_features.shape[0]),
            "num_wsi_super_patches": int(host["sp_feats"].shape[0]),
            "num_tma_patches": int(tma_features.shape[0]),
            "num_edges": int(edge_index.shape[1]),
            "num_hyperedges": int(num_hyperedges),
            "k": int(hypergraph_k),
        },
    }
    arrays = _hypergraph_arrays(
        host["sp_feats"], host["sp_pos"], tma_features, edge_index, edge_weights,
        group_labels, K_full, host["sim"] if save_similarity else None,
    )
    return stats, arrays


def _finalize_host(
    case_id, h5_rel_path, h5_path, n_patches, tma_features, host, save_similarity,
    num_wsi_super_patches, num_groups, hypergraph_k, num_hyperedges,
    raise_errors: bool = False, write: bool = True,
):
    """Edge assembly + stats + HDF5 write for one slide's outputs; runs on
    a thread pool so it overlaps other slides' device work.  Errors are
    isolated per file, except under ``raise_errors``.  ``write=False`` (a
    mesh rank other than 0) returns the stats without writing."""
    try:
        stats, arrays = _assemble_result(
            n_patches, tma_features, host, save_similarity, num_wsi_super_patches,
            num_groups, hypergraph_k, num_hyperedges,
        )
        if write:
            write_hypergraph_group(h5_path, arrays, stats=stats)
        if case_id is not None:
            stats["case_id"] = case_id
            stats["h5_path"] = h5_rel_path
        stats["num_patches_processed"] = int(n_patches)
        return stats
    except Exception as e:
        if raise_errors:
            raise
        return {"case_id": case_id, "error": str(e)}


# ---------------------------------------------------------------------------
# Entry points
# ---------------------------------------------------------------------------

def _upload_dt(upload_dtype: str) -> torch.dtype:
    """Dtype features/TMA are uploaded in (compute is always f32).
    ``bfloat16`` halves the host->device bytes and quantises the input."""
    if upload_dtype not in ("float32", "bfloat16"):
        raise ValueError(f"upload_dtype must be float32|bfloat16, got {upload_dtype!r}")
    return torch.bfloat16 if upload_dtype == "bfloat16" else torch.float32


def _stats_modes(save_similarity: bool, n: int) -> Tuple[bool, bool]:
    """(full_stats, block_stats) for a slide of ``n`` patches: the whole
    [N, N] when it is cached or fits ``FULL_STATS_MAX_N``; above that,
    exact blockwise statistics unless ``LARGE_N_STATS`` asks for the
    subsample."""
    full = save_similarity or n <= FULL_STATS_MAX_N
    return full, (not full) and LARGE_N_STATS == "blockwise"


def _bucketed(wsi_features, wsi_positions, bucket_patches):
    """Pad the patch axis up to the next multiple of ``bucket_patches``."""
    n = wsi_features.shape[0]
    n_pad = ((n + bucket_patches - 1) // bucket_patches) * bucket_patches
    if n_pad == n:
        return wsi_features, wsi_positions, n, False
    f = np.zeros((n_pad, wsi_features.shape[1]), np.float32)
    f[:n] = wsi_features
    p = np.zeros((n_pad, wsi_positions.shape[1]), np.float32)
    p[:n] = wsi_positions
    return f, p, n, True


def _stacked(arrays) -> torch.Tensor:
    """One host tensor [B, ...] of same-shape arrays (no copy for one)."""
    if len(arrays) == 1:
        return torch.as_tensor(np.asarray(arrays[0]))[None]
    return torch.as_tensor(np.stack([np.asarray(a) for a in arrays]))


def _place_for_mesh(mesh, feats: np.ndarray, pos: np.ndarray):
    """This rank's row block of one slide's patch axis, zero-padded up to
    a multiple of the mesh size (counterpart of the JAX build's
    ``_place_for_mesh``): (feature rows, position rows, padded).  The pad
    rows lie outside the valid block, so no statistic and no KMeans sees
    them (the JAX package's masked build)."""
    n = feats.shape[0]
    n_pad = -(-n // mesh.size) * mesh.size
    pad = n_pad != n
    if pad:
        feats = np.concatenate([feats, np.zeros((n_pad - n,) + feats.shape[1:], feats.dtype)])
        pos = np.concatenate([pos, np.zeros((n_pad - n,) + pos.shape[1:], pos.dtype)])
    rows = rows_of(mesh, n_pad)
    return feats[rows], pos[rows], pad


@dataclass
class _Dispatched:
    """A chunk whose build was launched: per-slide valid counts, the host
    copies in flight, and, for streamed statistics, what the exact-median
    sweeps read (the slides as uploaded, kept on the device until drained)."""
    n_valid: List[int]
    host: Dict
    event: object
    feats: Optional[torch.Tensor] = None
    pos: Optional[torch.Tensor] = None
    padded: bool = False
    bf16_exact: bool = False
    mesh: object = None


def _dispatch_build(
    slides, device, num_wsi_super_patches, num_groups, hypergraph_k,
    num_hyperedges, lambda_h, lambda_g, seed, save_similarity, bucket_patches,
    upload_dtype, init_centers=None, mesh=None,
) -> _Dispatched:
    """Upload a chunk of slides [(features, positions, tma), ...] whose
    arrays share their shapes once bucketed, run ``_fused_build`` once for
    the chunk and start the copies back.  Every slide draws from its own
    three generators, seeded from ``seed`` as a slide built alone is.

    Under ``mesh`` (one slide) each rank uploads its row block
    (``_place_for_mesh``) and the blocks are all-gathered into the whole
    slide on every rank, for the replicated O(N * D) stages and as the
    column copies of the rank's K1 stripes."""
    if bucket_patches and save_similarity:
        raise ValueError(
            "bucket_patches requires save_similarity=False (the persisted "
            "[N,N] cache keeps exact shapes)"
        )
    feats, pos, n_valid, padded = [], [], [], False
    for f, p, _ in slides:
        nv = f.shape[0]
        if bucket_patches:
            f, p, nv, pad = _bucketed(f, p, bucket_patches)
            padded |= pad
        feats.append(f)
        pos.append(p)
        n_valid.append(nv)
    full_stats, block_stats = _stats_modes(save_similarity, feats[0].shape[0])
    dt = _upload_dt(upload_dtype)
    bf16_exact = upload_dtype == "bfloat16"
    if mesh is not None:
        if len(slides) != 1:
            raise ValueError("a mesh shards one slide's patch axis: build slides one at a time")
        n_rows = feats[0].shape[0]
        f_rows, p_rows, mesh_pad = _place_for_mesh(mesh, np.asarray(feats[0]),
                                                   np.asarray(pos[0], np.float32))
        if mesh_pad and save_similarity:
            raise ValueError(
                "mesh-sharded build needs the patch count to divide the mesh size when "
                "save_similarity=True (the persisted cache keeps exact shapes); use "
                "save_similarity=False")
        feats_dev = all_gather_rows(mesh, torch.as_tensor(f_rows).to(device=device, dtype=dt))
        pos_dev = all_gather_rows(mesh, torch.as_tensor(p_rows).to(device))
        feats_dev, pos_dev = feats_dev[None, :n_rows], pos_dev[None, :n_rows]
    else:
        feats_dev = _stacked(feats).to(device=device, dtype=dt)
        pos_dev = _stacked([np.asarray(p, np.float32) for p in pos]).to(device)
    out = _fused_build(
        [_generators(seed, device) for _ in slides], feats_dev, pos_dev,
        _stacked([t for _, _, t in slides]).to(device=device, dtype=dt),
        n_valid, lambda_h, lambda_g,
        num_wsi_super_patches, num_groups, hypergraph_k, num_hyperedges,
        full_stats=full_stats, ship_cache=save_similarity, padded=padded,
        block_stats=block_stats, bf16_exact=bf16_exact, init_centers=init_centers, mesh=mesh,
    )
    host, event = _to_host_start(out)
    if not block_stats:
        return _Dispatched(n_valid, host, event)
    return _Dispatched(n_valid, host, event, feats_dev, pos_dev, padded, bf16_exact, mesh)


def _collect(d: _Dispatched, lambda_h, lambda_g) -> List[Dict[str, np.ndarray]]:
    """Each slide's host outputs of a dispatched chunk, with the exact
    blockwise median attached."""
    host = _to_host_finish(d.host, d.event)
    slides = [{k: v[i] for k, v in host.items()} for i in range(len(d.n_valid))]
    for i, h in enumerate(slides):
        if d.feats is not None:
            _attach_exact_median(h, d.n_valid[i], d.feats[i], d.pos[i], lambda_h, lambda_g,
                                 d.padded, bf16_exact=d.bf16_exact, mesh=d.mesh)
    return slides


def process_arrays(
    wsi_features: np.ndarray,
    wsi_positions: np.ndarray,
    tma_features: np.ndarray,
    num_wsi_super_patches: int = 100,
    num_groups: int = 10,
    hypergraph_k: int = 5,
    num_hyperedges: int = 10,
    lambda_h: float = 1.0,
    lambda_g: float = 1.0,
    seed: int = 42,
    save_similarity: bool = True,
    bucket_patches: Optional[int] = None,
    upload_dtype: str = "float32",
    device=None,
    init_centers: Optional[Dict[str, torch.Tensor]] = None,
    mesh=None,
) -> Dict:
    """Build one slide's hypergraph from in-memory arrays, writing nothing.

    Returns {"stats": the stats dict, "arrays": the ``hypergraph/`` group's
    arrays by key, "host": the device outputs as numpy (super-patch
    ``labels``, ``K_stats``, ``intra_mean``, ``sim``, ...)}.
    ``init_centers`` maps "super", "group" and "hyperedge" to [N_INIT, k, D]
    starting centers.  ``mesh``: the slide's patch axis sharded over the
    mesh's ranks (``_fused_build``); every rank returns the same result."""
    dev = _build_device(mesh, device)
    tma_features = np.asarray(tma_features, np.float32)
    d = _dispatch_build(
        [(wsi_features, wsi_positions, tma_features)], dev, num_wsi_super_patches,
        num_groups, hypergraph_k, num_hyperedges, lambda_h, lambda_g, seed,
        save_similarity, bucket_patches, upload_dtype,
        None if init_centers is None else {k: v[None] for k, v in init_centers.items()},
        mesh,
    )
    host = _collect(d, lambda_h, lambda_g)[0]
    stats, arrays = _assemble_result(
        d.n_valid[0], tma_features, host, save_similarity, num_wsi_super_patches,
        num_groups, hypergraph_k, num_hyperedges,
    )
    stats["num_patches_processed"] = int(d.n_valid[0])
    return {"stats": stats, "arrays": arrays, "host": host}


def process_single_file(
    h5_path,
    num_wsi_super_patches: int = 100,
    num_groups: int = 10,
    hypergraph_k: int = 5,
    num_hyperedges: int = 10,
    lambda_h: float = 1.0,
    lambda_g: float = 1.0,
    seed: int = 42,
    save_similarity: bool = True,
    bucket_patches: Optional[int] = None,
    mesh=None,
    upload_dtype: str = "float32",
    device=None,
    init_centers: Optional[Dict[str, torch.Tensor]] = None,
) -> Dict:
    """Build one HDF5 file's hypergraph and write its ``hypergraph/`` group;
    errors raise.  ``mesh``: the slide's patch axis sharded over the mesh's
    ranks; rank 0 writes the group while the others wait, and every rank
    returns the stats."""
    dev = _build_device(mesh, device)
    wsi_features, wsi_positions = load_wsi_data(h5_path)
    tma_features = load_tma_data(h5_path)
    if tma_features is None:
        return {"status": "skipped", "reason": "no_tma"}
    d = _dispatch_build(
        [(wsi_features, wsi_positions, tma_features)], dev, num_wsi_super_patches,
        num_groups, hypergraph_k, num_hyperedges, lambda_h, lambda_g, seed,
        save_similarity, bucket_patches, upload_dtype,
        None if init_centers is None else {k: v[None] for k, v in init_centers.items()},
        mesh,
    )
    stats = _finalize_host(
        None, None, h5_path, d.n_valid[0], tma_features, _collect(d, lambda_h, lambda_g)[0],
        save_similarity, num_wsi_super_patches, num_groups, hypergraph_k,
        num_hyperedges, raise_errors=True, write=mesh is None or mesh.is_main,
    )
    barrier(mesh)
    return stats


def _build_device(mesh, device) -> torch.device:
    """The build's device: the mesh rank's under a mesh."""
    return resolve_device(device) if mesh is None else mesh.device


def _read_csv_rows(csv_path) -> List[Dict[str, str]]:
    with open(csv_path, newline="") as f:
        reader = csv.DictReader(f)
        if "h5_file_path" not in (reader.fieldnames or []):
            raise ValueError("CSV must contain 'h5_file_path' column")
        return list(reader)


def _case_of(idx, row) -> str:
    return str(row.get("case_id") or f"case_{idx}")


def _summary(all_stats, t0, dev, output_stats_path, write: bool = True):
    total_patches = sum(s.get("num_patches_processed", 0) for s in all_stats)
    elapsed = time.time() - t0
    summary = {
        "files": len(all_stats),
        "total_patches": total_patches,
        "elapsed_s": elapsed,
        "patches_per_sec": total_patches / elapsed if elapsed > 0 else 0.0,
        "device": str(dev),
    }
    if output_stats_path and write:
        Path(output_stats_path).write_text(
            json.dumps({"summary": summary, "files": all_stats}, indent=2, default=_json_default)
        )
    return summary


def process_dataset(
    csv_path,
    data_root_dir,
    num_wsi_super_patches: int = 100,
    num_groups: int = 10,
    hypergraph_k: int = 5,
    num_hyperedges: int = 10,
    lambda_h: float = 1.0,
    lambda_g: float = 1.0,
    output_stats_path=None,
    seed: int = 42,
    save_similarity: bool = True,
    pipeline_depth: int = 3,
    file_batch: int = 1,
    bucket_patches: Optional[int] = None,
    mesh=None,
    upload_dtype: str = "float32",
    skip_existing: bool = False,
    device=None,
):
    """Dataset-level build, software-pipelined: up to ``pipeline_depth``
    slides are built and their device->host copies started before the
    oldest is drained; edge assembly and HDF5 writes run on a 2-thread pool
    so they overlap later slides.  ``file_batch > 1`` builds chunks of
    same-shape files at once (``_process_dataset_batched``).  Results come
    back in CSV order; per-file errors are isolated.  Returns (per-file
    stats, summary).

    ``mesh``: shard each slide's patch axis over the mesh's ranks
    (``_fused_build``), intra-slide parallelism, exclusive with
    ``file_batch``.  Every rank reads each file and builds it with the
    others; rank 0 writes the groups and the stats file, and the others
    wait for it at a barrier before returning."""
    _upload_dt(upload_dtype)
    if bucket_patches and save_similarity:
        raise ValueError(
            "bucket_patches requires save_similarity=False (the persisted "
            "[N,N] cache keeps exact shapes) — pass save_similarity=False / "
            "--no_save_similarity"
        )
    if mesh is not None and file_batch > 1:
        raise ValueError(
            "mesh (intra-slide sharding) and file_batch (inter-file batching) are mutually "
            "exclusive"
        )
    dev = _build_device(mesh, device)
    is_main = mesh is None or mesh.is_main
    rows = list(enumerate(_read_csv_rows(csv_path)))

    all_stats: list = []
    if skip_existing:
        keep = []
        for idx, row in rows:
            h5_path = os.path.join(str(data_root_dir), row["h5_file_path"])
            if os.path.exists(h5_path) and has_complete_hypergraph(
                h5_path, require_similarity=save_similarity
            ):
                all_stats.append({
                    "case_id": _case_of(idx, row), "status": "skipped",
                    "reason": "existing_hypergraph",
                })
            else:
                keep.append((idx, row))
        rows = keep
        barrier(mesh)  # every rank has read the files before rank 0 writes
    t0 = time.time()
    build_args = (num_wsi_super_patches, num_groups, hypergraph_k, num_hyperedges, lambda_h,
                  lambda_g, seed, save_similarity, bucket_patches, upload_dtype)
    if file_batch > 1:
        all_stats += _process_dataset_batched(rows, data_root_dir, dev, file_batch, build_args)
        return all_stats, _summary(all_stats, t0, dev, output_stats_path)

    pending: deque = deque()
    results: list = []  # (future or None, immediate result) in CSV order

    def dispatch(idx, row):
        h5_path = os.path.join(str(data_root_dir), row["h5_file_path"])
        if not os.path.exists(h5_path):
            return None
        wsi_features, wsi_positions = load_wsi_data(h5_path)
        tma_features = load_tma_data(h5_path)
        if tma_features is None:
            return (idx, row, h5_path, None, None)
        d = _dispatch_build([(wsi_features, wsi_positions, tma_features)], dev, *build_args,
                            mesh=mesh)
        return (idx, row, h5_path, tma_features, d)

    with ThreadPoolExecutor(max_workers=2) as pool:

        def drain(item):
            idx, row, h5_path, tma_features, d = item
            case_id = _case_of(idx, row)
            if d is None:
                results.append((None, {"case_id": case_id, "status": "skipped", "reason": "no_tma"}))
                return
            try:
                host = _collect(d, lambda_h, lambda_g)[0]
            except Exception as e:  # per-file isolation, as in the JAX process_dataset
                results.append((None, {"case_id": case_id, "error": str(e)}))
                return
            fut = pool.submit(
                _finalize_host, case_id, row["h5_file_path"], h5_path, d.n_valid[0],
                tma_features, host, save_similarity, num_wsi_super_patches,
                num_groups, hypergraph_k, num_hyperedges, write=is_main,
            )
            results.append((fut, None))

        for idx, row in rows:
            try:
                item = dispatch(idx, row)
            except Exception as e:  # per-file isolation, as in the JAX process_dataset
                results.append((None, {"case_id": _case_of(idx, row), "error": str(e)}))
                continue
            if item is None:
                continue
            pending.append(item)
            if len(pending) >= pipeline_depth:
                drain(pending.popleft())
        while pending:
            drain(pending.popleft())
        for fut, immediate in results:
            all_stats.append(immediate if fut is None else fut.result())
    barrier(mesh)
    return all_stats, _summary(all_stats, t0, dev, output_stats_path, write=is_main)


# A batched build's [B, N, N] similarity stays under ~4 GB f32, and at most
# this many dispatched chunks hold device outputs before the oldest drains.
_BATCH_K_ELEM_BUDGET = 1 << 30
_MAX_INFLIGHT_CHUNKS = 3


def _effective_file_batch(file_batch: int, n: int, full_stats: bool, d: int = 1024) -> int:
    """Slides a chunk of ``n``-patch slides may hold under the device
    budget: [B, N, N] similarities in full-statistics groups; in streamed
    groups (N > FULL_STATS_MAX_N) the [B, N, D] features plus ~4 stripe
    temporaries [B, 1024, N]."""
    if not full_stats:
        per_file_elems = n * d + 4 * 1024 * n
        return max(1, min(file_batch, _BATCH_K_ELEM_BUDGET // max(per_file_elems, 1)))
    return max(1, min(file_batch, _BATCH_K_ELEM_BUDGET // max(n * n, 1)))


def _process_dataset_batched(rows, data_root_dir, dev, file_batch, build_args) -> List[Dict]:
    """Batched dataset build: files are grouped by their full array shapes
    (N_patches, feature dim, position dim, N_tma, TMA dim), read from the
    HDF5 headers only, and each group is built in chunks of up to
    ``file_batch`` (``_effective_file_batch``) through one ``_fused_build``
    call.  Every file draws from generators seeded as a file built alone
    is, so its outputs are its ``file_batch=1`` outputs.

    A chunk's arrays load just before its dispatch, and at most
    ``_MAX_INFLIGHT_CHUNKS`` chunks are in flight before the oldest is
    drained.  Load and dispatch errors, missing files and no-TMA skips stay
    per file or per chunk; results come back in CSV order.  With
    ``bucket_patches`` the patch axis of the group key is rounded up to the
    bucket, so slides of different patch counts share a chunk."""
    (num_super, num_groups, hypergraph_k, num_hyperedges, lambda_h, lambda_g, _seed,
     save_similarity, bucket_patches, _upload) = build_args
    results: Dict[int, Dict] = {}
    groups: Dict[Tuple, list] = {}
    for order, (idx, row) in enumerate(rows):
        h5_path = os.path.join(str(data_root_dir), row["h5_file_path"])
        if not os.path.exists(h5_path):
            continue
        try:
            shape_key = _shape_key(h5_path)
        except Exception as e:
            results[order] = {"case_id": _case_of(idx, row), "error": str(e)}
            continue
        if shape_key is None:
            results[order] = {"case_id": _case_of(idx, row), "status": "skipped", "reason": "no_tma"}
            continue
        if bucket_patches:
            n_pad = -(-shape_key[0] // bucket_patches) * bucket_patches
            shape_key = (n_pad,) + shape_key[1:]
        groups.setdefault(shape_key, []).append((order, idx, row, h5_path))

    futures = []  # (order, future)
    inflight: deque = deque()

    def fail(items, e):
        for order, idx, row, *_ in items:
            results[order] = {"case_id": _case_of(idx, row), "error": str(e)}

    with ThreadPoolExecutor(max_workers=2) as pool:

        def drain(meta, d):
            try:
                hosts = _collect(d, lambda_h, lambda_g)
            except Exception as e:
                fail(meta, e)
                return
            for (order, idx, row, h5_path, tma), host, nv in zip(meta, hosts, d.n_valid):
                futures.append((order, pool.submit(
                    _finalize_host, _case_of(idx, row), row["h5_file_path"], h5_path, nv, tma,
                    host, save_similarity, num_super, num_groups, hypergraph_k, num_hyperedges,
                )))

        for shape_key, items in groups.items():
            n = shape_key[0]
            full_stats, _ = _stats_modes(save_similarity, n)
            eff = _effective_file_batch(file_batch, n, full_stats)
            for start in range(0, len(items), eff):
                slides, meta = [], []
                for order, idx, row, h5_path in items[start:start + eff]:
                    try:
                        feats, pos = load_wsi_data(h5_path)
                        tma = load_tma_data(h5_path)
                    except Exception as e:
                        fail([(order, idx, row)], e)
                        continue
                    slides.append((feats, pos, tma))
                    meta.append((order, idx, row, h5_path, tma))
                if not slides:
                    continue
                try:
                    d = _dispatch_build(slides, dev, *build_args)
                except Exception as e:
                    fail(meta, e)
                    continue
                inflight.append((meta, d))
                if len(inflight) >= _MAX_INFLIGHT_CHUNKS:
                    drain(*inflight.popleft())
        while inflight:
            drain(*inflight.popleft())
        for order, fut in futures:
            results[order] = fut.result()
    return [results[o] for o in sorted(results)]


# ---------------------------------------------------------------------------
# Stage-wise functions (the JAX package's public API)
# ---------------------------------------------------------------------------

def _f32_on(x, dev: torch.device) -> torch.Tensor:
    """A float32 copy of the array ``x`` on ``dev`` (a copy: JAX's and h5py's
    arrays may be read-only)."""
    return torch.tensor(np.asarray(x, np.float32), device=dev)


def _stage_generator(seed: int, dev: torch.device) -> torch.Generator:
    """One stage's generator, where the JAX stage takes jax.random.key(seed)."""
    return torch.Generator(device=dev).manual_seed(int(seed))


def aggregate_wsi_super_patches(
    wsi_features: np.ndarray,
    wsi_positions: np.ndarray,
    num_super_patches: int,
    lambda_h: float = 1.0,
    lambda_g: float = 1.0,
    seed: int = 42,
    wsi_similarity_matrix: Optional[np.ndarray] = None,
    compute_similarity: bool = True,
    device=None,
    init_centers: Optional[torch.Tensor] = None,
) -> Tuple[np.ndarray, np.ndarray, Dict, Optional[np.ndarray]]:
    """KMeans over the raw features; per-cluster mean features and
    positions; intra-cluster similarity statistics from the (cached)
    combined similarity, computed by K1 when not given.  Returns
    (super-patch features, positions, stats, K)."""
    dev = resolve_device(device)
    feats = _f32_on(wsi_features, dev)
    pos = _f32_on(wsi_positions, dev)
    n = feats.shape[0]
    if wsi_similarity_matrix is not None:
        K_wsi = np.asarray(wsi_similarity_matrix)
    elif compute_similarity:
        K_wsi = combined_similarity_auto(feats, pos, lambda_h, lambda_g).cpu().numpy()
    else:
        K_wsi = None

    res = kmeans(feats, num_super_patches, _stage_generator(seed, dev), n_init=N_INIT,
                 init_centers=init_centers)
    labels = res.labels.cpu().numpy()
    onehot = torch.zeros((n, num_super_patches), dtype=torch.float32, device=dev)
    onehot.scatter_(1, res.labels[:, None], 1.0)
    counts = torch.sum(onehot, dim=0)
    if bool(torch.any(counts == 0)):
        raise ValueError("empty cluster in super-patch aggregation")
    sp_feats = ((onehot.T @ feats) / counts[:, None]).cpu().numpy()
    sp_pos = ((onehot.T @ pos) / counts[:, None]).cpu().numpy()

    stats: Dict = {"num_original_patches": int(n), "num_super_patches": int(num_super_patches)}
    if K_wsi is not None:
        # intra-cluster mean off-diagonal similarity, averaged over clusters
        intra = []
        for c in range(num_super_patches):
            idx = np.where(labels == c)[0]
            if len(idx) > 1:
                sub = K_wsi[np.ix_(idx, idx)]
                intra.append(float(sub[~np.eye(len(idx), dtype=bool)].mean()))
        stats["avg_intra_cluster_similarity"] = float(np.mean(intra)) if intra else 0.0
        stats["wsi_similarity_matrix_stats"] = _matrix_stats(K_wsi)
    return sp_feats, sp_pos, stats, K_wsi


def compute_wsi_tma_similarity(
    wsi_super_features: np.ndarray,
    tma_features: np.ndarray,
    lambda_h: float = 1.0,
    device=None,
) -> Tuple[np.ndarray, Dict]:
    """Morphological-only similarity [S, T] (no spatial term across
    modalities) and its statistics."""
    dev = resolve_device(device)
    sim = cross_similarity(
        _f32_on(wsi_super_features, dev), _f32_on(tma_features, dev), lambda_h,
    ).cpu().numpy()
    return sim, _matrix_stats(sim)


def group_by_similarity(
    similarity_matrix: np.ndarray,
    num_groups: int,
    method: str = "kmeans",
    seed: int = 42,
    device=None,
    init_centers: Optional[torch.Tensor] = None,
) -> Tuple[np.ndarray, Dict]:
    """Group the rows of a similarity matrix: KMeans on the rows
    (``kmeans``), or KMeans on each row's most similar column under the
    cosine of similarity rows (``knn``, square matrices only)."""
    dev = resolve_device(device)
    if method == "kmeans":
        x = np.asarray(similarity_matrix, np.float32)
    elif method == "knn":
        k = min(num_groups, similarity_matrix.shape[1])
        rows = similarity_matrix / (np.linalg.norm(similarity_matrix, axis=1, keepdims=True) + 1e-12)
        cols = similarity_matrix.T / (np.linalg.norm(similarity_matrix.T, axis=1, keepdims=True) + 1e-12)
        if rows.shape[1] != cols.shape[1]:
            raise ValueError("knn grouping requires square-compatible similarity")
        x = np.argmax(rows @ cols.T, axis=1).astype(np.float32).reshape(-1, 1)
    else:
        raise ValueError(f"Unknown grouping method: {method}")
    res = kmeans(_f32_on(x, dev), num_groups, _stage_generator(seed, dev),
                 n_init=N_INIT, init_centers=init_centers)
    labels = res.labels.cpu().numpy()
    stats = {"method": method, "num_groups": int(num_groups)}
    if method == "knn":
        stats["k"] = int(k)
    stats["group_sizes"] = [int((labels == i).sum()) for i in range(num_groups)]
    return labels, stats


def build_hypergraph_knn_kmeans(
    wsi_super_features: np.ndarray,
    tma_features: np.ndarray,
    group_labels: Optional[np.ndarray] = None,
    k: int = 5,
    num_hyperedges: int = 10,
    seed: int = 42,
    device=None,
    init_centers: Optional[torch.Tensor] = None,
) -> Tuple[np.ndarray, np.ndarray, Dict]:
    """KNN pairs + KMeans-clique hyperedges over the super-patches and TMA
    cores, with cosine weights (the fused build's ``_assemble_edges``).
    ``group_labels`` is accepted and unused, as in the reference."""
    dev = resolve_device(device)
    all_feats = np.concatenate([wsi_super_features, tma_features], axis=0).astype(np.float32)
    n_total = all_feats.shape[0]
    fa = _f32_on(all_feats, dev)
    _, idx = knn_indices_auto(fa, min(k + 1, n_total))
    res = kmeans(fa, num_hyperedges, _stage_generator(seed, dev), n_init=N_INIT,
                 init_centers=init_centers)
    norm = all_feats / (np.linalg.norm(all_feats, axis=1, keepdims=True) + 1e-12)
    edge_index, w = _assemble_edges(idx.cpu().numpy(), res.labels.cpu().numpy(), norm,
                                    num_hyperedges)
    if edge_index.size == 0:
        return edge_index, w, {"num_nodes": int(n_total), "num_edges": 0}
    stats = {
        "num_nodes": int(n_total),
        "num_wsi_super_patches": int(wsi_super_features.shape[0]),
        "num_tma_patches": int(tma_features.shape[0]),
        "num_edges": int(edge_index.shape[1]),
        "num_hyperedges": int(num_hyperedges),
        "k": int(k),
    }
    return edge_index, w, stats


# ---------------------------------------------------------------------------
# Similarity caches and the rebuild from them
# ---------------------------------------------------------------------------

def rebuild_hypergraph_from_similarity(
    h5_path,
    num_wsi_super_patches: Optional[int] = None,
    num_groups: Optional[int] = None,
    hypergraph_k: int = 5,
    num_hyperedges: int = 10,
    threshold_median_ratio: Optional[float] = None,
    seed: int = 42,
    device=None,
    init_centers: Optional[Dict[str, torch.Tensor]] = None,
) -> Dict:
    """Re-tune one file's hypergraph from its cached similarity matrices
    through the stage-wise functions, and rewrite its ``hypergraph/``
    group.  Without a cached [N, N] K it is computed by K1 at lambda_h =
    lambda_g = 1, whatever the build used (as the JAX package does).
    ``threshold_median_ratio`` keeps the edges whose weight is at least that
    ratio of the lower middle edge weight.  ``init_centers`` maps "super",
    "group" and "hyperedge" to [N_INIT, k, D] starting centers."""
    dev = resolve_device(device)
    init = init_centers or {}
    wsi_features, wsi_positions = load_wsi_data(h5_path)
    tma_features = load_tma_data(h5_path)
    if tma_features is None:
        raise ValueError("TMA features not found")
    wsi_sim, wsi_tma_sim = load_similarity_matrices(h5_path)
    if wsi_sim is None:
        wsi_sim = combined_similarity_auto(
            _f32_on(wsi_features, dev), _f32_on(wsi_positions, dev),
            1.0, 1.0,
        ).cpu().numpy()

    wsi_stats: Dict = {}
    if num_wsi_super_patches is not None:
        sp_feats, sp_pos, wsi_stats, _ = aggregate_wsi_super_patches(
            wsi_features, wsi_positions, num_wsi_super_patches, seed=seed,
            wsi_similarity_matrix=wsi_sim, device=dev, init_centers=init.get("super"),
        )
        sim, sim_stats = compute_wsi_tma_similarity(sp_feats, tma_features, device=dev)
    else:
        def read_super(f):
            if "hypergraph/wsi_super/features" not in f:
                raise ValueError("wsi_super not found and num_wsi_super_patches not given")
            return (np.asarray(f["hypergraph/wsi_super/features"], np.float32),
                    np.asarray(f["hypergraph/wsi_super/positions"], np.float32))

        sp_feats, sp_pos = read_h5_retrying(h5_path, read_super)
        if wsi_tma_sim is not None and wsi_tma_sim.shape[0] == sp_feats.shape[0]:
            sim = wsi_tma_sim
            sim_stats = _matrix_stats(sim)
        else:
            sim, sim_stats = compute_wsi_tma_similarity(sp_feats, tma_features, device=dev)

    if num_groups is not None:
        group_labels, group_stats = group_by_similarity(
            sim, num_groups, "kmeans", seed, device=dev, init_centers=init.get("group"))
    else:
        def read_groups(f):
            if "hypergraph/group_labels" not in f:
                raise ValueError("group labels not found and num_groups not given")
            return np.asarray(f["hypergraph/group_labels"])

        group_labels = read_h5_retrying(h5_path, read_groups)
        group_stats = {"method": "existing", "num_groups": int(len(np.unique(group_labels)))}

    edge_index, edge_weights, hg_stats = build_hypergraph_knn_kmeans(
        sp_feats, tma_features, group_labels, hypergraph_k, num_hyperedges, seed,
        device=dev, init_centers=init.get("hyperedge"),
    )
    if threshold_median_ratio is not None:
        # torch.median's LOWER middle of the sorted weights (numpy would
        # interpolate for even counts and drop the median edge)
        median_w = (float(np.sort(edge_weights)[(edge_weights.size - 1) // 2])
                    if edge_weights.size else 0.0)
        threshold = median_w * threshold_median_ratio
        keep = edge_weights >= threshold
        edge_index = edge_index[:, keep]
        edge_weights = edge_weights[keep]
        hg_stats["num_edges_after_threshold"] = int(edge_weights.shape[0])
        hg_stats["threshold"] = threshold
        hg_stats["threshold_ratio"] = threshold_median_ratio

    all_stats = {
        "wsi_aggregation": wsi_stats,
        "similarity": sim_stats,
        "grouping": group_stats,
        "hypergraph": hg_stats,
    }
    save_hypergraph(
        h5_path, sp_feats, sp_pos, tma_features, edge_index, edge_weights,
        group_labels, all_stats, wsi_similarity_matrix=wsi_sim, wsi_tma_similarity_matrix=sim,
    )
    return all_stats


def cache_similarity_matrices(
    h5_path,
    lambda_h: float = 1.0,
    lambda_g: float = 1.0,
    overwrite: bool = False,
    device=None,
) -> Dict:
    """Write ``hypergraph/similarity/{wsi_internal,wsi_tma}`` into a built
    file on demand (K by K1, the cross similarity from its super-patches),
    leaving its other datasets alone; returns {key: shape} of what it
    wrote.  The per-path lock is held from the probe to the write, so two
    callers in one process cannot both decide to compute."""
    dev = resolve_device(device)

    def probe(f):
        grp = f.get("hypergraph")
        has_k = grp is not None and "similarity/wsi_internal" in grp
        has_sim = grp is not None and "similarity/wsi_tma" in grp
        has_super = grp is not None and "wsi_super/features" in grp
        return has_k, has_sim, has_super

    with _lock_for(str(h5_path)):
        return _cache_similarity_locked(h5_path, lambda_h, lambda_g, overwrite, probe, dev)


def _cache_similarity_locked(h5_path, lambda_h, lambda_g, overwrite, probe, dev):
    has_k, has_sim, has_super = read_h5_retrying(h5_path, probe)
    need_k = overwrite or not has_k
    need_sim = has_super and (overwrite or not has_sim)
    written: Dict = {}
    if not (need_k or need_sim):
        return written

    pairs = []
    if need_k:
        wsi_features, wsi_positions = load_wsi_data(h5_path)
        K = combined_similarity_auto(
            _f32_on(wsi_features, dev), _f32_on(wsi_positions, dev),
            lambda_h, lambda_g,
        ).cpu().numpy()
        pairs.append(("similarity/wsi_internal", K))
        written["similarity/wsi_internal"] = K.shape
    if need_sim:
        tma_features = load_tma_data(h5_path)
        if tma_features is not None:
            sp = read_h5_retrying(
                h5_path, lambda f: np.asarray(f["hypergraph/wsi_super/features"], np.float32)
            )
            sim = cross_similarity(_f32_on(sp, dev), _f32_on(tma_features, dev), lambda_h).cpu().numpy()
            pairs.append(("similarity/wsi_tma", sim))
            written["similarity/wsi_tma"] = sim.shape
    with open_h5_retrying(h5_path, "a") as f:
        grp = f.require_group("hypergraph")
        for key, arr in pairs:
            if key in grp:
                del grp[key]
            grp.create_dataset(key, data=arr)
    return written


def batch_cache_similarity(csv_path, data_root_dir, **kwargs):
    """Dataset-level on-demand similarity caching (CLI ``--cache_similarity``)."""
    out = []
    for idx, row in enumerate(_read_csv_rows(csv_path)):
        h5_path = os.path.join(str(data_root_dir), row["h5_file_path"])
        if not os.path.exists(h5_path):
            continue
        try:
            written = cache_similarity_matrices(h5_path, **kwargs)
            out.append({"case_id": _case_of(idx, row), **{k: list(v) for k, v in written.items()}})
        except Exception as e:
            out.append({"case_id": _case_of(idx, row), "error": str(e)})
    return out


def batch_rebuild_hypergraph(csv_path, data_root_dir, **kwargs):
    """``rebuild_hypergraph_from_similarity`` over a dataset CSV (CLI
    ``--rebuild``)."""
    out = []
    for idx, row in enumerate(_read_csv_rows(csv_path)):
        h5_path = os.path.join(str(data_root_dir), row["h5_file_path"])
        if not os.path.exists(h5_path):
            continue
        try:
            stats = rebuild_hypergraph_from_similarity(h5_path, **kwargs)
            stats["case_id"] = _case_of(idx, row)
            out.append(stats)
        except Exception as e:
            out.append({"case_id": _case_of(idx, row), "error": str(e)})
    return out

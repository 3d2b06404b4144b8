"""Per-slide hypergraph build (PyTorch port of
``multimodal_fusion_tpu.hypergraph.build``, full-statistics mode).

Per slide: combined similarity [N, N] (CUDA kernel K1) -> KMeans
super-patches (+ intra-cluster statistics) -> cross-modal similarity ->
grouping KMeans -> node KNN (CUDA kernel K2 once the node count reaches
4096) + hyperedge KMeans -> cosine features, all on the run's device
(``_fused_build``); then edge assembly, statistics and the HDF5 write on the
host (``_finalize_host``).

Entry points: ``process_arrays`` (in memory, no HDF5), ``process_single_file``
and ``process_dataset`` (HDF5 in and out).  They take ``device=None``, which
means CUDA; the CPU runs only when asked for.  Random numbers come from three
``torch.Generator``s on the run's device, one per KMeans, seeded from
``seed``; ``init_centers`` replaces their kmeans++ draws.

Not in this slice (they raise ``NotImplementedError`` naming the ROADMAP
item): blockwise statistics above ``FULL_STATS_MAX_N`` patches without a
similarity cache, ``file_batch > 1`` and ``mesh``.
"""

from __future__ import annotations

import csv
import json
import math
import os
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from multimodal_fusion_tpu_torch.device import resolve_device
from multimodal_fusion_tpu_torch.io.h5io import (
    _json_default,
    has_complete_hypergraph,
    read_h5_retrying,
    write_hypergraph_group,
)
from multimodal_fusion_tpu_torch.ops.kmeans import kmeans
from multimodal_fusion_tpu_torch.ops.knn_kernel import knn_indices_auto
from multimodal_fusion_tpu_torch.ops.similarity import cross_similarity
from multimodal_fusion_tpu_torch.ops.similarity_kernel import combined_similarity_auto

# Above this many patches the [N, N] f32 similarity (4 GB at 32768) is not
# materialised unless it is cached; that regime streams blockwise statistics.
FULL_STATS_MAX_N = 32768

# KMeans restarts of every clustering in the build.
N_INIT = 10


def _not_ported(what: str, item: str):
    return NotImplementedError(
        f"{what} is not ported to PyTorch yet: see ROADMAP.md, Queue 1, '{item}'"
    )


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


# ---------------------------------------------------------------------------
# Statistics
# ---------------------------------------------------------------------------

# Below this many elements the sort-based median is cheap; above it the
# bit-pattern bisection avoids sorting the [N, N] matrix.
_BISECT_MEDIAN_MIN_SIZE = 1 << 16
_INT32_MAX = 2**31 - 1


def _bitpattern_median(K: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """EXACT median of non-negative finite f32 values by bisection in
    bit-pattern space, no sort.  For non-negative IEEE floats the int32 bit
    pattern is order-isomorphic to the value, so 31 compare+count passes
    isolate the k1 = (M+1)//2 and k2 = M//2+1 smallest values; their f32 mean
    is numpy's median (``torch.median`` would return the lower middle).
    ``mask`` marks the valid entries; M == 0 gives NaN."""
    keys = K.reshape(-1).float().contiguous().view(torch.int32)
    if mask is not None:
        v = mask.reshape(-1)
        m_cnt = torch.sum(v, dtype=torch.int64)
        # the sentinel sorts above every valid key and is never <= a midpoint
        keys = torch.where(v, keys, _INT32_MAX)
        hi0 = torch.max(torch.where(v, keys, -1))
    else:
        m_cnt = torch.tensor(keys.numel(), dtype=torch.int64, device=K.device)
        hi0 = torch.max(keys)
    k1 = (m_cnt + 1) // 2
    k2 = m_cnt // 2 + 1
    lo1 = torch.zeros((), dtype=torch.int32, device=K.device)
    lo2 = lo1.clone()
    hi1 = hi0.clone()
    hi2 = hi0.clone()
    for _ in range(31):
        m1 = lo1 + (hi1 - lo1) // 2
        m2 = lo2 + (hi2 - lo2) // 2
        c1 = torch.sum(keys <= m1)
        c2 = torch.sum(keys <= m2)
        lo1, hi1 = torch.where(c1 >= k1, lo1, m1 + 1), torch.where(c1 >= k1, m1, hi1)
        lo2, hi2 = torch.where(c2 >= k2, lo2, m2 + 1), torch.where(c2 >= k2, m2, hi2)
    v1 = lo1.reshape(1).view(torch.float32)[0]
    v2 = lo2.reshape(1).view(torch.float32)[0]
    med = (v1 + v2) / 2.0
    return torch.where(m_cnt > 0, med, torch.nan)


def _sort_median(vals: torch.Tensor) -> torch.Tensor:
    """numpy/jnp median of a 1-D tensor: the f32 midpoint of the two
    middle order statistics."""
    s = torch.sort(vals).values
    m = s.numel()
    return (s[(m - 1) // 2] + s[m // 2]) * 0.5


def _matrix_stats_dev(K: torch.Tensor) -> torch.Tensor:
    """[mean, std, min, max, median] on the device; std is the population
    std; an empty matrix gives NaNs."""
    if K.numel() == 0:
        return torch.full((5,), torch.nan, dtype=torch.float32, device=K.device)
    med = (
        _bitpattern_median(K)
        if K.numel() >= _BISECT_MEDIAN_MIN_SIZE
        else _sort_median(K.reshape(-1))
    )
    return torch.stack([
        torch.mean(K), torch.std(K, correction=0), torch.min(K), torch.max(K), med,
    ])


def _matrix_stats_dev_masked(K: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Statistics over the valid block only (the unpadded statistics)."""
    if K.numel() >= _BISECT_MEDIAN_MIN_SIZE:
        vals = K[mask]
        return torch.stack([
            torch.mean(vals), torch.std(vals, correction=0), torch.min(vals),
            torch.max(vals), _bitpattern_median(K, mask=mask),
        ])
    return _matrix_stats_dev(K[mask])


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


# ---------------------------------------------------------------------------
# The per-slide numeric core
# ---------------------------------------------------------------------------

def _generators(seed: int, device: torch.device) -> Tuple[torch.Generator, ...]:
    """Three independent generators on ``device`` (super-patch, grouping
    and hyperedge KMeans), where the JAX build splits one key three ways."""
    seeds = [int(s.generate_state(1)[0]) for s in np.random.SeedSequence(seed).spawn(3)]
    return tuple(torch.Generator(device=device).manual_seed(s) for s in seeds)


def _fused_build(
    generators: Sequence[torch.Generator],
    feats: torch.Tensor,  # [N, D]   (N may be a padded bucket size)
    pos: torch.Tensor,  # [N, P]
    tma: torch.Tensor,  # [T, D]
    n_valid: int,
    lambda_h: float,
    lambda_g: float,
    num_super: int,
    num_groups: int,
    k: int,
    num_hyperedges: int,
    cache_bf16: bool = True,
    ship_cache: bool = True,
    padded: bool = False,
    bf16_exact: bool = False,
    init_centers: Optional[Dict[str, torch.Tensor]] = None,
) -> Dict[str, torch.Tensor]:
    """The per-slide numeric pipeline on the tensors' device, in the JAX
    build's full-statistics modes: unpadded, padded bucket (``padded``: only
    the first ``n_valid`` rows are real) and ``ship_cache`` (the packed upper
    triangle of K, in bf16 under ``cache_bf16``).

    ``init_centers`` maps "super", "group" and "hyperedge" to [N_INIT, k, D]
    starting centers for the three KMeans, replacing their kmeans++ draws."""
    if padded and ship_cache:
        raise ValueError("a padded build cannot ship the exact-shape similarity cache")
    feats = feats.float()
    pos = pos.float()
    tma = tma.float()
    g1, g2, g3 = generators
    init = init_centers or {}
    n = feats.shape[0]
    dev = feats.device
    mask = (torch.arange(n, device=dev) < n_valid) if padded else None

    K = combined_similarity_auto(feats, pos, lambda_h, lambda_g, bf16_exact=bf16_exact)

    km = kmeans(feats, num_super, g1, n_init=N_INIT, mask=mask, init_centers=init.get("super"))
    onehot = torch.zeros((n, num_super), dtype=torch.float32, device=dev)
    onehot.scatter_(1, km.labels[:, None], 1.0)
    if padded:
        onehot = onehot * mask[:, None].float()
    counts = torch.sum(onehot, dim=0)  # [S]
    denom = torch.clamp_min(counts, 1.0)[:, None]
    sp_feats = (onehot.T @ feats) / denom
    sp_pos = (onehot.T @ pos) / denom

    # intra-cluster mean off-diagonal similarity via two matmuls:
    # s_cc = 1_c^T K 1_c ; off-diag mean = (s_cc - sum(diag K within c)) / (n_c^2 - n_c)
    KH = K @ onehot
    s_cc = torch.sum(onehot * KH, dim=0)
    diag_c = onehot.T @ torch.diagonal(K)
    pair_counts = counts * counts - counts
    has_pairs = pair_counts > 0
    intra_mean_per = torch.where(
        has_pairs, (s_cc - diag_c) / torch.clamp_min(pair_counts, 1.0), torch.nan
    )
    # 0.0 (the reference's value) when every cluster is a singleton
    intra_mean = torch.where(
        torch.any(has_pairs),
        torch.sum(torch.where(has_pairs, intra_mean_per, 0.0))
        / torch.clamp_min(torch.sum(has_pairs), 1),
        0.0,
    )

    sim = cross_similarity(sp_feats, tma, lambda_h)  # [S, T]
    group = kmeans(sim, num_groups, g2, n_init=N_INIT, init_centers=init.get("group"))

    all_feats = torch.cat([sp_feats, tma], dim=0)
    n_total = all_feats.shape[0]
    _, knn_idx = knn_indices_auto(all_feats, min(k + 1, n_total))
    he = kmeans(all_feats, num_hyperedges, g3, n_init=N_INIT, init_centers=init.get("hyperedge"))
    normed = all_feats / (torch.linalg.norm(all_feats, dim=1, keepdim=True) + 1e-12)

    if padded:
        K_stats = _matrix_stats_dev_masked(K, mask[:, None] & mask[None, :])
    else:
        K_stats = _matrix_stats_dev(K)

    out: Dict[str, torch.Tensor] = {}
    if ship_cache:
        # K is symmetric: ship the packed upper triangle (np.triu_indices order)
        K_packed = K[torch.ones((n, n), dtype=torch.bool, device=dev).triu_()]
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
        "sim_stats": _matrix_stats_dev(sim),
        "group_labels": group.labels,
        "knn_idx": knn_idx,
        "hyperedge_labels": he.labels,
        "normed": normed,
    }


def _to_host_start(out: Dict[str, torch.Tensor]):
    """Start the device->host copies of one slide's outputs; returns the
    host tensors and the event to wait on (None on the CPU)."""
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
    raise_errors: bool = False,
):
    """Edge assembly + stats + HDF5 write for one slide's outputs; runs on
    a thread pool so it overlaps other slides' device work.  Errors are
    isolated per file, except under ``raise_errors``."""
    try:
        stats, arrays = _assemble_result(
            n_patches, tma_features, host, save_similarity, num_wsi_super_patches,
            num_groups, hypergraph_k, num_hyperedges,
        )
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
    """(full_stats, block_stats) for a slide of ``n`` patches."""
    full = save_similarity or n <= FULL_STATS_MAX_N
    return full, not full


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


def _dispatch_build(
    feats, pos, tma, device, num_wsi_super_patches, num_groups, hypergraph_k,
    num_hyperedges, lambda_h, lambda_g, seed, save_similarity, bucket_patches,
    upload_dtype, init_centers=None,
):
    """Upload one slide, run ``_fused_build`` and start the copies back.
    Returns (n_valid, host tensors, event)."""
    if bucket_patches and save_similarity:
        raise ValueError(
            "bucket_patches requires save_similarity=False (the persisted "
            "[N,N] cache keeps exact shapes)"
        )
    n_valid = feats.shape[0]
    padded = False
    if bucket_patches:
        feats, pos, n_valid, padded = _bucketed(feats, pos, bucket_patches)
    full_stats, _ = _stats_modes(save_similarity, feats.shape[0])
    if not full_stats:
        raise _not_ported(
            f"save_similarity=False above FULL_STATS_MAX_N={FULL_STATS_MAX_N} patches",
            "blockwise statistics",
        )
    dt = _upload_dt(upload_dtype)
    out = _fused_build(
        _generators(seed, device),
        torch.as_tensor(np.asarray(feats)).to(device=device, dtype=dt),
        torch.as_tensor(np.asarray(pos, np.float32)).to(device),
        torch.as_tensor(np.asarray(tma)).to(device=device, dtype=dt),
        n_valid, lambda_h, lambda_g,
        num_wsi_super_patches, num_groups, hypergraph_k, num_hyperedges,
        ship_cache=save_similarity, padded=padded,
        bf16_exact=upload_dtype == "bfloat16", init_centers=init_centers,
    )
    host, event = _to_host_start(out)
    return n_valid, host, event


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
) -> Dict:
    """Build one slide's hypergraph from in-memory arrays, writing nothing.

    Returns {"stats": the stats dict, "arrays": the ``hypergraph/`` group's
    arrays by key, "host": the device outputs as numpy (super-patch
    ``labels``, ``K_stats``, ``intra_mean``, ``sim``, ...)}."""
    dev = resolve_device(device)
    tma_features = np.asarray(tma_features, np.float32)
    n_valid, host_t, event = _dispatch_build(
        wsi_features, wsi_positions, tma_features, dev, num_wsi_super_patches,
        num_groups, hypergraph_k, num_hyperedges, lambda_h, lambda_g, seed,
        save_similarity, bucket_patches, upload_dtype, init_centers,
    )
    host = _to_host_finish(host_t, event)
    stats, arrays = _assemble_result(
        n_valid, tma_features, host, save_similarity, num_wsi_super_patches,
        num_groups, hypergraph_k, num_hyperedges,
    )
    stats["num_patches_processed"] = int(n_valid)
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
    errors raise."""
    if mesh is not None:
        raise _not_ported("mesh (intra-slide sharding)", "mesh")
    dev = resolve_device(device)
    wsi_features, wsi_positions = load_wsi_data(h5_path)
    tma_features = load_tma_data(h5_path)
    if tma_features is None:
        return {"status": "skipped", "reason": "no_tma"}
    n_valid, host_t, event = _dispatch_build(
        wsi_features, wsi_positions, tma_features, dev, num_wsi_super_patches,
        num_groups, hypergraph_k, num_hyperedges, lambda_h, lambda_g, seed,
        save_similarity, bucket_patches, upload_dtype, init_centers,
    )
    return _finalize_host(
        None, None, h5_path, n_valid, tma_features, _to_host_finish(host_t, event),
        save_similarity, num_wsi_super_patches, num_groups, hypergraph_k,
        num_hyperedges, raise_errors=True,
    )


def _read_csv_rows(csv_path) -> List[Dict[str, str]]:
    with open(csv_path, newline="") as f:
        reader = csv.DictReader(f)
        if "h5_file_path" not in (reader.fieldnames or []):
            raise ValueError("CSV must contain 'h5_file_path' column")
        return list(reader)


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
    so they overlap later slides.  Results come back in CSV order; per-file
    errors are isolated.  Returns (per-file stats, summary)."""
    _upload_dt(upload_dtype)
    if bucket_patches and save_similarity:
        raise ValueError(
            "bucket_patches requires save_similarity=False (the persisted "
            "[N,N] cache keeps exact shapes) — pass save_similarity=False / "
            "--no_save_similarity"
        )
    if file_batch > 1:
        raise _not_ported("file_batch > 1 (batched same-shape build)", "batched build")
    if mesh is not None:
        raise _not_ported("mesh (intra-slide sharding)", "mesh")
    dev = resolve_device(device)
    rows = list(enumerate(_read_csv_rows(csv_path)))

    def case_of(idx, row):
        return str(row.get("case_id") or f"case_{idx}")

    all_stats: list = []
    if skip_existing:
        keep = []
        for idx, row in rows:
            h5_path = os.path.join(str(data_root_dir), row["h5_file_path"])
            if os.path.exists(h5_path) and has_complete_hypergraph(
                h5_path, require_similarity=save_similarity
            ):
                all_stats.append({
                    "case_id": case_of(idx, row), "status": "skipped",
                    "reason": "existing_hypergraph",
                })
            else:
                keep.append((idx, row))
        rows = keep
    t0 = time.time()

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
        n_valid, host_t, event = _dispatch_build(
            wsi_features, wsi_positions, tma_features, dev, num_wsi_super_patches,
            num_groups, hypergraph_k, num_hyperedges, lambda_h, lambda_g, seed,
            save_similarity, bucket_patches, upload_dtype,
        )
        return (idx, row, h5_path, (n_valid, tma_features), (host_t, event))

    with ThreadPoolExecutor(max_workers=2) as pool:

        def drain(item):
            idx, row, h5_path, meta, out = item
            case_id = case_of(idx, row)
            if meta is None:
                results.append((None, {"case_id": case_id, "status": "skipped", "reason": "no_tma"}))
                return
            n_patches, tma_features = meta
            try:
                host = _to_host_finish(*out)
            except Exception as e:  # per-file isolation, as in the JAX process_dataset
                results.append((None, {"case_id": case_id, "error": str(e)}))
                return
            fut = pool.submit(
                _finalize_host, case_id, row["h5_file_path"], h5_path, n_patches,
                tma_features, host, save_similarity, num_wsi_super_patches,
                num_groups, hypergraph_k, num_hyperedges,
            )
            results.append((fut, None))

        for idx, row in rows:
            try:
                item = dispatch(idx, row)
            except NotImplementedError:
                raise
            except Exception as e:  # per-file isolation, as in the JAX process_dataset
                results.append((None, {"case_id": case_of(idx, row), "error": str(e)}))
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

    total_patches = sum(s.get("num_patches_processed", 0) for s in all_stats)
    elapsed = time.time() - t0
    summary = {
        "files": len(all_stats),
        "total_patches": total_patches,
        "elapsed_s": elapsed,
        "patches_per_sec": total_patches / elapsed if elapsed > 0 else 0.0,
        "device": str(dev),
    }
    if output_stats_path:
        Path(output_stats_path).write_text(
            json.dumps({"summary": summary, "files": all_stats}, indent=2, default=_json_default)
        )
    return all_stats, summary

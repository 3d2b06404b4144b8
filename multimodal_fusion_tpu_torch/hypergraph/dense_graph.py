"""Dense thresholded similarity graph (PyTorch port of
``multimodal_fusion_tpu.hypergraph.dense_graph``).

``build_weighted_hypergraph`` keeps every (i, j) pair, self loops and both
directions included, whose combined similarity (K1) is at least the lower
middle of the off-diagonal similarities times ``threshold_median_ratio``,
enumerated row-major over the [N, N] grid as the reference's double loop
enumerates them.  ``mean_pool_with_similarity`` also takes the legacy
(features, positions, lambda_h, lambda_g) signature and ignores the extra
arguments; ``build_hypergraph_data(legacy_keys=True)`` emits the older
``pooled_features`` key.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from multimodal_fusion_tpu_torch.device import resolve_device
from multimodal_fusion_tpu_torch.ops.similarity import mean_pool, median_offdiag
from multimodal_fusion_tpu_torch.ops.similarity_kernel import combined_similarity_auto


def build_weighted_hypergraph(
    features: np.ndarray,
    positions: np.ndarray,
    lambda_h: float = 1.0,
    lambda_g: float = 1.0,
    threshold_median_ratio: Optional[float] = None,
    device=None,
) -> Tuple[np.ndarray, np.ndarray]:
    """(edge_index [2, E], edge_weights [E]) over the dense similarity graph."""
    n = features.shape[0]
    if n <= 1:
        raise ValueError(f"Number of nodes must be greater than 1, got N={n}.")
    dev = resolve_device(device)
    K = combined_similarity_auto(
        torch.tensor(np.asarray(features, np.float32), device=dev),
        torch.tensor(np.asarray(positions, np.float32), device=dev), lambda_h, lambda_g,
    )
    K_host = K.cpu().numpy()
    if threshold_median_ratio is not None:
        keep = K_host >= float(median_offdiag(K)) * threshold_median_ratio
    else:
        keep = np.ones_like(K_host, dtype=bool)
    src, dst = np.nonzero(keep)  # row-major: the reference's loop order
    return np.stack([src, dst]).astype(np.int64), K_host[src, dst].astype(np.float32)


def mean_pool_with_similarity(features: np.ndarray, *legacy_args, device=None) -> np.ndarray:
    """Global mean feature [1, D]; extra positional arguments (the legacy
    positions / lambdas signature) are ignored."""
    dev = resolve_device(device)
    return mean_pool(torch.tensor(np.asarray(features, np.float32), device=dev)).cpu().numpy()


def build_hypergraph_data(
    features: np.ndarray,
    positions: np.ndarray,
    lambda_h: float = 1.0,
    lambda_g: float = 1.0,
    threshold_median_ratio: Optional[float] = None,
    use_pooling: bool = True,
    legacy_keys: bool = False,
    device=None,
) -> Dict[str, np.ndarray]:
    """The graph-data dict {x, edge_index, edge_attr, pos[, pooled_feature]}."""
    edge_index, edge_weights = build_weighted_hypergraph(
        features, positions, lambda_h, lambda_g, threshold_median_ratio, device=device
    )
    result = {
        "x": np.asarray(features, np.float32),
        "edge_index": edge_index,
        "edge_attr": edge_weights,
        "pos": np.asarray(positions, np.float32),
    }
    if use_pooling:
        key = "pooled_features" if legacy_keys else "pooled_feature"
        result[key] = mean_pool_with_similarity(features, device=device)
    return result

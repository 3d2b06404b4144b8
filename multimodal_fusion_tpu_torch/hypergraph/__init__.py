"""Hypergraph construction (PyTorch port of ``multimodal_fusion_tpu.hypergraph``)."""

from multimodal_fusion_tpu_torch.hypergraph.build import (  # noqa: F401
    aggregate_wsi_super_patches,
    compute_wsi_tma_similarity,
    group_by_similarity,
    build_hypergraph_knn_kmeans,
    process_single_file,
    process_dataset,
    rebuild_hypergraph_from_similarity,
    batch_rebuild_hypergraph,
    cache_similarity_matrices,
    batch_cache_similarity,
    save_hypergraph,
    load_similarity_matrices,
)
from multimodal_fusion_tpu_torch.hypergraph.dense_graph import (  # noqa: F401
    build_weighted_hypergraph,
    build_hypergraph_data,
    mean_pool_with_similarity,
)

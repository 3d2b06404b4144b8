"""PyTorch / CUDA port of ``multimodal_fusion_tpu`` for NVIDIA Hopper (H100).

The JAX package stays the reference; this package imports ``torch`` and
nothing of JAX or of the JAX package.  This slice covers the per-slide
hypergraph build (``hypergraph.build``) in its full-statistics mode, with
hand-written CUDA kernels for the combined similarity
(``ops.similarity_kernel``) and the running-top-k KNN (``ops.knn_kernel``).
"""

from multimodal_fusion_tpu_torch.device import resolve_device, strict_fp32

__all__ = ["resolve_device", "strict_fp32"]

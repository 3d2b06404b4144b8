"""PyTorch / CUDA port of ``multimodal_fusion_tpu`` for NVIDIA Hopper (H100).

The JAX package stays the reference; this package imports ``torch`` and
nothing of JAX or of the JAX package.  It covers the per-slide hypergraph
build (``hypergraph.build``) in its full-statistics mode, ViT-L/16 TMA
feature extraction (``data.tma_extraction``), MFMF survival training
(``train.survival``), and the flagship ``svd_gate_random_clam`` family's
evaluation and serving (``models.svd_gate``, ``utils.predict``,
``utils.serve``), with hand-written CUDA kernels for the combined
similarity (``ops.similarity_kernel``), the running-top-k KNN
(``ops.knn_kernel``) and the fused attention forward and backward
(``ops.attention_kernel``).
"""

from multimodal_fusion_tpu_torch.device import resolve_device, strict_fp32

__all__ = ["resolve_device", "strict_fp32"]

"""PyTorch / CUDA port of ``multimodal_fusion_tpu`` for NVIDIA Hopper (H100).

The JAX package stays the reference; this package imports ``torch`` and
nothing of JAX or of the JAX package.  It does what the JAX package does:

- ``hypergraph``: the per-slide hypergraph build (full, blockwise and
  sampled statistics, the batched build, the similarity caches and the
  rebuild), with hand-written CUDA kernels for the combined similarity
  (``ops.similarity_kernel``) and the running-top-k KNN
  (``ops.knn_kernel``);
- ``data.tma_extraction``: ViT TMA feature extraction (UNI, UNI2-h), whose
  attention runs the fused attention kernel (``ops.attention_kernel``);
- ``models``, ``train``: the survival zoo (all 24 factory keys) with its
  trainer, alignment pretraining and the WSI VAE; MFMF's training runs the
  attention kernel's backward;
- ``utils``: evaluation, ``predict`` and HTTP serving, ``torch.export``
  serving artifacts (``utils.export``), the missing-modality sweep
  (``utils.robust``), reference-checkpoint import
  (``utils.torch_import``) and MFU accounting (``utils.mfu``);
- ``parallel``: data parallelism on ``torch.distributed``;
- ``cli``: the command-line entry points, the JAX package's flags plus
  ``--device``.
"""

from multimodal_fusion_tpu_torch.channels import (  # noqa: F401
    TMA_MARKERS,
    get_available_channels,
    parse_channels,
)
from multimodal_fusion_tpu_torch.device import resolve_device, strict_fp32

__all__ = ["TMA_MARKERS", "get_available_channels", "parse_channels", "resolve_device",
           "strict_fp32"]

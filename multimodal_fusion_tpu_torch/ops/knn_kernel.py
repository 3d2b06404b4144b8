"""Running-top-k self-KNN: CUDA kernel K2 and its dispatcher.

Counterpart of ``multimodal_fusion_tpu.ops.pallas_knn``.  The kernel
(``csrc/knn.cu``) replaces the Pallas TPU kernel ``_knn_kernel``
(pallas_knn.py:35, called at :115 from ``pallas_knn``): f32 norm-expansion
distances clamped at 0, self-distance pinned to exactly 0, a running top-k
over key tiles ordered by (value, smallest index), sqrt applied to the
output.  It is compute-bound on the H100 (true f32 FMAs for the distances);
the source note says what its design does about that.  Its plain version is
``ops.knn.knn_indices_blockwise``.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from multimodal_fusion_tpu_torch.ops import _cuda
from multimodal_fusion_tpu_torch.ops.knn import knn_indices, knn_indices_blockwise

KNN_MAX_K = 128


@functools.cache  # loaded and typed once per process
def _lib():
    lib = _cuda.load("knn")
    lib.mmf_knn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    lib.mmf_knn.restype = ctypes.c_int
    return lib


def knn(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Self-KNN over rows of ``x`` [N, D]: (distances [N, k] ascending,
    indices [N, k]) with self in slot 0.  K2 on CUDA tensors, the blockwise
    plain version on CPU tensors.  ``knn.launches`` counts kernel launches."""
    n, d = x.shape
    if not 1 <= k <= min(KNN_MAX_K, n):
        raise ValueError(f"knn: need 1 <= k <= min({KNN_MAX_K}, N={n}), got k={k}")
    if x.device.type == "cpu":
        return knn_indices_blockwise(x.float(), k)
    if x.device.type != "cuda":
        raise ValueError(f"knn: unsupported device {x.device}")
    xf = x.float().contiguous()
    out_d = torch.empty((n, k), dtype=torch.float32, device=x.device)
    out_i = torch.empty((n, k), dtype=torch.int32, device=x.device)
    err = _cuda.call(x.device, _lib().mmf_knn, xf.data_ptr(), out_d.data_ptr(), out_i.data_ptr(),
                     n, d, k)
    _cuda.check(err, "knn kernel")
    knn.launches += 1
    return out_d, out_i.long()


knn.launches = 0


def knn_indices_auto(
    x: torch.Tensor, k: int, min_kernel_n: int = 4096
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The build's node-KNN dispatcher, as in the JAX package: the running
    top-k (K2 on CUDA, its blockwise plain version on the CPU) once N
    reaches ``min_kernel_n``; the dense [N, N] top-k below that."""
    if x.shape[0] >= min_kernel_n:
        return knn(x, k)
    return knn_indices(x, k)

"""Running-top-k self-KNN: CUDA kernel K2 and its dispatcher.

Counterpart of ``multimodal_fusion_tpu.ops.pallas_knn``.  The kernel
(``csrc/knn.cu``) replaces the Pallas TPU kernel ``_knn_kernel``
(pallas_knn.py:35, called at :115 from ``pallas_knn``): f32 norm-expansion
distances clamped at 0, self-distance pinned to exactly 0, a running top-k
over key tiles ordered by (value, smallest index), sqrt applied to the
output.  It is compute-bound on the H100 (true f32 FMAs for the distances);
the source note says what its design does about that.  It splits the key
axis into ``knn_segments`` segments, one block per (query tile, segment),
and merges the segments' lists in a second launch; ``ops.knn`` holds the
plain versions of both (``knn_indices_blockwise`` for the whole function,
``knn_merge_partials`` for the merge).  It reads rows 16 bytes at a time:
``padded_rows`` hands it rows as they are when they allow that, else a
zero-padded copy.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from multimodal_fusion_tpu_torch.ops import _cuda
from multimodal_fusion_tpu_torch.ops.knn import knn_indices, knn_indices_blockwise
from multimodal_fusion_tpu_torch.ops.similarity_kernel import padded_rows

KNN_MAX_K = 128
KNN_TILE = 128  # csrc/knn.cu: query rows per block and keys per tile
KNN_MAX_SEGMENTS = 16


@functools.cache  # loaded and typed once per process
def _lib():
    lib = _cuda.load("knn")
    lib.mmf_knn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    lib.mmf_knn.restype = ctypes.c_int
    return lib


def knn_segments(n: int, k: int, sms: int = 132) -> int:
    """S, the number of key segments K2 splits N keys into, from a cost
    model: one block of ~210 registers a thread fits an SM, so ceil(N / 128)
    query tiles x S blocks run in ceil(blocks / sms) waves, each as long as
    a segment's key tiles plus its first tile's merge (k insertions a row,
    taken as 0.25 + k / 64 tiles).  Takes the cheapest S of 1 to
    min(tiles, 16), the smallest on a tie, counted as the segments that hold
    keys (none is empty).  N 4096, k 6: S 4, one wave of 128 blocks."""
    tiles = -(-n // KNN_TILE)
    first = 0.25 + k / 64
    best, best_cost = 1, None
    for s in range(1, min(tiles, KNN_MAX_SEGMENTS) + 1):
        per = -(-tiles // s)
        used = -(-tiles // per)
        cost = -(-tiles * used // sms) * (per + first)
        if best_cost is None or cost < best_cost:
            best, best_cost = used, cost
    return best


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def knn_launch_rows(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, int]:
    """What K2 is launched with: the rows of ``x`` as float32 that 16-byte
    loads can read (``padded_rows``) and the number of key segments
    (``knn_segments`` for the card's SM count, 132 off the card)."""
    sms = 132
    if x.device.type == "cuda":
        index = x.device.index
        sms = _sm_count(torch.cuda.current_device() if index is None else index)
    return padded_rows(x.float()), knn_segments(x.shape[0], k, sms)


def knn(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Self-KNN over rows of ``x`` [N, D]: (distances [N, k] ascending,
    indices [N, k]) with self in slot 0.  K2 on CUDA tensors, the blockwise
    plain version on CPU tensors.  ``knn.launches`` counts calls that
    launched K2 (one or two kernels each)."""
    n, _ = x.shape
    if not 1 <= k <= min(KNN_MAX_K, n):
        raise ValueError(f"knn: need 1 <= k <= min({KNN_MAX_K}, N={n}), got k={k}")
    if x.device.type == "cpu":
        return knn_indices_blockwise(x.float(), k)
    if x.device.type != "cuda":
        raise ValueError(f"knn: unsupported device {x.device}")
    xf, s = knn_launch_rows(x, k)
    out_d = torch.empty((n, k), dtype=torch.float32, device=x.device)
    out_i = torch.empty((n, k), dtype=torch.int32, device=x.device)
    part_d = part_i = None
    if s > 1:  # the segments' lists, merged by the second launch
        part_d = torch.empty((s, n, k), dtype=torch.float32, device=x.device)
        part_i = torch.empty((s, n, k), dtype=torch.int32, device=x.device)
    err = _cuda.call(x.device, _lib().mmf_knn, xf.data_ptr(), out_d.data_ptr(), out_i.data_ptr(),
                     None if part_d is None else part_d.data_ptr(),
                     None if part_i is None else part_i.data_ptr(), n, xf.shape[1], k, s)
    _cuda.check(err, "knn kernel")
    knn.launches += 1
    return out_d, out_i.long()


knn.launches = 0


def knn_indices_auto(
    x: torch.Tensor, k: int, min_kernel_n: int = 4096
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The build's node-KNN dispatcher, as in the JAX package: the running
    top-k (K2 on CUDA, its blockwise plain version on the CPU) once N
    reaches ``min_kernel_n``; the dense [N, N] top-k below that.  ``x`` is
    [N, D] or a batch of slides [B, N, D]: the dense top-k runs once for
    the batch, K2 once per slide."""
    if x.shape[-2] < min_kernel_n:
        return knn_indices(x, k)
    if x.dim() == 2:
        return knn(x, k)
    d, i = zip(*(knn(xb, k) for xb in x))
    return torch.stack(d), torch.stack(i)

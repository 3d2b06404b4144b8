"""The port's CUDA kernels against their plain PyTorch versions, on the card.

CUDA kernels have no CPU mode, so every test here carries the ``cuda``
marker and skips without a CUDA device.  On a machine with one:

    python -m pytest tests/test_torch_port_cuda.py -m cuda -q
"""

import numpy as np
import pytest
import torch

from multimodal_fusion_tpu_torch.device import resolve_device
from multimodal_fusion_tpu_torch.io.fixtures import clustered_slide
from multimodal_fusion_tpu_torch.ops.knn import knn_indices_blockwise
from multimodal_fusion_tpu_torch.ops.knn_kernel import knn
from multimodal_fusion_tpu_torch.ops.similarity_kernel import (
    similarity_rect,
    similarity_rect_plain,
)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the port's kernels have no CPU mode")
    return resolve_device("cuda")


@pytest.mark.parametrize(
    "m,n,d,bf16", [(1, 1, 1, False), (65, 129, 17, False), (300, 257, 1000, False), (130, 70, 64, True)]
)
def test_similarity_kernel_matches_plain(cuda, m, n, d, bf16):
    rng = np.random.default_rng(m + n + d)
    rf = torch.as_tensor((rng.standard_normal((m, d)) / np.sqrt(d)).astype(np.float32), device=cuda)
    cf = torch.as_tensor((rng.standard_normal((n, d)) / np.sqrt(d)).astype(np.float32), device=cuda)
    if bf16:
        rf, cf = rf.to(torch.bfloat16).float(), cf.to(torch.bfloat16).float()
    rp = torch.as_tensor(rng.uniform(0, 4, (m, 2)).astype(np.float32), device=cuda)
    cp = torch.as_tensor(rng.uniform(0, 4, (n, 2)).astype(np.float32), device=cuda)
    before = similarity_rect.launches
    out = similarity_rect(rf, rp, cf, cp, 0.7, 1.3, bf16)
    again = similarity_rect(rf, rp, cf, cp, 0.7, 1.3, bf16)
    plain = similarity_rect_plain(rf, rp, cf, cp, 0.7, 1.3, bf16)
    torch.cuda.synchronize()
    assert similarity_rect.launches == before + 2
    assert torch.equal(out, again)  # no atomics, no split over D
    # f32 sums in another order than the plain version's float64 evaluation
    assert float((out - plain).abs().max()) <= 1e-5


@pytest.mark.parametrize(
    "n,k,data", [(33, 1, "integer"), (200, 6, "integer"), (700, 128, "integer"), (1500, 6, "float")]
)
def test_knn_kernel_matches_plain(cuda, n, k, data):
    rng = np.random.default_rng(n)
    if data == "integer":
        # exact f32 distances, so ties rank by the smaller index
        x_np = rng.integers(-2, 3, (n, 40)).astype(np.float32)
    else:
        # clustered blobs at the build's width: rounded f32 distances
        x_np = clustered_slide(rng, n, 1, 1024)[0]
    x = torch.as_tensor(x_np, device=cuda)
    before = knn.launches
    d_k, i_k = knn(x, k)
    d_p, i_p = knn_indices_blockwise(x, k, block=256)
    torch.cuda.synchronize()
    assert knn.launches == before + 1
    assert torch.equal(i_k[:, 0], torch.arange(n, device=cuda))
    if data == "integer":
        assert torch.equal(i_k, i_p)
        assert float((d_k - d_p).abs().max()) <= 1e-5
        return
    # float data: errors relative to ||x_i||^2 + ||x_j||^2, the scale at
    # which f32 rounds the norm expansion (the distance itself can be far
    # smaller and cancel).  The kernel's squared distances lie within 1e-5
    # of that scale of float64 (worst case of 16-wide chunked f32 sums over
    # D = 1024; TF32 would be 50x off); at most 1% of rows differ from the
    # plain version, and only between near-ties (2e-5: both sides round)
    x64 = x.double()
    sq = (x64 * x64).sum(dim=1)
    e_k = ((x64[i_k] - x64[:, None, :]) ** 2).sum(-1)
    e_p = ((x64[i_p] - x64[:, None, :]) ** 2).sum(-1)
    assert float((i_k != i_p).any(dim=1).float().mean()) <= 0.01
    tie_scale = sq[:, None] + torch.maximum(sq[i_k], sq[i_p])
    assert float(((e_k - e_p).abs() / tie_scale).max()) <= 2e-5
    assert float(((d_k.double() ** 2 - e_k).abs() / (sq[:, None] + sq[i_k])).max()) <= 1e-5


def test_kernel_wrappers_raise_instead_of_falling_back(cuda):
    x = torch.zeros((10, 4), device=cuda)
    with pytest.raises(ValueError):
        knn(x, 11)
    with pytest.raises(ValueError):
        similarity_rect(x, x[:, :2], x[:, :3], x[:, :2])

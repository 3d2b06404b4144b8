"""The port's CUDA kernels against their plain PyTorch versions, on the card.

CUDA kernels have no CPU mode, so every test here carries the ``cuda``
marker and skips without a CUDA device.  On a machine with one:

    python -m pytest tests/test_torch_port_cuda.py -m cuda -q
"""

import numpy as np
import pytest
import torch

from multimodal_fusion_tpu_torch.device import resolve_device
from multimodal_fusion_tpu_torch.ops.attention import plain_fused_attention, plain_fused_attention_bwd
from multimodal_fusion_tpu_torch.ops.attention_kernel import attention_bwd, attention_fwd
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
    q = torch.zeros((2, 5, 2, 16), device=cuda)
    with pytest.raises(ValueError):
        attention_fwd(q.half(), q.half(), q.half())  # float16 is not a K3 dtype
    with pytest.raises(ValueError):
        attention_fwd(q, q.bfloat16(), q)  # mixed dtypes
    wide = torch.zeros((5, 2, 136), device=cuda)
    with pytest.raises(ValueError):
        attention_fwd(wide, wide, wide)  # head dim above 128


# K3 against its plain version.  f32: o within 2e-5 absolute, l within 1e-5
# relative, m within 1e-6 relative + 1e-6 absolute (the dots sum in another
# order; m is exact where the scores are, see the grid case); bf16 o within
# 2e-2 (p rounds to bf16 before P.V on both sides, a last-bit difference in
# f32 p can flip one rounding).
def _attn_inputs(rng, b, tq, tk, h, hd, dtype, cuda, grid=False):
    def draw(t):
        x = rng.standard_normal((b, t, h, hd))
        if grid:  # multiples of 1/8 in [-1, 1]: every dot exact in f32
            x = np.round(np.clip(x, -1, 1) * 8) / 8
        return torch.as_tensor(x.astype(np.float32), device=cuda).to(dtype)
    return draw(tq), draw(tk), draw(tk)


def _o_close(got, want, scale=None):
    """float32 o within 2e-5 absolute.  bf16 o (``scale`` given: the plain
    output on |v|, elementwise sum_j p_j |v_j| / l) within 4 * 2^-8 *
    scale: each side rounds every p_j to bf16, a flip moving it by at most
    2^-7 of itself, and o to bf16, at most 2^-7 of |o| <= scale."""
    err = (got.float() - want.float()).abs()
    if scale is None:
        return float(err.max()) <= 2e-5
    return bool(torch.all(err <= 4 * 2 ** -8 * scale.float()))


def _check_attn(got, want, qkv, mask=None, **dropout):
    q, k, v = qkv
    scale = None
    if q.dtype == torch.bfloat16:
        scale = plain_fused_attention(q, k, v.abs(), mask, **dropout)[0]
    assert _o_close(got[0], want[0], scale)
    assert torch.allclose(got[1], want[1], rtol=1e-6, atol=1e-6)
    assert torch.allclose(got[2], want[2], rtol=1e-5, atol=0)


@pytest.mark.parametrize(
    "b,tq,tk,h,hd,dtype",
    [
        (2, 257, 257, 4, 64, torch.float32),  # ViT-L tokens
        (2, 257, 257, 4, 64, torch.bfloat16),
        (1, 40, 1100, 2, 40, torch.float32),  # hd padded to 64, ragged key tiles
        (1, 40, 1100, 2, 40, torch.bfloat16),
        (3, 7, 5, 3, 16, torch.float32),  # hd padded to 32, one partial tile
        (1, 130, 70, 2, 128, torch.float32),
        (1, 130, 70, 2, 128, torch.bfloat16),
    ],
)
def test_attention_kernel_matches_plain(cuda, b, tq, tk, h, hd, dtype):
    rng = np.random.default_rng(tq + tk + hd)
    q, k, v = _attn_inputs(rng, b, tq, tk, h, hd, dtype, cuda)
    mask = torch.as_tensor(rng.random((b, tk)) > 0.3, device=cuda)
    for msk in (None, mask, mask[0]):  # no mask, per batch, one [Tk] mask for all
        before = attention_fwd.launches
        got = attention_fwd(q, k, v, msk)
        again = attention_fwd(q, k, v, msk)
        want = plain_fused_attention(q, k, v, msk)
        torch.cuda.synchronize()
        assert attention_fwd.launches == before + 2
        assert got[0].dtype == dtype and got[0].shape == (b, tq, h, hd)
        assert all(torch.equal(x, y) for x, y in zip(got, again))  # deterministic
        _check_attn(got, want, (q, k, v), msk)


def test_attention_kernel_m_exact_on_exact_scores(cuda):
    """Where every score is exact in f32 the row max is too."""
    q, k, v = _attn_inputs(np.random.default_rng(0), 2, 100, 90, 2, 64, torch.float32, cuda, grid=True)
    got = attention_fwd(q, k, v)
    want = plain_fused_attention(q, k, v)
    assert torch.equal(got[1], want[1])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attention_kernel_masking_replaces(cuda, dtype):
    """All-masked rows (large scores too) give the uniform average of v and
    m = -1e9 exactly; keys of a ragged valid length are excluded."""
    rng = np.random.default_rng(1)
    q, k, v = _attn_inputs(rng, 2, 33, 300, 2, 64, dtype, cuda)
    q, k = q * 40, k * 40
    mask = torch.ones((2, 300), dtype=torch.bool, device=cuda)
    mask[0] = False
    mask[1, 211:] = False
    got = attention_fwd(q, k, v, mask)
    want = plain_fused_attention(q, k, v, mask)
    _check_attn(got, want, (q, k, v), mask)
    assert torch.all(got[1][0] == -1e9)
    scale = None
    if dtype == torch.bfloat16:
        scale = plain_fused_attention(q, k, v.abs(), mask)[0]
    uniform = v[0].float().mean(0)[None].expand_as(got[0][0])  # [H, hd] per query
    assert _o_close(got[0][0], uniform, None if scale is None else scale[0])
    cut = attention_fwd(q[1:], k[1:, :211], v[1:, :211])
    assert _o_close(got[0][1], cut[0][0], None if scale is None else scale[1])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attention_kernel_dropout_matches_plain(cuda, dtype):
    rng = np.random.default_rng(2)
    q, k, v = _attn_inputs(rng, 2, 40, 300, 2, 64, dtype, cuda)
    for seed in (7, -1399772917):
        got = attention_fwd(q, k, v, dropout_rate=0.1, seed=seed)
        want = plain_fused_attention(q, k, v, dropout_rate=0.1, seed=seed)
        _check_attn(got, want, (q, k, v), dropout_rate=0.1, seed=seed)
    undropped = attention_fwd(q, k, v)
    assert torch.equal(got[1], undropped[1]) and torch.equal(got[2], undropped[2])


def test_attention_kernel_reads_strided_qkv(cuda):
    """q, k, v as views of a fused [B, T, 3, H, hd] projection."""
    rng = np.random.default_rng(3)
    qkv = torch.as_tensor(rng.standard_normal((2, 257, 3, 4, 64)).astype(np.float32), device=cuda)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    got = attention_fwd(q, k, v)
    want = plain_fused_attention(q.contiguous(), k.contiguous(), v.contiguous())
    _check_attn(got, want, (q, k, v))
    one = attention_fwd(q[1], k[1], v[1])  # unbatched [T, H, hd]
    assert one[0].shape == (257, 4, 64) and one[1].shape == (4, 257)
    assert torch.equal(one[0], got[0][1])


# K4 against its plain version.  The two are fed the same m, l and dsum (the
# plain forward's), so only the backward's arithmetic differs: f32 sums in
# other orders (relative L2 <= 1e-5 per output); bf16 rounds ds and p to
# bf16 before the second products on both sides, where a last-bit f32
# difference can flip a rounding (relative L2 <= 1e-2).
def _rel_l2(a, b):
    a, b = a.float(), b.float()
    return float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b).clamp_min(1e-30))


def _bwd_inputs(rng, b, tq, tk, h, hd, dtype, cuda, mask=None, **dropout):
    q, k, v = _attn_inputs(rng, b, tq, tk, h, hd, dtype, cuda)
    do = torch.as_tensor(rng.standard_normal((b, tq, h, hd)).astype(np.float32), device=cuda).to(dtype)
    o, m, l = plain_fused_attention(q, k, v, mask, **dropout)
    dsum = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
    return q, k, v, do, m, l, dsum


@pytest.mark.parametrize(
    "b,tq,tk,h,hd,dtype,mask_kind",
    [
        (64, 5, 512, 8, 16, torch.float32, "markers"),  # MFMF block 1: other -> tma
        (64, 5, 4096, 8, 16, torch.float32, "ragged"),  # block 2: result -> wsi bag
        (64, 4096, 5, 8, 16, torch.float32, None),  # block 3: reconstruct -> result
        (1, 4096, 4096, 8, 64, torch.float32, None),  # the bag gradient shape
        (1, 4096, 4096, 8, 64, torch.bfloat16, None),
        (2, 257, 257, 4, 64, torch.bfloat16, "ragged"),
        (1, 40, 1100, 2, 40, torch.float32, "ragged"),  # hd padded to 64
        (3, 7, 5, 3, 16, torch.float32, None),  # one partial tile each way
        (1, 130, 70, 2, 128, torch.float32, "ragged"),
        (1, 130, 70, 2, 128, torch.bfloat16, "ragged"),
    ],
)
def test_attention_bwd_kernel_matches_plain(cuda, b, tq, tk, h, hd, dtype, mask_kind):
    rng = np.random.default_rng(tq + tk + hd)
    mask = None
    if mask_kind == "ragged":
        n_valid = rng.integers(tk // 2, tk + 1, b)
        mask = torch.as_tensor(np.arange(tk)[None] < n_valid[:, None], device=cuda)
    elif mask_kind == "markers":  # 8 markers of 9-16 valid of 64 padded rows
        mask = torch.as_tensor(np.concatenate(
            [np.arange(64)[None] < rng.integers(9, 17, (b, 1)) for _ in range(8)], axis=1), device=cuda)
    args = _bwd_inputs(rng, b, tq, tk, h, hd, dtype, cuda, mask)
    before = attention_bwd.launches
    got = attention_bwd(*args, mask)
    again = attention_bwd(*args, mask)
    want = plain_fused_attention_bwd(*args, mask)
    torch.cuda.synchronize()
    assert attention_bwd.launches == before + 2
    assert all(torch.equal(x, y) for x, y in zip(got, again))  # no atomics
    bar = 1e-5 if dtype == torch.float32 else 1e-2
    for g, w, name in zip(got, want, ("dq", "dk", "dv")):
        assert g.dtype == dtype and g.shape == w.shape
        assert _rel_l2(g, w) <= bar, (name, _rel_l2(g, w))


def test_attention_bwd_kernel_all_masked_and_per_case_seeds(cuda):
    """Dropout 0.1 with one seed per case against the plain version; case 0
    is all masked (dq = dk = 0, dv through the uniform p), case 1 ragged."""
    rng = np.random.default_rng(4)
    b, tq, tk, h, hd = 3, 70, 300, 2, 32
    mask = torch.ones((b, tk), dtype=torch.bool, device=cuda)
    mask[0] = False
    mask[1, 211:] = False
    seeds = torch.as_tensor([7, -1399772917, 123456], dtype=torch.int32, device=cuda)
    drop = dict(dropout_rate=0.1, seed=seeds)
    args = _bwd_inputs(rng, b, tq, tk, h, hd, torch.float32, cuda, mask, **drop)
    _check_attn(attention_fwd(*args[:3], mask, **drop), plain_fused_attention(*args[:3], mask, **drop),
                args[:3], mask, **drop)
    got = attention_bwd(*args, mask, **drop)
    want = plain_fused_attention_bwd(*args, mask, **drop)
    for g, w in zip(got, want):
        assert _rel_l2(g, w) <= 1e-5
    assert not got[0][0].any() and not got[1][0].any() and got[2][0].abs().max() > 0
    # one shared seed draws another mask than the per-case seeds
    shared = attention_bwd(*args, mask, dropout_rate=0.1, seed=7)
    assert torch.equal(shared[2][0], got[2][0]) and not torch.equal(shared[2][1], got[2][1])


def test_gradients_reach_projections_through_auto(cuda):
    """attention(impl='auto') on the card goes through K3 forward and K4
    backward, and the q/k/v projection weights get the gradients a CPU run
    of the same layer gets (plain K3 and K4)."""
    from multimodal_fusion_tpu_torch.models.mfmf import CrossAttentionLayer

    def layer(device):
        gen = torch.Generator(device="cpu").manual_seed(0)
        return CrossAttentionLayer(128, 8, 1, 0.0, gen).to(device)

    rng = np.random.default_rng(6)
    q = torch.as_tensor(rng.standard_normal((4, 5, 128)).astype(np.float32))
    kv = torch.as_tensor(rng.standard_normal((4, 300, 128)).astype(np.float32))
    mask = torch.as_tensor(np.arange(300)[None] < rng.integers(100, 301, (4, 1)))
    grads = {}
    for device in ("cpu", cuda):
        net = layer(device)
        before = (attention_fwd.launches, attention_bwd.launches)
        out = net(q.to(device), kv.to(device), mask.to(device))
        (out ** 2).sum().backward()
        after = (attention_fwd.launches, attention_bwd.launches)
        assert after == (before if device == "cpu" else (before[0] + 1, before[1] + 1))
        grads[str(device)] = {n: p.grad.cpu() for n, p in net.named_parameters()}
    for name in ("q_proj.weight", "k_proj.weight", "v_proj.weight"):
        g = grads[str(cuda)][name]
        assert g is not None and float(g.abs().max()) > 0, name
        assert _rel_l2(g, grads["cpu"][name]) <= 1e-4, name


def test_attention_bwd_raises_instead_of_falling_back(cuda):
    q = torch.zeros((2, 5, 2, 16), device=cuda)
    stats = torch.zeros((2, 2, 5), device=cuda)
    with pytest.raises(ValueError):  # float16 is not a K4 dtype
        attention_bwd(q.half(), q.half(), q.half(), q.half(), stats, stats + 1, stats)
    with pytest.raises(ValueError):  # mixed dtypes
        attention_bwd(q, q, q, q.bfloat16(), stats, stats + 1, stats)
    wide = torch.zeros((5, 2, 136), device=cuda)
    with pytest.raises(ValueError):  # head dim above 128
        attention_bwd(wide, wide, wide, wide, stats[0], stats[0] + 1, stats[0])
    with pytest.raises(ValueError):  # statistics of the wrong shape
        attention_bwd(q, q, q, q, stats[:, :, :4], stats + 1, stats)

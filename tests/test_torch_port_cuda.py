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
from multimodal_fusion_tpu_torch.ops.attention_kernel import ROUTES, _route, attention_bwd, attention_fwd
from multimodal_fusion_tpu_torch.io.fixtures import clustered_slide
from multimodal_fusion_tpu_torch.ops import _cuda, knn_kernel
from multimodal_fusion_tpu_torch.ops.knn import knn_indices_blockwise, knn_merge_partials, knn_partials
from multimodal_fusion_tpu_torch.ops.knn_kernel import KNN_TILE, knn, knn_launch_rows
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
    "m,n,d,bf16",
    [
        (1, 1, 1, False), (65, 129, 17, False), (300, 257, 1000, False), (130, 70, 64, True),
        # one 128 x 128 tile and one 16-wide chunk; ragged tiles at D = 1000
        # and D = 1023 (padded to 1024 by the wrapper)
        (128, 128, 16, False), (129, 257, 1000, False), (257, 130, 1023, False),
        (33, 200, 20, True), (129, 131, 1000, True),
    ],
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


@pytest.mark.parametrize("bf16", [False, True])
def test_similarity_kernel_reads_row_slices(cuda, bf16):
    """``rf[1:]`` at D = 17 starts off 16 bytes and goes through a padded
    copy; ``rf[8:]`` at D = 16 is read in place.  Both match the plain
    version, and a square call at lambda_h = 1 gives K == 1 exactly on the
    diagonal (norms and dot share one summation order)."""
    rng = np.random.default_rng(17)
    for d, start in ((17, 1), (16, 8)):
        full = torch.as_tensor((rng.standard_normal((300, d)) / np.sqrt(d)).astype(np.float32),
                               device=cuda)
        if bf16:
            full = full.to(torch.bfloat16).float()
        rf, cf = full[start:], full[:200]
        rp = torch.as_tensor(rng.uniform(0, 4, (rf.shape[0], 2)).astype(np.float32), device=cuda)
        cp = torch.as_tensor(rng.uniform(0, 4, (200, 2)).astype(np.float32), device=cuda)
        out = similarity_rect(rf, rp, cf, cp, 0.7, 1.3, bf16)
        plain = similarity_rect_plain(rf, rp, cf, cp, 0.7, 1.3, bf16)
        assert float((out - plain).abs().max()) <= 1e-5
    f, p, _ = clustered_slide(rng, 1000, 1, 1024)
    f, p = torch.as_tensor(f, device=cuda), torch.as_tensor(p, device=cuda)
    if bf16:
        f = f.to(torch.bfloat16).float()
    k = similarity_rect(f, p, f, p, 1.0, 0.5, bf16)
    torch.cuda.synchronize()
    assert bool((k.diagonal() == 1.0).all())


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_similarity_stripe_equals_the_rows_of_the_whole_k(cuda, bf16):
    """The blockwise statistics' stripes (rows r0:r0+B of the points against
    all of them) are bit-identical to the same rows of the whole K, for a
    short last stripe too: K1's value at (i, j) does not depend on the
    launch's shape."""
    rng = np.random.default_rng(23)
    f, p, _ = clustered_slide(rng, 3000, 1, 1024)
    f, p = torch.as_tensor(f, device=cuda), torch.as_tensor(p, device=cuda)
    if bf16:
        f = f.to(torch.bfloat16)
    whole = similarity_rect(f, p, f, p, 1.0, 1.0, bf16)
    for r0 in (0, 1024, 2048):
        stripe = similarity_rect(f[r0:r0 + 1024], p[r0:r0 + 1024], f, p, 1.0, 1.0, bf16)
        assert torch.equal(stripe, whole[r0:r0 + 1024])


def test_blockwise_statistics_equal_the_whole_k(cuda):
    """The build's streamed statistics on the card against the whole K of
    the same points: minimum, maximum and median bit-equal, mean and std
    within 1e-6 relative; the stats pass and the refine sweeps agree (the
    median's total cross-check)."""
    from multimodal_fusion_tpu_torch.hypergraph import build

    rng = np.random.default_rng(24)
    f, p, _ = clustered_slide(rng, 2500, 1, 256)
    f, p = torch.as_tensor(f, device=cuda), torch.as_tensor(p, device=cuda)
    labels = torch.as_tensor(rng.integers(0, 8, 2500), device=cuda)
    tsum, tsumsq, mn, mx, *_, hist = build._blockwise_similarity_stats(
        f, p, 1.0, 1.0, labels, 8, 2500, False, block=1024)
    host = {"med_cnt": hist.cpu().numpy(), "K_stats": np.zeros(5, np.float32)}
    build._attach_exact_median(host, 2500, f, p, 1.0, 1.0, False)
    want = build._matrix_stats_dev(similarity_rect(f, p, f, p)).cpu().numpy()
    cnt = 2500.0 ** 2
    mean = float(tsum) / cnt
    std = (float(tsumsq) / cnt - mean * mean) ** 0.5
    assert float(mn) == want[2] and float(mx) == want[3] and host["K_stats"][4] == want[4]
    np.testing.assert_allclose([mean, std], want[:2], rtol=1e-6)


@pytest.mark.parametrize(
    "n,k,data",
    [
        (33, 1, "integer"), (200, 6, "integer"), (700, 128, "integer"), (1500, 6, "float"),
        # one 128-row tile and one row under and over it; k at its ends; on
        # 132 SMs the last key segment holds 1 key (129 keys: 2 segments of
        # one 128-key tile; 257: 3, the last with fewer keys than k = 17);
        # 4097 keys go in 4 segments of 9, 9, 9 and 6 tiles
        (127, 6, "integer"), (129, 6, "integer"), (4097, 6, "float"), (129, 1, "integer"),
        (129, 128, "integer"), (257, 17, "integer"), (4097, 6, "integer"),
    ],
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
    d_again, i_again = knn(x, k)
    d_p, i_p = knn_indices_blockwise(x, k, block=256)
    torch.cuda.synchronize()
    assert knn.launches == before + 2
    assert torch.equal(d_k, d_again) and torch.equal(i_k, i_again)  # no atomics on the result
    assert torch.equal(i_k[:, 0], torch.arange(n, device=cuda))
    if data == "integer":
        assert torch.equal(i_k, i_p)
        assert float((d_k - d_p).abs().max()) <= 1e-5
        s = knn_launch_rows(x, k)[1]
        # the plain versions of the two launches at the kernel's S
        d_s, i_s = knn_merge_partials(*knn_partials(x, k, s, unit=KNN_TILE), k)
        assert torch.equal(i_k, i_s) and torch.equal(d_k, d_s)
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


@pytest.mark.parametrize("view", ["d37", "d37_row_slice", "offset_base", "column_slice"])
def test_knn_kernel_reads_padded_rows(cuda, view):
    """Rows K2 cannot read 16 bytes at a time (D 37, ``x[1:]`` at D 37, a
    base 4 bytes off 16, a column slice) go through a zero-padded copy and
    give what a contiguous aligned copy gives, bit for bit."""
    rng = np.random.default_rng(37)
    flat = torch.as_tensor(rng.standard_normal(1001 * 40 + 1).astype(np.float32), device=cuda)
    x = {
        "d37": lambda: flat[:1000 * 37].view(1000, 37),
        "d37_row_slice": lambda: flat[:1001 * 37].view(1001, 37)[1:],
        "offset_base": lambda: flat[1:1 + 1000 * 40].view(1000, 40),
        "column_slice": lambda: flat[:1000 * 40].view(1000, 40)[:, :36],
    }[view]()
    assert knn_launch_rows(x, 6)[0].data_ptr() != x.data_ptr()
    d_k, i_k = knn(x, 6)
    d_c, i_c = knn(x.clone(memory_format=torch.contiguous_format), 6)
    torch.cuda.synchronize()
    assert torch.equal(d_k, d_c) and torch.equal(i_k, i_c)
    assert torch.equal(i_k[:, 0], torch.arange(1000, device=cuda))


def test_knn_c_entry_refuses_what_it_cannot_serve(cuda):
    """``mmf_knn`` refuses k outside [1, 128], S outside [1, 16], rows it
    cannot read 16 bytes at a time; the wrapper raises on its error code."""
    x = torch.zeros((200, 40), device=cuda)
    out_d = torch.empty((200, 129), device=cuda)
    out_i = torch.empty((200, 129), dtype=torch.int32, device=cuda)
    part = torch.empty((17 * 200 * 129,), device=cuda)
    lib = knn_kernel._lib()
    for ptr, d, k, s in ((x.data_ptr(), 40, 0, 1), (x.data_ptr(), 40, 129, 1),
                         (x.data_ptr(), 40, 6, 0), (x.data_ptr(), 40, 6, 17),
                         (x.data_ptr(), 37, 6, 1), (x.data_ptr() + 4, 36, 6, 1)):
        err = _cuda.call(x.device, lib.mmf_knn, ptr, out_d.data_ptr(), out_i.data_ptr(),
                         part.data_ptr(), part.data_ptr(), 200, d, k, s)
        with pytest.raises(RuntimeError, match="knn kernel"):
            _cuda.check(err, "knn kernel")
    for k in (0, 129):
        with pytest.raises(ValueError):
            knn(x, k)


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
    """Relative L2 distance of ``a`` from ``b``, on the CPU (the card-vs-CPU
    tests below hold a card tensor against a CPU one)."""
    a, b = a.float().cpu(), b.float().cpu()
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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd", [16, 20, 32, 64, 128])
@pytest.mark.parametrize("side", ["q", "k"])
@pytest.mark.parametrize("narrow", [1, 5, 16, 17])
def test_attention_routes_match_plain(cuda, narrow, side, hd, dtype):
    """K3 and K4 on the shape's route (narrow_q, narrow_k, or general at 17)
    against their plain versions and against the general route on the same
    inputs: no mask, a ragged mask with case 0 all masked, and dropout 0.1
    with per-case seeds; two launches bit-identical; the route counters
    show which kernel ran.  The long side is 300: several narrow blocks."""
    rng = np.random.default_rng(narrow * 100 + hd + (side == "k"))
    b, h, long_side = 3, 2, 300
    tq, tk = (narrow, long_side) if side == "q" else (long_side, narrow)
    route = _route(tq, tk, hd)
    assert route == ("general" if narrow > 16 else f"narrow_{side}")
    # at least 2 valid keys per case where Tk allows: over one key the
    # softmax is a constant and dq, dk are rounding noise
    ragged = torch.as_tensor(np.arange(tk)[None] < rng.integers(min(2, tk), tk + 1, (b, 1)),
                             device=cuda)
    ragged[0] = False
    seeds = torch.as_tensor(rng.integers(-2 ** 31, 2 ** 31, b), dtype=torch.int32, device=cuda)
    bar = 1e-5 if dtype == torch.float32 else 1e-2
    for mask, drop in ((None, {}), (ragged, {}), (ragged, dict(dropout_rate=0.1, seed=seeds))):
        args = _bwd_inputs(rng, b, tq, tk, h, hd, dtype, cuda, mask, **drop)
        q, k, v = args[:3]
        fwd0, bwd0 = dict(attention_fwd.route_launches), dict(attention_bwd.route_launches)
        got = attention_fwd(q, k, v, mask, **drop)
        again = attention_fwd(q, k, v, mask, **drop)
        grads = attention_bwd(*args, mask, **drop)
        grads_again = attention_bwd(*args, mask, **drop)
        torch.cuda.synchronize()
        assert attention_fwd.route_launches == dict(fwd0, **{route: fwd0[route] + 2})
        assert attention_bwd.route_launches == dict(bwd0, **{route: bwd0[route] + 2})
        assert all(torch.equal(x, y) for x, y in zip(got, again))
        assert all(torch.equal(x, y) for x, y in zip(grads, grads_again))
        plain = plain_fused_attention(q, k, v, mask, **drop)
        _check_attn(got, plain, (q, k, v), mask, **drop)
        want = plain_fused_attention_bwd(*args, mask, **drop)
        # a softmax over one key is a constant: dq and dk are 0 in exact
        # arithmetic and rounding noise on both sides, so at Tk = 1 they are
        # held against the norm of dv instead of their own
        scales = [w.float().norm() if tk > 1 else want[2].float().norm() for w in want[:2]]
        for g, w, name, sc in zip(grads, want, ("dq", "dk", "dv"), scales + [want[2].float().norm()]):
            assert g.dtype == dtype and g.shape == w.shape
            err = float((g.float() - w.float()).norm() / sc.clamp_min(1e-30))
            assert err <= bar, (name, err)
        if mask is not None:  # case 0 all masked: m = -1e9, dq = dk = 0
            assert torch.all(got[1][0] == -1e9)
            assert not grads[0][0].any() and not grads[1][0].any()
        # the general route on the same inputs, held to the same plain outputs
        general = attention_fwd(q, k, v, mask, route="general", **drop)
        _check_attn(general, plain, (q, k, v), mask, **drop)
        for g, w, sc in zip(attention_bwd(*args, mask, route="general", **drop), want,
                            scales + [want[2].float().norm()]):
            assert float((g.float() - w.float()).norm() / sc.clamp_min(1e-30)) <= bar


@pytest.mark.parametrize("hd", [20, 40, 64])
def test_attention_bf16_general_route_strided_and_unaligned(cuda, hd):
    """The general bf16 route on q/k/v views of a fused [B, T, 3, H, hd]
    projection: read in place where every row is 16-byte aligned (hd 40,
    64), copied to padded rows where not (hd 20: 40-byte rows)."""
    rng = np.random.default_rng(hd)
    qkv = torch.as_tensor(rng.standard_normal((2, 257, 3, 4, hd)).astype(np.float32),
                          device=cuda).to(torch.bfloat16)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    before = attention_fwd.route_launches["general"]
    got = attention_fwd(q, k, v)
    assert attention_fwd.route_launches["general"] == before + 1
    want = plain_fused_attention(q.contiguous(), k.contiguous(), v.contiguous())
    _check_attn(got, want, (q, k, v))
    assert torch.equal(attention_fwd(q.contiguous(), k.contiguous(), v.contiguous())[0], got[0])


def test_attention_routes_refuse_shapes_they_do_not_serve(cuda):
    q = torch.zeros((2, 20, 2, 16), device=cuda)
    k = torch.zeros((2, 5, 2, 16), device=cuda)
    with pytest.raises(ValueError):
        attention_fwd(q, k, k, route="narrow_q")  # Tq 20 > 16
    with pytest.raises(ValueError):
        attention_fwd(q, q, q, route="narrow_k")  # Tk 20 > 16
    with pytest.raises(ValueError):
        attention_fwd(q, k, k, route="flash")
    assert set(attention_fwd.route_launches) == set(ROUTES)


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


def _flagship(key, device, dim=256, out=32):
    from multimodal_fusion_tpu_torch.config import ModelConfig
    from multimodal_fusion_tpu_torch.models.factory import ModelFactory

    chans = ["wsi=features", "tma=cd3=features", "tma=cd8=features", "clinical=val", "clinical=mask"]
    cfg = ModelConfig(model_type=key, n_classes=2, input_dim=dim, model_size="64*32", dropout=0.25,
                      output_dim=out, inst_number=8, base_weight=0.9, subtyping=True,
                      channels_used_in_model=chans, channel_input_dims={"clinical=val": 16})
    return ModelFactory.create_model(cfg, seed=0, device=device)


def _flagship_window(device, G=4, dim=256, seed=0):
    """A padded window: WSI bags of 5-600 of 640 slots (some below
    inst_number), two markers of 3-12 patches, clinical values with a mask."""
    rng = np.random.default_rng(seed)
    n = rng.integers(5, 601, G)
    n[0] = 5
    masks = {"wsi=features": np.arange(640)[None, :] < n[:, None]}
    chans = {"wsi=features": rng.standard_normal((G, 640, dim)).astype(np.float32)}
    for mk in ("cd3", "cd8"):
        m = rng.integers(3, 13, G)
        chans[f"tma={mk}=features"] = rng.standard_normal((G, 16, dim)).astype(np.float32)
        masks[f"tma={mk}=features"] = np.arange(16)[None, :] < m[:, None]
    chans["clinical=val"] = rng.standard_normal((G, 1, 16)).astype(np.float32)
    chans["clinical=mask"] = (rng.random((G, 1, 16)) > 0.2).astype(np.float32)
    put = lambda d: {k: torch.as_tensor(v, device=device) for k, v in d.items()}  # noqa: E731
    return ({"channels": put(chans), "masks": put(masks)},
            torch.as_tensor(np.arange(G) % 2, device=device))


@pytest.mark.parametrize("key", ["svd_gate_random_clam", "svd_gate_random_clam_detach",
                                 "deep_supervise_svd_gate_random", "clam_mlp"])
def test_flagship_forward_card_matches_cpu(cuda, key):
    """The flagship family's eval forward on the card against the CPU from
    the same weights and window (true float32 on both: TF32 off), and no
    launch of K1-K4 (no TPU kernel lies on this path)."""
    card = _flagship(key, cuda)
    host = _flagship(key, "cpu")
    host.load_state_dict({k: v.cpu() for k, v in card.state_dict().items()})
    case, label = _flagship_window(cuda)
    host_case = {k: {c: t.cpu() for c, t in case[k].items()} for k in case}
    counters = (similarity_rect, knn, attention_fwd, attention_bwd)
    before = [fn.launches for fn in counters]
    with torch.no_grad():
        got = card(case, label)
        loss = card.loss_fn(got["logits"], label, got)
        want = host(host_case, label.cpu())
        want_loss = host.loss_fn(want["logits"], label.cpu(), want)
    torch.cuda.synchronize()
    assert [fn.launches for fn in counters] == before
    torch.testing.assert_close(got["logits"].cpu(), want["logits"], rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(got["probabilities"].cpu(), want["probabilities"], rtol=0, atol=1e-5)
    torch.testing.assert_close(loss.cpu(), want_loss, rtol=1e-4, atol=1e-5)


def test_flagship_bf16_and_drop_prob_on_card(cuda, tmp_path):
    """bfloat16 evaluation within 4e-2 of float32 probabilities; the detach
    model at drop_prob 0 equals its forward without it, and at drop_prob 1
    its fusion input is all zeros."""
    from multimodal_fusion_tpu_torch.config import Configs, ModelConfig
    from multimodal_fusion_tpu_torch.train.survival import SurvivalTrainer

    model = _flagship("svd_gate_random_clam_detach", cuda)
    case, label = _flagship_window(cuda, seed=1)
    cfg = Configs(model_config=ModelConfig())
    cfg.model_config.extra["compute_dtype"] = "bfloat16"
    tr = SurvivalTrainer(cfg, tmp_path, device=cuda)
    _, p16, _, l16, _ = tr._eval_window(tr._compute_model(model), {**case, "label": label})
    with torch.no_grad():
        p32 = model(case, label)["probabilities"]
        gen = torch.Generator(device=cuda)
        zero = model(case, label, generator=gen.manual_seed(0), drop_prob=0.0)
        ones = model(case, label, generator=gen.manual_seed(0), drop_prob=1.0)
        head = model.fusion_prediction(torch.zeros(len(label), model.fusion_prediction[0].in_features,
                                                      device=cuda))
    assert p16.dtype == torch.float32 and torch.isfinite(l16).all()
    assert float((p16 - p32).abs().max()) <= 4e-2
    assert torch.equal(zero["probabilities"], p32)
    assert torch.equal(ones["logits"], head)


@pytest.mark.parametrize("loss_type,svd_impl,lambda2", [("volume", "gram", 0.0),
                                                        ("rank1", "gram", 0.1)])
def test_alignment_step_card_matches_cpu(cuda, loss_type, svd_impl, lambda2):
    """One alignment batch card vs CPU from the same weights, batch and
    predictor dropout masks (drawn by one CPU generator): loss within 1e-5
    relative, the alignment layers' gradients within 1e-4 relative L2; no
    kernel of the port is launched."""
    from multimodal_fusion_tpu_torch.models.alignment import MultiModalAlignmentModel
    from multimodal_fusion_tpu_torch.train.alignment import MultiModalAlignmentTrainer

    markers = ["cd3", "cd8", "he"]
    rng = np.random.default_rng(0)
    pos = {m: rng.standard_normal((64, 64)).astype(np.float32) / 8 for m in markers}
    neg = {m: rng.standard_normal((64, 64)).astype(np.float32) / 8 for m in markers}
    counters = (similarity_rect, knn, attention_fwd, attention_bwd)
    before = [fn.launches for fn in counters]
    out = {}
    for dev in (cuda, torch.device("cpu")):
        model = MultiModalAlignmentModel(markers, feature_dim=64, num_layers=2,
                                         generator=torch.Generator().manual_seed(0)).to(dev)
        tr = MultiModalAlignmentTrainer(model, loss_type=loss_type, svd_impl=svd_impl,
                                        lambda2=lambda2, tau2=0.05, loss2_chunk_size=8)
        loss, _ = tr._loss(tr._to_device(pos), tr._to_device(neg), torch.Generator().manual_seed(1),
                           True)
        out[dev.type] = (loss.detach().cpu(), torch.autograd.grad(loss, tr.params))
    assert [fn.launches for fn in counters] == before
    (lc, gc), (lh, gh) = out["cuda"], out["cpu"]
    assert float((lc - lh).abs() / lh.abs()) <= 1e-5
    assert max(_rel_l2(a, b) for a, b in zip(gc, gh)) <= 1e-4


def test_vae_step_card_matches_cpu(cuda):
    """One VAE training step card vs CPU from the same weights, batch and
    draws (keep masks and noise drawn once on the CPU): loss within 1e-5
    relative, gradients within 1e-4 relative L2."""
    from multimodal_fusion_tpu_torch.models.vae import VAE, vae_loss

    rng = np.random.default_rng(0)
    x = torch.as_tensor(rng.standard_normal((256, 1024)).astype(np.float32))
    g = torch.Generator().manual_seed(3)
    draws = {"encoder": [torch.rand((256, 512), generator=g) < 0.9],
             "eps": torch.randn((256, 128), generator=g),
             "decoder": [torch.rand((256, 256), generator=g) < 0.9]}
    out = {}
    for dev in (cuda, torch.device("cpu")):
        model = VAE(generator=torch.Generator().manual_seed(0)).to(dev)
        loss = vae_loss(x.to(dev), *model(x.to(dev), train=True, draws=draws))[0]
        out[dev.type] = (loss.detach().cpu(), torch.autograd.grad(loss, list(model.parameters())))
    (lc, gc), (lh, gh) = out["cuda"], out["cpu"]
    assert float((lc - lh).abs() / lh.abs()) <= 1e-5
    assert max(_rel_l2(a, b) for a, b in zip(gc, gh)) <= 1e-4


def test_world_of_one_nccl_sharded_similarity_and_training_step(cuda, tmp_path):
    """An NCCL world of 1 in a subprocess (``multihost.run_gang``): K1's
    sharded stripe equals the whole K's rows bit for bit, the mesh build
    equals the unsharded one, and one flagship window sharded equals it
    unsharded (loss 1e-5, gradients 1e-4, parameters 1e-5)."""
    from multimodal_fusion_tpu_torch.parallel.multihost import run_gang

    dry = "multimodal_fusion_tpu_torch.parallel.dryrun"
    calls = [(f"{dry}:check_sharded_similarity", dict(n=1024, dim=256), {"data": 1}),
             (f"{dry}:check_build", dict(n_patches=2048, dim=64), {"data": 1}),
             (f"{dry}:check_flagship_step", dict(G=8, tol={"loss": 1e-5, "grad": 1e-4,
                                                           "param": 1e-5}), {"data": 1})]
    (results,), _ = run_gang(f"{dry}:run_calls", 1, {"calls": calls, "device": "cuda"},
                             timeout=600, device="cuda", workdir=tmp_path)
    for res in results:
        assert "raised" not in res, res
    assert results[0]["equal"] and results[0]["launches"] == 1

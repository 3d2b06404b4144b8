"""The port's CUDA kernels against their plain PyTorch versions, on the card.

CUDA kernels have no CPU mode, so every test here carries the ``cuda``
marker and skips without a CUDA device.  On a machine with one:

    python -m pytest tests/test_torch_port_cuda.py -m cuda -q
"""

import numpy as np
import pytest
import torch

from multimodal_fusion_tpu_torch.channels import TMA_MARKERS
from multimodal_fusion_tpu_torch.device import resolve_device
from multimodal_fusion_tpu_torch.ops.attention import (
    fused_attention,
    plain_fused_attention,
    plain_fused_attention_bwd,
)
from multimodal_fusion_tpu_torch.ops.attention_kernel import ROUTES, _route, attention_bwd, attention_fwd
from multimodal_fusion_tpu_torch.io.fixtures import TABULAR_DIMS, clustered_slide
from multimodal_fusion_tpu_torch.ops import _cuda, knn_kernel
from multimodal_fusion_tpu_torch.ops.knn import knn_indices_blockwise, knn_merge_partials, knn_partials
from multimodal_fusion_tpu_torch.ops.knn_kernel import KNN_TILE, knn, knn_launch_rows
from multimodal_fusion_tpu_torch.ops.layer_norm import layer_norm, layer_norm_bwd, plain_layer_norm
from multimodal_fusion_tpu_torch.ops.similarity_kernel import (
    similarity_rect,
    similarity_rect_plain,
)
from multimodal_fusion_tpu_torch.utils import profiling

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
        # the build's: a slide of 4096 patches (f32 and bf16 upload), a
        # ragged [1000, 3001] at D = 1000, and a blockwise statistics stripe
        (4096, 4096, 1024, False), (4096, 4096, 1024, True), (1000, 3001, 1000, False),
        (1024, 65536, 1024, False),
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
        # 5000 keys at k 6 and 128; the large-node build's 4096 nodes
        (5000, 6, "integer"), (5000, 128, "integer"), (4096, 6, "float"),
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
# relative, m within 1e-6 of max(|m|, 1) up to hd 64 and 1e-6 + 1e-6 |m| at
# hd 128 (the dots sum in another order, over up to 128 products; m is
# exact where the scores are, see the grid case); bf16 o within 2e-2 (p
# rounds to bf16 before P.V on both sides, a last-bit difference in f32 p
# can flip one rounding).
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
    m_tol = 1e-6 * want[1].abs().clamp_min(1) if q.shape[-1] <= 64 else 1e-6 + 1e-6 * want[1].abs()
    assert bool(((got[1] - want[1]).abs() <= m_tol).all())
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
        (32, 257, 257, 16, 64, torch.float32),  # a ViT-L/16 batch
        (32, 257, 257, 16, 64, torch.bfloat16),
        (2, 4096, 4096, 8, 64, torch.float32),  # the bag shape
        (2, 4096, 4096, 8, 64, torch.bfloat16),
        (64, 5, 512, 8, 16, torch.float32),  # MFMF's blocks 1, 2 (narrow_q), 3 (narrow_k)
        (64, 5, 512, 8, 16, torch.bfloat16),
        (64, 5, 4096, 8, 16, torch.float32),
        (64, 5, 4096, 8, 16, torch.bfloat16),
        (64, 4096, 5, 8, 16, torch.float32),
        (64, 4096, 5, 8, 16, torch.bfloat16),
        (64, 512, 4096, 8, 16, torch.bfloat16),  # mfmf_config1's blocks 2 and 3
        (64, 4096, 512, 8, 16, torch.bfloat16),
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


@pytest.mark.parametrize("b,tq,tk,h,dtype", [(2, 100, 90, 2, torch.float32),
                                              (32, 257, 257, 16, torch.float32),
                                              (32, 257, 257, 16, torch.bfloat16)])
def test_attention_kernel_m_exact_on_exact_scores(cuda, b, tq, tk, h, dtype):
    """Where every score is exact in f32 the row max is too."""
    q, k, v = _attn_inputs(np.random.default_rng(0), b, tq, tk, h, 64, dtype, cuda, grid=True)
    got = attention_fwd(q, k, v)
    want = plain_fused_attention(q, k, v)
    assert torch.equal(got[1], want[1])


# large scores at the short shape; the bag shape's draws as they come
@pytest.mark.parametrize("tq,tk,h,valid,scale", [(33, 300, 2, 211, 40), (4096, 4096, 8, 3001, 1)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attention_kernel_masking_replaces(cuda, dtype, tq, tk, h, valid, scale):
    """All-masked rows give the uniform average of v and m = -1e9 exactly;
    keys of a ragged valid length are excluded."""
    rng = np.random.default_rng(1)
    q, k, v = _attn_inputs(rng, 2, tq, tk, h, 64, dtype, cuda)
    q, k = q * scale, k * scale
    mask = torch.ones((2, tk), dtype=torch.bool, device=cuda)
    mask[0] = False
    mask[1, valid:] = False
    got = attention_fwd(q, k, v, mask)
    want = plain_fused_attention(q, k, v, mask)
    _check_attn(got, want, (q, k, v), mask)
    assert torch.all(got[1][0] == -1e9)
    scale = None
    if dtype == torch.bfloat16:
        scale = plain_fused_attention(q, k, v.abs(), mask)[0]
    uniform = v[0].float().mean(0)[None].expand_as(got[0][0])  # [H, hd] per query
    assert _o_close(got[0][0], uniform, None if scale is None else scale[0])
    cut = attention_fwd(q[1:], k[1:, :valid], v[1:, :valid])
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


@pytest.mark.parametrize("b,h,dtype", [(2, 4, torch.float32), (32, 16, torch.float32),
                                       (32, 16, torch.bfloat16)])
def test_attention_kernel_reads_strided_qkv(cuda, b, h, dtype):
    """q, k, v as views of a fused [B, T, 3, H, hd] projection (the ViT's)."""
    rng = np.random.default_rng(3)
    qkv = torch.as_tensor(rng.standard_normal((b, 257, 3, h, 64)).astype(np.float32),
                          device=cuda).to(dtype)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    got = attention_fwd(q, k, v)
    want = plain_fused_attention(q.contiguous(), k.contiguous(), v.contiguous())
    _check_attn(got, want, (q, k, v))
    one = attention_fwd(q[1], k[1], v[1])  # unbatched [T, H, hd]
    assert one[0].shape == (257, h, 64) and one[1].shape == (h, 257)
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
        # mfmf_config1's block 2 (result -> wsi bag) and block 3
        # (reconstruct -> result: 8 markers' buckets) at 64 cases
        (64, 512, 4096, 8, 16, torch.float32, "ragged"),
        (64, 4096, 512, 8, 16, torch.float32, "markers"),
        (64, 512, 4096, 8, 16, torch.bfloat16, "ragged"),
        (64, 4096, 512, 8, 16, torch.bfloat16, "markers"),
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
    undropped = attention_bwd(*args, mask)  # case 0's dv through the uniform p: sum_q do / Tk
    assert float((undropped[2][0] - args[3][0].sum(0) / tk).abs().max()) <= 1e-6
    # one shared seed draws another mask than the per-case seeds
    shared = attention_bwd(*args, mask, dropout_rate=0.1, seed=7)
    assert torch.equal(shared[2][0], got[2][0]) and not torch.equal(shared[2][1], got[2][1])


def _key_mask(rng, kind, b, tk, cuda, all_masked=True):
    """Key masks for ``b`` cases: ``wsi`` keeps a prefix of tk/2..tk keys
    (mfmf_config1's WSI bag: 2048-4096 of 4096), ``buckets`` 9-16 keys of
    each 64-key bucket (its 8 markers at tk 512), ``scattered`` each key
    with probability 0.05 (a run of 16 then holds none 44% of the time).
    Case 0 keeps no key when ``all_masked``, else at least its first."""
    if kind == "wsi":
        mask = np.arange(tk)[None] < rng.integers(tk // 2, tk + 1, (b, 1))
    elif kind == "buckets":
        mask = np.concatenate([np.arange(64)[None] < rng.integers(9, 17, (b, 1))
                               for _ in range(tk // 64)], axis=1)
    else:
        mask = rng.random((b, tk)) < 0.05
    if all_masked:
        mask[0] = False
    else:
        mask[:, 0] = True
    return torch.as_tensor(mask, device=cuda)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("drop", [False, True], ids=["no_dropout", "per_case_seeds"])
@pytest.mark.parametrize("kind,tq,tk", [("wsi", 512, 4096), ("buckets", 4096, 512)],
                         ids=["block2_wsi", "block3_buckets"])
def test_attention_bwd_general_hd16_on_config1_masks(cuda, kind, tq, tk, drop, dtype):
    """K4's general route at hd 16 (unpadded) at mfmf_config1's blocks 2 and
    3 on 6 cases: ragged WSI masks or bucket masks (whose runs of 16 keys
    without a valid key the kernel skips), case 0 all masked (dq = dk = 0, dv
    through the uniform p), with and without dropout 0.1 under per-case
    seeds; against the plain version, two launches bit-identical."""
    rng = np.random.default_rng(tq + 3 * drop)
    b, h, hd = 6, 8, 16
    mask = _key_mask(rng, kind, b, tk, cuda)
    dropout = {}
    if drop:
        seeds = torch.as_tensor(rng.integers(-2 ** 31, 2 ** 31, b), dtype=torch.int32, device=cuda)
        dropout = dict(dropout_rate=0.1, seed=seeds)
    args = _bwd_inputs(rng, b, tq, tk, h, hd, dtype, cuda, mask, **dropout)
    assert _route(tq, tk, hd) == "general"
    before = attention_bwd.route_launches["general"]
    got = attention_bwd(*args, mask, **dropout)
    again = attention_bwd(*args, mask, **dropout)
    want = plain_fused_attention_bwd(*args, mask, **dropout)
    torch.cuda.synchronize()
    assert attention_bwd.route_launches["general"] == before + 2
    assert all(torch.equal(x, y) for x, y in zip(got, again))  # no atomics
    bar = 1e-5 if dtype == torch.float32 else 1e-2
    for g, w, name in zip(got, want, ("dq", "dk", "dv")):
        assert g.dtype == dtype and g.shape == w.shape
        assert _rel_l2(g, w) <= bar, (name, _rel_l2(g, w))
    assert not got[0][0].any() and not got[1][0].any() and got[2][0].abs().max() > 0
    # a masked key of a case that keeps one has dk = dv = 0 exactly
    masked = ~mask[1:]
    assert not got[1][1:][masked].any() and not got[2][1:][masked].any()


def _one_pass_calls(*args, **kwargs):
    """(K4's outputs, how far ``attention_bwd.one_pass`` moved) of one call."""
    before = profiling.counters().get("attention_bwd.one_pass", 0)
    got = attention_bwd(*args, **kwargs)
    return got, profiling.counters().get("attention_bwd.one_pass", 0) - before


# K4's float32 general route takes one pass where the short side's sums fit
# the block's shared memory (attention_bwd.cu: OnePass): mfmf_config1's
# blocks 2 (keys long: dq summed over spans of 512 keys) and 3 (q rows long:
# dk and dv summed), a short side at hd 32 and one at hd 64 at the limit, and
# long sides of several spans with a ragged last one.
_ONE_PASS = [  # (hd, b, tq, tk, mask kind)
    (16, 6, 512, 4096, "wsi"),  # config1 block 2
    (16, 6, 4096, 512, "buckets"),  # config1 block 3
    (32, 3, 256, 1100, "scattered"),
    (64, 3, 1300, 128, "buckets"),  # 64 KB of dk and dv sums: the limit
]


@pytest.mark.parametrize("drop", [False, True], ids=["no_dropout", "per_case_seeds"])
@pytest.mark.parametrize("hd,b,tq,tk,kind", _ONE_PASS)
def test_attention_bwd_one_pass(cuda, hd, b, tq, tk, kind, drop):
    """The one-pass route against the plain version at the file's float32
    tolerance, case 0 all masked (dq = dk = 0, dv through the uniform p),
    with and without dropout 0.1 under per-case seeds: a masked key of a
    live case gets dk = dv = 0 exactly, two launches are bit-identical, and
    ``attention_bwd.one_pass`` moves by one a call."""
    rng = np.random.default_rng(tq + tk + hd + drop)
    mask = _key_mask(rng, kind, b, tk, cuda)
    dropout = _listing_seeds(rng, b, cuda, drop)
    args = _bwd_inputs(rng, b, tq, tk, 8 if hd == 16 else 2, hd, torch.float32, cuda, mask, **dropout)
    assert _route(tq, tk, hd) == "general"
    got, moved = _one_pass_calls(*args, mask, **dropout)
    again, moved_again = _one_pass_calls(*args, mask, **dropout)
    want = plain_fused_attention_bwd(*args, mask, **dropout)
    torch.cuda.synchronize()
    assert (moved, moved_again) == (1, 1)
    assert all(torch.equal(x, y) for x, y in zip(got, again))  # no atomics
    for g, w, name in zip(got, want, ("dq", "dk", "dv")):
        assert g.dtype == torch.float32 and g.shape == w.shape
        assert _rel_l2(g, w) <= 1e-5, (name, _rel_l2(g, w))
    assert not got[0][0].any() and not got[1][0].any() and got[2][0].abs().max() > 0
    masked = ~mask[1:]
    assert not got[1][1:][masked].any() and not got[2][1:][masked].any()


@pytest.mark.parametrize(
    "b,tq,tk,h,hd,dtype",
    [
        (1, 4096, 4096, 8, 64, torch.float32),  # the bag shape: both sides long
        (2, 2048, 600, 2, 16, torch.float32),  # 75 KB of dk and dv sums at hd 16
        (1, 130, 70, 2, 128, torch.float32),  # hd 128
        (6, 512, 4096, 8, 16, torch.bfloat16),  # config1's block 2 in bf16
    ],
)
def test_attention_bwd_keeps_the_pair_past_the_one_pass_limit(cuda, b, tq, tk, h, hd, dtype):
    """Where the short side's sums do not fit, or in bf16, the general route
    keeps its pair of launches: ``attention_bwd.one_pass`` does not move and
    the gradients still match the plain version under a ragged mask."""
    rng = np.random.default_rng(tq + tk + hd)
    mask = torch.as_tensor(np.arange(tk)[None] < rng.integers(tk // 2, tk + 1, (b, 1)), device=cuda)
    args = _bwd_inputs(rng, b, tq, tk, h, hd, dtype, cuda, mask)
    assert _route(tq, tk, hd) == "general"
    got, moved = _one_pass_calls(*args, mask)
    want = plain_fused_attention_bwd(*args, mask)
    assert moved == 0
    bar = 1e-5 if dtype == torch.float32 else 1e-2
    for g, w, name in zip(got, want, ("dq", "dk", "dv")):
        assert _rel_l2(g, w) <= bar, (name, _rel_l2(g, w))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("kind,tq,tk", [("wsi", 512, 4096), ("buckets", 4096, 512)],
                         ids=["block2_wsi", "block3_buckets"])
def test_attention_general_hd16_on_config1_masks(cuda, kind, tq, tk, dtype):
    """K3's general route at hd 16 (its new unpadded instantiation) at
    mfmf_config1's blocks 2 and 3 on 6 cases, case 0 all masked, against
    the plain version; two launches bit-identical."""
    rng = np.random.default_rng(tk)
    mask = _key_mask(rng, kind, 6, tk, cuda)
    q, k, v = _attn_inputs(rng, 6, tq, tk, 8, 16, dtype, cuda)
    before = attention_fwd.route_launches["general"]
    got = attention_fwd(q, k, v, mask)
    again = attention_fwd(q, k, v, mask)
    assert attention_fwd.route_launches["general"] == before + 2
    assert all(torch.equal(x, y) for x, y in zip(got, again))
    _check_attn(got, plain_fused_attention(q, k, v, mask), (q, k, v), mask)


# K3's float32 general route under a key mask lists the runs of 16 keys that
# hold a valid key and streams only those (attention.cu).  The shapes below
# reach it at hd 16 and hd 64 with mfmf_config1's masks, scattered keys and
# key sides of several listed segments (over 4096 keys).
_LISTING = [  # (hd, b, tq, tk, mask kind)
    (16, 6, 512, 4096, "wsi"),  # config1 block 2: the WSI bag
    (16, 6, 4096, 512, "buckets"),  # config1 block 3: 8 markers
    (16, 6, 300, 4096, "scattered"),
    (16, 2, 70, 9000, "scattered"),  # three listed segments
    (64, 3, 130, 1024, "buckets"),
    (64, 3, 130, 1100, "wsi"),
    (64, 3, 130, 1100, "scattered"),
    (64, 2, 70, 9000, "wsi"),
    (16, 64, 512, 4096, "wsi"),  # config1's blocks 2 and 3 at 64 cases
    (16, 64, 4096, 512, "buckets"),
]


def _listing_seeds(rng, b, cuda, drop):
    if not drop:
        return {}
    seeds = torch.as_tensor(rng.integers(-2 ** 31, 2 ** 31, b), dtype=torch.int32, device=cuda)
    return dict(dropout_rate=0.1, seed=seeds)


@pytest.mark.parametrize("drop", [False, True], ids=["no_dropout", "per_case_seeds"])
@pytest.mark.parametrize("hd,b,tq,tk,kind", _LISTING)
def test_attention_f32_general_lists_runs_under_a_mask(cuda, hd, b, tq, tk, kind, drop):
    """K3's float32 general route under a key mask, case 0 keeping no key
    (the uniform average, m = -1e9), with and without dropout 0.1 under
    per-case seeds: against the plain version at the file's tolerances, two
    launches bit-identical."""
    rng = np.random.default_rng(tq + tk + hd + drop)
    mask = _key_mask(rng, kind, b, tk, cuda)
    dropout = _listing_seeds(rng, b, cuda, drop)
    q, k, v = _attn_inputs(rng, b, tq, tk, 8 if hd == 16 else 2, hd, torch.float32, cuda)
    assert _route(tq, tk, hd) == "general"
    got = attention_fwd(q, k, v, mask, **dropout)
    again = attention_fwd(q, k, v, mask, **dropout)
    assert all(torch.equal(x, y) for x, y in zip(got, again))
    _check_attn(got, plain_fused_attention(q, k, v, mask, **dropout), (q, k, v), mask, **dropout)
    assert torch.all(got[1][0] == -1e9)


@pytest.mark.parametrize("drop", [False, True], ids=["no_dropout", "per_case_seeds"])
@pytest.mark.parametrize("hd,b,tq,tk,kind", [_LISTING[0], _LISTING[1], _LISTING[6]])
def test_attention_f32_general_listing_gradients(cuda, hd, b, tq, tk, kind, drop):
    """Gradients through ``FusedAttention`` (K3's saved m and l feed K4)
    against the plain versions on the same card tensors: relative L2 within
    1e-5, as K4 against its plain version."""
    rng = np.random.default_rng(7 * tk + hd + drop)
    mask = _key_mask(rng, kind, b, tk, cuda)
    dropout = _listing_seeds(rng, b, cuda, drop)
    qkv = _attn_inputs(rng, b, tq, tk, 8 if hd == 16 else 2, hd, torch.float32, cuda)
    w = torch.as_tensor(rng.standard_normal(qkv[0].shape).astype(np.float32), device=cuda)
    grads = []
    for plain in (False, True):
        leaves = [x.clone().requires_grad_(True) for x in qkv]
        before = attention_bwd.route_launches["general"]
        o = fused_attention(*leaves, mask, plain=plain, **dropout)
        (o * w).sum().backward()
        assert attention_bwd.route_launches["general"] == before + (not plain)
        grads.append([x.grad for x in leaves])
    for g, want, name in zip(*grads, ("dq", "dk", "dv")):
        assert _rel_l2(g, want) <= 1e-5, (name, _rel_l2(g, want))


@pytest.mark.parametrize("hd,b,tq,tk,kind", [_LISTING[0], _LISTING[1], _LISTING[3], _LISTING[6]])
def test_attention_f32_general_never_reads_skipped_runs(cuda, hd, b, tq, tk, kind):
    """In cases that keep a key, K and V of every run of 16 keys without a
    valid key are NaN: the output stays finite and equal, bit for bit, to
    the output with those runs zero-filled (a kernel that read them would
    give 0 * NaN = NaN)."""
    rng = np.random.default_rng(tq + tk + hd)
    mask = _key_mask(rng, kind, b, tk, cuda, all_masked=False)
    q, k, v = _attn_inputs(rng, b, tq, tk, 8 if hd == 16 else 2, hd, torch.float32, cuda)
    runs = torch.nn.functional.pad(mask, (0, -tk % 16)).view(b, -1, 16).any(-1)
    skipped = ~runs.repeat_interleave(16, dim=1)[:, :tk]
    assert skipped.any()
    zero, nan = [], []
    for fill, out in ((0.0, zero), (float("nan"), nan)):
        kf, vf = k.clone(), v.clone()
        kf[skipped], vf[skipped] = fill, fill
        out.extend(attention_fwd(q, kf, vf, mask))
    assert all(bool(torch.isfinite(x).all()) for x in nan)
    assert all(torch.equal(x, y) for x, y in zip(nan, zero))
    _check_attn(zero, plain_fused_attention(q, k, v, mask), (q, k, v), mask)


def test_attention_run_listed_counter(cuda):
    """``attention_fwd.run_listed`` counts K3's float32 general launches
    with a key mask: not a mask-free one, a bf16 one or a narrow route's."""
    rng = np.random.default_rng(8)
    q, k, v = _attn_inputs(rng, 2, 70, 300, 2, 16, torch.float32, cuda)
    mask = _key_mask(rng, "scattered", 2, 300, cuda)

    def listed(*args):
        before = profiling.counters().get("attention_fwd.run_listed", 0)
        attention_fwd(*args)
        return profiling.counters().get("attention_fwd.run_listed", 0) - before

    assert listed(q, k, v, mask) == 1
    assert listed(q, k, v, mask[0]) == 1
    assert listed(q, k, v) == 0
    assert listed(q.bfloat16(), k.bfloat16(), v.bfloat16(), mask) == 0
    assert listed(q[:, :5], k, v, mask) == 0  # narrow_q


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


# K5 (LayerNorm) against its plain version, the composite ops it replaced,
# on the same card: relative L2 <= 1e-5 for y, dx, dw and db in float32 (the
# row sums and the sums over rows go in other orders); a bf16 y within 2^-8
# relative L2 of float32's plain y on the same values (one rounding to bf16).
def _ln_inputs(shape, cuda, seed, offset=False):
    rng = np.random.default_rng(seed)
    width = shape[-1]
    x = rng.standard_normal(shape).astype(np.float32) * 2.0 + rng.standard_normal(width).astype(np.float32)
    w = (1.0 + 0.1 * rng.standard_normal(width)).astype(np.float32)
    b = (0.02 * rng.standard_normal(width)).astype(np.float32)
    dy = rng.standard_normal(shape).astype(np.float32)
    x, w, b, dy = (torch.as_tensor(a, device=cuda) for a in (x, w, b, dy))
    if offset:  # contiguous but 4 bytes off 16: the kernels' scalar loads
        buf = torch.empty(x.numel() + 1, device=cuda)
        buf[1:] = x.reshape(-1)
        x = buf[1:].view(shape)
    return x, w, b, dy


def _ln_run(fn, x, w, b, dy):
    leaves = [t.detach().clone().requires_grad_(True) for t in (x, w, b)]
    if x.data_ptr() % 16:  # keep the offset of the input under test
        leaves[0] = x.detach().requires_grad_(True)
    y = fn(*leaves, 1e-6)
    y.backward(dy)
    return [y.detach()] + [t.grad for t in leaves]


@pytest.mark.parametrize("shape,offset", [
    ((64, 4096, 128), False), ((64, 512, 128), False), ((64, 5, 128), False),  # mfmf_config1's
    ((1000, 18), False), ((1000, 36), False), ((1000, 64), False), ((1000, 256), False),
    ((513, 1024), False), ((777, 128), True), ((9, 1000), False),
], ids=["config1_bag", "config1_markers", "config1_tabular", "w18", "w36", "w64", "w256", "w1024",
        "w128_offset", "w1000"])
def test_layer_norm_kernel_matches_plain(cuda, shape, offset):
    x, w, b, dy = _ln_inputs(shape, cuda, sum(shape), offset)
    before = (layer_norm.launches, layer_norm_bwd.launches,
              profiling.counters().get("layer_norm.fused", 0))
    got = _ln_run(layer_norm, x, w, b, dy)
    torch.cuda.synchronize()
    after = (layer_norm.launches, layer_norm_bwd.launches, profiling.counters().get("layer_norm.fused", 0))
    assert after == tuple(n + 1 for n in before)
    want = _ln_run(plain_layer_norm, x, w, b, dy)
    for name, g, t in zip(("y", "dx", "dw", "db"), got, want):
        assert _rel_l2(g, t) <= 1e-5, name


@pytest.mark.parametrize("width", [2, 36, 128])
def test_layer_norm_kernel_constant_zero_and_clipped_rows(cuda, width):
    """Constant rows (variance 0), all-zero padding rows (y = b) and, at
    width 2, rows whose raw variance E[x^2] - mu^2 rounds below 0 and is
    clipped (x = 1 + 2^-23, 1 + 2^-22: every sum exact but the squares',
    so both sides round alike), among ordinary rows: each row's y and dx
    within 1e-5 relative L2 of the plain version's, dw and db too.  At
    width 2 the ordinary rows are (1, 1 + 2^-23), variance 2^-23 unclipped:
    a pair of spread values has dx of 1 - xhat^2, all cancellation."""
    x, w, b, dy = _ln_inputs((48, width), cuda, width)
    x[0::4] = 0.75
    x[1::4] = 0.0
    if width == 2:
        x[2::4] = torch.tensor([1 + 2 ** -23, 1 + 2 ** -22], device=cuda)
        x[3::4] = torch.tensor([1.0, 1 + 2 ** -23], device=cuda)
        xs = x[2::4]
        mu = xs.mean(-1)
        assert bool(((xs * xs).mean(-1) - mu * mu < 0).all())  # the plain version clips them
    got = _ln_run(layer_norm, x, w, b, dy)
    want = _ln_run(plain_layer_norm, x, w, b, dy)
    assert torch.equal(got[0][1::4], b.expand(12, width))
    for name, g, t in zip(("y", "dx"), got, want):
        rows = [_rel_l2(g[i], t[i]) for i in range(48)]
        assert max(rows) <= 1e-5, (name, int(np.argmax(rows)))
    for name, g, t in zip(("dw", "db"), got[2:], want[2:]):
        assert _rel_l2(g, t) <= 1e-5, name


@pytest.mark.parametrize("shape", [(64, 512, 128), (1000, 36)], ids=["config1_markers", "w36"])
def test_layer_norm_kernel_bf16_forward(cuda, shape):
    x, w, b, _ = _ln_inputs(shape, cuda, 3)
    x, w, b = x.bfloat16(), w.bfloat16(), b.bfloat16()
    y = layer_norm(x, w, b)
    assert y.dtype == torch.bfloat16
    assert _rel_l2(y, plain_layer_norm(x.float(), w.float(), b.float(), 1e-6)) <= 2 ** -8
    with pytest.raises(ValueError, match="float32"):  # bf16 runs forward only
        layer_norm(x, w.requires_grad_(True), b).sum().backward()


@pytest.mark.parametrize("shape", [(64, 4096, 128), (64, 512, 128), (64, 5, 128)],
                         ids=["config1_bag", "config1_markers", "config1_tabular"])
def test_layer_norm_kernel_forward_is_the_composite_bit_for_bit(cuda, shape):
    """At mfmf_config1's width the forward's y equals the composite ops' on
    the card bit for bit: the kernel rounds each product and sum as they
    do, and the row sums of 128 values come out the same."""
    x, w, b, _ = _ln_inputs(shape, cuda, 7)
    with torch.no_grad():
        assert torch.equal(layer_norm(x, w, b), plain_layer_norm(x, w, b, 1e-6))


def test_layer_norm_kernel_refuses_a_trace(cuda):
    """Under torch.export K5 raises rather than take the plain version
    unasked; a LayerNorm set to "plain" exports the composite ops and
    launches nothing."""
    from multimodal_fusion_tpu_torch.models.common import LayerNorm

    module = LayerNorm(128, device=cuda)
    x = torch.randn(4, 128, device=cuda)
    with pytest.raises(RuntimeError, match="impl='plain'"):
        torch.export.export(module, (x,), strict=False)
    module.impl = "plain"
    before = layer_norm.launches
    program = torch.export.export(module, (x,), strict=False)
    with torch.no_grad():
        assert torch.equal(program.module()(x), plain_layer_norm(x, module.weight, module.bias, 1e-6))
    assert layer_norm.launches == before

def test_layer_norm_kernel_two_launches_bit_identical(cuda):
    x, w, b, dy = _ln_inputs((64, 4096, 128), cuda, 11)
    one, two = (_ln_run(layer_norm, x, w, b, dy) for _ in range(2))
    assert all(torch.equal(a, c) for a, c in zip(one, two))


def test_layer_norm_kernel_refuses_what_it_cannot_serve(cuda):
    x, w, b, _ = _ln_inputs((4, 1025), cuda, 0)
    with pytest.raises(ValueError, match="width 1025"):
        layer_norm(x, w, b)
    x, w, b, _ = _ln_inputs((4, 64), cuda, 0)
    with pytest.raises(ValueError):  # float64 is not a K5 dtype
        layer_norm(x.double(), w.double(), b.double())
    with pytest.raises(ValueError):  # mixed dtypes
        layer_norm(x, w.bfloat16(), b)
    with pytest.raises(ValueError):  # a parameter of another width
        layer_norm(x, w[:32], b)
    dy = torch.ones_like(x)
    with pytest.raises(ValueError):  # dy of another shape
        layer_norm_bwd(dy[:2], x, w, torch.zeros(4, device=cuda), torch.ones(4, device=cuda))


def _flagship(key, device, script=False):
    """A flagship-family model: 256-d over five channels, or with ``script``
    at combined_svd_gate_random_clam.sh's config (1024-d, output 128; WSI,
    the 8 TMA markers and the 5 tabular groups with masks; two alignment
    layers; the SVD, gate and random losses on)."""
    from multimodal_fusion_tpu_torch.channels import parse_channels
    from multimodal_fusion_tpu_torch.config import ModelConfig
    from multimodal_fusion_tpu_torch.models.factory import ModelFactory

    width = dict(input_dim=256, output_dim=32, channel_input_dims={"clinical=val": 16},
                 channels_used_in_model=["wsi=features", "tma=cd3=features", "tma=cd8=features",
                                         "clinical=val", "clinical=mask"])
    if script:
        width = dict(input_dim=1024, output_dim=128, alignment_layer_num=2, lambda1=0.1, lambda2=0.1,
                     tau1=1.0, tau2=1.0, weight_random_loss=0.1, enable_svd=True,
                     enable_dynamic_gate=True, enable_random_loss=True,
                     channels_used_in_model=parse_channels(["wsi", "tma"] + [f"{g}_mask" for g in TABULAR_DIMS]),
                     channel_input_dims={f"{g}=val": d for g, d in TABULAR_DIMS.items()})
    cfg = ModelConfig(model_type=key, n_classes=2, model_size="64*32", dropout=0.25, inst_number=8,
                      base_weight=0.9, subtyping=True, **width)
    return ModelFactory.create_model(cfg, seed=0, device=device)


def _flagship_window(device, G=4, seed=0, script=False):
    """A padded window: WSI bags of 5-600 of 640 slots (some below
    inst_number), two markers of 3-12 patches, clinical values with a mask.
    With ``script``, the script's channels as ``make_window`` pads them: WSI
    bags of 2048-4096 x 1024, each of the 8 markers' 9-16 patches, the 5
    tabular groups' values with 0/1 masks."""
    from multimodal_fusion_tpu_torch.data.batching import make_window

    rng = np.random.default_rng(seed)
    put = lambda d: {k: torch.as_tensor(v, device=device) for k, v in d.items()}  # noqa: E731
    label = torch.as_tensor(np.arange(G) % 2, device=device)
    if script:
        raws = [{"wsi=features": rng.standard_normal((rng.integers(2048, 4097), 1024), dtype=np.float32),
                 **{f"tma={mk}=features": rng.standard_normal((rng.integers(9, 17), 1024), dtype=np.float32)
                    for mk in TMA_MARKERS},
                 **{f"{g}={kind}": rng.standard_normal((1, d), dtype=np.float32) if kind == "val" else
                    (rng.random((1, d)) > 0.2).astype(np.float32)
                    for g, d in TABULAR_DIMS.items() for kind in ("val", "mask")}} for _ in range(G)]
        window = make_window(raws, np.arange(G) % 2)
        return {"channels": put(window["channels"]), "masks": put(window["masks"])}, label
    n = rng.integers(5, 601, G)
    n[0] = 5
    masks = {"wsi=features": np.arange(640)[None, :] < n[:, None]}
    chans = {"wsi=features": rng.standard_normal((G, 640, 256)).astype(np.float32)}
    for mk in ("cd3", "cd8"):
        m = rng.integers(3, 13, G)
        chans[f"tma={mk}=features"] = rng.standard_normal((G, 16, 256)).astype(np.float32)
        masks[f"tma={mk}=features"] = np.arange(16)[None, :] < m[:, None]
    chans["clinical=val"] = rng.standard_normal((G, 1, 16)).astype(np.float32)
    chans["clinical=mask"] = (rng.random((G, 1, 16)) > 0.2).astype(np.float32)
    return {"channels": put(chans), "masks": put(masks)}, label


@pytest.mark.parametrize("key,script", [
    *(pytest.param(key, False, id=key) for key in (
        "svd_gate_random_clam", "svd_gate_random_clam_detach", "deep_supervise_svd_gate_random",
        "clam_mlp")),
    pytest.param("svd_gate_random_clam", True, id="combined_svd_gate_random_clam"),
])
def test_flagship_forward_card_matches_cpu(cuda, key, script):
    """The flagship family's eval forward on the card against the CPU from
    the same weights and window (true float32 on both: TF32 off), and no
    launch of K1-K4 (no TPU kernel lies on this path); with ``script`` at
    combined_svd_gate_random_clam.sh's config on 16 cases."""
    card = _flagship(key, cuda, script)
    host = _flagship(key, "cpu", script)
    host.load_state_dict({k: v.cpu() for k, v in card.state_dict().items()})
    case, label = _flagship_window(cuda, 16 if script else 4, script=script)
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
    if "aligned_features_stack" in want:  # the SVD's input
        assert _rel_l2(got["aligned_features_stack"], want["aligned_features_stack"]) <= 1e-5
    if script:  # 7 modalities; logits within 1e-4 absolute, losses 1e-4 relative
        assert len(card.used_modality) == 7, card.used_modality
        assert float((got["logits"].cpu() - want["logits"]).abs().max()) <= 1e-4
        assert float(((loss.cpu() - want_loss).abs() / want_loss.abs()).max()) <= 1e-4


@pytest.mark.parametrize("script", [pytest.param(False, id="detach"),
                                    pytest.param(True, id="combined_svd_gate_random_clam")])
def test_flagship_bf16_and_drop_prob_on_card(cuda, tmp_path, script):
    """bfloat16 evaluation within 4e-2 of float32 probabilities; the detach
    model at drop_prob 0 equals its forward without it, and at drop_prob 1
    its fusion input is all zeros.  At the script's config the bf16 model
    is svd_gate_random_clam, on 16 cases."""
    from multimodal_fusion_tpu_torch.config import Configs, ModelConfig
    from multimodal_fusion_tpu_torch.train.survival import SurvivalTrainer

    det = _flagship("svd_gate_random_clam_detach", cuda, script)
    model = _flagship("svd_gate_random_clam", cuda, script) if script else det
    case, label = _flagship_window(cuda, 16 if script else 4, seed=1, script=script)
    cfg = Configs(model_config=ModelConfig())
    cfg.model_config.extra["compute_dtype"] = "bfloat16"
    tr = SurvivalTrainer(cfg, tmp_path, device=cuda)
    _, p16, _, l16, _ = tr._eval_window(tr._compute_model(model), {**case, "label": label})
    with torch.no_grad():
        p32 = model(case, label)["probabilities"]
        gen = torch.Generator(device=cuda)
        zero = det(case, label, generator=gen.manual_seed(0), drop_prob=0.0)
        ones = det(case, label, generator=gen.manual_seed(0), drop_prob=1.0)
        head = det.fusion_prediction(torch.zeros(len(label), det.fusion_prediction[0].in_features,
                                                  device=cuda))
        plain = p32 if det is model else det(case, label)["probabilities"]
    assert p16.dtype == torch.float32 and torch.isfinite(l16).all()
    assert float((p16 - p32).abs().max()) <= 4e-2
    assert torch.equal(zero["probabilities"], plain)
    assert torch.equal(ones["logits"], head)


@pytest.mark.parametrize("loss_type,svd_impl,lambda2,markers,dim,batch", [
    pytest.param("volume", "gram", 0.0, ("cd3", "cd8", "he"), 64, 64, id="volume-gram-0.0"),
    pytest.param("rank1", "gram", 0.1, ("cd3", "cd8", "he"), 64, 64, id="rank1-gram-0.1"),
    # exp_volume_256_tma.sh and exp_svd_256_tma.sh: 8 markers x 1024, batches of 512
    pytest.param("volume", "gram", 0.1, TMA_MARKERS, 1024, 512, id="exp_volume_256_tma"),
    pytest.param("rank1", "gram", 0.1, TMA_MARKERS, 1024, 512, id="exp_svd_256_tma"),
])
def test_alignment_step_card_matches_cpu(cuda, loss_type, svd_impl, lambda2, markers, dim, batch):
    """One alignment batch card vs CPU from the same weights, batch and
    predictor dropout masks (drawn by one CPU generator): loss within 1e-5
    relative, the alignment layers' gradients within 1e-4 relative L2, the
    singular values within 1e-4 of the largest; no kernel of the port is
    launched."""
    from multimodal_fusion_tpu_torch.models.alignment import MultiModalAlignmentModel
    from multimodal_fusion_tpu_torch.train.alignment import MultiModalAlignmentTrainer

    markers = list(markers)
    rng = np.random.default_rng(0)
    pos = {m: rng.standard_normal((batch, dim)).astype(np.float32) / 8 for m in markers}
    neg = {m: rng.standard_normal((batch, dim)).astype(np.float32) / 8 for m in markers}
    counters = (similarity_rect, knn, attention_fwd, attention_bwd)
    before = [fn.launches for fn in counters]
    out = {}
    for dev in (cuda, torch.device("cpu")):
        model = MultiModalAlignmentModel(markers, feature_dim=dim, num_layers=2,
                                         generator=torch.Generator().manual_seed(0)).to(dev)
        tr = MultiModalAlignmentTrainer(model, loss_type=loss_type, svd_impl=svd_impl,
                                        lambda2=lambda2, tau2=0.05, loss2_chunk_size=8)
        loss, svd = tr._loss(tr._to_device(pos), tr._to_device(neg),
                             torch.Generator().manual_seed(1), True)
        out[dev.type] = (loss.detach().cpu(), torch.autograd.grad(loss, tr.params), svd.detach().cpu())
    assert [fn.launches for fn in counters] == before
    (lc, gc, sc), (lh, gh, sh) = out["cuda"], out["cpu"]
    assert float((lc - lh).abs() / lh.abs()) <= 1e-5
    assert max(_rel_l2(a, b) for a, b in zip(gc, gh)) <= 1e-4
    assert float((sc - sh).abs().max() / sh.abs().max()) <= 1e-4


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

"""PyTorch port ops (CPU) against the JAX package on the same inputs.

Inputs come from numpy generators and go through both sides; Pallas kernels
run in interpret mode, as tests/test_pallas_kernels.py runs them.  On the
CPU the port's kernel wrappers take their plain PyTorch versions, which
repeat the kernels' arithmetic."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from sklearn.metrics import adjusted_rand_score

from multimodal_fusion_tpu.hypergraph import build as jbuild
from multimodal_fusion_tpu.ops import knn as jknn
from multimodal_fusion_tpu.ops import similarity as jsim
from multimodal_fusion_tpu.ops.pallas_knn import pallas_knn
from multimodal_fusion_tpu.ops.pallas_similarity import pallas_combined_similarity_rect
from multimodal_fusion_tpu_torch.hypergraph import build as tbuild
from multimodal_fusion_tpu_torch.ops import kmeans as tkm
from multimodal_fusion_tpu_torch.ops import knn as tknn
from multimodal_fusion_tpu_torch.ops import similarity as tsim
from multimodal_fusion_tpu_torch.ops.knn_kernel import (
    KNN_MAX_SEGMENTS,
    KNN_TILE,
    knn,
    knn_indices_auto,
    knn_launch_rows,
    knn_segments,
)
from multimodal_fusion_tpu_torch.ops.similarity_kernel import (
    combined_similarity_auto,
    padded_rows,
    similarity_rect,
    similarity_rect_plain,
)

# the JAX ops package re-exports the function `kmeans` under the module's name
jkm = importlib.import_module("multimodal_fusion_tpu.ops.kmeans")
T = torch.as_tensor


def _np(x):
    return np.asarray(x)


# ---------------------------------------------------------------------------
# similarity (K1's plain version)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize(
    "m,n,d,lam_h,lam_g,bf16",
    [
        (65, 65, 130, 1.0, 1.0, False),
        (97, 131, 37, 0.7, 0.3, False),
        (131, 70, 70, 0.4, 2.0, True),
        (64, 64, 32, 1.0, 1.0, True),
        # K1's 128-wide tiles and 16-wide chunks: one under, at and over each
        (127, 129, 16, 1.0, 1.0, False),
        (128, 128, 17, 0.7, 0.3, False),
        (129, 127, 1000, 1.0, 1.0, False),
        (127, 127, 16, 1.0, 1.0, True),
        (129, 128, 17, 0.5, 1.5, True),
        (128, 129, 1000, 1.0, 1.0, True),
    ],
)
def test_similarity_matches_jax_and_pallas(m, n, d, lam_h, lam_g, bf16):
    rng = np.random.default_rng(m * 1000 + n)
    scale = np.sqrt(2.0 / d)  # ||f_i - f_j||^2 ~ 4: informative K, not all ~0
    rf = (rng.standard_normal((m, d)) * scale).astype(np.float32)
    cf = (rng.standard_normal((n, d)) * scale).astype(np.float32)
    if bf16:  # bf16_exact's precondition: values exactly bf16-representable
        rf = np.asarray(jnp.asarray(rf, jnp.bfloat16).astype(jnp.float32))
        cf = np.asarray(jnp.asarray(cf, jnp.bfloat16).astype(jnp.float32))
    rp = rng.uniform(0, 3, (m, 2)).astype(np.float32)
    cp = rng.uniform(0, 3, (n, 2)).astype(np.float32)

    xla = np.exp(-(
        lam_h * _np(jsim.pairwise_sq_dists(jnp.asarray(rf), jnp.asarray(cf)))
        + lam_g * _np(jsim.pairwise_sq_dists(jnp.asarray(rp), jnp.asarray(cp)))
    ))
    pallas = _np(pallas_combined_similarity_rect(
        jnp.asarray(rf), jnp.asarray(rp), jnp.asarray(cf), jnp.asarray(cp),
        lam_h, lam_g, tile_m=64, tile_n=64, interpret=True, bf16_exact=bf16,
    ))
    port = similarity_rect(T(rf), T(rp), T(cf), T(cp), lam_h, lam_g, bf16_exact=bf16).numpy()
    # 1e-6 abs: f32 norm-expansion rounding (~1e-7 relative on distances of
    # O(10)) in differently ordered sums; K is in [0, 1]
    np.testing.assert_allclose(port, pallas, rtol=0, atol=1e-6)
    np.testing.assert_allclose(port, xla, rtol=0, atol=1e-6)
    assert port.shape == (m, n)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", ["aligned", "aligned_row_slice", "row_slice", "odd_width",
                                  "column_slice"])
def test_padded_rows_copies_only_what_k1_cannot_read(case, dtype):
    """K1 reads feature rows 16 bytes at a time.  Rows that allow it go in
    as they are; others are copied once, zero-padded to a multiple of 16
    bytes, and give the same K."""
    gen = torch.Generator().manual_seed(len(case))
    per = 16 // torch.empty((), dtype=dtype).element_size()
    shape, view = {
        "aligned": ((40, 2 * per), lambda t: t),
        "aligned_row_slice": ((44, 16), lambda t: t[4:]),  # starts 4 rows of 16 in
        "row_slice": ((41, 17), lambda t: t[1:]),
        "odd_width": ((40, 1023), lambda t: t),
        "column_slice": ((40, 24), lambda t: t[:, :16]),
    }[case]
    base = view(torch.randn(shape, generator=gen).to(dtype))
    x = padded_rows(base)
    copied = case in ("row_slice", "odd_width", "column_slice")
    assert (x.data_ptr() != base.data_ptr()) == copied
    assert x.is_contiguous() and x.shape[1] % per == 0 and x.data_ptr() % 16 == 0
    d = base.shape[1]
    assert x.shape == (base.shape[0], d + (-d % per))
    assert torch.equal(x[:, :d], base) and not x[:, d:].any()

    pos = torch.rand((base.shape[0], 2), generator=gen) * 3
    cols, cpos = base[5:], pos[5:]
    for bf16 in (False, True):
        want = similarity_rect_plain(base, pos, cols, cpos, 0.7, 1.3, bf16)
        got = similarity_rect_plain(x, pos, padded_rows(cols), cpos, 0.7, 1.3, bf16)
        np.testing.assert_array_equal(got.numpy(), want.numpy())
    # CPU tensors take the plain version and count no kernel launch
    before = (similarity_rect.launches, knn.launches)
    similarity_rect(base, pos, cols, cpos)
    knn(base.float(), 3)
    assert (similarity_rect.launches, knn.launches) == before


def test_square_similarity_matches_jax_combined():
    rng = np.random.default_rng(7)
    f = (rng.standard_normal((150, 33)) * 0.25).astype(np.float32)
    p = rng.uniform(0, 2, (150, 2)).astype(np.float32)
    want = _np(jsim.combined_similarity(jnp.asarray(f), jnp.asarray(p), 0.7, 0.3))
    auto = combined_similarity_auto(T(f), T(p), 0.7, 0.3).numpy()
    plain = tsim.combined_similarity(T(f), T(p), 0.7, 0.3).numpy()
    cross = tsim.cross_similarity(T(f[:40]), T(f[40:]), 0.7).numpy()
    # same 1e-6 abs bound and reason as above
    np.testing.assert_allclose(auto, want, rtol=0, atol=1e-6)
    np.testing.assert_allclose(plain, want, rtol=0, atol=1e-6)
    np.testing.assert_allclose(
        cross, _np(jsim.cross_similarity(jnp.asarray(f[:40]), jnp.asarray(f[40:]), 0.7)),
        rtol=0, atol=1e-6,
    )


def test_pairwise_sq_dists_direct_and_bf16_paths():
    rng = np.random.default_rng(8)
    pos = (rng.uniform(0, 5e4, (50, 2))).astype(np.float32)  # slide coordinates
    a = np.asarray(jnp.asarray(rng.standard_normal((40, 24)), jnp.bfloat16).astype(jnp.float32))
    # the D <= 4 path is exact-signed coordinate arithmetic: identical
    np.testing.assert_array_equal(
        tsim.pairwise_sq_dists(T(pos)).numpy(), _np(jsim.pairwise_sq_dists(jnp.asarray(pos)))
    )
    got = tsim.pairwise_sq_dists(T(a), bf16_exact=True).numpy()
    want = _np(jsim.pairwise_sq_dists(jnp.asarray(a), bf16_exact=True))
    # f32 accumulation order differs (the docstring's "drift by f32 ulps");
    # distances are O(50)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)


# ---------------------------------------------------------------------------
# KNN (K2's plain version and the dense top-k)
# ---------------------------------------------------------------------------

def _knn_cases():
    rng = np.random.default_rng(3)
    return {
        "float": (rng.standard_normal((300, 24)) * 2.0).astype(np.float32),
        # integer features: exact distances, so many exact ties that must
        # rank by (value, smallest index) on every side
        "ties": rng.integers(-2, 3, (200, 16)).astype(np.float32),
    }


def _assert_same_neighbours(got, want, x, exact):
    """Identical indices; on float data a swap is tolerated only between two
    candidates whose float64 distances differ by less than f32 rounding of
    the expansion (1e-5 relative): there the order is decided by the last
    bit of differently ordered f32 sums, not by the algorithm."""
    got, want = np.asarray(got), np.asarray(want)
    if exact:
        np.testing.assert_array_equal(got, want)
        return
    x64 = x.astype(np.float64)
    rows = np.nonzero((got != want).any(axis=1))[0]
    assert len(rows) <= 0.01 * len(x)
    for r in rows:
        d_got = ((x64[got[r]] - x64[r]) ** 2).sum(1)
        d_want = ((x64[want[r]] - x64[r]) ** 2).sum(1)
        np.testing.assert_allclose(d_got, d_want, rtol=1e-5)


@pytest.mark.parametrize("case", ["float", "ties"])
@pytest.mark.parametrize("k", [1, 6, 17])
def test_knn_indices_identical_to_jax(case, k):
    x = _knn_cases()[case]
    _, i_jax = jknn.knn_indices(jnp.asarray(x), k)
    _, i_pl = pallas_knn(jnp.asarray(x), k, tile_m=128, tile_n=128, interpret=True)
    d_dense, i_dense = tknn.knn_indices(T(x), k)
    d_blk, i_blk = tknn.knn_indices_blockwise(T(x), k, block=64)
    d_k2, i_k2 = knn(T(x), k)  # CPU tensor -> K2's plain version
    for got in (i_dense, i_blk, i_k2):
        _assert_same_neighbours(got.numpy(), _np(i_jax), x, exact=case == "ties")
        _assert_same_neighbours(got.numpy(), _np(i_pl), x, exact=case == "ties")
    np.testing.assert_array_equal(d_dense.numpy()[:, 0], 0.0)
    # sqrt of f32 expansion distances: ~1e-6 relative on the squares
    np.testing.assert_allclose(d_blk.numpy(), d_dense.numpy(), rtol=1e-5, atol=1e-3)
    np.testing.assert_allclose(d_k2.numpy(), _np(jknn.knn_indices(jnp.asarray(x), k)[0]),
                               rtol=1e-5, atol=1e-3)


def test_knn_self_distance_pinned_at_large_magnitude():
    """Mirrors test_pallas_knn_self_distance_pinned_at_large_magnitude:
    at magnitude ~300 the expansion residue would evict self from slot 0."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((96, 16)).astype(np.float32) * 300.0
    d_pl, i_pl = pallas_knn(jnp.asarray(x), 4, tile_m=64, tile_n=64, interpret=True)
    _, i_x = jknn.knn_indices(jnp.asarray(x), 4)
    d_k2, i_k2 = knn(T(x), 4)
    _, i_dense = tknn.knn_indices(T(x), 4)
    np.testing.assert_array_equal(i_k2.numpy()[:, 0], np.arange(96))
    np.testing.assert_array_equal(d_k2.numpy()[:, 0], 0.0)
    np.testing.assert_array_equal(i_k2.numpy(), _np(i_pl))
    np.testing.assert_array_equal(i_dense.numpy(), _np(i_x))


def test_knn_dispatch_and_edges():
    x = _knn_cases()["float"]
    _, i_small = knn_indices_auto(T(x), 5)  # below 4096: dense top-k
    _, i_run = knn_indices_auto(T(x), 5, min_kernel_n=100)  # running top-k
    np.testing.assert_array_equal(i_small.numpy(), i_run.numpy())
    np.testing.assert_array_equal(
        tknn.knn_edges(i_small).numpy(), _np(jknn.knn_edges(jnp.asarray(i_small.numpy())))
    )
    with pytest.raises(ValueError):
        knn(T(x), 129)


def _knn_split(x, k, segments, unit):
    """K2's two launches in plain PyTorch: segment lists, then the merge."""
    return tknn.knn_merge_partials(*tknn.knn_partials(x, k, segments, unit), k)


# K2's split of the key axis and its merge launch, in plain PyTorch.  The
# keys go in runs of whole 32-key tiles: 300 keys in 2, 3, 5 segments are
# 160 + 140, 128 + 128 + 44, 4 x 64 + 44; 200 keys are 128 + 72, 96 + 96 + 8
# (fewer keys than k = 17 in the last) and 64 + 64 + 64 + 8 with a fifth
# segment that is empty.
@pytest.mark.parametrize("segments", [1, 2, 3, 5])
@pytest.mark.parametrize("k", [1, 17])
@pytest.mark.parametrize("case", ["float", "ties"])
def test_knn_split_merge_matches_jax(case, k, segments):
    x = _knn_cases()[case]
    d_jax, i_jax = jknn.knn_indices(jnp.asarray(x), k)
    _, i_pl = pallas_knn(jnp.asarray(x), k, tile_m=128, tile_n=128, interpret=True)
    d_split, i_split = _knn_split(T(x), k, segments, unit=32)
    _assert_same_neighbours(i_split.numpy(), _np(i_jax), x, exact=case == "ties")
    _assert_same_neighbours(i_split.numpy(), _np(i_pl), x, exact=case == "ties")
    # sqrt of f32 expansion distances: ~1e-6 relative on the squares
    np.testing.assert_allclose(d_split.numpy(), _np(d_jax), rtol=1e-5, atol=1e-3)
    if case == "ties":  # exact distances: the split changes nothing, bit for bit
        d_blk, i_blk = tknn.knn_indices_blockwise(T(x), k)
        np.testing.assert_array_equal(d_split.numpy(), d_blk.numpy())
        np.testing.assert_array_equal(i_split.numpy(), i_blk.numpy())


@pytest.mark.parametrize("segments", [1, 2, 3, 5])
def test_knn_split_merge_pins_self_at_large_magnitude(segments):
    """The split version of test_knn_self_distance_pinned_at_large_magnitude
    (96 keys in 16-key tiles: at S = 5, three segments of 32 and two empty)."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((96, 16)).astype(np.float32) * 300.0
    d_pl, i_pl = pallas_knn(jnp.asarray(x), 4, tile_m=64, tile_n=64, interpret=True)
    d, i = _knn_split(T(x), 4, segments, unit=16)
    np.testing.assert_array_equal(i.numpy()[:, 0], np.arange(96))
    np.testing.assert_array_equal(d.numpy()[:, 0], 0.0)
    np.testing.assert_array_equal(i.numpy(), _np(i_pl))


@pytest.mark.parametrize("segments", [2, 3, 5])
def test_knn_merge_partials_takes_segments_in_any_order(segments):
    """The merge ranks by (value, smallest index), not by where a list sits:
    the segments' lists in reverse order merge to the same result."""
    x = T(_knn_cases()["ties"])
    part_d, part_i = tknn.knn_partials(x, 17, segments, unit=32)
    d, i = tknn.knn_merge_partials(part_d, part_i, 17)
    d_rev, i_rev = tknn.knn_merge_partials(part_d.flip(0), part_i.flip(0), 17)
    assert torch.equal(d, d_rev) and torch.equal(i, i_rev)
    assert (part_i == x.shape[0]).any() == (segments > 2)  # short or empty segments pad


@pytest.mark.parametrize(
    "n,k,want",
    [(1, 6, 1), (127, 6, 1), (128, 6, 1), (129, 6, 2), (1024, 6, 8), (2048, 6, 8),
     (4096, 6, 4), (4097, 6, 4), (5000, 6, 3), (5000, 128, 3), (20000, 6, 5)],
)
def test_knn_segment_chooser(n, k, want):
    """S for N keys on 132 SMs: one full wave of (query tiles x S) blocks
    where it fits (N 4096: 32 x 4 = 128 blocks), at most one segment per
    128-key tile and 16 in all, and no empty segment."""
    s = knn_segments(n, k)
    tiles = -(-n // KNN_TILE)
    per = -(-tiles // s)
    assert s == want
    assert 1 <= s <= min(tiles, KNN_MAX_SEGMENTS)
    assert (s - 1) * per < tiles  # the last segment holds keys
    if tiles <= 132:  # the query tiles fit one wave: so do the blocks
        assert tiles * s <= 132


@pytest.mark.parametrize("case", ["aligned", "d37", "d37_row_slice", "offset_base", "column_slice"])
def test_knn_launch_rows_pad_what_k2_cannot_read(case):
    """K2 reads rows 16 bytes at a time: ``knn_launch_rows`` passes rows
    that allow it as they are and copies others once into zero-padded rows
    (``padded_rows``), which give the same neighbours bit for bit."""
    rng = np.random.default_rng(11)
    flat = T(rng.integers(-2, 3, 301 * 40 + 1).astype(np.float32))
    base = {
        "aligned": lambda: flat[:300 * 40].view(300, 40),
        "d37": lambda: flat[:300 * 37].view(300, 37),
        "d37_row_slice": lambda: flat[:301 * 37].view(301, 37)[1:],
        "offset_base": lambda: flat[1:1 + 300 * 40].view(300, 40),  # 4 bytes off 16
        "column_slice": lambda: flat[:300 * 40].view(300, 40)[:, :36],
    }[case]()
    xp, s = knn_launch_rows(base, 6)
    assert (xp.data_ptr() != base.data_ptr()) == (case != "aligned")
    assert xp.is_contiguous() and xp.shape[1] % 4 == 0 and xp.data_ptr() % 16 == 0
    d = base.shape[1]
    assert torch.equal(xp[:, :d], base) and not xp[:, d:].any()
    assert s == knn_segments(300, 6)
    want = _knn_split(base, 6, s, unit=KNN_TILE)
    got = _knn_split(xp, 6, s, unit=KNN_TILE)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w.numpy())


# ---------------------------------------------------------------------------
# statistics
# ---------------------------------------------------------------------------

def _same_bits(a, b):
    return np.float32(a).view(np.int32) == np.float32(b).view(np.int32)


@pytest.mark.parametrize("shape", [(300, 300), (257, 255), (16, 4097)])
def test_bitpattern_median_equals_numpy(shape):
    rng = np.random.default_rng(shape[0])
    K = np.exp(-rng.gamma(2.0, 2.0, shape)).astype(np.float32)
    K[:3, :3] = K[0, 0]  # a few exact ties
    assert _same_bits(tbuild._bitpattern_median(T(K)).item(), np.median(K))
    mask = np.zeros(shape, bool)
    mask[: shape[0] - 7, : shape[1] - 3] = True
    got = tbuild._bitpattern_median(T(K), mask=T(mask)).item()
    assert _same_bits(got, np.median(K[mask]))
    # small-size sort path: numpy's midpoint too
    assert _same_bits(tbuild._sort_median(T(K[:5, :7].reshape(-1))).item(), np.median(K[:5, :7]))
    assert np.isnan(tbuild._bitpattern_median(T(K), mask=T(np.zeros(shape, bool))).item())


def test_matrix_stats_match_jax():
    rng = np.random.default_rng(11)
    for shape in [(40, 30), (300, 300)]:
        K = np.exp(-rng.gamma(2.0, 2.0, shape)).astype(np.float32)
        got = tbuild._matrix_stats_dev(T(K)).numpy()
        want = _np(jax.jit(jbuild._matrix_stats_dev)(jnp.asarray(K)))
        # mean/std differ only by f32 summation order
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7)
        assert _same_bits(got[4], want[4])
        mask = np.zeros(shape, bool)
        mask[:-5, :-5] = True
        got_m = tbuild._matrix_stats_dev_masked(T(K), T(mask)).numpy()
        want_m = _np(jax.jit(jbuild._matrix_stats_dev_masked)(jnp.asarray(K), jnp.asarray(mask)))
        np.testing.assert_allclose(got_m, want_m, rtol=1e-5, atol=1e-7)
    assert np.isnan(tbuild._matrix_stats_dev(torch.zeros((4, 0))).numpy()).all()


# ---------------------------------------------------------------------------
# KMeans
# ---------------------------------------------------------------------------

def _blobs(rng, n=400, d=32, k=12, spread=0.08):
    centers = rng.standard_normal((k, d)) * 3.0
    assign = np.repeat(np.arange(k), n // k)
    pts = centers[assign] + spread * rng.standard_normal((len(assign), d))
    return pts.astype(np.float32), assign


def _kmeans_cases():
    rng = np.random.default_rng(3)
    blobs, _ = _blobs(rng)
    loose = rng.standard_normal((150, 8)).astype(np.float32)
    mask = np.arange(150) < 130
    # 6 distinct points repeated: kmeans++ must re-pick duplicates, so Lloyd
    # starts with empty clusters and runs the relocation + cascade guard
    dup = np.repeat(rng.standard_normal((6, 4)), 5, axis=0).astype(np.float32)
    return {
        "blobs": (blobs, 12, None),
        "masked": (loose, 10, mask),
        "relocate": (dup, 8, None),
    }


@pytest.mark.parametrize("case", ["blobs", "masked", "relocate"])
def test_lloyd_from_jax_init_matches_per_restart(case):
    x, k, mask = _kmeans_cases()[case]
    keys = jax.random.split(jax.random.key(0), 10)
    jmask = None if mask is None else jnp.asarray(mask)
    inits = jax.jit(jax.vmap(lambda kk: jkm.kmeans_plus_plus_init(kk, jnp.asarray(x), k, jmask)))(keys)
    w = np.ones(len(x), np.float32) if mask is None else mask.astype(np.float32)
    _, j_labels, j_inertia = jax.jit(jax.vmap(
        lambda c: jkm._lloyd(jnp.asarray(x), c, jnp.asarray(w), 50, 1e-4)
    ))(inits)
    _, t_labels, t_inertia = tkm._lloyd(T(x), T(np.array(inits)), T(w), 50, 1e-4)
    np.testing.assert_array_equal(t_labels.numpy(), _np(j_labels))
    # inertia: f32 sums in another order
    np.testing.assert_allclose(t_inertia.numpy(), _np(j_inertia), rtol=1e-4, atol=1e-6)
    # and through the public entry point: the best restart wins
    res = tkm.kmeans(T(x), k, n_init=10, mask=None if mask is None else T(mask),
                     init_centers=T(np.array(inits)))
    best = int(np.argmin(_np(j_inertia)))
    np.testing.assert_array_equal(res.labels.numpy(), _np(j_labels)[best])


def test_seeded_kmeans_reaches_clustering_parity_ari():
    """Un-injected runs: the ARI levels of tests/test_clustering_parity.py
    (there against sklearn; here against the JAX kmeans and the truth)."""
    rng = np.random.default_rng(3)
    x, truth = _blobs(rng)
    ours = tkm.kmeans(T(x), 12, torch.Generator().manual_seed(0), n_init=10).labels.numpy()
    jax_labels = _np(jkm.kmeans(jax.random.key(0), jnp.asarray(x), k=12, n_init=10).labels)
    assert adjusted_rand_score(ours, jax_labels) > 0.9
    assert adjusted_rand_score(ours, truth) > 0.95


def test_kmeans_plus_plus_init_draws_valid_rows_only():
    rng = np.random.default_rng(5)
    x = rng.standard_normal((60, 5)).astype(np.float32)
    mask = np.arange(60) < 40
    x[40:] = 1e3  # padding far away: would dominate D^2 sampling if drawn
    c = tkm.kmeans_plus_plus_init(T(x), 7, torch.Generator().manual_seed(1), n_init=4, mask=T(mask))
    assert c.shape == (4, 7, 5)
    assert (np.abs(c.numpy()) < 1e2).all()


def test_kernel_wrappers_take_the_plain_version_only_on_cpu():
    x = torch.zeros((8, 4), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        similarity_rect(x, x[:, :2], x, x[:, :2])
    with pytest.raises(ValueError, match="unsupported device"):
        knn(x, 3)
    before = (similarity_rect.launches, knn.launches)
    y = torch.rand((8, 4))
    similarity_rect(y, y[:, :2], y, y[:, :2])
    knn(y, 3)
    assert (similarity_rect.launches, knn.launches) == before  # plain path: no launch

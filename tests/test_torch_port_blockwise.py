"""The port's statistics above FULL_STATS_MAX_N (CPU) against the JAX build:
exact blockwise statistics with the bit-pattern median, and the sampled
mode.

As in the JAX package's own tests, FULL_STATS_MAX_N is lowered to 100 on
both sides so that 300-2500-patch slides take the large-slide paths.  The
JAX side's kmeans++ draws are computed here and passed to the port through
``init_centers`` (the port cannot reproduce jax.random streams)."""

import importlib

import h5py
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_fusion_tpu.hypergraph import build as jbuild
from multimodal_fusion_tpu_torch.hypergraph import build as tbuild
from multimodal_fusion_tpu_torch.io.h5io import read_hypergraph_group
from multimodal_fusion_tpu_torch.ops.similarity_kernel import similarity_rect_plain

jkm = importlib.import_module("multimodal_fusion_tpu.ops.kmeans")
PARAMS = (6, 2, 2, 3)  # super-patches, groups, k, hyperedges
SEED = 42


def _slide(n, d, seed, bf16=False):
    rng = np.random.default_rng(seed)
    feats = (rng.standard_normal((n, d)) * 0.3).astype(np.float32)
    if bf16:  # bf16-representable: what arrives under --upload_dtype bfloat16
        feats = torch.as_tensor(feats).to(torch.bfloat16).float().numpy()
    pos = rng.uniform(0, 3, (n, 2)).astype(np.float32)
    tma = (rng.standard_normal((6, d)) * 0.3).astype(np.float32)
    return feats, pos, tma


def _write(path, feats, pos, tma):
    with h5py.File(path, "w") as f:
        f["wsi/features"] = feats
        f["wsi/positions"] = pos
        f["tma/features"] = tma


def _combined(hi, lo):
    return np.asarray(hi).astype(np.int64) * (1 << 15) + np.asarray(lo)


def _port_K(feats, pos, bf16=False):
    f, p = torch.as_tensor(feats), torch.as_tensor(pos)
    return similarity_rect_plain(f, p, f, p, 1.0, 1.0, bf16).numpy()


def _np_counts(keys, lo_key, shift, nbins):
    rel = keys - lo_key
    idx = rel >> shift
    ok = (rel >= 0) & (idx < nbins)
    return np.bincount(idx[ok], minlength=nbins).astype(np.int64)


@pytest.mark.parametrize("n", [300, 320])
@pytest.mark.parametrize("padded", [False, True], ids=["unpadded", "padded"])
@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16_exact"])
def test_blockwise_stats_match_jax_and_an_oracle(padded, bf16, n):
    """A block of 64 does not divide N = 300: five full stripes and a short
    one (N = 320: five full stripes); padded: 20 garbage rows with label -1
    past n_valid."""
    d, s = 16, 6
    feats, pos, _ = _slide(n, d, 0, bf16)
    labels = np.random.default_rng(1).integers(0, s, n).astype(np.int32)
    f, p, lab = feats, pos, labels
    if padded:
        f = np.concatenate([feats, np.ones((20, d), np.float32)])
        p = np.concatenate([pos, np.ones((20, 2), np.float32)])
        lab = np.concatenate([labels, np.full(20, -1, np.int32)])
    got = tbuild._blockwise_similarity_stats(
        torch.as_tensor(f), torch.as_tensor(p), 1.0, 1.0, torch.as_tensor(lab), s, n, padded,
        block=64, bf16_exact=bf16)
    want = jbuild._blockwise_similarity_stats(
        jnp.asarray(f), jnp.asarray(p), 1.0, 1.0, jnp.asarray(lab), s, jnp.int32(n), padded,
        block=64, bf16_exact=bf16)
    for g, w in zip(got[:6], want[:6]):
        np.testing.assert_allclose(np.asarray(g), np.asarray(w), rtol=1e-5)
    np.testing.assert_array_equal(got[6].numpy(), _combined(*want[6]))

    # the numpy oracle on the port's own K: exact extrema and counts
    K = _port_K(feats, pos, bf16).astype(np.float64)
    onehot = np.eye(s)[labels]
    keys = K.astype(np.float32).reshape(-1).view(np.int32).astype(np.int64)
    # each stripe's moments are float32 (var_mean), combined in float64
    np.testing.assert_allclose(float(got[0]), K.sum(), rtol=1e-6)
    np.testing.assert_allclose(float(got[1]), (K * K).sum(), rtol=1e-6)
    assert float(got[2]) == K.min() and float(got[3]) == K.max()
    np.testing.assert_allclose(got[4].numpy(), np.einsum("ns,ns->s", onehot, K @ onehot), rtol=1e-5)
    np.testing.assert_allclose(got[5].numpy(), onehot.T @ np.diagonal(K), rtol=1e-6)
    np.testing.assert_array_equal(
        got[6].numpy(), _np_counts(keys, 0, tbuild._MED_L1_SHIFT, tbuild._MED_FANOUT))
    assert int(got[6].sum()) == n * n


def _level1_host(keys):
    l1 = _np_counts(keys, 0, tbuild._MED_L1_SHIFT, tbuild._MED_FANOUT)
    return {"med_cnt": l1}, {"med_cnt_hi": (l1 >> 15).astype(np.int32),
                             "med_cnt_lo": (l1 & ((1 << 15) - 1)).astype(np.int32)}


@pytest.mark.parametrize("case", ["dense", "identical", "split_middles", "denormal", "similarity"])
def test_exact_median_host_matches_jax(case):
    """The port's and the JAX package's host bisection on the same counts:
    the same median, the same refine requests, numpy's median."""
    rng = np.random.default_rng(0)
    values = {
        "dense": np.sort((0.5 + rng.uniform(-4e-4, 4e-4, 101)).astype(np.float32)),
        "identical": np.full(51, 0.5, np.float32),
        "split_middles": np.asarray([0.25] * 25 + [0.75] * 25, np.float32),
        "denormal": np.sort(np.where(np.arange(64) < 20, 0.0,
                                     rng.uniform(0, 1, 64) * 1e-41).astype(np.float32)),
        "similarity": _port_K(*_slide(64, 4, 3)[:2]).reshape(-1)[:64 * 64],
    }[case]
    n = values.shape[0] if case != "similarity" else 64
    keys = (np.repeat(values.view(np.int32).astype(np.int64), n) if case != "similarity"
            else values.view(np.int32).astype(np.int64))
    t_host, j_host = _level1_host(keys)
    calls = {"port": [], "jax": []}

    def refine(side):
        def run(lo_key, shift, nbins):
            calls[side].append((lo_key, shift, nbins))
            return _np_counts(keys, lo_key, shift, nbins)
        return run

    got = tbuild._exact_median_host(t_host, n, refine("port"))
    want = jbuild._exact_median_host(j_host, n, refine("jax"))
    assert np.float32(got) == np.float32(want) == np.float32(np.median(keys.astype(np.int32).view(np.float32)))
    assert calls["port"] == calls["jax"]
    # one rank chain, directly
    l1 = t_host["med_cnt"]
    rank = (n * n + 1) // 2
    width = 1 << tbuild._MED_L1_SHIFT
    assert (tbuild._select_key(l1, rank, 0, width, refine("port"))
            == jbuild._select_key(l1, rank, 0, width, refine("jax")))


def test_refine_mismatch_raises_like_jax():
    keys = np.full(9, np.float32(0.5).view(np.int32), np.int64)  # a 3 x 3 matrix
    t_host, j_host = _level1_host(keys)

    def bad_refine(lo_key, shift, nbins):
        return np.zeros(nbins, np.int64)  # drops every value

    with pytest.raises(RuntimeError, match="disagrees"):
        tbuild._exact_median_host(t_host, 3, bad_refine)
    with pytest.raises(RuntimeError, match="disagrees"):
        jbuild._exact_median_host(j_host, 3, bad_refine)


@pytest.mark.parametrize("n,blk,n_eff,padded", [(63, 16, 63, False), (64, 16, 47, True),
                                                (64, 16, 46, True), (40, 8, 1, True),
                                                (96, 32, 96, False), (96, 16, 64, True)])
def test_median_level_pass_counts_the_port_k(n, blk, n_eff, padded):
    """Every (shift, nbins) the descent uses, over the valid block only,
    whatever the parity of the valid count."""
    rng = np.random.default_rng(3)
    feats = (rng.standard_normal((n, 8)) * 0.3).astype(np.float32)
    pos = rng.uniform(0, 2, (n, 2)).astype(np.float32)
    K = _port_K(feats[:n_eff], pos[:n_eff])
    keys = K.reshape(-1).view(np.int32).astype(np.int64)
    med_key = int(np.sort(keys)[len(keys) // 2])
    sigs = [(0, tbuild._MED_L1_SHIFT, tbuild._MED_FANOUT)] + [
        ((med_key >> (s + 5)) << (s + 5), s, 32) for s in (20, 15, 10, 5, 0)]
    for lo, shift, nbins in sigs:
        got = tbuild._median_level_pass(torch.as_tensor(feats), torch.as_tensor(pos), 1.0, 1.0,
                                        n_eff, lo, shift, nbins, padded, block=blk)
        np.testing.assert_array_equal(got.numpy(), _np_counts(keys, lo, shift, nbins),
                                      err_msg=f"{lo},{shift}")


def _jax_draws(h5, bucket, upload_dtype):
    """The JAX build's outputs in the large-slide mode and its three
    kmeans++ draws (the key split as its _fused_build splits it)."""
    feats, pos = jbuild.load_wsi_data(h5)
    tma = jbuild.load_tma_data(h5)
    n_valid, padded = feats.shape[0], False
    if bucket:
        feats, pos, n_valid, padded = jbuild._bucketed(feats, pos, bucket)
    full_stats, block_stats = jbuild._stats_modes(False, feats.shape[0])
    dt = jbuild._upload_dt(upload_dtype)
    key = jax.random.key(SEED)
    out = jbuild._fused_build(
        key, jnp.asarray(feats, dt), jnp.asarray(pos), jnp.asarray(tma, dt),
        jnp.asarray(n_valid, jnp.int32), 1.0, 1.0, *PARAMS, full_stats=full_stats,
        ship_cache=False, padded=padded, block_stats=block_stats,
        bf16_exact=upload_dtype == "bfloat16")
    f32 = jnp.asarray(feats, dt).astype(jnp.float32)
    k1, k2, k3 = jax.random.split(key, 3)
    mask = jnp.arange(feats.shape[0]) < n_valid if padded else None

    def draws(k, x, n_clusters, m=None):
        keys = jax.random.split(k, 10)
        return torch.as_tensor(np.array(jax.jit(jax.vmap(
            lambda kk: jkm.kmeans_plus_plus_init(kk, x, n_clusters, m)))(keys)))

    all_feats = jnp.concatenate([out["sp_feats"], jnp.asarray(tma, dt).astype(jnp.float32)])
    return {"super": draws(k1, f32, PARAMS[0], mask), "group": draws(k2, out["sim"], PARAMS[1]),
            "hyperedge": draws(k3, all_feats, PARAMS[3])}


@pytest.mark.parametrize(
    "mode,n,d,bucket,upload_dtype",
    [("blockwise", 300, 16, None, "float32"), ("blockwise", 300, 16, 128, "float32"),
     ("blockwise", 300, 16, None, "bfloat16"), ("sampled", 300, 16, None, "float32"),
     ("sampled", 2500, 8, None, "float32")],
    ids=["blockwise", "blockwise_bucketed", "blockwise_bf16", "sampled", "sampled_2500"],
)
def test_large_slide_build_matches_jax(tmp_path, monkeypatch, mode, n, d, bucket, upload_dtype):
    """process_single_file above FULL_STATS_MAX_N on both sides, the JAX
    draws injected: statistics within 1e-5, edges and groups identical."""
    for mod in (jbuild, tbuild):
        monkeypatch.setattr(mod, "FULL_STATS_MAX_N", 100)
        monkeypatch.setattr(mod, "LARGE_N_STATS", mode)
    slide = _slide(n, d, 12, upload_dtype == "bfloat16")
    h5_j, h5_t = tmp_path / "j.h5", tmp_path / "t.h5"
    _write(h5_j, *slide)
    _write(h5_t, *slide)
    init = _jax_draws(h5_j, bucket, upload_dtype)
    common = dict(seed=SEED, save_similarity=False, bucket_patches=bucket, upload_dtype=upload_dtype)
    js = jbuild.process_single_file(h5_j, *PARAMS, **common)
    ts = tbuild.process_single_file(h5_t, *PARAMS, **common, device="cpu", init_centers=init)
    jk = js["wsi_aggregation"]["wsi_similarity_matrix_stats"]
    tk = ts["wsi_aggregation"]["wsi_similarity_matrix_stats"]
    for key in jk:
        np.testing.assert_allclose(tk[key], jk[key], rtol=1e-5, atol=1e-8, err_msg=key)
    np.testing.assert_allclose(ts["wsi_aggregation"]["avg_intra_cluster_similarity"],
                               js["wsi_aggregation"]["avg_intra_cluster_similarity"], rtol=1e-5)
    assert ts["hypergraph"] == js["hypergraph"] and ts["grouping"] == js["grouping"]
    jg, tg = read_hypergraph_group(h5_j), read_hypergraph_group(h5_t)
    assert set(jg) == set(tg) and "similarity/wsi_internal" not in tg
    for key in ("edge_index", "group_labels"):
        np.testing.assert_array_equal(tg[key], jg[key], err_msg=key)
    np.testing.assert_allclose(tg["edge_weights"], jg["edge_weights"], rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("bucket", [None, 1024], ids=["unpadded", "bucketed"])
def test_blockwise_equals_the_ports_full_statistics(monkeypatch, bucket):
    """n = 2500 > 2048: the subsample no longer covers every row, and only
    the bit-pattern selection can give the full-statistics median.  Median,
    min and max bit-equal; mean and std within 1e-6."""
    feats, pos, tma = _slide(2500, 8, 5)
    kw = dict(seed=SEED, save_similarity=False, bucket_patches=bucket, device="cpu")
    full = tbuild.process_arrays(feats, pos, tma, *PARAMS, **kw)["host"]
    monkeypatch.setattr(tbuild, "FULL_STATS_MAX_N", 100)
    block = tbuild.process_arrays(feats, pos, tma, *PARAMS, **kw)["host"]
    assert "med_cnt" in block and "med_cnt" not in full
    fs, bs = full["K_stats"], block["K_stats"]
    assert bs[2] == fs[2] and bs[3] == fs[3] and bs[4] == fs[4]
    np.testing.assert_allclose(bs[:2], fs[:2], rtol=1e-6)
    np.testing.assert_allclose(block["intra_mean"], full["intra_mean"], rtol=1e-6)
    np.testing.assert_array_equal(block["labels"], full["labels"])


@pytest.mark.parametrize("save_similarity", [False, True])
@pytest.mark.parametrize("mode", ["blockwise", "sampled"])
def test_stats_modes_match_jax(monkeypatch, mode, save_similarity):
    for mod in (jbuild, tbuild):
        monkeypatch.setattr(mod, "LARGE_N_STATS", mode)
    for n in (1, 4096, 32768, 32769, 65536):
        assert tbuild._stats_modes(save_similarity, n) == jbuild._stats_modes(save_similarity, n)


def test_sample_rows_match_jax():
    """round(linspace(0, 1, S) * (n - 1)) in float32: the same rows as the
    JAX build takes at every n up to 131072 (padded or not, only n_valid
    counts).  torch.linspace's grid would differ from jnp.linspace's in two
    of its 2048 points, and the rows at 1000 of these n."""
    s = 2048
    grid = jnp.linspace(0.0, 1.0, s)
    for n in range(2, 2049):  # S = n: every row, in order
        np.testing.assert_array_equal(tbuild._sample_rows([n], n, "cpu")[0].numpy(), np.arange(n))
    ns = np.arange(2049, 131073)
    for c0 in range(0, ns.size, 16384):
        chunk = ns[c0:c0 + 16384]
        got = tbuild._sample_rows(chunk.tolist(), s, "cpu").numpy()
        want = np.asarray(jnp.round(grid[None, :] * jnp.asarray(chunk - 1, jnp.float32)[:, None])
                          .astype(jnp.int32))
        np.testing.assert_array_equal(got, want)

"""The port's stage-wise build functions, dense graph, similarity caches and
rebuild (CPU) against the JAX package's.

Every JAX stage function draws its KMeans from ``jax.random.key(seed)``;
those kmeans++ draws are computed here and passed to the port's functions
through ``init_centers`` (the port cannot reproduce jax.random streams)."""

import csv
import importlib
import shutil

import h5py
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_fusion_tpu.cli import preprocess_hypergraph as jcli
from multimodal_fusion_tpu.hypergraph import build as jbuild
from multimodal_fusion_tpu.hypergraph import dense_graph as jdense
from multimodal_fusion_tpu.ops import similarity as jsim
from multimodal_fusion_tpu_torch.cli import preprocess_hypergraph as tcli
from multimodal_fusion_tpu_torch.hypergraph import build as tbuild
from multimodal_fusion_tpu_torch.hypergraph import dense_graph as tdense
from multimodal_fusion_tpu_torch.io.h5io import read_hypergraph_group
from multimodal_fusion_tpu_torch.ops import similarity as tsim
from multimodal_fusion_tpu_torch.ops.similarity_kernel import similarity_rect_plain

jkm = importlib.import_module("multimodal_fusion_tpu.ops.kmeans")
SEED = 42


def _draws(x, k, seed=SEED):
    """The kmeans++ starting centers of JAX ``kmeans(jax.random.key(seed), x, k)``."""
    keys = jax.random.split(jax.random.key(seed), 10)
    return torch.as_tensor(np.array(jax.jit(jax.vmap(
        lambda kk: jkm.kmeans_plus_plus_init(kk, jnp.asarray(x), k, None)))(keys)))


def _blobs(seed, n=300, d=64, n_tma=8):
    """The verify skill's clustered fixture with the TMA cores near the blob
    centers (bench.py's draw; standard-normal cores make every cross
    similarity subnormal)."""
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((5, d)) * np.sqrt(1.75 / d)
    noise = np.sqrt(0.25 / d)
    feats = (centers[rng.integers(0, 5, n)] + rng.standard_normal((n, d)) * noise).astype(np.float32)
    pos = rng.uniform(0, 4, (n, 2)).astype(np.float32)
    tma = (centers[rng.integers(0, 5, n_tma)] + rng.standard_normal((n_tma, d)) * noise).astype(np.float32)
    return feats, pos, tma


def _write_ds(root, n_cases=3):
    root.mkdir(parents=True, exist_ok=True)
    rows = []
    for i in range(n_cases):
        feats, pos, tma = _blobs(i)
        with h5py.File(root / f"case_{i}.h5", "w") as f:
            f["wsi/features"], f["wsi/positions"], f["tma/features"] = feats, pos, tma
        rows.append({"patient_id": i, "case_id": f"case_{i}", "label": "living",
                     "h5_file_path": f"case_{i}.h5"})
    with open(root / "dataset.csv", "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=["patient_id", "case_id", "label", "h5_file_path"])
        w.writeheader()
        w.writerows(rows)
    return root / "dataset.csv"


def _close(a, b, path="stats", rtol=1e-5, atol=1e-6):
    if isinstance(a, dict):
        assert set(a) == set(b), path
        for key in a:
            _close(a[key], b[key], f"{path}.{key}", rtol, atol)
    elif isinstance(a, list):
        assert a == b, path
    elif isinstance(a, float) or isinstance(b, float):
        np.testing.assert_allclose(a, b, rtol=rtol, atol=atol, err_msg=path)
    else:
        assert a == b, path


def test_similarity_ops_match_jax():
    rng = np.random.default_rng(0)
    f = (rng.standard_normal((40, 12)) * 0.3).astype(np.float32)
    p = rng.uniform(0, 2, (40, 2)).astype(np.float32)
    T, J = torch.as_tensor, jnp.asarray
    np.testing.assert_allclose(tsim.morphological_similarity(T(f), 0.7).numpy(),
                               jsim.morphological_similarity(J(f), 0.7), rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(tsim.spatial_similarity(T(p), 0.5).numpy(),
                               jsim.spatial_similarity(J(p), 0.5), rtol=1e-6, atol=1e-7)
    K = jsim.combined_similarity(J(f), J(p), 1.0, 1.0)
    Kt = T(np.array(K))
    for n_valid in (None, 31, 2):
        assert float(tsim.median_offdiag(Kt, n_valid)) == \
            float(jsim.median_offdiag(K, n_valid)), n_valid
        thr = float(jsim.median_offdiag(K, n_valid))
        np.testing.assert_array_equal(tsim.threshold_edge_mask(Kt, thr, n_valid).numpy(),
                                      jsim.threshold_edge_mask(K, thr, n_valid))
    mask = np.arange(40) < 25
    # f32 sums of values ~0.3 in another order: absolute error ~1e-8
    np.testing.assert_allclose(tsim.mean_pool(T(f)).numpy(), jsim.mean_pool(J(f)), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(tsim.mean_pool(T(f), T(mask)).numpy(), jsim.mean_pool(J(f), J(mask)),
                               rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("n,ratio", [(12, 1.0), (40, 0.8), (40, None)])
def test_dense_graph_matches_jax(n, ratio):
    rng = np.random.default_rng(n)
    f = (rng.standard_normal((n, 6)) * 0.3).astype(np.float32)
    p = (rng.standard_normal((n, 2)) * 0.3).astype(np.float32)
    ei, w = tdense.build_weighted_hypergraph(f, p, 0.8, 0.5, ratio, device="cpu")
    jei, jw = jdense.build_weighted_hypergraph(f, p, 0.8, 0.5, ratio)
    np.testing.assert_array_equal(ei, jei)
    np.testing.assert_allclose(w, jw, rtol=1e-5, atol=1e-7)
    for legacy in (False, True):
        got = tdense.build_hypergraph_data(f, p, threshold_median_ratio=ratio, legacy_keys=legacy,
                                           device="cpu")
        want = jdense.build_hypergraph_data(f, p, threshold_median_ratio=ratio, legacy_keys=legacy)
        assert set(got) == set(want)
        for key in want:
            np.testing.assert_allclose(got[key], want[key], rtol=1e-5, atol=1e-7, err_msg=key)
    np.testing.assert_allclose(tdense.mean_pool_with_similarity(f, p, 1.0, 1.0, device="cpu"),
                               jdense.mean_pool_with_similarity(f, p, 1.0, 1.0), rtol=1e-6)
    with pytest.raises(ValueError, match="greater than 1"):
        tdense.build_weighted_hypergraph(f[:1], p[:1], device="cpu")


def test_stagewise_functions_match_jax():
    feats, pos, tma = _blobs(1)
    sp, spp, st, K = tbuild.aggregate_wsi_super_patches(
        feats, pos, 20, 0.5, 0.7, seed=SEED, device="cpu", init_centers=_draws(feats, 20))
    jsp, jspp, jst, jK = jbuild.aggregate_wsi_super_patches(feats, pos, 20, 0.5, 0.7, seed=SEED)
    np.testing.assert_allclose(K, jK, rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(sp, jsp, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(spp, jspp, rtol=1e-5, atol=1e-6)
    _close(st, jst)
    # a given cache, and no similarity at all
    _, _, st2, K2 = tbuild.aggregate_wsi_super_patches(
        feats, pos, 20, seed=SEED, wsi_similarity_matrix=jK, device="cpu",
        init_centers=_draws(feats, 20))
    assert K2 is jK
    _close(st2, jst, rtol=1e-6, atol=0)
    _, _, st3, K3 = tbuild.aggregate_wsi_super_patches(
        feats, pos, 20, compute_similarity=False, device="cpu", init_centers=_draws(feats, 20))
    assert K3 is None and set(st3) == {"num_original_patches", "num_super_patches"}

    sim, sst = tbuild.compute_wsi_tma_similarity(jsp, tma, 0.8, device="cpu")
    jsim_, jsst = jbuild.compute_wsi_tma_similarity(jsp, tma, 0.8)
    np.testing.assert_allclose(sim, jsim_, rtol=1e-5, atol=1e-7)
    _close(sst, jsst)

    labels, gst = tbuild.group_by_similarity(jsim_, 4, "kmeans", SEED, device="cpu",
                                             init_centers=_draws(jsim_, 4))
    jlabels, jgst = jbuild.group_by_similarity(jsim_, 4, "kmeans", SEED)
    np.testing.assert_array_equal(labels, jlabels)
    assert gst == jgst
    square = np.asarray(jK[:30, :30])
    nearest = np.argmax((square / np.linalg.norm(square, axis=1, keepdims=True))
                        @ (square.T / np.linalg.norm(square.T, axis=1, keepdims=True)).T, axis=1)
    labels, gst = tbuild.group_by_similarity(
        square, 3, "knn", SEED, device="cpu",
        init_centers=_draws(nearest.astype(np.float32).reshape(-1, 1), 3))
    jlabels, jgst = jbuild.group_by_similarity(square, 3, "knn", SEED)
    np.testing.assert_array_equal(labels, jlabels)
    assert gst == jgst
    with pytest.raises(ValueError, match="Unknown grouping method"):
        tbuild.group_by_similarity(sim, 3, "spectral", device="cpu")


@pytest.mark.parametrize("n_super", [20, 4100], ids=["dense_topk", "running_topk"])
def test_build_hypergraph_knn_kmeans_matches_jax(n_super):
    """At 4096 nodes and more, the node KNN runs the running top-k (K2 on
    the card); small-integer features make every distance exact, so ties
    order by index on both sides."""
    rng = np.random.default_rng(n_super)
    if n_super > 1000:
        sp = rng.integers(-3, 4, (n_super, 8)).astype(np.float32)
        tma = rng.integers(-3, 4, (6, 8)).astype(np.float32)
    else:
        sp, _, tma = _blobs(2, n=n_super, d=16, n_tma=6)
    fa = np.concatenate([sp, tma])
    ei, w, st = tbuild.build_hypergraph_knn_kmeans(sp, tma, None, 3, 40, SEED, device="cpu",
                                                   init_centers=_draws(fa, 40))
    jei, jw, jst = jbuild.build_hypergraph_knn_kmeans(sp, tma, None, 3, 40, SEED)
    np.testing.assert_array_equal(ei, jei)
    np.testing.assert_allclose(w, jw, rtol=1e-5, atol=1e-6)
    assert st == jst


def _rebuild_draws(h5, S, G, H):
    """The JAX rebuild's three draws: key(seed) for each stage, the group and
    hyperedge inputs from the JAX stages it runs."""
    feats, pos = jbuild.load_wsi_data(h5)
    tma = jbuild.load_tma_data(h5)
    K, _ = jbuild.load_similarity_matrices(h5)
    sp, _, _, _ = jbuild.aggregate_wsi_super_patches(feats, pos, S, seed=SEED, wsi_similarity_matrix=K)
    sim, _ = jbuild.compute_wsi_tma_similarity(sp, tma)
    return {"super": _draws(feats, S), "group": _draws(sim, G),
            "hyperedge": _draws(np.concatenate([sp, tma]), H)}


def test_cache_then_rebuild_matches_jax(tmp_path):
    """Both packages cache the similarities of the same built file, then
    rebuild it with new parameters and a threshold at the median edge."""
    _write_ds(tmp_path / "j", 1)
    h5_j, h5_t = tmp_path / "j" / "case_0.h5", tmp_path / "t.h5"
    jbuild.process_single_file(h5_j, 20, 4, 3, 5, save_similarity=False)
    shutil.copy(h5_j, h5_t)
    written = tbuild.cache_similarity_matrices(h5_t, device="cpu")
    assert written == jbuild.cache_similarity_matrices(h5_j)
    assert tbuild.cache_similarity_matrices(h5_t, device="cpu") == {}  # cached: nothing to do
    (tK, tS), (jK, jS) = tbuild.load_similarity_matrices(h5_t), jbuild.load_similarity_matrices(h5_j)
    np.testing.assert_allclose(tK, jK, rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(tS, jS, rtol=1e-5, atol=1e-7)
    feats, pos = (torch.as_tensor(a) for a in tbuild.load_wsi_data(h5_t))
    np.testing.assert_array_equal(tK, similarity_rect_plain(feats, pos, feats, pos).numpy())

    kw = dict(num_wsi_super_patches=6, num_groups=2, hypergraph_k=2, num_hyperedges=3,
              threshold_median_ratio=1.0, seed=SEED)
    init = _rebuild_draws(h5_j, 6, 2, 3)
    ts = tbuild.rebuild_hypergraph_from_similarity(h5_t, **kw, device="cpu", init_centers=init)
    js = jbuild.rebuild_hypergraph_from_similarity(h5_j, **kw)
    _close(ts, js)
    tg, jg = read_hypergraph_group(h5_t), read_hypergraph_group(h5_j)
    assert set(tg) == set(jg)
    for key in ("edge_index", "group_labels"):
        np.testing.assert_array_equal(tg[key], jg[key], err_msg=key)
    for key in ("edge_weights", "wsi_super/features", "similarity/wsi_tma", "similarity/wsi_internal"):
        np.testing.assert_allclose(tg[key], jg[key], rtol=1e-5, atol=1e-7, err_msg=key)
    assert (tg["edge_weights"] >= ts["hypergraph"]["threshold"]).all()
    assert ts["hypergraph"]["num_edges_after_threshold"] < ts["hypergraph"]["num_edges"]

    # the rebuilt group's super-patches and groups, re-used as they stand
    kw2 = dict(num_wsi_super_patches=None, num_groups=None, hypergraph_k=3, num_hyperedges=2)
    fa = np.concatenate([tg["wsi_super/features"], tg["tma/features"]])
    ts2 = tbuild.rebuild_hypergraph_from_similarity(h5_t, **kw2, device="cpu",
                                                    init_centers={"hyperedge": _draws(fa, 2)})
    js2 = jbuild.rebuild_hypergraph_from_similarity(h5_j, **kw2)
    _close(ts2, js2)
    np.testing.assert_array_equal(read_hypergraph_group(h5_t)["edge_index"],
                                  read_hypergraph_group(h5_j)["edge_index"])


def test_rebuild_without_cache_takes_unit_lambdas(tmp_path):
    """A ROADMAP Queue 3 property of the reference, kept: with no cached K
    the rebuild computes it at lambda_h = lambda_g = 1, whatever the build
    used; and it needs the super-patches or their count."""
    _write_ds(tmp_path, 1)
    h5 = tmp_path / "case_0.h5"
    tbuild.process_single_file(h5, 20, 4, 3, 5, lambda_h=0.5, save_similarity=False, device="cpu")
    assert tbuild.load_similarity_matrices(h5) == (None, None)
    shutil.copy(h5, tmp_path / "jax.h5")
    tbuild.rebuild_hypergraph_from_similarity(h5, hypergraph_k=2, num_hyperedges=3, device="cpu")
    jbuild.rebuild_hypergraph_from_similarity(tmp_path / "jax.h5", hypergraph_k=2, num_hyperedges=3)
    feats, pos = (torch.as_tensor(a) for a in tbuild.load_wsi_data(h5))
    K = tbuild.load_similarity_matrices(h5)[0]
    np.testing.assert_array_equal(K, similarity_rect_plain(feats, pos, feats, pos, 1.0, 1.0).numpy())
    np.testing.assert_allclose(K, tbuild.load_similarity_matrices(tmp_path / "jax.h5")[0],
                               rtol=1e-5, atol=1e-7)
    assert not np.allclose(K, similarity_rect_plain(feats, pos, feats, pos, 0.5, 1.0).numpy())
    with h5py.File(h5, "a") as f:
        del f["hypergraph/wsi_super"]
    with pytest.raises(ValueError, match="wsi_super not found"):
        tbuild.rebuild_hypergraph_from_similarity(h5, device="cpu")


def test_cli_cache_and_rebuild_flags_match_jax_files(tmp_path):
    """The port's CLI (--file_batch, then --cache_similarity, then --rebuild
    with --threshold_median_ratio) against the JAX CLI's files on copies of
    one dataset: the same datasets and stats keys, the same cached K, every
    kept weight at least the threshold."""
    csv_j = _write_ds(tmp_path / "j")
    shutil.copytree(tmp_path / "j", tmp_path / "t")
    csv_t = tmp_path / "t" / "dataset.csv"
    common = ["--num_wsi_super_patches", "20", "--num_groups", "4", "--hypergraph_k", "3",
              "--num_hyperedges", "5"]
    runs = [["--no_save_similarity", "--file_batch", "2"], ["--cache_similarity"],
            ["--rebuild", "--threshold_median_ratio", "1.0", "--num_groups", "3"]]
    for extra in runs:
        jcli.main(["--csv_path", str(csv_j), "--data_root_dir", str(tmp_path / "j")] + common + extra)
        out = tcli.main(["--csv_path", str(csv_t), "--data_root_dir", str(tmp_path / "t")]
                        + common + extra + ["--device", "cpu"])
        assert all("error" not in s for s in out), out
    for i in range(3):
        tg = read_hypergraph_group(tmp_path / "t" / f"case_{i}.h5")
        jg = read_hypergraph_group(tmp_path / "j" / f"case_{i}.h5")
        assert set(tg) == set(jg)
        np.testing.assert_allclose(tg["similarity/wsi_internal"], jg["similarity/wsi_internal"],
                                   rtol=1e-5, atol=1e-7)
        ts, js = tg["__stats__"], jg["__stats__"]
        assert {k: set(v) for k, v in ts.items()} == {k: set(v) for k, v in js.items()}
        assert (tg["edge_weights"] >= ts["hypergraph"]["threshold"]).all()
        assert tg["wsi_super/features"].shape == jg["wsi_super/features"].shape
        assert set(np.unique(tg["group_labels"])) <= {0, 1, 2}

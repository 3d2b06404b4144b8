"""The port's per-slide hypergraph build (CPU) against the JAX build.

Both sides build copies of the same HDF5 fixture.  The port cannot
reproduce jax.random streams, so the JAX side's three sets of kmeans++ draws
are computed here (the key split as ``_fused_build`` splits it, the second
and third KMeans' inputs taken from JAX ``_fused_build``'s own ``sim`` and
``sp_feats``) and passed to the port through ``init_centers``."""

import csv
import importlib
import json
import subprocess
import sys
from pathlib import Path

import h5py
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_fusion_tpu.hypergraph import build as jbuild
from multimodal_fusion_tpu_torch.hypergraph import build as tbuild
from multimodal_fusion_tpu_torch.io.h5io import has_complete_hypergraph, read_hypergraph_group

jkm = importlib.import_module("multimodal_fusion_tpu.ops.kmeans")
REPO = Path(__file__).resolve().parents[1]
PARAMS = dict(num_wsi_super_patches=20, num_groups=4, hypergraph_k=3, num_hyperedges=5)
SEED = 42


def _write_fixture(root: Path, n_cases: int = 2, n: int = 300, d: int = 64):
    """The verify skill's fixture (5 blobs, N=300, D=64, 8 TMA cores), with
    the TMA cores drawn near the blob centers as bench.py draws them.  With
    the skill's standard-normal cores every cross similarity is ~1e-25, the
    grouping KMeans' squared distances fall below f32's normal range, and
    whether a backend flushes those subnormals to zero decides the groups."""
    rng = np.random.default_rng(0)
    rows = []
    for i in range(n_cases):
        centers = rng.standard_normal((5, d)) * np.sqrt(1.75 / d)
        a = rng.integers(0, 5, n)
        noise = np.sqrt(0.25 / d)
        with h5py.File(root / f"case_{i}.h5", "w") as f:
            f["wsi/features"] = (centers[a] + rng.standard_normal((n, d)) * noise).astype(np.float32)
            f["wsi/positions"] = rng.uniform(0, 4, (n, 2)).astype(np.float32)
            f["tma/features"] = (
                centers[rng.integers(0, 5, 8)] + rng.standard_normal((8, d)) * noise
            ).astype(np.float32)
        rows.append({"patient_id": i, "case_id": f"case_{i}",
                     "label": "living" if i % 2 else "deceased", "h5_file_path": f"case_{i}.h5"})
    with open(root / "dataset.csv", "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=["patient_id", "case_id", "label", "h5_file_path"])
        w.writeheader()
        w.writerows(rows)
    return root / "dataset.csv"


def _jax_side(h5, save_similarity, bucket_patches, upload_dtype):
    """JAX _fused_build outputs and its three kmeans++ draws for one file."""
    feats, pos = jbuild.load_wsi_data(h5)
    tma = jbuild.load_tma_data(h5)
    n_valid, padded = feats.shape[0], False
    if bucket_patches:
        feats, pos, n_valid, padded = jbuild._bucketed(feats, pos, bucket_patches)
    dt = jbuild._upload_dt(upload_dtype)
    feats = jnp.asarray(feats, dt).astype(jnp.float32)  # what _fused_build computes on
    tma = jnp.asarray(tma, dt).astype(jnp.float32)
    key = jax.random.key(SEED)
    out = jbuild._fused_build(
        key, jnp.asarray(feats, dt), jnp.asarray(pos), jnp.asarray(tma, dt),
        jnp.asarray(n_valid, jnp.int32), 1.0, 1.0, 20, 4, 3, 5,
        full_stats=True, ship_cache=save_similarity, padded=padded,
        bf16_exact=upload_dtype == "bfloat16",
    )
    k1, k2, k3 = jax.random.split(key, 3)
    mask = jnp.arange(feats.shape[0]) < n_valid if padded else None

    def draws(k, x, n_clusters, m=None):
        keys = jax.random.split(k, 10)
        init = jax.jit(jax.vmap(lambda kk: jkm.kmeans_plus_plus_init(kk, x, n_clusters, m)))(keys)
        return torch.as_tensor(np.array(init))

    all_feats = jnp.concatenate([out["sp_feats"], tma], axis=0)
    init = {
        "super": draws(k1, feats, 20, mask),
        "group": draws(k2, out["sim"], 4),
        "hyperedge": draws(k3, all_feats, 5),
    }
    return jax.device_get(out), init


def _assert_stats_close(a, b, path="stats"):
    if isinstance(a, dict):
        assert set(a) == set(b), path
        for key in a:
            _assert_stats_close(a[key], b[key], f"{path}.{key}")
    elif isinstance(a, float) or isinstance(b, float):
        # f32 statistics of ulp-different similarities
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5, err_msg=path)
    else:
        assert a == b, path


@pytest.mark.parametrize(
    "save_similarity,bucket_patches,upload_dtype",
    [(False, None, "float32"), (False, 128, "float32"), (True, None, "float32"),
     (False, None, "bfloat16")],
    ids=["compute_on_read", "bucketed", "save_similarity", "bf16_upload"],
)
def test_build_matches_jax_with_injected_draws(tmp_path, save_similarity, bucket_patches, upload_dtype):
    (tmp_path / "jax").mkdir()
    (tmp_path / "port").mkdir()
    _write_fixture(tmp_path / "jax")
    _write_fixture(tmp_path / "port")
    for i in range(2):
        h5_j, h5_t = tmp_path / "jax" / f"case_{i}.h5", tmp_path / "port" / f"case_{i}.h5"
        jout, init = _jax_side(h5_j, save_similarity, bucket_patches, upload_dtype)
        common = dict(PARAMS, seed=SEED, save_similarity=save_similarity,
                      bucket_patches=bucket_patches, upload_dtype=upload_dtype)
        js = jbuild.process_single_file(h5_j, **common)
        ts = tbuild.process_single_file(h5_t, **common, device="cpu", init_centers=init)
        _assert_stats_close(ts, js)
        jg, tg = read_hypergraph_group(h5_j), read_hypergraph_group(h5_t)
        assert set(jg) == set(tg)
        for key in ("group_labels", "edge_index"):
            np.testing.assert_array_equal(tg[key], jg[key], err_msg=key)
        for key in ("wsi_super/features", "wsi_super/positions", "tma/features",
                    "edge_weights", "similarity/wsi_tma"):
            if key in jg:  # f32 features/weights of ulp-different inputs
                np.testing.assert_allclose(tg[key], jg[key], rtol=1e-5, atol=1e-5, err_msg=key)
        if save_similarity:
            # the cache is stored in bf16: an ulp-level difference in K can
            # round to the neighbouring bf16 value (one bf16 ulp is at most
            # 2^-7 of the value)
            np.testing.assert_allclose(
                tg["similarity/wsi_internal"], jg["similarity/wsi_internal"],
                rtol=2.0**-7, atol=1e-7,
            )
        _assert_stats_close(tg["__stats__"], jg["__stats__"])

        # the super-patch labels never reach the file: compare the device outputs
        feats, pos = tbuild.load_wsi_data(h5_t)
        res = tbuild.process_arrays(
            feats, pos, tbuild.load_tma_data(h5_t), **common, device="cpu", init_centers=init,
        )
        np.testing.assert_array_equal(res["host"]["labels"], np.asarray(jout["labels"]))
        np.testing.assert_allclose(res["host"]["K_stats"], jout["K_stats"], rtol=1e-5, atol=1e-7)
        np.testing.assert_allclose(res["host"]["intra_mean"], jout["intra_mean"], rtol=1e-5)
        np.testing.assert_array_equal(res["arrays"]["edge_index"], tg["edge_index"])


@pytest.mark.parametrize("case", ["empty_tma", "all_singletons"])
def test_edge_cases_build_like_jax(tmp_path, case):
    """A present-but-empty TMA dataset builds (null cross-similarity stats);
    n == num_super_patches makes every cluster a singleton (intra mean 0.0)."""
    rng = np.random.default_rng(2)
    n, n_tma = (60, 0) if case == "empty_tma" else (6, 3)
    p = tmp_path / "case_0.h5"
    with h5py.File(p, "w") as f:
        f["wsi/features"] = (rng.standard_normal((n, 16)) * 0.4).astype(np.float32)
        f["wsi/positions"] = rng.uniform(0, 2, (n, 2)).astype(np.float32)
        f["tma/features"] = (rng.standard_normal((n_tma, 16)) * 0.4).astype(np.float32)
    params = (6, 2, 2, 3)
    stats = tbuild.process_single_file(p, *params, save_similarity=False, device="cpu")
    want = jbuild.process_single_file(p, *params, save_similarity=False)
    assert stats["hypergraph"]["num_nodes"] == want["hypergraph"]["num_nodes"]
    assert stats["similarity"].keys() == want["similarity"].keys()
    if case == "empty_tma":
        assert stats["similarity"]["mean"] is None and want["similarity"]["mean"] is None
        assert read_hypergraph_group(p)["edge_index"].shape[1] > 0
    else:
        assert stats["wsi_aggregation"]["avg_intra_cluster_similarity"] == 0.0


def test_process_dataset_pipeline_and_resume(tmp_path):
    csv_path = _write_fixture(tmp_path)
    with open(csv_path, "a", newline="") as f:
        f.write("9,missing,living,nowhere.h5\n")
    stats, summary = tbuild.process_dataset(
        csv_path, tmp_path, **PARAMS, save_similarity=False, pipeline_depth=2,
        output_stats_path=tmp_path / "stats.json", device="cpu",
    )
    assert [s["case_id"] for s in stats] == ["case_0", "case_1"]
    assert summary["total_patches"] == 600 and summary["files"] == 2
    assert json.loads((tmp_path / "stats.json").read_text())["summary"]["files"] == 2
    assert all(has_complete_hypergraph(tmp_path / f"case_{i}.h5") for i in range(2))
    # the same seed gives the same build, slide for slide
    single = tbuild.process_single_file(
        tmp_path / "case_1.h5", **PARAMS, save_similarity=False, device="cpu"
    )
    assert single["hypergraph"] == stats[1]["hypergraph"]
    again, _ = tbuild.process_dataset(
        csv_path, tmp_path, **PARAMS, save_similarity=False, skip_existing=True, device="cpu"
    )
    assert [s.get("reason") for s in again] == ["existing_hypergraph"] * 2


def test_unported_paths_raise_and_device_defaults_to_cuda(tmp_path, monkeypatch):
    """Nothing is unported any more: ``mesh`` builds (in a gang,
    tests/test_torch_port_parallel.py) and refuses ``file_batch``, as the
    JAX build does; the batched build and blockwise statistics build."""
    csv_path = _write_fixture(tmp_path, n_cases=1)
    with pytest.raises(ValueError, match="mutually exclusive"):
        tbuild.process_dataset(csv_path, tmp_path, save_similarity=False, mesh=object(),
                               file_batch=2, device="cpu")
    assert not hasattr(tbuild, "_not_ported")
    stats, _ = tbuild.process_dataset(csv_path, tmp_path, **PARAMS, file_batch=2,
                                      save_similarity=False, device="cpu")
    assert [s.get("error") for s in stats] == [None]
    monkeypatch.setattr(tbuild, "FULL_STATS_MAX_N", 100)
    block = tbuild.process_single_file(tmp_path / "case_0.h5", **PARAMS, save_similarity=False,
                                       device="cpu")
    assert block["wsi_aggregation"]["wsi_similarity_matrix_stats"]["median"] is not None
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            tbuild.process_single_file(tmp_path / "case_0.h5", **PARAMS)


def test_cli_builds_on_cpu_and_rejects_unported_flags(tmp_path):
    csv_path = _write_fixture(tmp_path, n_cases=2)
    cmd = [sys.executable, "-m", "multimodal_fusion_tpu_torch.cli.preprocess_hypergraph",
           "--csv_path", str(csv_path), "--data_root_dir", str(tmp_path),
           "--num_wsi_super_patches", "20", "--num_groups", "4", "--hypergraph_k", "3",
           "--num_hyperedges", "5", "--no_save_similarity", "--device", "cpu",
           "--output_stats_path", str(tmp_path / "stats.json")]
    out = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    summary = json.loads(out.stdout.strip().splitlines()[-1])
    assert summary["files"] == 2 and summary["total_patches"] == 600
    assert all(has_complete_hypergraph(tmp_path / f"case_{i}.h5") for i in range(2))
    # --mesh_data larger than the world (no launcher: a world of 1) fails
    # as the JAX package's make_mesh does
    bad = subprocess.run(cmd + ["--mesh_data", "2"], cwd=REPO, capture_output=True, text=True,
                         timeout=300)
    assert bad.returncode == 1 and "requested 2 devices, have 1" in bad.stderr


def _h5_datasets(path):
    out = {}
    with h5py.File(path, "r") as f:
        f.visititems(lambda name, obj: out.__setitem__(name, np.asarray(obj))
                     if isinstance(obj, h5py.Dataset) else None)
    return out


def test_fixture_copies_match_the_jax_package_and_bench(tmp_path):
    """The port's own fixture generators write what the JAX package's
    make_synthetic_dataset and bench.py's make_fixtures write."""
    import bench
    from multimodal_fusion_tpu.io.fixtures import make_synthetic_dataset as jax_make
    from multimodal_fusion_tpu_torch.io.fixtures import (
        make_clustered_dataset,
        make_synthetic_dataset,
    )

    kw = dict(n_patients=2, seed=0, min_wsi_patches=24, max_wsi_patches=48, feature_dim=64)
    jcsv = jax_make(tmp_path / "j", **kw)
    tcsv = make_synthetic_dataset(tmp_path / "t", **kw)
    (tmp_path / "bench").mkdir()
    bench.make_fixtures(tmp_path / "bench", 2)
    ccsv = make_clustered_dataset(tmp_path / "c", 2)
    pairs = [(jcsv, tcsv), (tmp_path / "bench" / "dataset.csv", ccsv)]
    for want_csv, got_csv in pairs:
        assert want_csv.read_text() == got_csv.read_text()
        for row in tbuild._read_csv_rows(got_csv):
            want = _h5_datasets(want_csv.parent / row["h5_file_path"])
            got = _h5_datasets(got_csv.parent / row["h5_file_path"])
            assert want.keys() == got.keys()
            for key in want:
                np.testing.assert_array_equal(got[key], want[key], err_msg=key)

    # per-marker TMA layout (8 markers x 4 cores): the build concatenates them
    stats, summary = tbuild.process_dataset(
        tcsv, tmp_path / "t", 6, 2, 2, 3, save_similarity=False, device="cpu"
    )
    assert all("error" not in s for s in stats), stats
    assert [s["hypergraph"]["num_tma_patches"] for s in stats] == [32, 32]

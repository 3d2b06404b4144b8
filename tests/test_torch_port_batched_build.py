"""The port's batched build (``file_batch > 1``, CPU): each file of a chunk
gets what ``file_batch=1`` gives it, since every slide draws from its own
generators seeded as a slide built alone; chunking and error handling as in
the JAX package's ``_process_dataset_batched``."""

import csv

import h5py
import numpy as np
import pytest
import torch

from multimodal_fusion_tpu.hypergraph import build as jbuild
from multimodal_fusion_tpu_torch.hypergraph import build as tbuild
from multimodal_fusion_tpu_torch.io.h5io import read_hypergraph_group
from multimodal_fusion_tpu_torch.ops import kmeans as tkm

PARAMS = (8, 3, 2, 4)  # super-patches, groups, k, hyperedges


def _write_ds(root, n_per_file, seed0=100, d=16):
    """The JAX package's batched-build fixture: one file per patch count."""
    root.mkdir()
    rows = []
    for i, n in enumerate(n_per_file):
        r = np.random.default_rng(seed0 + i)
        with h5py.File(root / f"case_{i}.h5", "w") as f:
            f["wsi/features"] = (r.standard_normal((n, d)) * 0.3).astype(np.float32)
            f["wsi/positions"] = r.uniform(0, 3, (n, 2)).astype(np.float32)
            f["tma/features"] = (r.standard_normal((6, d)) * 0.3).astype(np.float32)
        rows.append({"patient_id": i, "case_id": f"case_{i}", "label": "living",
                     "h5_file_path": f"case_{i}.h5"})
    with open(root / "d.csv", "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=["patient_id", "case_id", "label", "h5_file_path"])
        w.writeheader()
        w.writerows(rows)
    return root / "d.csv"


def _same_files(a_root, b_root, n_files):
    for i in range(n_files):
        a = read_hypergraph_group(a_root / f"case_{i}.h5")
        b = read_hypergraph_group(b_root / f"case_{i}.h5")
        assert set(a) == set(b)
        for key in ("edge_index", "group_labels"):
            np.testing.assert_array_equal(b[key], a[key], err_msg=f"file {i}: {key}")
        for key in ("wsi_super/features", "wsi_super/positions", "edge_weights"):
            np.testing.assert_allclose(b[key], a[key], rtol=1e-6, atol=1e-7, err_msg=f"file {i}: {key}")
        sa, sb = a["__stats__"], b["__stats__"]
        assert sa["wsi_aggregation"]["wsi_similarity_matrix_stats"] == \
            sb["wsi_aggregation"]["wsi_similarity_matrix_stats"], i
        np.testing.assert_allclose(sb["wsi_aggregation"]["avg_intra_cluster_similarity"],
                                   sa["wsi_aggregation"]["avg_intra_cluster_similarity"], rtol=1e-6)


@pytest.mark.parametrize(
    "shapes,file_batch,bucket",
    [([50, 50, 70, 50, 70], 3, None), ([40, 55, 70, 90], 4, 128)],
    ids=["shape_groups", "bucketed"],
)
def test_file_batch_matches_file_batch_1(tmp_path, shapes, file_batch, bucket):
    """The JAX package's shapes: two shape groups (3 files of 50 patches, 2
    of 70) in chunks of 3; or four patch counts in one 128-bucket.  Edges
    and groups identical, K statistics equal."""
    csv_a = _write_ds(tmp_path / "a", shapes)
    csv_b = _write_ds(tmp_path / "b", shapes)
    kw = dict(save_similarity=False, bucket_patches=bucket, device="cpu")
    stats_a, _ = tbuild.process_dataset(csv_a, tmp_path / "a", *PARAMS, **kw)
    stats_b, summary = tbuild.process_dataset(csv_b, tmp_path / "b", *PARAMS, file_batch=file_batch, **kw)
    assert all("error" not in s for s in stats_a + stats_b), stats_b
    assert [s["case_id"] for s in stats_b] == [f"case_{i}" for i in range(len(shapes))]
    assert [s["num_patches_processed"] for s in stats_b] == shapes
    assert summary["total_patches"] == sum(shapes)
    _same_files(tmp_path / "a", tmp_path / "b", len(shapes))


@pytest.mark.parametrize("mode", ["blockwise", "sampled"])
def test_large_slide_groups_batch(tmp_path, monkeypatch, mode):
    """Above FULL_STATS_MAX_N (lowered to 100): blockwise groups batch all
    but their stripes and attach each median when drained; sampled groups
    batch too."""
    monkeypatch.setattr(tbuild, "FULL_STATS_MAX_N", 100)
    monkeypatch.setattr(tbuild, "LARGE_N_STATS", mode)
    shapes = [300, 300, 300]
    csv_a = _write_ds(tmp_path / "a", shapes)
    csv_b = _write_ds(tmp_path / "b", shapes)
    stats_a, _ = tbuild.process_dataset(csv_a, tmp_path / "a", *PARAMS, save_similarity=False,
                                        device="cpu")
    stats_b, _ = tbuild.process_dataset(csv_b, tmp_path / "b", *PARAMS, save_similarity=False,
                                        file_batch=2, device="cpu")
    assert all("error" not in s for s in stats_a + stats_b), stats_b
    _same_files(tmp_path / "a", tmp_path / "b", len(shapes))


def test_batched_build_isolates_errors_and_resumes(tmp_path):
    """CSV order with a missing file, a file without TMA (skipped), a file
    without WSI features (its error alone), then skip_existing."""
    csv_path = _write_ds(tmp_path / "d", [50, 50, 50, 50])
    root = tmp_path / "d"
    with h5py.File(root / "case_1.h5", "a") as f:
        del f["tma"]
    with h5py.File(root / "case_2.h5", "a") as f:
        del f["wsi/features"]
    with open(csv_path, "a", newline="") as f:
        f.write("9,missing,living,nowhere.h5\n")
    stats, summary = tbuild.process_dataset(csv_path, root, *PARAMS, save_similarity=False,
                                            file_batch=4, device="cpu")
    assert [s["case_id"] for s in stats] == ["case_0", "case_1", "case_2", "case_3"]
    assert stats[1] == {"case_id": "case_1", "status": "skipped", "reason": "no_tma"}
    assert "WSI features not found" in stats[2]["error"]
    assert "error" not in stats[0] and "error" not in stats[3]
    assert summary["total_patches"] == 100
    again, summary = tbuild.process_dataset(csv_path, root, *PARAMS, save_similarity=False,
                                            file_batch=4, skip_existing=True, device="cpu")
    assert [s.get("reason") for s in again[:2]] == ["existing_hypergraph"] * 2
    assert summary["total_patches"] == 0


def test_effective_file_batch_matches_jax():
    for file_batch in (1, 2, 3, 8, 64):
        for n in (50, 4096, 16384, 32768, 32769, 65536, 200000):
            for full_stats in (True, False):
                for d in (16, 1024):
                    assert tbuild._effective_file_batch(file_batch, n, full_stats, d) == \
                        jbuild._effective_file_batch(file_batch, n, full_stats, d), (file_batch, n)


def test_kmeans_batched_draws_as_each_slide_alone():
    """Each slide of a batch draws from its own generator: kmeans_batched
    equals kmeans one slide at a time (labels and inertia), padded rows
    never drawn."""
    rng = np.random.default_rng(4)
    x = torch.as_tensor(rng.standard_normal((3, 120, 8)).astype(np.float32))
    mask = torch.arange(120)[None, :] < torch.as_tensor([120, 97, 64])[:, None]
    gens = lambda: [torch.Generator().manual_seed(7) for _ in range(3)]  # noqa: E731
    init = torch.stack([tkm.kmeans_plus_plus_init(x[i], 5, g, 10, mask[i])
                        for i, g in enumerate(gens())])
    batched_init = tkm._kmeans_pp(x, 5, gens(), 10, mask)
    torch.testing.assert_close(batched_init, init, rtol=0, atol=0)
    got = tkm.kmeans_batched(x, 5, gens(), mask=mask)
    for i, g in enumerate(gens()):
        one = tkm.kmeans(x[i], 5, g, mask=mask[i])
        np.testing.assert_array_equal(got.labels[i].numpy(), one.labels.numpy())
        np.testing.assert_allclose(got.inertia[i].numpy(), one.inertia.numpy(), rtol=1e-6)
    rows = torch.cdist(init.reshape(3, -1, 8), x).argmin(-1)  # each center is a row of its slide
    assert all(int(rows[i].max()) < int(mask[i].sum()) for i in range(3))


def test_inverse_cdf_draws():
    """Inverse-CDF selection: never an index of weight 0, index 0 from an
    all-zero row (as jax.random.choice), and the draw frequencies of the
    weights."""
    w = torch.tensor([[0.0, 1.0, 0.0, 3.0, 0.0], [0.0] * 5])
    u = torch.tensor([[0.0, 0.2499, 0.25, 0.9999999, 1.0 - 2**-24], [0.3] * 5])
    np.testing.assert_array_equal(tkm._inverse_cdf(w, u).numpy(),
                                  [[1, 1, 3, 3, 3], [0, 0, 0, 0, 0]])
    g = torch.Generator().manual_seed(0)
    draws = tkm._inverse_cdf(w[:1], torch.rand((1, 40000), generator=g))
    np.testing.assert_allclose(np.bincount(draws[0].numpy(), minlength=5) / 40000,
                               [0, 0.25, 0, 0.75, 0], atol=0.01)

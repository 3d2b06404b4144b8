"""Synthetic fixtures for the port: the survival-dataset layout (CSV +
per-patient HDF5), the per-marker NPZ files of alignment pretraining and
the clustered-blob slides of the build benchmark.

``clustered_slide`` draws exactly what ``bench.py:make_fixtures`` draws for
one slide (same generator calls in the same order), so
``make_clustered_dataset(root, n, seed=0)`` reproduces the benchmark's
files.  Its arrays are usable without h5py (``hypergraph.build.process_arrays``).
"""

from __future__ import annotations

import csv
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from multimodal_fusion_tpu_torch.channels import TMA_MARKERS
from multimodal_fusion_tpu_torch.io.h5io import write_channel

TABULAR_DIMS = {
    "clinical": 16,
    "pathological": 12,
    "blood": 24,
    "icd": 10,
    "tma_cell_density": 8,
}

_CSV_FIELDS = ["patient_id", "case_id", "label", "h5_file_path"]


def _write_csv(path: Path, rows: List[Dict]) -> None:
    with open(path, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=_CSV_FIELDS)
        w.writeheader()
        w.writerows(rows)


def make_patient_h5(
    path: Path,
    rng: np.random.Generator,
    n_wsi_patches: int,
    n_tma_patches: int = 4,
    feature_dim: int = 1024,
    markers: Sequence[str] = TMA_MARKERS,
    tabular_dims: Optional[Dict[str, int]] = None,
    with_reconstructed: bool = False,
) -> None:
    tabular_dims = tabular_dims or TABULAR_DIMS
    feats = rng.standard_normal((n_wsi_patches, feature_dim)).astype(np.float32)
    pos = (rng.integers(0, 50_000, size=(n_wsi_patches, 2))).astype(np.float32)
    write_channel(path, "wsi=features", feats)
    write_channel(path, "wsi=positions", pos)
    if with_reconstructed:
        write_channel(path, "wsi=reconstructed_features", feats + 0.01)
    for mk in markers:
        mfeats = rng.standard_normal((n_tma_patches, feature_dim)).astype(np.float32)
        write_channel(path, f"tma={mk}=features", mfeats)
    for grp, dim in tabular_dims.items():
        val = rng.standard_normal((1, dim)).astype(np.float32)
        mask = (rng.random((1, dim)) > 0.1).astype(np.float32)
        write_channel(path, f"{grp}=val", val)
        write_channel(path, f"{grp}=ori_val", val * 2.0)
        write_channel(path, f"{grp}=mask", mask)


def make_synthetic_dataset(
    root,
    n_patients: int = 8,
    seed: int = 0,
    min_wsi_patches: int = 32,
    max_wsi_patches: int = 96,
    n_tma_patches: int = 4,
    feature_dim: int = 1024,
    markers: Sequence[str] = TMA_MARKERS,
    labels: Sequence[str] = ("living", "deceased"),
    with_reconstructed: bool = False,
) -> Path:
    """Synthetic survival dataset under ``root``; returns the CSV path
    (columns: patient_id, case_id, label, h5_file_path)."""
    root = Path(root)
    (root / "h5").mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    rows: List[Dict[str, str]] = []
    for i in range(n_patients):
        case_id = f"patient_{i:03d}"
        h5_rel = f"h5/{case_id}.h5"
        n_patches = int(rng.integers(min_wsi_patches, max_wsi_patches + 1))
        make_patient_h5(
            root / h5_rel, rng, n_wsi_patches=n_patches, n_tma_patches=n_tma_patches,
            feature_dim=feature_dim, markers=markers,
            with_reconstructed=with_reconstructed,
        )
        rows.append({
            "patient_id": str(i + 1), "case_id": case_id,
            "label": labels[i % len(labels)], "h5_file_path": h5_rel,
        })
    csv_path = root / "dataset.csv"
    _write_csv(csv_path, rows)
    return csv_path


def clustered_slide(
    rng: np.random.Generator,
    n_patches: int = 4096,
    n_tma: int = 32,
    dim: int = 1024,
    n_blobs: int = 12,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """One slide of clustered blobs in the informative kernel regime:
    within-blob E||df||^2 = 0.5 (kappa_h ~ 0.61), across-blob ~ 4, spatial
    blobs on the same assignment, TMA cores near blob centers.  Returns
    float32 (features [N, D], positions [N, 2], tma [T, D])."""
    centers = rng.standard_normal((n_blobs, dim)) * np.sqrt(1.75 / dim)
    pos_centers = rng.uniform(0.0, 4.0, (n_blobs, 2))
    assign = rng.integers(0, n_blobs, n_patches)
    feats = centers[assign] + rng.standard_normal((n_patches, dim)) * np.sqrt(0.25 / dim)
    pos = pos_centers[assign] + rng.normal(0.0, 0.3, (n_patches, 2))
    tma_assign = rng.integers(0, n_blobs, n_tma)
    tma = centers[tma_assign] + rng.standard_normal((n_tma, dim)) * np.sqrt(0.25 / dim)
    return feats.astype(np.float32), pos.astype(np.float32), tma.astype(np.float32)


def make_clustered_dataset(
    root,
    n_files: int,
    n_patches: int = 4096,
    n_tma: int = 32,
    dim: int = 1024,
    seed: int = 0,
) -> Path:
    """Write ``n_files`` clustered-blob slides as ``case_<i>.h5`` plus
    ``dataset.csv`` under ``root``; returns the CSV path."""
    import h5py

    root = Path(root)
    root.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    rows = []
    for i in range(n_files):
        feats, pos, tma = clustered_slide(rng, n_patches, n_tma, dim)
        with h5py.File(root / f"case_{i}.h5", "w") as f:
            f["wsi/features"] = feats
            f["wsi/positions"] = pos
            f["tma/features"] = tma
        rows.append({
            "patient_id": i, "case_id": f"case_{i}", "label": "living",
            "h5_file_path": f"case_{i}.h5",
        })
    csv_path = root / "dataset.csv"
    _write_csv(csv_path, rows)
    return csv_path


def make_alignment_npz_fixtures(
    root,
    n_cores: int = 6,
    patches_per_core: int = 3,
    feature_dim: int = 1024,
    markers: Sequence[str] = TMA_MARKERS,
    seed: int = 0,
) -> Dict[str, Path]:
    """Per-marker NPZ files with aligned keys; returns {marker: path}.

    Keys follow the reference regex ``_block(\\d+)_x(\\d+)_y(\\d+)_patient(\\w+)$``
    (reference: alignment/alignment_dataset.py:57): each entry is a
    ``[patches_per_core, feature_dim]`` array keyed by
    ``<marker>_block<b>_x<x>_y<y>_patient<pid>``.  The generator calls are
    the JAX package's, so one seed gives the same files in both packages."""
    root = Path(root)
    root.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    cores = [
        (int(rng.integers(1, 4)), int(rng.integers(0, 20)), int(rng.integers(0, 20)), f"{i:03d}")
        for i in range(n_cores)
    ]
    data = {mk: {f"{mk}_block{b}_x{x}_y{y}_patient{pid}":
                 rng.standard_normal((patches_per_core, feature_dim)).astype(np.float32)
                 for (b, x, y, pid) in cores} for mk in markers}
    paths = {mk: root / f"{mk}.npz" for mk in markers}
    # zlib releases the GIL: the markers' files compress on threads
    with ThreadPoolExecutor(max_workers=min(8, len(paths) or 1)) as ex:
        list(ex.map(lambda mk: np.savez_compressed(paths[mk], **data[mk]), markers))
    return paths

"""K-fold splitting and class-balanced sampling (counterpart of
``multimodal_fusion_tpu.data.splits``).

The JAX package calls scikit-learn's ``StratifiedKFold``; the port carries
its own copy of that algorithm (``stratified_kfold``, numpy only), which
gives the same fold membership for the same labels and seed.

Reference semantics: ``downstream_survival/main.py:257-441`` —
- ``random`` mode: StratifiedKFold(k, shuffle, seed) over cases; each fold's
  SORTED held-out indices are split val/test by a nested
  StratifiedKFold(2, shuffle, seed) — the fold-0 "train" half is val, the
  other half test (main.py:421-439; SAME membership as the reference given
  the same seed/labels);
- ``fixed`` mode: external JSON with train/test patient lists (robust numeric
  id matching, JSON-list ORDER preserved when building the pools); k-fold
  runs only within the train portion, the fixed test set is shared by all
  folds; an unmatched train list raises the reference's informative error.
  Both on-disk formats are accepted: the reference's list of
  ``{"patient_id": ..., "dataset": "training"|"test"}`` records
  (main.py:257-289) and the flat ``{"train": [...], "test": [...]}`` dict.
Weighted sampling: ``trainer.py:241-276`` — inverse-class-frequency weights
with replacement.
"""

from __future__ import annotations

import json
import re
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List, Optional, Sequence

import warnings

import numpy as np


def extract_numeric_id(value) -> Optional[int]:
    """Last integer run in an id string (reference main.py:443-456)."""
    try:
        if isinstance(value, (int, np.integer)):
            return int(value)
        if value is None:
            return None
        m = re.findall(r"\d+", str(value))
        return int(m[-1]) if m else None
    except Exception:
        return None


def stratified_kfold(labels, n_splits: int, seed: int):
    """Yield (train, test) index arrays of a shuffled stratified k-fold, as
    ``sklearn.model_selection.StratifiedKFold(n_splits, shuffle=True,
    random_state=seed).split(X, labels)`` does: classes are coded in order
    of first appearance, each fold takes its share of every class by a
    round robin over the sorted codes, and each class's fold assignments
    are shuffled by ``np.random.RandomState(seed)``, class by class."""
    if n_splits < 2:
        raise ValueError(f"k-fold cross-validation needs n_splits >= 2, got {n_splits}")
    y = np.asarray(labels).reshape(-1)
    rng = np.random.RandomState(seed)
    _, y_idx, y_inv = np.unique(y, return_index=True, return_inverse=True)
    _, class_perm = np.unique(y_idx, return_inverse=True)
    y_encoded = class_perm[y_inv.reshape(-1)]
    n_classes = len(y_idx)
    y_counts = np.bincount(y_encoded)
    if np.all(n_splits > y_counts):
        raise ValueError(f"n_splits={n_splits} cannot be greater than the number of members "
                         "in each class.")
    if n_splits > y_counts.min():
        warnings.warn(f"The least populated class in y has only {y_counts.min()} members, "
                      f"which is less than n_splits={n_splits}.", UserWarning)
    y_order = np.sort(y_encoded)
    allocation = np.asarray(
        [np.bincount(y_order[i::n_splits], minlength=n_classes) for i in range(n_splits)]
    )
    test_folds = np.empty(len(y), dtype="i")
    for k in range(n_classes):
        folds_for_class = np.arange(n_splits).repeat(allocation[:, k])
        rng.shuffle(folds_for_class)
        test_folds[y_encoded == k] = folds_for_class
    indices = np.arange(len(y))
    for i in range(n_splits):
        yield indices[test_folds != i], indices[test_folds == i]


@dataclass
class FoldSplit:
    train_idx: np.ndarray
    val_idx: np.ndarray
    test_idx: np.ndarray


def create_k_fold_splits(
    labels: Sequence[int],
    k: int,
    seed: int,
    patient_ids: Optional[Sequence] = None,
    fixed_split_path: Optional[str | Path] = None,
) -> List[FoldSplit]:
    labels = np.asarray(labels)
    n = len(labels)
    if fixed_split_path is None:
        out = []
        for train_idx, heldout in stratified_kfold(labels, k, seed):
            # reference main.py:421-433: sort the held-out fold, then a
            # nested seeded StratifiedKFold(2) — its first fold's TRAIN half
            # is val, the test half is test (identical membership)
            heldout = np.sort(heldout)
            val_rel, test_rel = next(stratified_kfold(labels[heldout], 2, seed))
            out.append(FoldSplit(train_idx, heldout[val_rel], heldout[test_rel]))
        return out

    spec = json.loads(Path(fixed_split_path).read_text())
    if isinstance(spec, list):
        # reference on-disk format: records of {"patient_id", "dataset"}
        # (main.py:257-289)
        spec = {
            "train": [r["patient_id"] for r in spec if r.get("dataset") == "training"],
            "test": [r["patient_id"] for r in spec if r.get("dataset") == "test"],
        }
    if patient_ids is None:
        raise ValueError("fixed split mode requires patient_ids")
    numeric = [extract_numeric_id(p) for p in patient_ids]
    id_to_indices: Dict[int, List[int]] = {}
    for i, pid in enumerate(numeric):
        if pid is not None:
            id_to_indices.setdefault(pid, []).append(i)

    def match(id_list):
        # JSON-list order preserved (reference main.py:364-388): the seeded
        # StratifiedKFold over the train pool sees the same element order
        matched: List[int] = []
        missing = []
        for x in id_list:
            cand = id_to_indices.get(extract_numeric_id(x), [])
            if cand:
                matched.extend(cand)
            else:
                missing.append(x)
        return np.asarray(matched, dtype=np.int64), missing

    test_idx, _ = match(spec.get("test", []))
    train_pool, missing_train = match(spec.get("train", []))
    if train_pool.size == 0:
        raise ValueError(
            "fixed split's train list matched no dataset patient ids "
            f"(first unmatched: {missing_train[:5]}; first available: "
            f"{list(patient_ids)[:5]}) — check id naming"
        )
    out = []
    for tr, va in stratified_kfold(labels[train_pool], k, seed):
        out.append(FoldSplit(train_pool[tr], train_pool[va], test_idx))
    return out


def save_fold_split(split: FoldSplit, case_ids: Sequence[str], path: str | Path) -> None:
    """Persist a fold split as case-id CSV (reference trainer.py:63-139)."""
    import csv

    rows = []
    maxlen = max(len(split.train_idx), len(split.val_idx), len(split.test_idx))
    for i in range(maxlen):
        rows.append(
            {
                "train": case_ids[split.train_idx[i]] if i < len(split.train_idx) else "",
                "val": case_ids[split.val_idx[i]] if i < len(split.val_idx) else "",
                "test": case_ids[split.test_idx[i]] if i < len(split.test_idx) else "",
            }
        )
    with open(path, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=["train", "val", "test"])
        w.writeheader()
        w.writerows(rows)


def load_fold_split(path: str | Path, case_ids: Sequence[str]) -> FoldSplit:
    """Inverse of ``save_fold_split``: case-id CSV -> index-based FoldSplit.

    Case ids absent from ``case_ids`` are dropped (the dataset may have
    filtered cases since training).  Reference reloads its persisted splits
    rather than re-deriving them (utils/robust_on_missing_modality.py:28-44).
    """
    import csv

    # the csv module stringified the ids on save; match on str so numeric
    # case_id columns (np.int64 in the dataset) still resolve
    idx = {str(cid): i for i, cid in enumerate(case_ids)}
    cols: Dict[str, List[int]] = {"train": [], "val": [], "test": []}
    with open(path, newline="") as f:
        for row in csv.DictReader(f):
            for k in cols:
                if row.get(k) and row[k] in idx:
                    cols[k].append(idx[row[k]])
    return FoldSplit(
        np.asarray(cols["train"], np.int64),
        np.asarray(cols["val"], np.int64),
        np.asarray(cols["test"], np.int64),
    )


class WeightedRandomSampler:
    """Inverse-class-frequency sampling with replacement, seeded."""

    def __init__(self, labels: Sequence[int], seed: int):
        labels = np.asarray(labels)
        counts = np.bincount(labels)
        weights = 1.0 / np.maximum(counts[labels], 1)
        self.probs = weights / weights.sum()
        self.rng = np.random.default_rng(seed)
        self.n = len(labels)

    def sample_epoch(self) -> np.ndarray:
        return self.rng.choice(self.n, size=self.n, replace=True, p=self.probs)

"""Missing-modality robustness sweep (counterpart of
``multimodal_fusion_tpu.utils.robust``).

Reference: ``downstream_survival/utils/robust_on_missing_modality.py`` —
load ``configs_*.json`` and the fold checkpoints of a results dir, take the
splits the trainer used, evaluate each fold's test split under a sweep of
modality ``drop_prob`` values, and write ``<out>.csv`` and ``<out>.json``
(``utils.visualization.plot_robust_results`` reads the JSON).  The draws
come from a ``torch.Generator`` seeded with ``seed`` on the run's device,
so they are not the JAX package's.
"""

from __future__ import annotations

import csv
import json
from pathlib import Path
from typing import Dict, List, Optional, Sequence

from multimodal_fusion_tpu_torch.data.splits import create_k_fold_splits, load_fold_split
from multimodal_fusion_tpu_torch.utils.results_io import load_results_context


def robustness_sweep(
    results_dir: str | Path,
    csv_path: str | Path,
    data_root_dir: str | Path,
    drop_probs: Sequence[float] = (0.0, 0.1, 0.2, 0.3, 0.4, 0.5),
    folds: Optional[Sequence[int]] = None,
    output_path: Optional[str | Path] = None,
    seed: int = 0,
    device=None,
) -> List[Dict]:
    """One row {fold, drop_prob, auc, acc, loss} per fold and drop_prob;
    the evaluation runs on ``device`` (default: the CUDA card)."""
    results_dir = Path(results_dir)
    configs, dataset, trainer, folds = load_results_context(
        results_dir, csv_path, data_root_dir, folds=folds, device=device
    )
    exp = configs.experiment_config

    def fold_split(fold: int):
        # the splits the trainer used, from its splits_<fold>.csv; deriving
        # them again from the seed is the fallback for results dirs that
        # predate the persisted splits
        persisted = results_dir / f"splits_{fold}.csv"
        if persisted.exists():
            return load_fold_split(persisted, dataset.case_ids)
        return create_k_fold_splits(
            dataset.labels,
            exp.k_folds,
            exp.seed,
            patient_ids=[dataset.case_to_patient[c] for c in dataset.case_ids],
            fixed_split_path=exp.fixed_split_path if exp.split_mode == "fixed" else None,
        )[fold]

    rows: List[Dict] = []
    for fold in folds:
        split = fold_split(fold)
        for dp in drop_probs:
            res = trainer.evaluate_fold(dataset, split, fold, drop_prob=dp if dp > 0 else None,
                                        seed=seed)
            rows.append({"fold": fold, "drop_prob": dp, "auc": res["auc"], "acc": res["acc"],
                         "loss": res["loss"]})

    out = Path(output_path) if output_path else results_dir / "robustness"
    with open(f"{out}.csv", "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=["fold", "drop_prob", "auc", "acc", "loss"])
        w.writeheader()
        w.writerows(rows)
    Path(f"{out}.json").write_text(json.dumps(rows, indent=2))
    return rows

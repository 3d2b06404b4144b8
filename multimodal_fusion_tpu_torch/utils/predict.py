"""Batch scoring of new cases from a trained survival results dir
(counterpart of ``multimodal_fusion_tpu.utils.predict``).

Loads ``configs_*.json`` and the per-fold ``s_<fold>_checkpoint.npz`` of a
results dir, scores every case of a CSV through ``evaluate_fold`` and
ensembles the folds by mean probability.  The CSV needs ``patient_id,
case_id, h5_file_path``; ``label`` is optional (unknown at serving time):
without it a placeholder label is written into a copy of the CSV in the
system temp dir, so the dataset layer's validation still applies, and no
per-fold AUC or accuracy is reported.  Probability columns follow the
training label order (sorted unique labels).  CSVs are read and written
with the stdlib ``csv`` module.
"""

from __future__ import annotations

import csv
import json
import os
import tempfile
from pathlib import Path
from typing import Dict, List, Optional, Sequence

import numpy as np

from multimodal_fusion_tpu_torch.data.splits import FoldSplit


def ensemble_rows(per_fold: Dict[int, Dict], folds: Sequence[int],
                  case_to_patient: Dict) -> List[Dict]:
    """Mean-probability fold ensemble -> one output row per case (shared by
    ``predict`` and ``utils.serve``)."""
    case_ids = per_fold[folds[0]]["patient_ids"]
    probs = np.mean([np.asarray(per_fold[f]["probs"]) for f in folds], axis=0)
    risk = np.mean([np.asarray(per_fold[f]["risk"]) for f in folds], axis=0)
    preds = probs.argmax(axis=1)
    rows: List[Dict] = []
    for i, cid in enumerate(case_ids):
        row = {
            "case_id": cid,
            "patient_id": case_to_patient[cid],
            "prediction": int(preds[i]),
            "risk": float(risk[i]),
        }
        for c in range(probs.shape[1]):
            row[f"prob_{c}"] = float(probs[i, c])
        for f in folds:
            row[f"fold_{f}_prob_1"] = float(per_fold[f]["probs"][i][1])
        rows.append(row)
    return rows


def write_csv(path, rows: List[Dict]) -> None:
    """``rows`` as a CSV whose columns are the union of their keys in
    first-seen order (a missing value is an empty field)."""
    fields: List[str] = []
    for r in rows:
        fields.extend(k for k in r if k not in fields)
    with open(path, "w", newline="") as fh:
        w = csv.DictWriter(fh, fieldnames=fields)
        w.writeheader()
        w.writerows(rows)


def predict(
    results_dir: str | Path,
    csv_path: str | Path,
    data_root_dir: str | Path,
    folds: Optional[Sequence[int]] = None,
    output_path: Optional[str | Path] = None,
    drop_prob: Optional[float] = None,
    seed: int = 0,
    device=None,
) -> Dict:
    """Score every case in ``csv_path`` with each fold checkpoint under
    ``results_dir`` on ``device`` (default: the CUDA card); returns the
    ensembled rows and writes ``predictions.csv`` / ``predictions.json``
    at ``output_path`` (default: in the results dir, or in the working
    directory when the results dir is read-only)."""
    from multimodal_fusion_tpu_torch.utils.results_io import load_results_context

    results_dir = Path(results_dir)
    with open(csv_path, newline="") as fh:
        reader = csv.DictReader(fh)
        columns = list(reader.fieldnames or [])
        in_rows = list(reader)
    tmp = None
    if "label" not in columns:
        # a copy with a placeholder label, in the system temp dir: the
        # results dir may be a read-only artifact
        tmp = tempfile.NamedTemporaryFile("w", suffix=".csv", delete=False)
        tmp.close()
        write_csv(tmp.name, [{**r, "label": "unknown"} for r in in_rows])
        csv_path = tmp.name
    try:
        configs, dataset, trainer, folds = load_results_context(
            results_dir, csv_path, data_root_dir, folds=folds, device=device)
        if len(dataset) == 0:
            raise ValueError("no cases to score: every CSV row was filtered by the dataset layer "
                             f"(missing h5 files or channels?); input rows={len(in_rows)}")
        split = FoldSplit(train_idx=np.array([], int), val_idx=np.array([], int),
                          test_idx=np.arange(len(dataset)))
        per_fold = {fold: trainer.evaluate_fold(dataset, split, fold, drop_prob=drop_prob, seed=seed)
                    for fold in folds}
    finally:
        if tmp is not None:
            Path(tmp.name).unlink(missing_ok=True)

    rows = ensemble_rows(per_fold, folds, dataset.case_to_patient)
    if output_path:
        out = Path(output_path)
    elif os.access(results_dir, os.W_OK):
        out = results_dir / "predictions"
    else:
        out = Path.cwd() / "predictions"
        print(f"results dir not writable; writing {out}.csv/.json")
    out.parent.mkdir(parents=True, exist_ok=True)
    write_csv(f"{out}.csv", rows)
    result = {
        "cases": rows,
        "folds": list(folds),
        "drop_prob": drop_prob,
        "n_cases_scored": len(rows),
        "n_cases_input": len(in_rows),
    }
    Path(f"{out}.json").write_text(json.dumps(result, indent=2))
    return result

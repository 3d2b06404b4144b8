"""Fold logger: per-epoch CSV log + per-class accuracy + JSON fold summary
(counterpart of ``multimodal_fusion_tpu.utils.logging``; it writes the same
files).

Reference: ``downstream_survival/trainer.py:279-485`` (Logger).
"""

from __future__ import annotations

import csv
import json
from pathlib import Path
from typing import Dict, List

import numpy as np

from multimodal_fusion_tpu_torch.train.metrics import per_class_accuracy


class FoldLogger:
    def __init__(self, log_dir: str | Path, fold_idx: int, n_classes: int = 2):
        self.log_dir = Path(log_dir)
        self.log_dir.mkdir(parents=True, exist_ok=True)
        self.fold_idx = fold_idx
        self.n_classes = n_classes
        # per-class columns follow n_classes
        self.FIELDS = (
            ["epoch", "lr", "train_loss", "val_loss", "val_auc", "val_acc"]
            + [f"val_acc_class{i}" for i in range(n_classes)]
            + ["time_s"]
        )
        self.csv_path = self.log_dir / f"fold_{fold_idx}_epochs.csv"
        self._rows: List[Dict] = []
        self.best: Dict = {}

    def log_epoch(self, epoch: int, lr: float, train_loss: float, val: Dict, time_s: float) -> None:
        pca = per_class_accuracy(val["preds"], val["labels"], self.n_classes)
        row = {
            "epoch": epoch,
            "lr": lr,
            "train_loss": train_loss,
            "val_loss": val["loss"],
            "val_auc": val["auc"],
            "val_acc": val["acc"],
            "time_s": time_s,
        }
        for i in range(self.n_classes):
            row[f"val_acc_class{i}"] = pca.get(i, float("nan"))
        self._rows.append(row)
        with open(self.csv_path, "w", newline="") as f:
            w = csv.DictWriter(f, fieldnames=self.FIELDS)
            w.writeheader()
            w.writerows(self._rows)

    def finalize(self, summary: Dict) -> None:
        self.best = summary
        (self.log_dir / f"fold_{self.fold_idx}_logger.json").write_text(
            json.dumps(
                {"fold": self.fold_idx, "epochs": self._rows, "summary": {
                    k: v for k, v in summary.items() if not isinstance(v, (list, dict))
                }},
                indent=2,
                default=lambda o: float(o) if isinstance(o, (np.floating, np.integer)) else str(o),
            )
        )

"""Evaluation metrics, host-side numpy (counterpart of
``multimodal_fusion_tpu.train.metrics``).

AUROC matches torchmetrics binary AUROC (rank statistic with tie handling)
as used by the reference (``downstream_survival/trainer.py:845-875``).
"""

from __future__ import annotations

from typing import Dict

import numpy as np


def binary_auroc(probs_pos: np.ndarray, labels: np.ndarray) -> float:
    """AUROC via the Mann-Whitney U statistic with midranks for ties."""
    probs_pos = np.asarray(probs_pos, np.float64)
    labels = np.asarray(labels)
    n_pos = int((labels == 1).sum())
    n_neg = int((labels == 0).sum())
    if n_pos == 0 or n_neg == 0:
        return float("nan")
    order = np.argsort(probs_pos, kind="mergesort")
    ranks = np.empty_like(order, dtype=np.float64)
    sorted_p = probs_pos[order]
    i = 0
    r = 1.0
    while i < len(sorted_p):
        j = i
        while j + 1 < len(sorted_p) and sorted_p[j + 1] == sorted_p[i]:
            j += 1
        midrank = (r + r + (j - i)) / 2.0
        ranks[order[i : j + 1]] = midrank
        r += j - i + 1
        i = j + 1
    sum_pos = ranks[labels == 1].sum()
    return float((sum_pos - n_pos * (n_pos + 1) / 2) / (n_pos * n_neg))


def concordance_index(risk: np.ndarray, time: np.ndarray, event: np.ndarray) -> float:
    """Harrell's C-index: fraction of comparable pairs ordered correctly by
    risk (higher risk -> earlier event).  Ties in risk count 0.5."""
    risk = np.asarray(risk, np.float64)
    time = np.asarray(time, np.float64)
    event = np.asarray(event).astype(bool)
    n = len(risk)
    concordant = 0.0
    comparable = 0
    for i in range(n):
        if not event[i]:
            continue
        for j in range(n):
            if time[j] > time[i] or (time[j] == time[i] and not event[j] and j != i):
                comparable += 1
                if risk[i] > risk[j]:
                    concordant += 1.0
                elif risk[i] == risk[j]:
                    concordant += 0.5
    return float(concordant / comparable) if comparable else float("nan")


def accuracy(preds: np.ndarray, labels: np.ndarray) -> float:
    return float((np.asarray(preds) == np.asarray(labels)).mean())


def per_class_accuracy(preds: np.ndarray, labels: np.ndarray, n_classes: int) -> Dict[int, float]:
    out = {}
    preds = np.asarray(preds)
    labels = np.asarray(labels)
    for c in range(n_classes):
        sel = labels == c
        out[c] = float((preds[sel] == c).mean()) if sel.any() else float("nan")
    return out


def multiclass_auroc_macro(probs: np.ndarray, labels: np.ndarray) -> float:
    """Macro one-vs-rest AUROC (torchmetrics AUROC(task='multiclass',
    average='macro') semantics, the reference's n_classes > 2 path —
    trainer.py:920-921).  ``probs`` [N, C]."""
    probs = np.asarray(probs, np.float64)
    labels = np.asarray(labels)
    aucs = []
    for c in range(probs.shape[1]):
        a = binary_auroc(probs[:, c], (labels == c).astype(int))
        if not np.isnan(a):
            aucs.append(a)
    return float(np.mean(aucs)) if aucs else float("nan")

"""Alignment visualization dumps and plots (counterpart of
``multimodal_fusion_tpu.utils.visualization``).

Reference utilities:
- ``downstream_survival/utils/alignment_visualization.py:1-304`` — run the
  model with ``return_svd_features`` and dump pre/post-SVD per-modality
  features + metadata per fold;
- ``plot_alignment_heatmap.py`` / ``plot_modality_tsne.py`` — similarity
  heatmap and t-SNE of aligned vs original features;
- ``plot_robust_results.py`` — AUC vs drop_prob box plots.

Plotting degrades to ``None`` when matplotlib is unavailable (the dump is
the primary artifact).
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, List, Optional, Sequence

import numpy as np


def dump_alignment_features(
    model,
    dataset,
    indices: Sequence[int],
    out_path: str | Path,
) -> Path:
    """Run a return_svd_features-capable model over cases, one case at a
    time on the model's device; save original and aligned per-modality
    features and labels as one NPZ (and the case ids beside it as JSON)."""
    import torch

    from multimodal_fusion_tpu_torch.data.batching import make_window

    device = next(model.parameters()).device
    model.return_svd_features = True
    originals: Dict[str, List[np.ndarray]] = {}
    aligneds: Dict[str, List[np.ndarray]] = {}
    labels: List[int] = []
    case_ids: List[str] = []
    try:
        with torch.no_grad():
            for idx in indices:
                cid = dataset.case_ids[idx]
                raw, label = dataset.get_case(cid)
                window = make_window([raw], [label])
                case = {part: {k: torch.as_tensor(v, device=device)
                               for k, v in window[part].items()}
                        for part in ("channels", "masks")}
                out = model(case, torch.as_tensor([label], device=device), train=False)
                for ch, feat in out["features"].items():
                    originals.setdefault(ch, []).append(feat[0].cpu().numpy())
                for ch, feat in out["aligned_features"].items():
                    aligneds.setdefault(ch, []).append(feat[0].cpu().numpy())
                labels.append(label)
                case_ids.append(cid)
    finally:
        model.return_svd_features = False

    payload = {}
    for ch, feats in originals.items():
        payload[f"original__{ch}"] = np.stack(feats)
    for ch, feats in aligneds.items():
        payload[f"aligned__{ch}"] = np.stack(feats)
    payload["labels"] = np.asarray(labels)
    out_path = Path(out_path)
    if out_path.suffix != ".npz":
        # np.savez appends '.npz' itself
        out_path = out_path.with_suffix(out_path.suffix + ".npz")
    out_path.parent.mkdir(parents=True, exist_ok=True)
    np.savez(out_path, **payload)
    (out_path.with_suffix(".json")).write_text(json.dumps({"case_ids": case_ids}))
    return out_path


def _get_plt():
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        return plt
    except Exception:
        return None


def plot_alignment_heatmap(dump_path: str | Path, out_path: str | Path) -> Optional[Path]:
    """Cross-modality cosine-similarity heatmaps, aligned vs original."""
    plt = _get_plt()
    if plt is None:
        return None
    data = np.load(dump_path)
    for prefix in ("original", "aligned"):
        chans = sorted(k for k in data.files if k.startswith(f"{prefix}__"))
        if not chans:
            continue
        M = len(chans)
        sim = np.zeros((M, M))
        feats = {c: data[c] / (np.linalg.norm(data[c], axis=1, keepdims=True) + 1e-8) for c in chans}
        for i, a in enumerate(chans):
            for j, b in enumerate(chans):
                sim[i, j] = float(np.mean(np.sum(feats[a] * feats[b], axis=1)))
        fig, ax = plt.subplots(figsize=(6, 5))
        im = ax.imshow(sim, vmin=-1, vmax=1, cmap="coolwarm")
        names = [c.split("__", 1)[1] for c in chans]
        ax.set_xticks(range(M), names, rotation=45, ha="right")
        ax.set_yticks(range(M), names)
        ax.set_title(f"{prefix} cross-modality similarity")
        fig.colorbar(im)
        fig.tight_layout()
        fig.savefig(f"{out_path}_{prefix}.png", dpi=120)
        plt.close(fig)
    return Path(f"{out_path}_aligned.png")


def plot_modality_tsne(dump_path: str | Path, out_path: str | Path) -> Optional[Path]:
    """t-SNE of aligned vs original features, colored by modality."""
    plt = _get_plt()
    if plt is None:
        return None
    from sklearn.manifold import TSNE

    data = np.load(dump_path)
    fig, axes = plt.subplots(1, 2, figsize=(12, 5))
    for ax, prefix in zip(axes, ("original", "aligned")):
        chans = sorted(k for k in data.files if k.startswith(f"{prefix}__"))
        if not chans:
            continue
        X = np.concatenate([data[c] for c in chans])
        groups = np.concatenate([[i] * len(data[c]) for i, c in enumerate(chans)])
        n = X.shape[0]
        if n < 3:
            continue  # sklearn requires perplexity < n_samples
        perplexity = max(2, min(30, (n - 1) // 3))
        perplexity = min(perplexity, n - 1)
        emb = TSNE(n_components=2, random_state=42, perplexity=perplexity).fit_transform(X)
        for i, c in enumerate(chans):
            sel = groups == i
            ax.scatter(emb[sel, 0], emb[sel, 1], s=8, label=c.split("__", 1)[1])
        ax.set_title(prefix)
        ax.legend(fontsize=6)
    fig.tight_layout()
    fig.savefig(f"{out_path}.png", dpi=120)
    plt.close(fig)
    return Path(f"{out_path}.png")


def plot_robust_results(robust_json: str | Path, out_path: str | Path) -> Optional[Path]:
    """AUC vs drop_prob box plots across folds."""
    plt = _get_plt()
    if plt is None:
        return None
    rows = json.loads(Path(robust_json).read_text())
    probs = sorted({r["drop_prob"] for r in rows})
    data = [[r["auc"] for r in rows if r["drop_prob"] == p and np.isfinite(r["auc"])] for p in probs]
    fig, ax = plt.subplots(figsize=(7, 4))
    ax.boxplot(data, tick_labels=[str(p) for p in probs])
    ax.set_xlabel("modality drop probability")
    ax.set_ylabel("test AUC")
    ax.set_title("Robustness to missing modalities")
    fig.tight_layout()
    fig.savefig(f"{out_path}.png", dpi=120)
    plt.close(fig)
    return Path(f"{out_path}.png")


def analyze_ablation(history_paths: Sequence[str | Path]) -> List[Dict]:
    """Aggregate best val loss from alignment ``.history.json`` files
    (reference alignment/experiments/analyze_ablation.py:15-60)."""
    rows = []
    for p in history_paths:
        p = Path(p)
        payload = json.loads(p.read_text())
        vals = payload.get("history", {}).get("val_loss", [])
        best = min((v["loss"] for v in vals), default=float("nan"))
        rows.append({"file": str(p), "best_val_loss": best, "config": payload.get("config", {})})
    return sorted(rows, key=lambda r: r["best_val_loss"])

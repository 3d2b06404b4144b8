"""Alignment-feature dump and visualization over a finished results dir
(counterpart of ``multimodal_fusion_tpu.cli.alignment_visualization``; the
JAX CLI's flags plus ``--device``, default the CUDA card).

Reference: ``downstream_survival/utils/alignment_visualization.py`` — load a
results dir's configs + fold checkpoint, run the model with
``return_svd_features`` over the fold's test split, save
``<results_dir>/svd_features/fold_<i>_features.npz``, then (optionally) plot
the heatmap and t-SNE (``utils/plot_alignment_heatmap.py`` /
``plot_modality_tsne.py`` are separate scripts there; one CLI here).
"""

from __future__ import annotations

import argparse
from pathlib import Path

from multimodal_fusion_tpu_torch.cli import console_script


def build_parser():
    p = argparse.ArgumentParser(description="Dump + plot aligned SVD features")
    p.add_argument("--results_dir", type=str, required=True)
    p.add_argument("--csv_path", type=str, required=True)
    p.add_argument("--data_root_dir", type=str, required=True)
    p.add_argument("--fold_idx", type=int, default=0)
    p.add_argument("--save_dir", type=str, default=None,
                   help="default: <results_dir>/svd_features")
    p.add_argument("--max_cases", type=int, default=None)
    p.add_argument("--plots", action="store_true", default=False,
                   help="also write heatmap + t-SNE PNGs next to the dump")
    p.add_argument("--device", type=str, default=None,
                   help="torch device (default: the CUDA card; 'cpu' to run on the CPU)")
    return p


def dump_svd_features_from_results(
    results_dir,
    csv_path,
    data_root_dir,
    fold_idx: int = 0,
    save_dir=None,
    max_cases=None,
    device=None,
) -> Path:
    """Rebuild the fold's model from configs + checkpoint on ``device``
    (default: the CUDA card), dump original and aligned per-modality
    features of the fold's TEST split (reloaded from the persisted
    splits_<fold>.csv)."""
    from multimodal_fusion_tpu_torch.data.multimodal import MultimodalDataset
    from multimodal_fusion_tpu_torch.data.splits import load_fold_split
    from multimodal_fusion_tpu_torch.device import resolve_device
    from multimodal_fusion_tpu_torch.train.checkpoint import load_model
    from multimodal_fusion_tpu_torch.train.survival import SurvivalTrainer
    from multimodal_fusion_tpu_torch.utils.results_io import load_configs
    from multimodal_fusion_tpu_torch.utils.visualization import dump_alignment_features

    device = resolve_device(device)  # no card without device="cpu": fail before reading data
    results_dir = Path(results_dir)
    configs = load_configs(results_dir)
    dataset = MultimodalDataset(
        csv_path, data_root_dir, channels=configs.experiment_config.target_channels
    )
    trainer = SurvivalTrainer(configs, results_dir, device=device)
    model = trainer._build_model(fold_idx)
    load_model(results_dir / f"s_{fold_idx}_checkpoint.npz", model)

    split = load_fold_split(results_dir / f"splits_{fold_idx}.csv", dataset.case_ids)
    indices = list(split.test_idx)
    if max_cases is not None:
        indices = indices[:max_cases]

    save_dir = Path(save_dir) if save_dir else results_dir / "svd_features"
    save_dir.mkdir(parents=True, exist_ok=True)
    out = save_dir / f"fold_{fold_idx}_features.npz"
    dump_alignment_features(model, dataset, indices, out)
    return out


def main(argv=None):
    args = build_parser().parse_args(argv)
    dump = dump_svd_features_from_results(
        args.results_dir, args.csv_path, args.data_root_dir,
        fold_idx=args.fold_idx, save_dir=args.save_dir, max_cases=args.max_cases,
        device=args.device,
    )
    print(f"dumped {dump}")
    outputs = [dump]
    if args.plots:
        from multimodal_fusion_tpu_torch.utils.visualization import (
            plot_alignment_heatmap,
            plot_modality_tsne,
        )

        hm = plot_alignment_heatmap(dump, dump.parent / f"fold_{args.fold_idx}_heatmap")
        ts = plot_modality_tsne(dump, dump.parent / f"fold_{args.fold_idx}_tsne")
        for o in (hm, ts):
            if o is not None:
                print(f"plotted {o}")
                outputs.append(o)
    return outputs


script_main = console_script(__name__)


if __name__ == "__main__":
    main()

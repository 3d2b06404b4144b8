"""Survival training CLI of the PyTorch port (counterpart of
``multimodal_fusion_tpu.cli.main_survival``).

The JAX CLI's flags, names, defaults and result files (itself a
flag-for-flag mirror of the reference's ``downstream_survival/
main.py:781-1001``), plus ``--device`` (default: the CUDA card)::

    python -m multimodal_fusion_tpu_torch.cli.main_survival \\
        --csv_path D/dataset.csv --data_root_dir D --results_dir D/results \\
        --model_type svd_gate_random_clam --enable_svd --k 5 --device cpu

Writes ``<results_dir>/<exp_code>_<stamp>/``: ``configs_<exp_code>.json``,
per fold ``splits_<fold>.csv``, ``s_<fold>_checkpoint.npz`` and the fold
logs, then ``summary.csv`` and ``detailed_results_for_plotting.json``.  The
port's ``cli.predict`` and ``cli.serve`` score that directory.

Per-channel input dims are probed from the first case up front (static
shapes replace the reference's lazily created transfer layers).
``--tpu_opts`` keeps its name: a JSON dict merged into the experiment
config (``device_data``, ``remat``, ``mesh_shape``, ...).  With a
``mesh_shape`` the CLI trains data parallel over the ranks of a launch::

    torchrun --nproc_per_node 2 -m multimodal_fusion_tpu_torch.cli.main_survival \
        ... --tpu_opts '{"mesh_shape": {"data": 2}}'

and rank 0 writes the results directory.  An alignment model
(``--alignment_model_path``, from ``cli.run_alignment``) aligns the
``--aligned_channels`` at load time into ``aligned_<channel>`` features;
a path that does not exist is ignored, as the JAX CLI ignores it.
"""

from __future__ import annotations

import argparse
import csv
import json
import time
from pathlib import Path
from typing import Dict, List

import numpy as np
import torch

from multimodal_fusion_tpu_torch.cli import console_script
from multimodal_fusion_tpu_torch.channels import parse_channels
from multimodal_fusion_tpu_torch.config import Configs, ExperimentConfig, ModelConfig
from multimodal_fusion_tpu_torch.data.splits import create_k_fold_splits
from multimodal_fusion_tpu_torch.models.base import derive_used_modalities
from multimodal_fusion_tpu_torch.parallel.mesh import broadcast, mesh_from_shape
from multimodal_fusion_tpu_torch.utils.seeding import seed_everything


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Multimodal survival status prediction")
    # data
    p.add_argument("--data_root_dir", type=str, default=None)
    p.add_argument("--results_dir", default="./results")
    p.add_argument("--csv_path", type=str, default="dataset_csv/survival_status_labels.csv")
    p.add_argument("--alignment_model_path", type=str, default=None)
    p.add_argument("--target_channels", type=str, nargs="+",
                   default=["cd3", "cd8", "cd56", "cd68", "cd163", "he", "mhc1", "pdl1"])
    p.add_argument("--aligned_channels", type=str, nargs="*", default=None)
    # experiment
    p.add_argument("--exp_code", type=str, default="exp")
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--start_k_fold", type=int, default=0)
    p.add_argument("--k", type=int, default=10)
    p.add_argument("--split_mode", type=str, choices=["random", "fixed"], default="random")
    p.add_argument("--dataset_split_path", type=str, default=None)
    p.add_argument("--max_epochs", type=int, default=200)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--reg", type=float, default=1e-5)
    p.add_argument("--opt", type=str, choices=["adam", "sgd"], default="adam")
    p.add_argument("--early_stopping", action="store_true", default=False)
    p.add_argument("--batch_size", type=int, default=64)
    p.add_argument("--lr_scheduler", type=str,
                   choices=["none", "cosine", "cosine_warm_restart", "step", "plateau", "exponential"],
                   default="none")
    p.add_argument("--lr_scheduler_params", type=str, default="{}")
    # model
    p.add_argument("--model_type", type=str, default="clam")
    p.add_argument("--input_dim", type=int, default=1024)
    p.add_argument("--dropout", type=float, default=0.25)
    p.add_argument("--n_classes", type=int, default=2)
    p.add_argument("--base_loss_fn", type=str, choices=["svm", "ce"], default="ce")
    # clam
    p.add_argument("--gate", action="store_true", default=True)
    p.add_argument("--base_weight", type=float, default=0.7)
    p.add_argument("--inst_loss_fn", type=str, choices=["svm", "ce"], default=None)
    p.add_argument("--model_size", type=str, default="small")
    p.add_argument("--subtyping", action="store_true", default=False)
    p.add_argument("--inst_number", type=int, default=8)
    p.add_argument("--channels_used_in_model", type=str, nargs="+",
                   default=["wsi", "tma", "clinical", "pathological", "blood", "icd", "tma_cell_density"])
    p.add_argument("--return_features", action="store_true", default=False)
    p.add_argument("--attention_only", action="store_true", default=False)
    p.add_argument("--output_dim", type=int, default=128)
    # svd
    p.add_argument("--enable_svd", action="store_true", default=False)
    p.add_argument("--alignment_layer_num", type=int, default=2)
    p.add_argument("--lambda1", type=float, default=1.0)
    p.add_argument("--lambda2", type=float, default=0.0)
    p.add_argument("--tau1", type=float, default=0.1)
    p.add_argument("--tau2", type=float, default=0.05)
    p.add_argument("--loss2_chunk_size", type=int, default=None)
    p.add_argument("--return_svd_features", action="store_true", default=False)
    # clip
    p.add_argument("--enable_clip", action="store_true", default=False)
    p.add_argument("--clip_init_tau", type=float, default=0.07)
    # gate
    p.add_argument("--enable_dynamic_gate", action="store_true", default=False)
    p.add_argument("--confidence_weight", type=float, default=1.0)
    p.add_argument("--feature_weight_weight", type=float, default=1.0)
    # auc
    p.add_argument("--auc_loss_weight", type=float, default=1.0)
    # random loss
    p.add_argument("--enable_random_loss", action="store_true", default=False)
    p.add_argument("--weight_random_loss", type=float, default=0.1)
    # attention / mfmf
    p.add_argument("--attention_num_heads", type=int, default=8)
    p.add_argument(
        "--fusion_blocks_sequence", type=str,
        default='[{"q": "other", "kv": "tma"}, {"q": "result", "kv": "wsi"}, {"q": "reconstruct", "kv": "result"}]',
    )
    p.add_argument("--attention_dropout", type=float, default=0.0)
    # auto/pallas: K3/K4 on CUDA tensors, their plain versions on the CPU
    p.add_argument("--attention_impl", type=str, default="auto",
                   choices=["auto", "xla", "pallas", "pallas_interpret"])
    # pooling
    p.add_argument("--pooling_strategy", type=str, choices=["mean", "max", "sum"], default="mean")
    # execution options, a JSON dict merged into ExperimentConfig, e.g.
    # --tpu_opts '{"device_data": false, "remat": true}'
    p.add_argument("--tpu_opts", type=str, default="{}")
    p.add_argument("--device", type=str, default=None,
                   help="torch device; default: the CUDA card (cpu runs on the host)")
    return p


def infer_channel_input_dims(dataset, channels: List[str]) -> Dict[str, int]:
    """Probe static tabular channel dims from the first case."""
    used = derive_used_modalities(channels)
    if not dataset.case_ids:
        return {}
    raw, _ = dataset.get_case(dataset.case_ids[0])
    dims = {}
    for ch in used:
        if ch in ("wsi=features", "tma=features"):
            continue
        if ch in raw:
            dims[ch] = int(raw[ch].shape[-1])
    return dims


def args_to_configs(args, channel_input_dims: Dict[str, int]) -> Configs:
    mc = ModelConfig(
        model_type=args.model_type,
        n_classes=args.n_classes,
        input_dim=args.input_dim,
        model_size=args.model_size,
        dropout=args.dropout,
        gate=args.gate,
        inst_number=args.inst_number,
        subtyping=args.subtyping,
        base_weight=args.base_weight,
        output_dim=args.output_dim,
        base_loss_fn=args.base_loss_fn,
        inst_loss_fn=args.inst_loss_fn,
        channels_used_in_model=args.channels_used_in_model,
        channel_input_dims=channel_input_dims,
        enable_svd=args.enable_svd,
        enable_dynamic_gate=args.enable_dynamic_gate,
        enable_random_loss=args.enable_random_loss,
        weight_random_loss=args.weight_random_loss,
        alignment_layer_num=args.alignment_layer_num,
        tau1=args.tau1,
        tau2=args.tau2,
        lambda1=args.lambda1,
        lambda2=args.lambda2,
        loss2_chunk_size=args.loss2_chunk_size,
        return_svd_features=args.return_svd_features,
        clip_tau=args.clip_init_tau,
        confidence_weight=args.confidence_weight,
        fusion_blocks_sequence=json.loads(args.fusion_blocks_sequence),
        num_heads=args.attention_num_heads,
    )
    mc.extra.update(
        enable_clip=args.enable_clip,
        clip_init_tau=args.clip_init_tau,
        feature_weight_weight=args.feature_weight_weight,
        auc_loss_weight=args.auc_loss_weight,
        pooling_strategy=args.pooling_strategy,
        attention_num_heads=args.attention_num_heads,
        attention_dropout=args.attention_dropout,
        attention_impl=args.attention_impl,
        return_features=args.return_features,
        attention_only=args.attention_only,
    )
    ec = ExperimentConfig(
        exp_name=args.exp_code or "exp",
        seed=args.seed,
        k_folds=args.k,
        split_mode=args.split_mode,
        fixed_split_path=args.dataset_split_path,
        max_epochs=args.max_epochs,
        batch_size=args.batch_size,
        lr=args.lr,
        optimizer=args.opt,
        weight_decay=args.reg,
        scheduler=None if args.lr_scheduler == "none" else args.lr_scheduler,
        scheduler_params=json.loads(args.lr_scheduler_params),
        early_stopping=args.early_stopping,
        target_channels=args.target_channels,
        aligned_channels=args.aligned_channels or [],
        alignment_model_path=args.alignment_model_path,
        results_dir=args.results_dir,
    )
    # the channel -> modality mapping itself persists (results_io rebuilds
    # the dataset from the config alone)
    if getattr(args, "_aligned_map", None):
        ec.extra["aligned_channels_map"] = dict(args._aligned_map)
    for k, v in json.loads(args.tpu_opts).items():
        if hasattr(ec, k):
            setattr(ec, k, v)
        else:
            ec.extra[k] = v
    return Configs(experiment_config=ec, model_config=mc)


def parse_args(argv=None) -> argparse.Namespace:
    """The parsed flags with the channel lists expanded (``parse_channels``)
    and ``--aligned_channels`` resolved: identity (``cd3``) or an explicit
    ``channel:modality`` mapping with a colon, kept as ``args._aligned_map``."""
    args = build_parser().parse_args(argv)
    args.target_channels = parse_channels([c.lower() for c in args.target_channels])
    aligned_map = {}
    if args.aligned_channels:
        plain = []
        for item in args.aligned_channels:
            if ":" in item:
                ch, mod = item.split(":", 1)
                aligned_map[parse_channels([ch.lower()])[0]] = mod
            else:
                plain.append(item)
        for ch in parse_channels(plain) if plain else []:
            aligned_map[ch] = ch
        args.aligned_channels = list(aligned_map)
    args._aligned_map = aligned_map
    args.channels_used_in_model = parse_channels(
        [c.lower() if "=" not in c else c for c in args.channels_used_in_model]
    )
    return args


def run(args: argparse.Namespace, dataset) -> Path:
    """Everything after the dataset is built: the configs JSON, the k-fold
    splits, ``train_fold`` over folds ``start_k_fold..k-1``, then
    ``summary.csv`` and ``detailed_results_for_plotting.json``.  ``dataset``
    is any object with the dataset's interface (``case_ids``, ``labels``,
    ``case_to_patient``, ``get_case``, ``has_survival_time``).  Returns the
    results directory."""
    from multimodal_fusion_tpu_torch.train.survival import SurvivalTrainer

    channel_dims = infer_channel_input_dims(dataset, args.channels_used_in_model)
    configs = args_to_configs(args, channel_dims)

    # under a mesh_shape (torchrun), every rank names the directory from
    # rank 0's clock, and rank 0 alone writes the files
    mesh = mesh_from_shape(configs.experiment_config.mesh_shape, args.device)
    now = broadcast(mesh, torch.tensor(int(time.time()), dtype=torch.int64))
    stamp = time.strftime("%Y%m%d_%H%M%S", time.localtime(int(now)))
    log_dir = Path(args.results_dir) / f"{args.exp_code}_{stamp}"
    log_dir.mkdir(parents=True, exist_ok=True)
    is_main = mesh is None or mesh.is_main
    if is_main:
        configs.save(log_dir / f"configs_{args.exp_code}.json")

    splits = create_k_fold_splits(
        dataset.labels,
        args.k,
        args.seed,
        patient_ids=[dataset.case_to_patient[c] for c in dataset.case_ids],
        fixed_split_path=args.dataset_split_path if args.split_mode == "fixed" else None,
    )
    trainer = SurvivalTrainer(configs, log_dir, device=args.device, mesh=mesh)
    summaries = [trainer.train_fold(dataset, splits[fold_idx], fold_idx)
                 for fold_idx in range(args.start_k_fold, args.k)]
    if not is_main:
        return log_dir

    with open(log_dir / "summary.csv", "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=["fold", "val_auc", "val_acc", "test_auc", "test_acc"])
        w.writeheader()
        for s in summaries:
            w.writerow({k: s[k] for k in w.fieldnames})
    detailed = {
        "folds": [
            {k: s[k] for k in ("fold", "val_auc", "val_acc", "test_auc", "test_acc")}
            for s in summaries
        ],
        "mean_test_auc": float(np.nanmean([s["test_auc"] for s in summaries])),
        "mean_test_acc": float(np.mean([s["test_acc"] for s in summaries])),
    }
    (log_dir / "detailed_results_for_plotting.json").write_text(json.dumps(detailed, indent=2))
    return log_dir


def main(argv=None) -> Path:
    from multimodal_fusion_tpu_torch.data.multimodal import MultimodalDataset
    from multimodal_fusion_tpu_torch.device import resolve_device

    args = parse_args(argv)
    resolve_device(args.device)  # no card without --device cpu: fail before reading data
    seed_everything(args.seed)
    align_fn = align_channels = None
    if args.alignment_model_path and Path(args.alignment_model_path).exists():
        from multimodal_fusion_tpu_torch.utils.results_io import load_alignment_model

        align_channels = dict(args._aligned_map)
        align_fn = load_alignment_model(args.alignment_model_path, align_channels, args.device)
    dataset = MultimodalDataset(args.csv_path, args.data_root_dir or ".", channels=args.target_channels,
                                align_channels=align_channels, alignment_apply_fn=align_fn)
    return run(args, dataset)


script_main = console_script(__name__)


if __name__ == "__main__":
    main()

"""Alignment pretraining CLI of the PyTorch port (counterpart of
``multimodal_fusion_tpu.cli.run_alignment``; reference
``alignment/run.py:31-228``).

The JAX CLI's flags and defaults, plus ``--device`` (default: the CUDA
card)::

    python -m multimodal_fusion_tpu_torch.cli.run_alignment --base_dir NPZ_DIR \
        --loss_type volume --num_layers 2 --batch_size 512 --device cpu

Fixed 8 markers at feature dim 1024 by default; builds the aligned-with-
negatives dataset, an 8:1:1 shuffled split by full tuple key (the JAX CLI's
membership for a seed), trains, and writes ``<save_path>`` (the best
checkpoint, at a validation), ``<save_path>.history.json`` (losses, SVD
values, config) and ``<save_path>.scalars.csv``.  ``--scan_steps`` keeps
the JAX CLI's meaning (the steps run one by one).  ``--mesh_data`` and
``--mesh_replica`` train data parallel over the ranks of a launch
(``train.alignment``; rank 0 writes the files)::

    torchrun --nproc_per_node 2 -m multimodal_fusion_tpu_torch.cli.run_alignment \
        --base_dir NPZ_DIR --mesh_data 2
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from multimodal_fusion_tpu_torch.cli import console_script
from multimodal_fusion_tpu_torch.channels import TMA_MARKERS
from multimodal_fusion_tpu_torch.data.alignment import TMANpzAlignedWithNegDataset
from multimodal_fusion_tpu_torch.models.alignment import MultiModalAlignmentModel
from multimodal_fusion_tpu_torch.parallel.mesh import rank_device
from multimodal_fusion_tpu_torch.train.alignment import MultiModalAlignmentTrainer


def build_parser():
    p = argparse.ArgumentParser(description="Cross-modal alignment pretraining")
    p.add_argument("--base_dir", type=str, required=True, help="directory of per-marker NPZ files")
    p.add_argument("--filename_template", type=str, default="tma_uni_tile_1024_{marker}.npz")
    p.add_argument("--markers", type=str, nargs="+", default=list(TMA_MARKERS))
    p.add_argument("--feature_dim", type=int, default=1024)
    p.add_argument("--num_layers", type=int, default=1)  # reference run.py:65
    p.add_argument("--align_mode", type=str, choices=["intersection", "union"], default="intersection")
    # reference default is "volume" (run.py:68-69; its name for rank1 is "svd")
    p.add_argument("--loss_type", type=str, choices=["rank1", "volume"], default="volume")
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--weight_decay", type=float, default=1e-5)
    p.add_argument("--tau1", type=float, default=0.1)
    p.add_argument("--tau2", type=float, default=0.1)
    p.add_argument("--lambda1", type=float, default=1.0)
    p.add_argument("--lambda2", type=float, default=0.1)
    p.add_argument("--loss2_chunk_size", type=int, default=None)
    p.add_argument("--svd_impl", type=str, choices=["gram", "svd"], default="gram",
                   help="rank-1 factor computation: 'gram' (M x M Gram eigh, "
                        "the default) or 'svd' (direct economy SVD)")
    p.add_argument("--mismatch_ratio", type=float, default=1.0)
    # defaults mirror the reference run.py (max_steps 100000, batch 128,
    # val every 500 steps) — a no-flag run must train like the reference's
    p.add_argument("--max_steps", type=int, default=100000)
    p.add_argument("--batch_size", type=int, default=128)
    p.add_argument("--val_interval", type=int, default=500)
    p.add_argument("--val_max_batches", type=int, default=None)
    p.add_argument("--save_interval", type=int, default=None)
    p.add_argument("--early_stopping_patience", type=int, default=10)
    p.add_argument("--early_stopping_min_delta", type=float, default=1e-4)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--save_path", type=str, default="alignment_model.npz")
    p.add_argument("--verbose", action="store_true", default=False)
    p.add_argument("--scan_steps", type=int, default=8,
                   help="accepted; the steps run one by one (the JAX package fuses "
                        "S of them into one dispatch with identical numerics)")
    p.add_argument("--device_data", action="store_true", default=None,
                   help="force the training view device-resident (default: "
                        "auto — on whenever it fits the device-memory budget)")
    p.add_argument("--no_device_data", dest="device_data", action="store_false",
                   help="force the host collate path")
    p.add_argument("--mesh_data", type=int, default=0,
                   help="shard each batch over N devices (not ported yet: raises)")
    p.add_argument("--mesh_replica", type=int, default=0,
                   help="outer replica axis for multi-slice/DCN meshes")
    p.add_argument("--scalar_log", type=str, default=None,
                   help="live per-val-interval scalar CSV (default: "
                        "<save_path>.scalars.csv; 'none' disables)")
    p.add_argument("--device", type=str, default=None,
                   help="torch device (default: the CUDA card; 'cpu' to run on the CPU)")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    # no card without --device cpu: fail before reading data; under a
    # launcher each rank takes its own card
    dev = rank_device(args.device)
    dataset = TMANpzAlignedWithNegDataset(
        args.base_dir,
        args.markers,
        filename_template=args.filename_template,
        align_mode=args.align_mode,
        mismatch_ratio=args.mismatch_ratio,
        seed=args.seed,
    )
    # 8:1:1 shuffled split by full tuple key, the reference's membership
    # for a given seed: RandomState (MT19937) index shuffle (reference
    # run.py:117-127)
    keys = list(dataset.normalized_keys)
    idx = np.arange(len(keys))
    np.random.RandomState(args.seed).shuffle(idx)
    keys = [keys[i] for i in idx]
    n = len(keys)
    n_train, n_val = int(n * 0.8), int(n * 0.1)
    groups = {
        "train": keys[:n_train],
        "val": keys[n_train : n_train + n_val],
        "test": keys[n_train + n_val :],
    }
    views = dataset.split_by_ids_with_neg(groups, id_type="tuple", seed=args.seed)

    model = MultiModalAlignmentModel(
        args.markers, feature_dim=args.feature_dim, num_layers=args.num_layers,
        generator=torch.Generator(device=dev).manual_seed(args.seed),
    )
    trainer = MultiModalAlignmentTrainer(
        model,
        learning_rate=args.lr,
        weight_decay=args.weight_decay,
        loss_type=args.loss_type,
        tau1=args.tau1,
        tau2=args.tau2,
        lambda1=args.lambda1,
        lambda2=args.lambda2,
        loss2_chunk_size=args.loss2_chunk_size,
        svd_impl=args.svd_impl,
        val_max_batches=args.val_max_batches,
        early_stopping_patience=args.early_stopping_patience,
        early_stopping_min_delta=args.early_stopping_min_delta,
        scan_steps=args.scan_steps,
        mesh_shape=(
            {"replica": args.mesh_replica, "data": args.mesh_data}
            if args.mesh_data > 1 or args.mesh_replica > 1
            else None
        ),
        scalar_log_path=(
            f"{args.save_path}.scalars.csv"
            if args.scalar_log is None
            else (None if args.scalar_log.lower() == "none" else args.scalar_log)
        ),
    )
    out = trainer.train(
        views["train"],
        views["val"],
        max_steps=args.max_steps,
        batch_size=args.batch_size,
        val_interval=args.val_interval,
        save_path=args.save_path,
        save_interval=args.save_interval,
        seed=args.seed,
        verbose=args.verbose,
        device_data="auto" if args.device_data is None else args.device_data,
    )
    trainer.save_history(f"{args.save_path}.history.json", config=vars(args))
    return out


script_main = console_script(__name__)


if __name__ == "__main__":
    main()

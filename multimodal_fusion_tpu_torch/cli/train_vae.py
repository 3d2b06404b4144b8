"""VAE training CLI of the PyTorch port (counterpart of
``multimodal_fusion_tpu.cli.train_vae``; reference ``vae/train.py:340-651``).

The JAX CLI's flags and defaults, plus ``--device`` (default: the CUDA
card)::

    python -m multimodal_fusion_tpu_torch.cli.train_vae --csv_path D/dataset.csv \
        --data_root_dir D --batch_size 1024 --lr 1e-4 --device cpu

Writes ``<checkpoint_dir>/{latest,best}.npz`` with their histories,
``scalars.csv`` and TensorBoard event files under ``tb/``.
``--scan_steps`` keeps the JAX CLI's meaning (the steps run one by one).
``--mesh_data`` and ``--mesh_replica`` train data parallel over the ranks
of a launch (``train.vae``; rank 0 writes the files)::

    torchrun --nproc_per_node 2 -m multimodal_fusion_tpu_torch.cli.train_vae \
        --csv_path D/dataset.csv --data_root_dir D --mesh_data 2
"""

from __future__ import annotations

import argparse

import torch

from multimodal_fusion_tpu_torch.data.vae_patches import WSIVAEDataset, split_train_val
from multimodal_fusion_tpu_torch.models.vae import VAE
from multimodal_fusion_tpu_torch.parallel.mesh import rank_device
from multimodal_fusion_tpu_torch.train.vae import VAETrainer


def build_parser():
    p = argparse.ArgumentParser(description="WSI patch-embedding VAE training")
    p.add_argument("--csv_path", type=str, required=True)
    p.add_argument("--data_root_dir", type=str, required=True)
    p.add_argument("--label_filter", type=str, default="living")
    p.add_argument("--input_dim", type=int, default=1024)
    p.add_argument("--hidden_dims", type=int, nargs="+", default=[512, 256])
    p.add_argument("--latent_dim", type=int, default=128)
    p.add_argument("--epochs", type=int, default=100)
    p.add_argument("--batch_size", type=int, default=256)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--weight_decay", type=float, default=1e-5)
    p.add_argument("--plateau_patience", type=int, default=10)
    p.add_argument("--use_all_data", action="store_true", default=False)
    p.add_argument("--checkpoint_dir", type=str, default="./vae_checkpoints")
    p.add_argument("--resume", action="store_true", default=False)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--verbose", action="store_true", default=False)
    p.add_argument("--scan_steps", type=int, default=8,
                   help="accepted; the steps run one by one (the JAX package fuses "
                        "S of them into one dispatch with identical numerics)")
    p.add_argument("--device_data", action="store_true", default=None,
                   help="force the patch subsample device-resident (default: "
                        "auto — on whenever it fits the device-memory budget)")
    p.add_argument("--no_device_data", dest="device_data", action="store_false",
                   help="force the host batch path")
    p.add_argument("--mesh_data", type=int, default=0,
                   help="shard each batch over N devices (not ported yet: raises)")
    p.add_argument("--mesh_replica", type=int, default=0,
                   help="outer replica axis for multi-slice/DCN meshes")
    p.add_argument("--scalar_log", type=str, default=None,
                   help="live per-epoch scalar CSV (default: "
                        "<checkpoint_dir>/scalars.csv; 'none' disables)")
    p.add_argument("--log_dir", type=str, default=None,
                   help="TensorBoard event-file dir (reference vae/train.py "
                        "log_dir; default: <checkpoint_dir>/tb; 'none' "
                        "disables)")
    p.add_argument("--device", type=str, default=None,
                   help="torch device (default: the CUDA card; 'cpu' to run on the CPU)")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    # no card without --device cpu: fail before reading data; under a
    # launcher each rank takes its own card
    dev = rank_device(args.device)
    ds = WSIVAEDataset(
        args.csv_path, args.data_root_dir, label_filter=args.label_filter,
        use_all_data=args.use_all_data, seed=args.seed,
    )
    # disjoint 80/20 split at patch level (reference vae/train.py:414-417
    # random_split)
    train, val = split_train_val(ds, val_frac=0.2, seed=args.seed)
    model = VAE(
        input_dim=args.input_dim,
        encoder_hidden=args.hidden_dims,
        decoder_hidden=list(reversed(args.hidden_dims)),
        latent_dim=args.latent_dim,
        generator=torch.Generator(device=dev).manual_seed(args.seed),
    )
    mesh_shape = None
    if args.mesh_data > 1 or args.mesh_replica > 1:
        mesh_shape = {"replica": args.mesh_replica, "data": args.mesh_data}
    scalar_log = args.scalar_log
    if scalar_log is None:
        scalar_log = f"{args.checkpoint_dir}/scalars.csv"
    elif scalar_log.lower() == "none":
        scalar_log = None
    tb_dir = args.log_dir
    if tb_dir is None:
        tb_dir = f"{args.checkpoint_dir}/tb"
    elif tb_dir.lower() == "none":
        tb_dir = None
    trainer = VAETrainer(
        model,
        learning_rate=args.lr,
        weight_decay=args.weight_decay,
        plateau_patience=args.plateau_patience,
        checkpoint_dir=args.checkpoint_dir,
        scan_steps=args.scan_steps,
        mesh_shape=mesh_shape,
        scalar_log_path=scalar_log,
        tb_log_dir=tb_dir,
    )
    if args.resume:
        trainer.resume("latest")
    return trainer.fit(
        train, val, epochs=args.epochs, batch_size=args.batch_size,
        seed=args.seed, verbose=args.verbose,
        device_data="auto" if args.device_data is None else args.device_data,
    )


if __name__ == "__main__":
    main()

"""Reconstructed-feature writer CLI of the PyTorch port (counterpart of
``multimodal_fusion_tpu.cli.generate_reconstructed_wsi``; reference
``vae/generate_reconstructed_wsi.py:26-274``).

The JAX CLI's flags plus ``--device`` (default: the CUDA card)::

    python -m multimodal_fusion_tpu_torch.cli.generate_reconstructed_wsi \
        --csv_path D/dataset.csv --data_root_dir D --checkpoint CKPT/best.npz --device cpu

Writes gzip ``wsi/reconstructed_features`` into every case's h5, which the
survival models read as ``wsi=reconstructed_features``.
"""

from __future__ import annotations

import argparse

import torch

from multimodal_fusion_tpu_torch.device import resolve_device
from multimodal_fusion_tpu_torch.models.vae import VAE
from multimodal_fusion_tpu_torch.train.checkpoint import load_model, load_state
from multimodal_fusion_tpu_torch.train.vae import generate_reconstructed_wsi


def build_parser():
    p = argparse.ArgumentParser(description="Write wsi/reconstructed_features from a trained VAE")
    p.add_argument("--csv_path", type=str, required=True)
    p.add_argument("--data_root_dir", type=str, required=True)
    p.add_argument("--checkpoint", type=str, required=True, help="best.npz from VAETrainer")
    p.add_argument("--input_dim", type=int, default=1024)
    p.add_argument("--hidden_dims", type=int, nargs="+", default=[512, 256])
    p.add_argument("--latent_dim", type=int, default=128)
    p.add_argument("--batch_size", type=int, default=256)
    p.add_argument("--device", type=str, default=None,
                   help="torch device (default: the CUDA card; 'cpu' to run on the CPU)")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    dev = resolve_device(args.device)
    model = VAE(
        input_dim=args.input_dim,
        encoder_hidden=args.hidden_dims,
        decoder_hidden=list(reversed(args.hidden_dims)),
        latent_dim=args.latent_dim,
        generator=torch.Generator(device=dev).manual_seed(0),
    )
    try:  # a VAETrainer checkpoint ({"model": ..., "opt": ...})
        restored, _ = load_state(args.checkpoint, {"model": model.state_dict()})
        model.load_state_dict(restored["model"])
    except KeyError:  # a plain save_model file
        load_model(args.checkpoint, model)
    done = generate_reconstructed_wsi(
        model, args.csv_path, args.data_root_dir, batch_size=args.batch_size
    )
    print(f"reconstructed {len(done)} files")
    return done


if __name__ == "__main__":
    main()

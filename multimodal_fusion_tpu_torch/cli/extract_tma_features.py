"""TMA feature-extraction CLI of the port (counterpart of
``multimodal_fusion_tpu.cli.extract_tma_features``; reference:
``alignment/tma_feature_extraction/extract_tma_features_uni.py:322-438``).

Walks ``<input_dir>/<marker>/*.png``, patches each core (256/stride 128,
optional white filter), extracts CLS features with ``--model``'s encoder
and writes them keyed by core stem: UNI's ViT-L/16 (``uni``, the default)
to ``tma_uni_tile_1024_<marker>.npz``, UNI2-h (``uni2_h``) to
``tma_uni2h_tile_1536_<marker>.npz``.

    python -m multimodal_fusion_tpu_torch.cli.extract_tma_features \
        --input_dir CORES --output_dir OUT [--model uni2_h] [--device cpu]

Pretrained weights load from the model's timm state dict converted to
numpy via ``--weights``; without weights the encoder runs from a seeded
random init.
Runs on the CUDA card unless ``--device cpu`` is given.  PIL is imported
inside ``main`` only, to decode the PNGs.  ``--mesh_data N`` shards each
batch over the N ranks of a launch (every rank decodes the cores, rank 0
writes the npz files)::

    torchrun --nproc_per_node 2 -m multimodal_fusion_tpu_torch.cli.extract_tma_features \
        --input_dir CORES --output_dir OUT --mesh_data 2
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np
import torch

from multimodal_fusion_tpu_torch.cli import console_script
from multimodal_fusion_tpu_torch.channels import TMA_MARKERS
from multimodal_fusion_tpu_torch.data.tma_extraction import (
    extract_marker_features,
    make_feature_extractor,
    save_marker_npz,
)
from multimodal_fusion_tpu_torch.device import resolve_device
from multimodal_fusion_tpu_torch.parallel.mesh import barrier, make_mesh
from multimodal_fusion_tpu_torch.models.vit import (
    load_timm_vit_weights,
    vit_large_16,
    vit_uni2_h,
)

# --model -> (its builder, the output file of a marker, named by the model
# and its width); the builders are looked up when called, so a test can
# swap the module's ``vit_large_16`` / ``vit_uni2_h`` for a smaller model
MODELS = {"uni": (lambda g: vit_large_16(g), "tma_uni_tile_1024_{marker}.npz"),
          "uni2_h": (lambda g: vit_uni2_h(g), "tma_uni2h_tile_1536_{marker}.npz")}


def build_parser():
    p = argparse.ArgumentParser(description="Extract TMA core features to per-marker NPZ")
    p.add_argument("--input_dir", type=str, required=True,
                   help="directory with <marker>/ subdirs of core PNGs")
    p.add_argument("--output_dir", type=str, required=True)
    p.add_argument("--markers", type=str, nargs="+", default=list(TMA_MARKERS))
    p.add_argument("--model", type=str, choices=sorted(MODELS), default="uni",
                   help="uni: UNI's ViT-L/16; uni2_h: UNI2-h (1536-d ViT/14, SwiGLU, registers)")
    p.add_argument("--weights", type=str, default=None,
                   help="npz of the model's timm state dict (converted offline)")
    p.add_argument("--patch_size", type=int, default=256)
    p.add_argument("--stride", type=int, default=128)
    p.add_argument("--white_threshold", type=float, default=None)
    p.add_argument("--min_content_ratio", type=float, default=None)
    p.add_argument("--batch_size", type=int, default=32)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--compute_dtype", type=str, choices=["float32", "bfloat16"],
                   default="float32",
                   help="bfloat16 runs the ViT in bf16 (features stay f32)")
    p.add_argument("--mesh_data", type=int, default=None,
                   help="shard each batch over the N ranks of a launch (torchrun)")
    p.add_argument("--device", type=str, default=None,
                   help="torch device; default: the CUDA card (cpu runs on the host)")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    mesh = None
    if args.mesh_data and args.mesh_data > 1:
        mesh = make_mesh(args.mesh_data, device=args.device)
    from PIL import Image

    dev = resolve_device(args.device) if mesh is None else mesh.device
    build, output_name = MODELS[args.model]
    model = build(torch.Generator(device=dev).manual_seed(args.seed))
    if args.weights:
        state = dict(np.load(args.weights))
        n = load_timm_vit_weights(model, state)
        print(f"loaded {n} weight tensors")
    extractor = make_feature_extractor(
        model, args.batch_size, compute_dtype=args.compute_dtype, mesh=mesh, device=dev
    )
    is_main = mesh is None or mesh.is_main

    out_dir = Path(args.output_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    written = {}
    for marker in args.markers:
        # our flat layout and the reference's data tree
        # (tma_tumorcenter_<MARKER>); a missing dir warns like the reference
        candidates = [
            Path(args.input_dir) / marker,
            Path(args.input_dir) / f"tma_tumorcenter_{marker.upper()}",
            Path(args.input_dir) / f"tma_tumorcenter_{marker}",
        ]
        marker_dir = next((d for d in candidates if d.exists()), None)
        if marker_dir is None:
            print(f"WARNING: no directory for marker {marker!r} "
                  f"(tried {[str(c) for c in candidates]})")
            continue

        def stream(marker_dir=marker_dir):
            # decode one core at a time
            for img_path in sorted(marker_dir.glob("*.png")):
                img = Image.open(img_path)
                if img.mode != "RGB":
                    img = img.convert("RGB")
                yield img_path.stem, np.asarray(img)

        feats = extract_marker_features(
            stream(), extractor, args.patch_size, args.stride,
            args.white_threshold, args.min_content_ratio,
        )
        out_path = out_dir / output_name.format(marker=marker)
        if is_main:
            save_marker_npz(out_path, feats)
            print(f"{marker}: {len(feats)} cores -> {out_path}")
        written[marker] = len(feats)
    barrier(mesh)
    return written


script_main = console_script(__name__)


if __name__ == "__main__":
    main()

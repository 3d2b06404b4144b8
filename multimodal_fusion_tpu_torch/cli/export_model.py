"""Export a trained checkpoint as a ``torch.export`` serving artifact
(counterpart of ``multimodal_fusion_tpu.cli.export_model``; see
``utils/export.py``): a survival fold (probabilities and risk), an
alignment model (aligned features) or a VAE (deterministic reconstruction
and mean latent), one program per platform (default ``cpu`` and
``cuda``)::

    python -m multimodal_fusion_tpu_torch.cli.export_model \\
        --results_dir runs/exp1 --fold 0 --output_path art/exp1 --platforms cpu
"""

from __future__ import annotations

import argparse
import json

from multimodal_fusion_tpu_torch.cli import console_script
from multimodal_fusion_tpu_torch.utils.export import (
    PLATFORMS,
    export_alignment_fn,
    export_serving_fn,
    export_vae_fn,
    program_path,
    write_serving_artifact,
)


def build_parser():
    p = argparse.ArgumentParser(
        description="Export a trained checkpoint as a self-contained torch.export serving "
        "artifact: a survival fold (probabilities + risk), an alignment model (aligned "
        "features) or a VAE (deterministic reconstruction + mean latent)"
    )
    p.add_argument("--kind", type=str, default="survival",
                   choices=["survival", "alignment", "vae"])
    p.add_argument("--results_dir", type=str, default=None,
                   help="trained survival results dir (kind=survival)")
    p.add_argument("--fold", type=int, default=0)
    p.add_argument("--wsi_patches", type=int, default=4096,
                   help="exported WSI bag size, kind=survival only (pad + mask shorter bags)")
    p.add_argument("--tma_patches", type=int, default=32,
                   help="exported TMA bag size (kind=survival only)")
    p.add_argument("--platforms", type=str, nargs="+", default=list(PLATFORMS),
                   help="one program each: cpu, cuda (the model on that device)")
    p.add_argument("--checkpoint_path", type=str, default=None,
                   help="explicit checkpoint .npz (required for kind=alignment/vae; optional "
                   "fold override for survival)")
    p.add_argument("--output_path", type=str, required=True,
                   help="prefix for <out>.<platform>.pt2 + <out>.json")
    p.add_argument("--fixed_batch", action="store_true", default=False,
                   help="export batch=1 instead of a symbolic batch axis")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    if args.kind == "survival":
        if not args.results_dir:
            raise SystemExit("--results_dir is required for --kind survival")
        programs, meta = export_serving_fn(
            args.results_dir, fold=args.fold, wsi_patches=args.wsi_patches,
            tma_patches=args.tma_patches, platforms=args.platforms,
            checkpoint_path=args.checkpoint_path, symbolic_batch=not args.fixed_batch,
        )
    else:
        ckpt = args.checkpoint_path
        if not ckpt and args.kind == "alignment" and args.results_dir:
            # a trained results dir whose config names the persisted
            # alignment model (the one predict and serve load)
            from multimodal_fusion_tpu_torch.utils.results_io import load_configs

            ckpt = load_configs(args.results_dir).experiment_config.get("alignment_model_path",
                                                                        None)
            if not ckpt:
                raise SystemExit(f"{args.results_dir} names no alignment_model_path in its "
                                 "config — pass --checkpoint_path explicitly")
        if not ckpt:
            raise SystemExit(f"--checkpoint_path (or, for alignment, --results_dir) is required "
                             f"for --kind {args.kind}")
        fn = export_alignment_fn if args.kind == "alignment" else export_vae_fn
        programs, meta = fn(ckpt, platforms=args.platforms, symbolic_batch=not args.fixed_batch)
    out = write_serving_artifact(args.output_path, programs, meta)
    nbytes = sum(program_path(out, p).stat().st_size for p in meta["platforms"])
    print(json.dumps({"artifact": str(out), "bytes": nbytes, "batch": meta["batch"],
                      "platforms": meta["platforms"]}))
    return out


script_main = console_script(__name__)


if __name__ == "__main__":
    main()

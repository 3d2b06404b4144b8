"""Hypergraph preprocessing CLI of the PyTorch port.

Same flags as ``multimodal_fusion_tpu.cli.preprocess_hypergraph`` plus
``--device`` (default ``cuda``)::

    python -m multimodal_fusion_tpu_torch.cli.preprocess_hypergraph \\
        --csv_path D/dataset.csv --data_root_dir D --no_save_similarity

``--cache_similarity`` writes the similarity caches into built files,
``--rebuild`` re-tunes built files from them (``--threshold_median_ratio``
drops the weaker edges).  ``--mesh_data N`` shards each slide's patch axis
over the N ranks of a launch (N larger than the world fails as the JAX
package's ``make_mesh`` does; rank 0 writes the groups)::

    torchrun --nproc_per_node 2 -m multimodal_fusion_tpu_torch.cli.preprocess_hypergraph \
        --csv_path D/dataset.csv --data_root_dir D --no_save_similarity --mesh_data 2
"""

from __future__ import annotations

import argparse
import json

from multimodal_fusion_tpu_torch.cli import console_script
from multimodal_fusion_tpu_torch.hypergraph.build import (
    batch_cache_similarity,
    batch_rebuild_hypergraph,
    process_dataset,
)
from multimodal_fusion_tpu_torch.parallel.mesh import make_mesh


def build_parser():
    p = argparse.ArgumentParser(description="Build WSI+TMA hypergraphs into patient h5 files")
    p.add_argument("--csv_path", type=str, required=True)
    p.add_argument("--data_root_dir", type=str, required=True)
    p.add_argument("--num_wsi_super_patches", type=int, default=100)
    p.add_argument("--num_groups", type=int, default=10)
    p.add_argument("--hypergraph_k", type=int, default=5)
    p.add_argument("--num_hyperedges", type=int, default=10)
    p.add_argument("--lambda_h", type=float, default=1.0)
    p.add_argument("--lambda_g", type=float, default=1.0)
    p.add_argument("--output_stats_path", type=str, default=None)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--no_save_similarity", action="store_true", default=False)
    p.add_argument("--file_batch", type=int, default=1)
    p.add_argument("--bucket_patches", type=int, default=None)
    p.add_argument("--cache_similarity", action="store_true", default=False)
    p.add_argument("--rebuild", action="store_true", default=False)
    p.add_argument("--threshold_median_ratio", type=float, default=None)
    p.add_argument("--mesh_data", type=int, default=None)
    p.add_argument("--upload_dtype", type=str, default="float32",
                   choices=["float32", "bfloat16"])
    p.add_argument("--skip_existing", action="store_true", default=False)
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device of the build (cuda, cuda:N or cpu)")
    return p


def main(argv=None):
    parser = build_parser()
    args = parser.parse_args(argv)
    if args.cache_similarity:
        out = batch_cache_similarity(
            args.csv_path, args.data_root_dir,
            lambda_h=args.lambda_h, lambda_g=args.lambda_g, device=args.device,
        )
        print(f"cached similarity for {len(out)} files")
        return out
    if args.rebuild:
        out = batch_rebuild_hypergraph(
            args.csv_path,
            args.data_root_dir,
            num_wsi_super_patches=args.num_wsi_super_patches,
            num_groups=args.num_groups,
            hypergraph_k=args.hypergraph_k,
            num_hyperedges=args.num_hyperedges,
            threshold_median_ratio=args.threshold_median_ratio,
            seed=args.seed,
            device=args.device,
        )
        print(f"rebuilt {len(out)} files")
        return out
    mesh = None
    if (args.mesh_data or 0) > 1:
        mesh = make_mesh(args.mesh_data, device=args.device)
    stats, summary = process_dataset(
        args.csv_path,
        args.data_root_dir,
        num_wsi_super_patches=args.num_wsi_super_patches,
        num_groups=args.num_groups,
        hypergraph_k=args.hypergraph_k,
        num_hyperedges=args.num_hyperedges,
        lambda_h=args.lambda_h,
        lambda_g=args.lambda_g,
        output_stats_path=args.output_stats_path,
        seed=args.seed,
        save_similarity=not args.no_save_similarity,
        file_batch=args.file_batch,
        bucket_patches=args.bucket_patches,
        upload_dtype=args.upload_dtype,
        skip_existing=args.skip_existing,
        device=args.device,
        mesh=mesh,
    )
    if mesh is None or mesh.is_main:
        print(json.dumps(summary))
    return stats


script_main = console_script(__name__)


if __name__ == "__main__":
    main()

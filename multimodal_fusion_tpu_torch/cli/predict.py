"""Scoring CLI of the PyTorch port: score new cases with a trained survival
results dir (``configs_*.json`` and ``s_<fold>_checkpoint.npz``).

Same flags as ``multimodal_fusion_tpu.cli.predict`` plus ``--device``
(default: the CUDA card)::

    python -m multimodal_fusion_tpu_torch.cli.predict \\
        --results_dir runs/exp1 --csv_path new_cases.csv --data_root_dir /data

See ``utils/predict.py``.
"""

from __future__ import annotations

import argparse
import json

from multimodal_fusion_tpu_torch.utils.predict import predict


def build_parser():
    p = argparse.ArgumentParser(
        description="Score cases in a CSV with trained fold checkpoints "
        "(label column optional; folds ensembled by mean probability)"
    )
    p.add_argument("--results_dir", type=str, required=True,
                   help="trained run dir containing configs_*.json and s_<fold>_checkpoint.npz")
    p.add_argument("--csv_path", type=str, required=True)
    p.add_argument("--data_root_dir", type=str, required=True)
    p.add_argument("--folds", type=int, nargs="*", default=None,
                   help="fold checkpoints to ensemble (default: all present)")
    p.add_argument("--output_path", type=str, default=None,
                   help="prefix for predictions.csv/.json (default: <results_dir>/predictions)")
    p.add_argument("--drop_prob", type=float, default=None,
                   help="optional inference-time modality dropout")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", type=str, default=None,
                   help="torch device; default: the CUDA card (cpu runs on the host)")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    res = predict(
        args.results_dir, args.csv_path, args.data_root_dir,
        folds=args.folds or None, output_path=args.output_path,
        drop_prob=args.drop_prob, seed=args.seed, device=args.device,
    )
    print(json.dumps({"n_cases_scored": res["n_cases_scored"], "folds": res["folds"]}))
    return res


if __name__ == "__main__":
    main()

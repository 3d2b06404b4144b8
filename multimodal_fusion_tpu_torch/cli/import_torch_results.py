"""Migrate a reference (torch) survival results dir into the port
(counterpart of ``multimodal_fusion_tpu.cli.import_torch_results``).

Converts every ``s_<fold>_checkpoint.pt`` of a reference results dir into
the port's ``s_<fold>_checkpoint.npz`` (``train.checkpoint.save_model``'s
layout, which the trainer, ``predict``, ``serve``, the robustness sweep and
the exporter read) through ``utils/torch_import.py``, and copies
``configs_<exp>.json`` and ``splits_<fold>.csv``.  A ``.pt`` alignment
model named by the config's ``alignment_model_path`` is converted too, and
the copied config points at the result.  Same flags as the JAX CLI plus
``--device`` (default: the CUDA card)::

    python -m multimodal_fusion_tpu_torch.cli.import_torch_results \\
        --src_dir REF_RESULTS --out_dir PORT_RESULTS
"""

from __future__ import annotations

import argparse
import json
import shutil
from pathlib import Path

from multimodal_fusion_tpu_torch.cli import console_script
from multimodal_fusion_tpu_torch.models.factory import ModelFactory
from multimodal_fusion_tpu_torch.train.checkpoint import save_model
from multimodal_fusion_tpu_torch.utils.results_io import load_configs
from multimodal_fusion_tpu_torch.utils.torch_import import (
    convert_alignment_checkpoint,
    import_survival_checkpoint,
)


def import_results_dir(src_dir: str | Path, out_dir: str | Path, device=None) -> dict:
    """Convert ``src_dir`` into ``out_dir``; the fold models are built on
    ``device`` (default: the CUDA card).  Returns {"folds", "out_dir",
    "unmapped_keys" (fold -> unused checkpoint keys), "alignment_model"}."""
    src_dir, out_dir = Path(src_dir), Path(out_dir)
    configs = load_configs(src_dir)
    cfg_files = sorted(src_dir.glob("configs_*.json"))
    out_dir.mkdir(parents=True, exist_ok=True)
    cfg_out = out_dir / cfg_files[0].name
    shutil.copy2(cfg_files[0], cfg_out)
    for extra in src_dir.glob("splits_*.csv"):  # keep the persisted splits
        shutil.copy2(extra, out_dir / extra.name)

    # a torch alignment checkpoint named by the config converts too (the
    # downstream tools refuse a missing or unreadable alignment model)
    align_path = configs.experiment_config.get("alignment_model_path", None)
    converted_alignment = None
    if align_path:
        src_align = Path(align_path)
        if not src_align.is_absolute():
            src_align = src_dir / src_align
        if src_align.exists() and src_align.suffix in (".pt", ".pth"):
            converted_alignment = convert_alignment_checkpoint(src_align,
                                                               out_dir / "alignment_model.npz")
            raw = json.loads(cfg_out.read_text())
            raw["experiment_config"]["alignment_model_path"] = str(converted_alignment)
            cfg_out.write_text(json.dumps(raw, indent=2, sort_keys=True))
        elif not src_align.exists():
            print(f"WARNING: alignment_model_path {align_path!r} not found next to the results "
                  "dir; downstream tools will refuse to run until the checkpoint is supplied or "
                  "the path cleared")

    converted, leftovers = [], {}
    for ckpt in sorted(src_dir.glob("s_*_checkpoint.pt")):
        fold = int(ckpt.stem.split("_")[1])
        model = ModelFactory.create_model(configs.model_config, seed=configs.experiment_config.seed,
                                          device=device)
        leftover = import_survival_checkpoint(model, ckpt)
        save_model(out_dir / f"s_{fold}_checkpoint.npz", model)
        converted.append(fold)
        if leftover:
            leftovers[fold] = leftover
    if not converted:
        raise FileNotFoundError(f"no s_<fold>_checkpoint.pt in {src_dir}")
    return {
        "folds": converted,
        "out_dir": str(out_dir),
        "unmapped_keys": leftovers,
        "alignment_model": str(converted_alignment) if converted_alignment else None,
    }


def build_parser():
    p = argparse.ArgumentParser(
        description="Convert a reference torch results dir (configs + s_<fold>_checkpoint.pt) "
        "into the port's npz checkpoints"
    )
    p.add_argument("--src_dir", type=str, required=True)
    p.add_argument("--out_dir", type=str, required=True)
    p.add_argument("--device", type=str, default=None,
                   help="torch device; default: the CUDA card (cpu runs on the host)")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    res = import_results_dir(args.src_dir, args.out_dir, device=args.device)
    print(json.dumps(res))
    return res


script_main = console_script(__name__)


if __name__ == "__main__":
    main()

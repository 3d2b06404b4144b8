"""Bootstrap for tools that read a trained survival results dir
(counterpart of ``multimodal_fusion_tpu.utils.results_io``).

``utils.predict`` and ``utils.serve`` start from the layout the trainer
writes (reference ``downstream_survival/trainer.py:741-745``):
``configs_<exp>.json`` and per-fold ``s_<fold>_checkpoint.npz``.  The
persisted alignment model that a config may name (``exp.alignment_model_path``,
applied at load time) is ROADMAP Queue 1 item 14: :func:`load_alignment`
raises for such a config instead of scoring raw features.
"""

from __future__ import annotations

from pathlib import Path
from typing import List, Optional, Tuple

from multimodal_fusion_tpu_torch.config import Configs
from multimodal_fusion_tpu_torch.data.multimodal import MultimodalDataset


def load_configs(results_dir: str | Path) -> Configs:
    results_dir = Path(results_dir)
    cfg_files = sorted(results_dir.glob("configs_*.json"))
    if not cfg_files:
        raise FileNotFoundError(f"no configs_*.json in {results_dir}")
    return Configs.load(cfg_files[0])


def discover_folds(results_dir: str | Path) -> List[int]:
    return [int(p.stem.split("_")[1]) for p in sorted(Path(results_dir).glob("s_*_checkpoint.npz"))]


def load_alignment(configs: Configs):
    """``(None, None)`` for a config that names no alignment model; a
    config that names one raises (alignment models are ROADMAP Queue 1
    item 14), as does one whose file is missing."""
    model_path = configs.experiment_config.get("alignment_model_path", None)
    if model_path and not Path(model_path).exists():
        raise FileNotFoundError(
            f"config names alignment_model_path={model_path!r} but the file does not exist on "
            "this host — copy the alignment checkpoint or clear the path in configs_*.json"
        )
    if model_path:
        raise NotImplementedError("alignment models are not ported yet: ROADMAP Queue 1 item 14")
    return None, None


def build_dataset(configs: Configs, csv_path, data_root_dir, align=None) -> MultimodalDataset:
    """Dataset over ``csv_path`` with the target channels training used.
    ``align`` is :func:`load_alignment`'s pair, checked once by a caller
    that builds many datasets (it is ``(None, None)`` until alignment
    models are ported)."""
    if align is None:
        load_alignment(configs)
    return MultimodalDataset(csv_path, data_root_dir,
                             channels=configs.experiment_config.target_channels)


def load_results_context(
    results_dir: str | Path,
    csv_path,
    data_root_dir,
    folds: Optional[List[int]] = None,
    device=None,
) -> Tuple[Configs, MultimodalDataset, "object", List[int]]:
    """(configs, dataset, trainer, folds) for a trained results dir; the
    trainer runs on ``device`` (default: the CUDA card)."""
    from multimodal_fusion_tpu_torch.train.survival import SurvivalTrainer

    results_dir = Path(results_dir)
    configs = load_configs(results_dir)
    dataset = build_dataset(configs, csv_path, data_root_dir)
    trainer = SurvivalTrainer(configs, results_dir, device=device)
    if folds is None:
        folds = discover_folds(results_dir)
    if not folds:
        raise FileNotFoundError(f"no s_<fold>_checkpoint.npz in {results_dir}")
    return configs, dataset, trainer, list(folds)

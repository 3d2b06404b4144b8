"""Bootstrap for tools that read a trained survival results dir
(counterpart of ``multimodal_fusion_tpu.utils.results_io``).

``utils.predict`` and ``utils.serve`` start from the layout the trainer
writes (reference ``downstream_survival/trainer.py:741-745``):
``configs_<exp>.json`` and per-fold ``s_<fold>_checkpoint.npz``, plus the
persisted alignment model a config may name (``exp.alignment_model_path``
and ``exp.aligned_channels``, applied at load time as
``cli/main_survival.py`` applies it during training).
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, List, Optional, Tuple

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


def load_alignment_model(model_path, align_channels: Dict[str, str], device=None):
    """An ``alignment_apply_fn`` over the checkpoint at ``model_path``: a
    MultiModalAlignmentModel over the sorted modalities of
    ``align_channels`` (channel -> modality), with the depth and width the
    checkpoint holds, on ``device`` (default: the CUDA card)."""
    import torch

    from multimodal_fusion_tpu_torch.device import resolve_device
    from multimodal_fusion_tpu_torch.models.alignment import (
        MultiModalAlignmentModel,
        infer_alignment_arch,
    )
    from multimodal_fusion_tpu_torch.train.alignment import make_alignment_apply_fn
    from multimodal_fusion_tpu_torch.train.checkpoint import load_model

    dev = resolve_device(device)
    num_layers, feature_dim = infer_alignment_arch(model_path)
    model = MultiModalAlignmentModel(sorted(align_channels.values()), feature_dim=feature_dim,
                                     num_layers=num_layers,
                                     generator=torch.Generator(device=dev).manual_seed(0))
    load_model(model_path, model)
    return make_alignment_apply_fn(model)


def load_alignment(configs: Configs, device=None):
    """(alignment_apply_fn, align_channels_map) for the alignment model the
    config names, or ``(None, None)``; the model runs on ``device``
    (default: the CUDA card).  Split out of :func:`build_dataset` so a
    long-lived server loads the checkpoint once instead of per request."""
    exp = configs.experiment_config
    model_path = exp.get("alignment_model_path", None)
    if model_path and not Path(model_path).exists():
        # a named but missing alignment model is a hard error: scoring raw
        # features instead would be garbage
        raise FileNotFoundError(
            f"config names alignment_model_path={model_path!r} but the file does not exist on "
            "this host — copy the alignment checkpoint or clear the path in configs_*.json"
        )
    if not model_path:
        return None, None
    # the persisted channel -> modality map when present (colon-form
    # mappings); identity over the key list otherwise
    align_channels = dict(exp.get("aligned_channels_map", None)
                          or {c: c for c in (exp.get("aligned_channels", None) or [])})
    return load_alignment_model(model_path, align_channels, device), align_channels


def build_dataset(configs: Configs, csv_path, data_root_dir, align=None,
                  device=None) -> MultimodalDataset:
    """Dataset over ``csv_path`` as training built it: the same target
    channels and the persisted alignment model (when the config names one)
    producing ``aligned_<channel>`` features at load time.  Pass a loaded
    ``align=(align_fn, align_channels)`` pair (:func:`load_alignment`) to
    skip re-reading the checkpoint; otherwise it is loaded on ``device``."""
    align_fn, align_channels = align if align is not None else load_alignment(configs, device)
    return MultimodalDataset(csv_path, data_root_dir,
                             channels=configs.experiment_config.target_channels,
                             align_channels=align_channels, alignment_apply_fn=align_fn)


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
    dataset = build_dataset(configs, csv_path, data_root_dir, device=device)
    trainer = SurvivalTrainer(configs, results_dir, device=device)
    if folds is None:
        folds = discover_folds(results_dir)
    if not folds:
        raise FileNotFoundError(f"no s_<fold>_checkpoint.npz in {results_dir}")
    return configs, dataset, trainer, list(folds)

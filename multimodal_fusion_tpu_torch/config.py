"""Configuration (counterpart of ``multimodal_fusion_tpu.config``).

The reference composes a nested dict ``{"experiment_config": {...},
"model_config": {...}}`` from ~50 argparse flags and persists it as
``configs_<exp>.json`` (reference: ``downstream_survival/main.py:950-988``).
The port keeps the JAX package's typed views and the same JSON shape, so a
``configs_*.json`` written by either package loads in the other.  Static
model shapes are derived up front (``channel_input_dims``).  The
experiment fields that name TPU execution (``mesh_shape``, ``remat``,
``scan_windows``, ``device_data``) keep their names; the port's trainer
says which of them it runs.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

# CLAM hidden-size table (reference: downstream_survival/models/clam_mlp.py:73-83).
MODEL_SIZE_DICT = {
    "small": (512, 256),
    "big": (512, 384),
    "128*64": (128, 64),
    "64*32": (64, 32),
    "32*16": (32, 16),
    "16*8": (16, 8),
    "8*4": (8, 4),
    "4*2": (4, 2),
    "2*1": (2, 1),
}


def model_size_dims(input_dim: int, model_size: str) -> Tuple[int, int, int]:
    """Return (input_dim, hidden1, hidden2) for a CLAM model-size key."""
    if model_size not in MODEL_SIZE_DICT:
        raise ValueError(
            f"Unsupported model size: {model_size!r}; "
            f"supported: {sorted(MODEL_SIZE_DICT)}"
        )
    h1, h2 = MODEL_SIZE_DICT[model_size]
    return (input_dim, h1, h2)


@dataclass
class ModelConfig:
    """Model configuration — a typed view over the reference's model_config dict."""

    model_type: str = "svd_gate_random_clam"
    n_classes: int = 2
    input_dim: int = 1024
    model_size: str = "64*32"
    dropout: float = 0.25
    gate: bool = True
    inst_number: int = 8
    subtyping: bool = False
    base_weight: float = 0.7
    output_dim: int = 1024
    base_loss_fn: str = "ce"
    inst_loss_fn: str = "ce"
    channels_used_in_model: List[str] = field(default_factory=list)
    # Static per-channel input dims for tabular transfer layers.  The reference
    # creates these lazily from runtime shapes; we require them up front so that
    # every parameter exists at init (checkpoint-friendly, jit-friendly).
    channel_input_dims: Dict[str, int] = field(default_factory=dict)

    # SVD / alignment family
    enable_svd: bool = True
    enable_dynamic_gate: bool = True
    enable_random_loss: bool = True
    weight_random_loss: float = 0.1
    alignment_layer_num: int = 2
    alignment_channels: Optional[List[str]] = None
    tau1: float = 0.1
    tau2: float = 0.1
    lambda1: float = 1.0
    lambda2: float = 0.1
    loss2_chunk_size: Optional[int] = None
    return_svd_features: bool = False

    # CLIP family
    clip_tau: float = 0.07

    # gate MIL family
    confidence_weight: float = 1.0

    # AUC family
    auc_margin: float = 1.0
    auc_weight: float = 1.0

    # mfmf
    fusion_blocks_sequence: Optional[List[Dict[str, Any]]] = None
    num_heads: int = 4

    # hypergraph fusion (CustOmics)
    hypergraph_hidden_dim: int = 256
    hypergraph_num_layers: int = 2

    extra: Dict[str, Any] = field(default_factory=dict)

    def to_dict(self) -> Dict[str, Any]:
        d = dataclasses.asdict(self)
        d.update(d.pop("extra"))
        return d

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "ModelConfig":
        known = {f.name for f in dataclasses.fields(cls)} - {"extra"}
        kw = {k: v for k, v in d.items() if k in known}
        extra = {k: v for k, v in d.items() if k not in known}
        return cls(**kw, extra=extra)

    def get(self, key: str, default: Any = None) -> Any:
        if hasattr(self, key) and key != "extra":
            v = getattr(self, key)
            return default if v is None and default is not None else v
        return self.extra.get(key, default)


@dataclass
class ExperimentConfig:
    """Experiment configuration — k-fold training harness settings."""

    exp_name: str = "exp"
    seed: int = 42
    k_folds: int = 5
    split_mode: str = "random"  # 'random' | 'fixed'
    fixed_split_path: Optional[str] = None
    max_epochs: int = 200
    batch_size: int = 16  # gradient-accumulation window (cases per update)
    lr: float = 1e-4
    optimizer: str = "adam"  # 'adam' | 'sgd'
    weight_decay: float = 1e-5
    scheduler: Optional[str] = None  # step|cosine|cosine_warm_restart|plateau|exponential
    scheduler_params: Dict[str, Any] = field(default_factory=dict)
    early_stopping: bool = True
    # the reference TRAINER constructs EarlyStopping(patience=25,
    # stop_epoch=10) (trainer.py:700-707) — not the class defaults 20/50
    patience: int = 25
    min_epochs: int = 10
    monitor_metric: str = "auc"  # 'auc' | 'acc' | 'loss'
    monitor_mode: str = "max"  # 'max' | 'min'
    weighted_sampling: bool = True
    target_channels: List[str] = field(default_factory=list)
    aligned_channels: List[str] = field(default_factory=list)
    alignment_model_path: Optional[str] = None
    results_dir: str = "results"
    label_map: Optional[Dict[str, int]] = None
    # execution options (JAX package names)
    mesh_shape: Optional[Dict[str, int]] = None  # e.g. {"data": 8}
    dtype: str = "float32"
    # rematerialisation: recompute the window's forward in the backward pass
    # instead of keeping its activations (torch.utils.checkpoint)
    remat: bool = False
    # windows per device dispatch in the JAX package (lax.scan, numerics
    # equal to sequential steps); the port runs them one after another
    scan_windows: int = 8
    # keep the fold's cases resident in device memory (padded to one global
    # bucket per channel) so every window is a row gather on the device
    # instead of a host->device upload.  "auto" enables it whenever the
    # stacked tables fit DEVICE_DATA_AUTO_BUDGET; True forces it, False
    # opts out.
    device_data: Any = "auto"

    extra: Dict[str, Any] = field(default_factory=dict)

    def to_dict(self) -> Dict[str, Any]:
        d = dataclasses.asdict(self)
        d.update(d.pop("extra"))
        return d

    # The reference's configs_<exp>.json uses these key names
    # (main.py:950-973); loading one of its files must not silently fall
    # back to OUR defaults for optimizer/decay/folds/scheduler
    _REFERENCE_ALIASES = {
        "exp_code": "exp_name",
        "num_splits": "k_folds",
        "reg": "weight_decay",
        "opt": "optimizer",
        "dataset_split_path": "fixed_split_path",
    }

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "ExperimentConfig":
        d = dict(d)
        for src, dst in cls._REFERENCE_ALIASES.items():
            if src in d and dst not in d:
                d[dst] = d.pop(src)
        # reference scheduler_config = {"type": ..., **params}
        if "scheduler_config" in d and "scheduler" not in d:
            sc = dict(d.pop("scheduler_config") or {})
            d["scheduler"] = sc.pop("type", None)
            d.setdefault("scheduler_params", sc)
        known = {f.name for f in dataclasses.fields(cls)} - {"extra"}
        kw = {k: v for k, v in d.items() if k in known}
        extra = {k: v for k, v in d.items() if k not in known}
        return cls(**kw, extra=extra)

    def get(self, key: str, default: Any = None) -> Any:
        if hasattr(self, key) and key != "extra":
            v = getattr(self, key)
            return default if v is None and default is not None else v
        return self.extra.get(key, default)


@dataclass
class Configs:
    """Top-level config bundle; JSON-compatible with the reference's
    ``configs_<exp>.json`` ({"experiment_config": ..., "model_config": ...})."""

    experiment_config: ExperimentConfig = field(default_factory=ExperimentConfig)
    model_config: ModelConfig = field(default_factory=ModelConfig)

    def to_dict(self) -> Dict[str, Any]:
        return {
            "experiment_config": self.experiment_config.to_dict(),
            "model_config": self.model_config.to_dict(),
        }

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "Configs":
        return cls(
            experiment_config=ExperimentConfig.from_dict(d.get("experiment_config", {})),
            model_config=ModelConfig.from_dict(d.get("model_config", {})),
        )

    def save(self, path: str | Path) -> None:
        Path(path).write_text(json.dumps(self.to_dict(), indent=2, sort_keys=True))

    @classmethod
    def load(cls, path: str | Path) -> "Configs":
        return cls.from_dict(json.loads(Path(path).read_text()))

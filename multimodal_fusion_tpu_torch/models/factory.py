"""Model factory (counterpart of ``multimodal_fusion_tpu.models.factory``).

The registry carries the JAX package's keys.  ``mfmf``, MIL, CLAM,
AUC-CLAM, the ClamMLP trunk, the flagship svd_gate family and its Cox
variant are ported; every other key raises ``NotImplementedError`` naming
ROADMAP Queue 1 item 12 (the rest of the zoo), which ports it.
"""

from __future__ import annotations

from typing import Dict, Optional, Type, Union

import torch

from multimodal_fusion_tpu_torch.config import ModelConfig
from multimodal_fusion_tpu_torch.device import resolve_device
from multimodal_fusion_tpu_torch.models.auc_clam import AUCCLAM
from multimodal_fusion_tpu_torch.models.base import BaseModel
from multimodal_fusion_tpu_torch.models.clam import CLAM, MILFC
from multimodal_fusion_tpu_torch.models.clam_mlp import ClamMLP, ClamMLPDetach
from multimodal_fusion_tpu_torch.models.cox import CoxSVDGateClam
from multimodal_fusion_tpu_torch.models.mfmf import MFMF
from multimodal_fusion_tpu_torch.models.svd_gate import (
    ClipGateRandomClam,
    ClipGateRandomClamDetach,
    DeepSuperviseSVDGateRandomClam,
    DeepSuperviseSVDGateRandomClamDetach,
    SVDGateRandomClam,
    SVDGateRandomClamDetach,
)

_PORTED = {
    "mil": MILFC,
    "clam": CLAM,
    "auc_clam": AUCCLAM,
    "clam_mlp": ClamMLP,
    "clam_mlp_detach": ClamMLPDetach,
    "svd_gate_random_clam": SVDGateRandomClam,
    "svd_gate_random_clam_detach": SVDGateRandomClamDetach,
    "clip_gate_random_clam": ClipGateRandomClam,
    "clip_gate_random_clam_detach": ClipGateRandomClamDetach,
    "deep_supervise_svd_gate_random": DeepSuperviseSVDGateRandomClam,
    "deep_supervise_svd_gate_random_detach": DeepSuperviseSVDGateRandomClamDetach,
    "cox_svd_gate_random_clam": CoxSVDGateClam,
    "mfmf": MFMF,
}
_ITEM_12 = (
    "gate_shared_mil", "gate_mil", "gate_auc_mil", "gate_mil_detach",
    "svd_pool", "mdlm", "ps3", "fbp", "cust_omics", "svd_clam", "auto_connections",
)

# key -> model class, or the ROADMAP item that ports it
MODEL_REGISTRY: Dict[str, Union[Type[BaseModel], str]] = {
    **_PORTED,
    **{k: "ROADMAP Queue 1 item 12" for k in _ITEM_12},
}


class ModelFactory:
    @staticmethod
    def create_model(config, seed: int = 0, device: Optional[Union[str, torch.device]] = None
                     ) -> BaseModel:
        """Build a model from a ModelConfig (or raw dict) with weights drawn
        from a ``torch.Generator`` seeded with ``seed`` on ``device``
        (default: the CUDA card, through ``device.resolve_device``)."""
        if isinstance(config, dict):
            config = ModelConfig.from_dict(config)
        model_type = config.model_type
        if model_type not in MODEL_REGISTRY:
            raise ValueError(
                f"Unknown model type {model_type!r}; available: {sorted(MODEL_REGISTRY)}"
            )
        cls = MODEL_REGISTRY[model_type]
        if isinstance(cls, str):
            raise NotImplementedError(f"model {model_type!r} is not ported yet ({cls})")
        return cls(config, torch.Generator(device=resolve_device(device)).manual_seed(seed))

    @staticmethod
    def available_models():
        return sorted(MODEL_REGISTRY)


def create_model(config, seed: int = 0, device=None) -> BaseModel:
    return ModelFactory.create_model(config, seed, device)

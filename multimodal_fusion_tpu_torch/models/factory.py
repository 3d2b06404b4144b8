"""Model factory (counterpart of ``multimodal_fusion_tpu.models.factory``).

The registry carries the JAX package's 24 keys, every one ported: the
reference's 20, ``cust_omics`` (which the reference implements but leaves
unregistered), the repaired ``svd_clam`` and ``auto_connections``, and the
Cox head on the flagship trunk.  ``survival_params_from_jax`` (from
``models.jax_params``) carries a JAX model's weights into any of them but
``mfmf``.
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
from multimodal_fusion_tpu_torch.models.extras import SVDCLAM, UniversalConnections
from multimodal_fusion_tpu_torch.models.fbp import FBP
from multimodal_fusion_tpu_torch.models.gate_mil import GateAUCMIL, GateMIL, GateMILDetach, GateSharedMIL
from multimodal_fusion_tpu_torch.models.hypergraph_fusion import CustOmics
from multimodal_fusion_tpu_torch.models.jax_params import survival_params_from_jax  # noqa: F401
from multimodal_fusion_tpu_torch.models.mfmf import MFMF
from multimodal_fusion_tpu_torch.models.pool_fusion import MDLM, SVDPool
from multimodal_fusion_tpu_torch.models.ps3 import PS3
from multimodal_fusion_tpu_torch.models.svd_gate import (
    ClipGateRandomClam,
    ClipGateRandomClamDetach,
    DeepSuperviseSVDGateRandomClam,
    DeepSuperviseSVDGateRandomClamDetach,
    SVDGateRandomClam,
    SVDGateRandomClamDetach,
)

MODEL_REGISTRY: Dict[str, Type[BaseModel]] = {
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
    "gate_shared_mil": GateSharedMIL,
    "gate_mil": GateMIL,
    "gate_auc_mil": GateAUCMIL,
    "gate_mil_detach": GateMILDetach,
    "svd_pool": SVDPool,
    "mdlm": MDLM,
    "ps3": PS3,
    "fbp": FBP,
    "mfmf": MFMF,
    "cust_omics": CustOmics,
    # dead code in the reference, repaired and registered by the JAX package
    "svd_clam": SVDCLAM,
    "auto_connections": UniversalConnections,
    "cox_svd_gate_random_clam": CoxSVDGateClam,
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
        return MODEL_REGISTRY[model_type](
            config, torch.Generator(device=resolve_device(device)).manual_seed(seed))

    @staticmethod
    def available_models():
        return sorted(MODEL_REGISTRY)


def create_model(config, seed: int = 0, device=None) -> BaseModel:
    return ModelFactory.create_model(config, seed, device)

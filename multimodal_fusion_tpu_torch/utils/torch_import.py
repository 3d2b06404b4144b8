"""Import trained reference (torch) checkpoints into the port's models
(counterpart of ``multimodal_fusion_tpu.utils.torch_import``).

Survival fold checkpoints (a raw ``state_dict``), VAE checkpoints and
alignment checkpoints (dicts with ``model_state_dict``, keys possibly
prefixed ``_orig_mod.`` by torch.compile) load into the port's models with
no reference model code: only the flat ``state_dict`` is read.

The port's parameters carry the reference ``state_dict`` names, so most of
the mapping is the identity.  The exception is a torch ``nn.Sequential``:
its children are numbered by position, activations and dropout included,
and the reference places those differently from model to model.  As in the
JAX importer, a Sequential's Linear entries pair positionally: the
checkpoint's index-sorted ``<prefix>.<i>.weight`` entries with the port's,
whatever the indices (a different count raises ``KeyError``).

What is imported follows the JAX importer exactly: the same model
families, the same parameters left at their initial values (AUCM's
``a``, ``b`` and ``alpha``, which the reference keeps in its loss object;
the modules that SVD-CLAM, CustOmics, UniversalConnections and the Cox
head add to the family the JAX importer maps them by), an optional bias
and ``clip_logit_scale``, and the sorted list of unused checkpoint keys
as the result.
"""

from __future__ import annotations

import re
from pathlib import Path
from typing import Dict, Iterable, List

import numpy as np
import torch

__all__ = [
    "load_torch_state_dict",
    "import_survival_checkpoint",
    "import_vae_checkpoint",
    "import_alignment_checkpoint",
    "convert_alignment_checkpoint",
]

# a parameter of a Sequential's numbered child: (prefix, index, leaf)
_NUMBERED = re.compile(r"^(.*)\.(\d+)\.(weight|bias)$")
# parameters the reference keeps outside the model's state_dict
_AUCM = ("auc_a", "auc_b", "auc_alpha")


def load_torch_state_dict(path_or_sd) -> Dict[str, np.ndarray]:
    """A reference checkpoint as {key: np.ndarray}: a path (``torch.load``
    on the CPU, tensors only) or an already-loaded mapping.  Unwraps the
    trainers' ``model_state_dict`` nesting and strips torch.compile's
    ``_orig_mod.`` prefixes."""
    if isinstance(path_or_sd, (str, Path)):
        obj = torch.load(path_or_sd, map_location="cpu", weights_only=True)
    else:
        obj = path_or_sd
    if isinstance(obj, dict) and "model_state_dict" in obj:
        obj = obj["model_state_dict"]
    out = {}
    for k, v in obj.items():
        k = k.removeprefix("_orig_mod.")
        out[k] = v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)
    return out


class _Importer:
    """Tracks which checkpoint keys were used; a missing key raises, so a
    partial import cannot pass silently."""

    def __init__(self, sd: Dict[str, np.ndarray]):
        self.sd = sd
        self.used: set = set()

    def take(self, key: str) -> np.ndarray:
        if key not in self.sd:
            raise KeyError(f"checkpoint is missing '{key}' — wrong model_type/config for this "
                           "checkpoint?")
        self.used.add(key)
        return self.sd[key]

    def linear_entries(self, prefix: str) -> List[int]:
        """Index-sorted Linear entries of the checkpoint's Sequential at
        ``prefix``: its direct children that hold a weight."""
        return sorted(int(m.group(2)) for k in self.sd
                      if (m := _NUMBERED.match(k)) and m.group(1) == prefix and m.group(3) == "weight")

    def load(self, module: torch.nn.Module, skip: Iterable[str] = ()) -> None:
        """Copy the checkpoint into ``module``'s parameters, but those whose
        names start with one of ``skip``; each Sequential's Linear entries
        pair positionally."""
        own = module.state_dict()
        entries: Dict[str, List[int]] = {}
        for name in own:
            m = _NUMBERED.match(name)
            if m and m.group(3) == "weight":
                entries.setdefault(m.group(1), []).append(int(m.group(2)))
        index = {}  # (prefix, the port's index) -> the checkpoint's
        for prefix, mine in entries.items():
            theirs = self.linear_entries(prefix)
            if len(theirs) != len(mine):
                raise KeyError(f"'{prefix}' has {len(theirs)} Linear entries, model expects "
                               f"{len(mine)}")
            index.update({(prefix, i): j for i, j in zip(sorted(mine), theirs)})
        new = {}
        for name, current in own.items():
            if name.startswith(tuple(skip)):
                continue
            m = _NUMBERED.match(name)
            key = name
            if m and (m.group(1), int(m.group(2))) in index:
                key = f"{m.group(1)}.{index[m.group(1), int(m.group(2))]}.{m.group(3)}"
            if key not in self.sd and (name.endswith(".bias") or name == "clip_logit_scale"):
                continue  # optional in the checkpoint: left at its initial value
            value = self.take(key)
            if tuple(value.shape) != tuple(current.shape):
                raise ValueError(f"shape mismatch for '{key}': checkpoint {tuple(value.shape)}, "
                                 f"model {tuple(current.shape)}")
            new[name] = torch.as_tensor(value)
        module.load_state_dict(new, strict=False)

    def leftover(self) -> List[str]:
        return sorted(k for k in self.sd if k not in self.used)


def _survival_skip(model) -> tuple:
    """Parameter prefixes ``import_survival_checkpoint`` leaves at their
    initial values for ``model``, as the JAX importer does; raises
    ``NotImplementedError`` for a model outside the families it maps."""
    from multimodal_fusion_tpu_torch.models.clam import CLAM, MILFC
    from multimodal_fusion_tpu_torch.models.clam_mlp import ClamMLP
    from multimodal_fusion_tpu_torch.models.cox import CoxSVDGateClam
    from multimodal_fusion_tpu_torch.models.extras import SVDCLAM, UniversalConnections
    from multimodal_fusion_tpu_torch.models.gate_mil import GateSharedMIL
    from multimodal_fusion_tpu_torch.models.hypergraph_fusion import CustOmics

    if not isinstance(model, (ClamMLP, CLAM, MILFC, GateSharedMIL)):
        raise NotImplementedError(
            f"torch-checkpoint import not implemented for {type(model).__name__}")
    # the JAX importer maps these by their base family (CLAM, ClamMLP, the
    # svd_gate family): the modules each adds keep their initial values
    added = {
        SVDCLAM: ("alignment_model.",),
        CustOmics: ("hypergraph_net.", "hypergraph_transfer.", "hypergraph_tma_transfer.",
                    "moe_gate.", "head."),
        UniversalConnections: ("q_gen.", "Wq.", "Wk.", "Wv.", "post_fc1.", "post_fc2."),
        CoxSVDGateClam: ("risk_head.", "risk_head_logits."),
    }
    return _AUCM + next((p for cls, p in added.items() if isinstance(model, cls)), ())


def import_survival_checkpoint(model, checkpoint) -> List[str]:
    """Copy a reference ``s_<fold>_checkpoint.pt`` (a path or a loaded
    mapping) into a port survival model built with the matching config;
    returns the sorted list of checkpoint keys it did not use."""
    skip = _survival_skip(model)
    imp = _Importer(load_torch_state_dict(checkpoint))
    imp.load(model, skip)
    return imp.leftover()


def import_vae_checkpoint(vae, checkpoint) -> List[str]:
    """A reference ``vae/train.py`` checkpoint into the port's ``VAE``."""
    imp = _Importer(load_torch_state_dict(checkpoint))
    imp.load(vae)
    return imp.leftover()


def import_alignment_checkpoint(model, checkpoint) -> List[str]:
    """A reference ``alignment/trainer.py`` checkpoint into the port's
    ``MultiModalAlignmentModel``; the match predictor only when the
    checkpoint holds one."""
    imp = _Importer(load_torch_state_dict(checkpoint))
    has_predictor = any(k.startswith("mlp_predictor.") for k in imp.sd)
    imp.load(model, () if has_predictor else ("mlp_predictor.",))
    return imp.leftover()


def convert_alignment_checkpoint(src_path, dst_path) -> Path:
    """Convert a reference alignment checkpoint into the port's npz
    (``train.checkpoint.save_model``), the markers, depth and width read
    from its keys; returns the path written."""
    from multimodal_fusion_tpu_torch.models.alignment import MultiModalAlignmentModel
    from multimodal_fusion_tpu_torch.train.checkpoint import save_model

    sd = load_torch_state_dict(src_path)
    pat = re.compile(r"alignment_layers\.([^.]+)\.(\d+)\.weight$")
    mods, depth, dim = set(), 0, None
    for k, v in sd.items():
        m = pat.match(k)
        if m:
            mods.add(m.group(1))
            depth = max(depth, int(m.group(2)) + 1)
            dim = int(v.shape[0])
    if not mods:
        raise ValueError(f"{src_path} has no alignment_layers keys")
    model = MultiModalAlignmentModel(sorted(mods), feature_dim=dim, num_layers=depth,
                                     generator=torch.Generator().manual_seed(0))
    import_alignment_checkpoint(model, sd)
    return save_model(dst_path, model)

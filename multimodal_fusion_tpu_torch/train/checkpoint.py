"""Checkpoint save/load: nested dicts of tensors <-> npz files (counterpart
of ``multimodal_fusion_tpu.train.checkpoint``).

A state is a nested dict whose leaves are tensors or arrays, e.g.
``{"params": model.state_dict()}``; keys flatten to ``a/b`` paths (a
state-dict name keeps its dots).  Static model shapes make load a plain
restore into a template of the same structure, with the shapes checked.
"""

from __future__ import annotations

from pathlib import Path
from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch


def _flatten(tree: Mapping, prefix: str = "") -> Dict[str, Any]:
    flat = {}
    for key, value in tree.items():
        path = f"{prefix}{key}"
        if isinstance(value, Mapping):
            flat.update(_flatten(value, path + "/"))
        else:
            flat[path] = value
    return flat


def _to_numpy(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _npz_path(path: str | Path) -> Path:
    """np.savez appends '.npz' to suffix-less paths; normalise so save and
    load agree on the on-disk name."""
    path = Path(path)
    if path.suffix != ".npz":
        path = path.with_name(path.name + ".npz")
    return path


def save_state(path: str | Path, state: Mapping, extra: Optional[Dict[str, Any]] = None) -> Path:
    """Save a nested dict of tensors/arrays plus optional scalar extras;
    returns the (.npz-normalised) path written."""
    path = _npz_path(path)
    flat = {k: _to_numpy(v) for k, v in _flatten(state).items()}
    for k, v in (extra or {}).items():
        flat[f"__extra__/{k}"] = np.asarray(v)
    path.parent.mkdir(parents=True, exist_ok=True)
    np.savez(path, **flat)
    return path


def load_state(path: str | Path, template: Mapping) -> Tuple[Dict, Dict[str, np.ndarray]]:
    """Restore arrays into the structure of ``template`` (same keys as
    saved).  Leaves come back as tensors on each template leaf's device and
    dtype (numpy arrays where the template holds arrays).  Returns
    (new_state, extras)."""
    path = Path(path)
    if not path.exists() and _npz_path(path).exists():
        path = _npz_path(path)
    with np.load(path, allow_pickle=False) as data:
        arrays = {k: data[k] for k in data.files}
    extras = {k[len("__extra__/"):]: v for k, v in arrays.items() if k.startswith("__extra__/")}

    def restore(tree: Mapping, prefix: str) -> Dict:
        out = {}
        for key, leaf in tree.items():
            name = f"{prefix}{key}"
            if isinstance(leaf, Mapping):
                out[key] = restore(leaf, name + "/")
                continue
            if name not in arrays:
                raise KeyError(f"checkpoint missing key {name}")
            arr = arrays[name]
            if tuple(arr.shape) != tuple(np.shape(leaf)):
                raise ValueError(f"shape mismatch for {name}: {arr.shape} vs {tuple(np.shape(leaf))}")
            if isinstance(leaf, torch.Tensor):
                out[key] = torch.as_tensor(arr).to(device=leaf.device, dtype=leaf.dtype)
            else:
                out[key] = arr
        return out

    return restore(template, ""), extras


def save_model(path: str | Path, model: torch.nn.Module,
               extra: Optional[Dict[str, Any]] = None) -> Path:
    return save_state(path, {"params": model.state_dict()}, extra)


def load_model(path: str | Path, model: torch.nn.Module) -> Dict[str, np.ndarray]:
    """Load a ``save_model`` checkpoint into ``model`` in place; returns
    the extras."""
    state, extras = load_state(path, {"params": model.state_dict()})
    model.load_state_dict(state["params"])
    return extras

"""Serving artifacts through ``torch.export`` (counterpart of
``multimodal_fusion_tpu.utils.export``).

A trained fold's eval forward — padded-bag channels and masks in, class
probabilities and risk out, the parameters inside the program — is
exported with ``torch.export`` so that a serving process runs it without
the model zoo or the trainer: ``load_serving_artifact(path).call(...)``.
The alignment model's apply pass and the VAE's deterministic
reconstruction export the same way.

The case axis is exported as a ``torch.export.Dim`` where possible, so one
program serves any window size; the patch axes are fixed at export time
(pad bags to the exported sizes and set the masks, as training does).

The JAX package writes one StableHLO blob for several platforms.  An
exported torch program holds its parameters on one device, so the port
exports once per platform (default ``cpu`` and ``cuda``), each with the
model on that device, and writes::

    <out>.<platform>.pt2   one program per platform (torch.export.save)
    <out>.json             the metadata, with the JAX package's keys

A load takes the program of the device asked for (the CUDA card unless
the caller asks for the CPU) and never another platform's.
"""

from __future__ import annotations

import json
import warnings
from pathlib import Path
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from multimodal_fusion_tpu_torch.device import resolve_device
from multimodal_fusion_tpu_torch.utils.tree import tree_map

PLATFORMS = ("cpu", "cuda")
Programs = Dict[str, "torch.export.ExportedProgram"]


def _channel_specs(model_cfg, wsi_patches: int, tma_patches: int, window: int, device):
    """Example inputs for every channel the model consumes, in the
    trainer's padded-window layout (``data/batching.py``): bag channels
    [B, N, D] float32 and a bool mask [B, N]; tabular channels [B, 1, dim]."""
    from multimodal_fusion_tpu_torch.channels import channel_group, is_mask_channel
    from multimodal_fusion_tpu_torch.data.batching import is_bag_channel

    D = model_cfg.input_dim
    dims = dict(model_cfg.channel_input_dims or {})
    used = list(model_cfg.channels_used_in_model)

    def width(ch):
        # a tabular mask is as wide as its group's values (the config holds
        # the values' width only; the JAX exporter gives the mask the input
        # width, which fails wherever the two differ)
        if is_mask_channel(ch):
            ch = next((c for c in used if channel_group(c) == channel_group(ch)
                       and not is_mask_channel(c)), ch)
        return dims.get(ch, D)

    channels, masks = {}, {}
    for ch in used:
        if ch.startswith("hypergraph="):
            # hypergraph node sets and incidences have model-specific padded
            # shapes that the bag / tabular layout does not cover
            raise NotImplementedError(
                f"export does not support hypergraph channels ({ch}); "
                "serve cust_omics/hypergraph models through cli.predict"
            )
        if is_bag_channel(ch):
            n = wsi_patches if ch.startswith("wsi") else tma_patches
            channels[ch] = torch.zeros((window, n, D), device=device)
            masks[ch] = torch.ones((window, n), dtype=torch.bool, device=device)
        else:
            channels[ch] = torch.zeros((window, 1, width(ch)), device=device)
    return channels, masks


class _SurvivalForward(torch.nn.Module):
    """The fold model's eval forward with a zero label (the forward reads
    the window's labels; the outputs do not depend on them):
    (probabilities [B, n_classes], risk [B])."""

    def __init__(self, model):
        super().__init__()
        self.model = model.eval()

    def forward(self, channels: Dict[str, torch.Tensor], masks: Dict[str, torch.Tensor]):
        first = next(iter(channels.values()))
        label = torch.zeros(first.shape[0], dtype=torch.int64, device=first.device)
        res = self.model({"channels": channels, "masks": masks}, label, train=False)
        # risk as the trainer's eval step takes it: the Cox head's output
        # when present, the positive-class logit otherwise
        risk = res["risk"] if "risk" in res else res["logits"][:, 1]
        return res["probabilities"], risk


class _Apply(torch.nn.Module):
    """``fn(model, x)`` as a module's forward, for export."""

    def __init__(self, model, fn: Callable):
        super().__init__()
        self.model = model.eval()
        self.fn = fn

    def forward(self, x):
        return self.fn(self.model, x)


def export_serving_fn(
    results_dir: str | Path,
    fold: int = 0,
    wsi_patches: int = 4096,
    tma_patches: int = 32,
    platforms: Sequence[str] = PLATFORMS,
    checkpoint_path: Optional[str | Path] = None,
    symbolic_batch: bool = True,
) -> Tuple[Programs, Dict]:
    """Export the fold's eval forward for each platform; returns
    ({platform: ExportedProgram}, metadata)."""
    from multimodal_fusion_tpu_torch.models.common import LayerNorm
    from multimodal_fusion_tpu_torch.models.factory import ModelFactory
    from multimodal_fusion_tpu_torch.train.checkpoint import load_model
    from multimodal_fusion_tpu_torch.utils.results_io import load_configs

    results_dir = Path(results_dir)
    configs = load_configs(results_dir)
    mc = configs.model_config
    path = Path(checkpoint_path or results_dir / f"s_{fold}_checkpoint.npz")

    def make(device):
        model = ModelFactory.create_model(mc, seed=configs.experiment_config.seed, device=device)
        # the kernels launch through ctypes (ops/_cuda.py), which
        # torch.export cannot trace: export the plain formulations, as the
        # JAX exporter forces XLA's over Pallas
        for blk in getattr(model, "attention_blocks", {}).values():
            blk.attn_impl = "xla"
        for norm in model.modules():
            if isinstance(norm, LayerNorm):  # MFMF's and PS3's, K5 on the card
                norm.impl = "plain"
        load_model(path, model)
        return _SurvivalForward(model)

    def specs(window, device):
        return _channel_specs(mc, wsi_patches, tma_patches, window, device)

    programs, batch = _export_with_symbolic_batch(make, specs, platforms, symbolic_batch)
    meta = {
        "model_type": mc.model_type,
        "fold": fold,
        "platforms": list(platforms),
        "batch": batch,
        "wsi_patches": wsi_patches,
        "tma_patches": tma_patches,
        "channels": list(mc.channels_used_in_model),
        "channel_input_dims": dict(mc.channel_input_dims or {}),
        "input_dim": mc.input_dim,
        "n_classes": mc.n_classes,
        "outputs": ["probabilities [B, n_classes]", "risk [B]"],
    }
    return programs, meta


def _export_with_symbolic_batch(make: Callable, specs: Callable, platforms: Sequence[str],
                                symbolic_batch: bool) -> Tuple[Programs, object]:
    """The shared export harness: ``make(device)`` builds the module on
    each platform's device, ``specs(batch, device)`` its example inputs
    (one tree, passed as the one argument, or a tuple of them).  Tries a
    symbolic case axis on every platform, and falls back to a fixed batch
    of 1 with a warning; returns (programs, "symbolic" or 1)."""
    modules = {p: make(resolve_device(p)) for p in platforms}

    def run(batch, dim):
        programs = {}
        for p, module in modules.items():
            spec = specs(batch, resolve_device(p))
            args = spec if isinstance(spec, tuple) else (spec,)
            # the case axis of every input is the one symbolic size
            shapes = None if dim is None else tree_map(lambda _: {0: dim}, args)
            programs[p] = torch.export.export(module, args, dynamic_shapes=shapes, strict=False)
            # the example inputs are zeros of a whole window (67 MB at
            # bench.py's inference cell), which torch.export.save would
            # write into the artifact
            programs[p].example_inputs = None
        return programs

    if symbolic_batch:
        try:
            # an example batch of 2: export specialises sizes 0 and 1
            return run(2, torch.export.Dim("b")), "symbolic"
        except Exception as e:  # noqa: BLE001 - any export failure takes the fixed batch
            warnings.warn(
                "symbolic-batch export failed; falling back to a FIXED batch=1 artifact "
                f"(callable only with batch 1): {e!r}",
                stacklevel=2,
            )
    return run(1, None), 1


def export_alignment_fn(
    checkpoint_path: str | Path,
    platforms: Sequence[str] = PLATFORMS,
    symbolic_batch: bool = True,
) -> Tuple[Programs, Dict]:
    """Export a trained alignment model's apply pass ({marker: [B, D]} ->
    {marker: [B, D]} aligned features), the preprocessing half of serving.
    The markers, depth and width are read from the checkpoint's keys."""
    from multimodal_fusion_tpu_torch.models.alignment import (
        MultiModalAlignmentModel,
        infer_alignment_arch,
        infer_alignment_markers,
    )
    from multimodal_fusion_tpu_torch.train.checkpoint import load_model

    with np.load(checkpoint_path, allow_pickle=False) as data:
        num_layers, feature_dim = infer_alignment_arch(checkpoint_path, data=data)
        markers = infer_alignment_markers(checkpoint_path, data=data)

    def make(device):
        model = MultiModalAlignmentModel(markers, feature_dim=feature_dim, num_layers=num_layers,
                                         generator=torch.Generator(device=device).manual_seed(0))
        load_model(checkpoint_path, model)
        return _Apply(model, lambda m, feats: m(feats))

    def specs(batch, device):
        return {m: torch.zeros((batch, feature_dim), device=device) for m in markers}

    programs, batch = _export_with_symbolic_batch(make, specs, platforms, symbolic_batch)
    meta = {
        "kind": "alignment",
        "markers": markers,
        "feature_dim": feature_dim,
        "num_layers": num_layers,
        "platforms": list(platforms),
        "batch": batch,
        "outputs": ["{marker: aligned [B, feature_dim]}"],
    }
    return programs, meta


def _reconstruct(model, x):
    """The VAE's deterministic reconstruction: decode the mean latent."""
    mu = model.encode(x)
    return model.decode(mu), mu


def export_vae_fn(
    checkpoint_path: str | Path,
    platforms: Sequence[str] = PLATFORMS,
    symbolic_batch: bool = True,
) -> Tuple[Programs, Dict]:
    """Export a trained VAE's deterministic reconstruction ([B, input_dim]
    -> (x_hat [B, input_dim], mu [B, latent_dim])), the mean-latent decode
    that ``generate_reconstructed_wsi`` writes.  The architecture is read
    from the checkpoint's keys; the checkpoint is a ``save_model`` file or
    a ``VAETrainer`` checkpoint."""
    from multimodal_fusion_tpu_torch.models.vae import VAE, infer_vae_arch
    from multimodal_fusion_tpu_torch.train.checkpoint import load_subtree

    input_dim, enc_hidden, dec_hidden, latent_dim = infer_vae_arch(checkpoint_path)
    with np.load(checkpoint_path, allow_pickle=False) as data:
        prefix = "model" if any(k.startswith("model/") for k in data.files) else "params"

    def make(device):
        model = VAE(input_dim=input_dim, encoder_hidden=enc_hidden, decoder_hidden=dec_hidden,
                    latent_dim=latent_dim, generator=torch.Generator(device=device).manual_seed(0))
        model.load_state_dict(load_subtree(checkpoint_path, model.state_dict(), prefix))
        return _Apply(model, _reconstruct)

    def specs(batch, device):
        return torch.zeros((batch, input_dim), device=device)

    programs, batch = _export_with_symbolic_batch(make, specs, platforms, symbolic_batch)
    meta = {
        "kind": "vae",
        "input_dim": input_dim,
        "encoder_hidden": enc_hidden,
        "decoder_hidden": dec_hidden,
        "latent_dim": latent_dim,
        "platforms": list(platforms),
        "batch": batch,
        "outputs": ["x_hat [B, input_dim]", "mu [B, latent_dim]"],
    }
    return programs, meta


def program_path(out_path: str | Path, platform: str) -> Path:
    """``<out>.<platform>.pt2`` of the artifact at ``out_path`` (its prefix
    or its ``.json``)."""
    meta = Path(out_path).with_suffix(".json")
    return meta.with_name(f"{meta.stem}.{platform}.pt2")


def write_serving_artifact(out_path: str | Path, programs: Programs, meta: Dict) -> Path:
    """Save each platform's program and the metadata; returns the
    ``.json`` path."""
    out = Path(out_path).with_suffix(".json")
    out.parent.mkdir(parents=True, exist_ok=True)
    for platform, program in programs.items():
        torch.export.save(program, program_path(out, platform))
    out.write_text(json.dumps(meta, indent=2))
    return out


def _to_device(tree, device):
    return tree_map(lambda x: torch.as_tensor(np.asarray(x), device=device), tree)


def _to_numpy(tree):
    return tree_map(lambda t: t.detach().cpu().numpy(), tree)


class ServingArtifact:
    """A loaded artifact: ``call(channels, masks) -> (probabilities,
    risk)`` for a survival fold, numpy in and out.  ``channels`` and
    ``masks`` follow the exported layout in ``meta``: pad bags to the
    exported patch counts and set the masks.  ``module`` is the program
    itself, for callers that hold tensors on ``device``."""

    def __init__(self, program, meta: Dict, device: torch.device):
        self.module = program.module()
        self.meta = meta
        self.device = device

    def call(self, channels: Dict[str, np.ndarray], masks: Dict[str, np.ndarray]):
        return self(channels, masks)

    def __call__(self, *args):
        """The program on numpy inputs, numpy out, structured as
        ``meta['outputs']`` says (alignment: one {marker: [B, D]} dict -> the
        aligned dict; vae: [B, input_dim] -> (x_hat, mu))."""
        with torch.no_grad():
            return _to_numpy(self.module(*_to_device(args, self.device)))


def load_serving_artifact(path: str | Path, device=None) -> ServingArtifact:
    """Load the artifact at ``path`` (its prefix or its ``.json``) for
    ``device`` (default: the CUDA card).  Raises when the artifact holds no
    program for that device's platform."""
    dev = resolve_device(device)
    meta = json.loads(Path(path).with_suffix(".json").read_text())
    if dev.type not in meta["platforms"]:
        raise ValueError(f"artifact {path} holds no program for platform {dev.type!r} "
                         f"(it has {meta['platforms']})")
    return ServingArtifact(torch.export.load(program_path(path, dev.type)), meta, dev)

"""TMA core patching + feature extraction to per-marker NPZ.

Counterpart of ``multimodal_fusion_tpu.data.tma_extraction`` (reference:
``alignment/tma_feature_extraction/extract_tma_features_uni.py``):

- sliding-window patches (size 256, stride 128) over each core; cores
  smaller than a patch are resized whole with Lanczos-3, rounded and
  clipped back to uint8;
- optional white-region filter: a patch is kept when its non-white content
  ratio >= min_content_ratio, white meaning all RGB >= white_threshold*255;
- features are extracted in fixed-size batches by the ViT encoder
  (``models.vit``) and written per marker as one [N_patches, 1024] entry
  per core.

The encoder runs on the CUDA card unless the caller passes
``device="cpu"``; on the card its attention is the fused kernel K3.
Uniform uint8 patches ship raw (4x fewer bytes than float32) from one
pinned host buffer with non-blocking uploads, and /255, the bicubic resize
to the model's input size and the ImageNet normalisation run on the device;
other patches are preprocessed on the host.  The last batch is padded to
the batch size and the padding dropped.  The host waits for the device
once, when it collects the features.
"""

from __future__ import annotations

import copy
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from multimodal_fusion_tpu_torch.device import resolve_device
from multimodal_fusion_tpu_torch.models.vit import (
    IMAGENET_MEAN,
    IMAGENET_STD,
    ViT,
    preprocess_patch,
    set_attention_impl,
)
from multimodal_fusion_tpu_torch.ops.resize import apply_resize, resize, resize_weights
from multimodal_fusion_tpu_torch.parallel.mesh import all_gather_rows, divides

COMPUTE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def extract_patches_from_image(
    img: np.ndarray,
    patch_size: int = 256,
    stride: int = 128,
    white_threshold: Optional[float] = None,
    min_content_ratio: Optional[float] = None,
) -> List[np.ndarray]:
    """uint8 [H, W, 3] -> list of [patch_size, patch_size, 3] patches."""
    h, w = img.shape[:2]
    if h < patch_size or w < patch_size:
        # the reference upsamples small cores with PIL LANCZOS; lanczos3 is
        # jax.image.resize's equivalent kernel, ROUNDED (not truncated) back
        up = resize(torch.from_numpy(img.astype(np.float32)), (patch_size, patch_size), "lanczos3")
        return [torch.clamp(torch.round(up), 0, 255).to(torch.uint8).numpy()]
    patches = []
    for y in range(0, h - patch_size + 1, stride):
        for x in range(0, w - patch_size + 1, stride):
            patch = img[y : y + patch_size, x : x + patch_size]
            if white_threshold is not None and min_content_ratio is not None:
                if not is_patch_valid(patch, white_threshold, min_content_ratio):
                    continue
            patches.append(patch)
    return patches


def is_patch_valid(patch: np.ndarray, white_threshold: float, min_content_ratio: float) -> bool:
    """content ratio = 1 - fraction of pixels with all RGB >= thr*255."""
    white = np.all(patch >= white_threshold * 255, axis=2)
    return (1.0 - float(white.mean())) >= min_content_ratio


def make_feature_extractor(
    model: ViT,
    batch_size: int = 32,
    compute_dtype: str = "float32",
    mesh=None,
    attn_impl: str = "auto",
    device=None,
) -> Callable[[Sequence[np.ndarray]], np.ndarray]:
    """Batched CLS-feature extractor: list of patches -> float32
    [N, embed_dim].

    ``compute_dtype="bfloat16"`` runs a bf16 copy of the weights on bf16
    inputs (features come back float32).  ``attn_impl`` is set on every
    block (``models.vit.set_attention_impl``); ``auto`` runs the fused
    kernel K3 on the card.  The model is used as it is when it already
    lies on ``device`` in ``compute_dtype``, else a converted copy is made.

    ``mesh`` (``parallel.mesh``): each rank runs its rows of every batch
    (``batch_size`` a multiple of the mesh size; otherwise every rank runs
    whole batches) on its device and the features are all-gathered in patch
    order, so every rank returns them all.  The JAX package forces XLA's
    attention under a mesh (GSPMD cannot partition a Mosaic call); the port
    keeps K3, with the same results."""
    if compute_dtype not in COMPUTE_DTYPES:
        raise ValueError(f"compute_dtype must be one of {tuple(COMPUTE_DTYPES)}, got {compute_dtype!r}")
    dev = resolve_device(device) if mesh is None else mesh.device
    share = batch_size // mesh.size if divides(mesh, batch_size) else None
    dtype = COMPUTE_DTYPES[compute_dtype]
    params = list(model.parameters())
    if all(p.device == dev and p.dtype == dtype for p in params):
        net = model
    else:
        net = copy.deepcopy(model).to(device=dev, dtype=dtype)
    set_attention_impl(net, attn_impl)  # validates; set again at every call
    net.eval()
    input_size = net.input_size
    mean = torch.as_tensor(IMAGENET_MEAN, device=dev)
    std = torch.as_tensor(IMAGENET_STD, device=dev)
    pinned = dev.type == "cuda"
    resize_w = {}  # patch (H, W) -> bicubic matrices to the input size, uploaded once

    def run(batch: torch.Tensor) -> torch.Tensor:  # [B, S, S, 3] preprocessed f32
        return net(batch.to(dtype)).float()

    def run_raw(batch_u8: torch.Tensor) -> torch.Tensor:  # [B, H, W, 3] raw uint8
        # the whole timm transform on the device: /255, bicubic resize to
        # the model's input size, ImageNet normalisation
        x = batch_u8.float() / 255.0
        hw = (x.shape[1], x.shape[2])
        if hw not in resize_w:
            resize_w[hw] = resize_weights(hw, (input_size, input_size), "bicubic", dev)
        x = apply_resize(x, resize_w[hw])
        x = (x - mean) / std
        return net(x.to(dtype)).float()

    @torch.inference_mode()
    def extract(patches: Sequence[np.ndarray]) -> np.ndarray:
        # the model may be shared with another extractor of another impl
        set_attention_impl(net, attn_impl)
        n = len(patches)
        if n == 0:
            return np.zeros((0, net.embed_dim), np.float32)
        raw = all(p.dtype == np.uint8 and p.shape == patches[0].shape for p in patches)
        if raw:
            host = torch.empty((n,) + tuple(patches[0].shape), dtype=torch.uint8, pin_memory=pinned)
            np.stack(patches, out=host.numpy())
        else:
            host = torch.empty((n, input_size, input_size, 3), dtype=torch.float32,
                               pin_memory=pinned)
            np.stack([preprocess_patch(p, size=input_size) for p in patches], out=host.numpy())
        step = run_raw if raw else run
        feats = []
        for start in range(0, n, batch_size):
            m = min(batch_size, n - start)
            # fixed batch size: the last batch is padded with zeros; under a
            # mesh the rank's share of it
            rows = batch_size if share is None else share
            lo = start if share is None else start + mesh.rank * share
            hi = min(lo + rows, start + m)
            chunk = torch.empty((rows,) + tuple(host.shape[1:]), dtype=host.dtype, device=dev)
            if hi > lo:
                chunk[:hi - lo].copy_(host[lo:hi], non_blocking=True)
            chunk[max(hi - lo, 0):].zero_()
            out = step(chunk)
            feats.append((out if share is None else all_gather_rows(mesh, out))[:m])
        return torch.cat(feats).cpu().numpy()  # the one wait for the device

    return extract


def extract_marker_features(
    image_files,
    extractor: Callable,
    patch_size: int = 256,
    stride: int = 128,
    white_threshold: Optional[float] = None,
    min_content_ratio: Optional[float] = None,
) -> Dict[str, np.ndarray]:
    """{core_key: uint8 image} (dict OR lazy (key, image) iterable -- the CLI
    streams one decoded core at a time) -> {core_key: [N_patches, D]
    features}."""
    items = image_files.items() if hasattr(image_files, "items") else image_files
    out = {}
    for key, img in items:
        patches = extract_patches_from_image(
            img, patch_size, stride, white_threshold, min_content_ratio
        )
        if not patches:
            continue
        out[key] = extractor(patches)
    return out


def save_marker_npz(path, features: Dict[str, np.ndarray]) -> None:
    np.savez_compressed(path, **features)

"""UNI2-h's forward, plain: uint8 windows to CLS features in float32 torch.

The model (huggingface.co/MahmoodLab/UNI2-h, the model card's timm
keywords): a ViT/14 at 224 px, 1536 wide, 24 blocks of 24 heads, LayerScale,
a packed SwiGLU MLP, 8 register tokens, a position embedding over the
patches only (``no_embed_class``), LayerNorm eps 1e-6, the feature the final
LayerNorm of the class token (``num_classes`` 0, token pooling).

- Input: each uint8 window [S, S, 3] scaled to [0, 1], resized to the
  model's input size, normalised with ImageNet's mean and standard
  deviation.
- Tokens: the patch embedding is timm's convolution (kernel and stride the
  patch size) over the channels-first image, flattened row by row; the
  position embedding is added to the patch tokens, then the class token and
  the register tokens are put in front: [cls, reg x R, patches].
- Each block: x += ls1 * proj(attention(LN(x))), the heads sliced out of one
  qkv projection with a bias as timm lays them out, softmax(q k^T / sqrt(hd))
  v; h = fc1(LN(x)), a, b = h.chunk(2), x += ls2 * fc2(silu(a) * b) (timm's
  ``GluMlp`` with ``gate_last=False``: the SiLU takes the first half).

Parameters are a timm state dict (``patch_embed.proj.weight`` [D, 3, P, P],
``cls_token`` [1, 1, D], ``reg_token`` [1, R, D], ``pos_embed`` [1, N, D],
``blocks.<i>.attn.qkv``, ``blocks.<i>.mlp.fc1`` [2 H, D], ``fc2`` [D, H],
``ls1.gamma``, ...) as tensors or numpy arrays.

Departures from timm's pipeline:

- the resize is ``jax.image.resize``'s antialiased bicubic (Keys' cubic,
  a = -0.5, the kernel widened by the downscale, weights normalised per
  output pixel), the kernel the port and the JAX package use, not
  torchvision's ``Resize(224)`` of the model card's transform;
- a square window is resized straight to the input size (the card's
  transform resizes the short side, the same for a square);
- no dropout and no drop path: inference;
- ``dynamic_img_size`` has nothing to do: the input is always ``img_size``,
  so the position embedding is never resampled.

It imports torch and numpy only: no JAX, nothing of the port, nothing of
the benchmark.
"""

from __future__ import annotations

import math
from typing import Dict, Mapping

import numpy as np
import torch
import torch.nn.functional as F

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
EPS = 1e-6


def bicubic_matrix(n_in: int, n_out: int) -> np.ndarray:
    """[n_out, n_in] weights of ``jax.image.resize``'s antialiased bicubic
    along one axis, float64."""
    inv_scale = n_in / n_out
    kernel_scale = max(inv_scale, 1.0)
    sample = (np.arange(n_out) + 0.5) * inv_scale - 0.5
    x = np.abs(sample[None, :] - np.arange(n_in)[:, None]) / kernel_scale
    w = np.where(x < 1.0, ((1.5 * x - 2.5) * x) * x + 1.0,
                 np.where(x < 2.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, 0.0))
    total = w.sum(axis=0, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * np.finfo(np.float32).eps,
                 w / np.where(total != 0, total, 1), 0.0)
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return np.where(inside[None, :], w, 0.0).T


def preprocess(windows: torch.Tensor, size: int) -> torch.Tensor:
    """uint8 windows [N, S, S, 3] -> normalised float32 [N, size, size, 3]."""
    x = windows.to(torch.float32) / 255.0
    s = x.shape[1]
    if s != size:
        r = torch.as_tensor(bicubic_matrix(s, size), dtype=torch.float32)
        x = torch.einsum("Hh,nhwc->nHwc", r, x)
        x = torch.einsum("Ww,nhwc->nhWc", r, x)
    mean = torch.as_tensor(IMAGENET_MEAN, dtype=torch.float32)
    std = torch.as_tensor(IMAGENET_STD, dtype=torch.float32)
    return (x - mean) / std


def _tensors(state: Mapping) -> Dict[str, torch.Tensor]:
    return {k: torch.as_tensor(np.asarray(v), dtype=torch.float32) for k, v in state.items()}


def _ln(x: torch.Tensor, w: Dict[str, torch.Tensor], name: str) -> torch.Tensor:
    return F.layer_norm(x, (x.shape[-1],), w[f"{name}.weight"], w[f"{name}.bias"], EPS)


def _linear(x: torch.Tensor, w: Dict[str, torch.Tensor], name: str) -> torch.Tensor:
    return x @ w[f"{name}.weight"].T + w[f"{name}.bias"]


def forward(state: Mapping, num_heads: int, images: torch.Tensor) -> torch.Tensor:
    """CLS features [N, D] of preprocessed images [N, S, S, 3]; the depth,
    the widths, the patch size and the register count come from the
    state dict's shapes."""
    w = _tensors(state)
    n = images.shape[0]
    d, _, p, _ = w["patch_embed.proj.weight"].shape
    depth = len({k.split(".")[1] for k in w if k.startswith("blocks.")})
    hd = d // num_heads
    x = F.conv2d(images.permute(0, 3, 1, 2).to(torch.float32), w["patch_embed.proj.weight"],
                 w["patch_embed.proj.bias"], stride=p)
    x = x.flatten(2).transpose(1, 2) + w["pos_embed"].reshape(1, -1, d)  # [N, patches, D]
    front = [w["cls_token"].reshape(1, 1, d).expand(n, 1, d)]
    if "reg_token" in w:
        reg = w["reg_token"].reshape(1, -1, d)
        front.append(reg.expand(n, reg.shape[1], d))
    x = torch.cat(front + [x], dim=1)
    t = x.shape[1]
    for i in range(depth):
        b = f"blocks.{i}"
        qkv = _linear(_ln(x, w, f"{b}.norm1"), w, f"{b}.attn.qkv")
        q, k, v = qkv.reshape(n, t, 3, num_heads, hd).permute(2, 0, 3, 1, 4)  # [N, H, T, hd]
        att = torch.softmax(q @ k.transpose(-1, -2) / math.sqrt(hd), dim=-1)
        o = (att @ v).transpose(1, 2).reshape(n, t, d)
        x = x + w[f"{b}.ls1.gamma"] * _linear(o, w, f"{b}.attn.proj")
        a, gate = _linear(_ln(x, w, f"{b}.norm2"), w, f"{b}.mlp.fc1").chunk(2, dim=-1)
        x = x + w[f"{b}.ls2.gamma"] * _linear(F.silu(a) * gate, w, f"{b}.mlp.fc2")
    return _ln(x[:, 0], w, "norm")


def features(state: Mapping, num_heads: int, img_size: int, windows: torch.Tensor) -> torch.Tensor:
    """CLS features [N, D] of uint8 windows [N, S, S, 3]."""
    with torch.no_grad():
        return forward(state, num_heads, preprocess(windows, img_size))

"""ViT (UNI: ViT-L/16 with LayerScale) feature extraction from TMA cores,
plain.

A core is cut into ``patch`` x ``patch`` windows at ``stride``, row by row;
each window is scaled to [0, 1], resized to the model's input with the
antialiased bicubic resize of ``jax.image.resize`` (Keys' cubic, a = -0.5,
the kernel widened by the downscale), normalised with ImageNet's mean and
standard deviation, cut into 16 x 16 patches (each a row-major H, W, C
vector) and embedded by a Linear; a class token is put first and the
position embedding added.  Each block: x += ls1 * proj(attention(LN(x))),
x += ls2 * fc2(GELU(fc1(LN(x)))), LayerNorm eps 1e-6, exact GELU, heads
sliced out of one qkv projection as timm lays them out.  The feature is
the final LayerNorm of the class token.
"""

from __future__ import annotations

import math
from typing import Dict, List

import numpy as np
import torch
import torch.nn.functional as F

from portbench.harness.draw import WeightSpec
from portbench.reference import kernels
from portbench.reference.numerics import Numerics, layer_norm

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def _dims(config: Dict):
    m = config["model"]
    d, depth, heads = int(m["embed_dim"]), int(m["depth"]), int(m["num_heads"])
    tokens = (int(m["img_size"]) // int(m["patch_size"])) ** 2 + 1
    return d, depth, heads, d // heads, int(d * float(m["mlp_ratio"])), tokens


def weight_spec(config: Dict) -> WeightSpec:
    """Every parameter under the port's state-dict name.  Linear weights
    and biases uniform in +-1/sqrt(fan_in); class token and position
    embedding N(0, 0.02^2); LayerNorm scales around 1, shifts around 0; the
    LayerScale factors uniform in ``assumed.layer_scale`` (a trained model's
    size, not the 1e-5 it starts training from, so that every block's work
    reaches the feature the check compares)."""
    m = config["model"]
    d, depth, _, _, hidden, tokens = _dims(config)
    p = int(m["patch_size"])
    ls_lo, ls_hi = config["assumed"]["layer_scale"]
    spec: WeightSpec = []

    def linear(prefix, fan_in, fan_out):
        bound = 1.0 / math.sqrt(fan_in)
        spec.append((f"{prefix}.weight", (fan_out, fan_in), "uniform", -bound, bound))
        spec.append((f"{prefix}.bias", (fan_out,), "uniform", -bound, bound))

    def norm(prefix):
        spec.append((f"{prefix}.weight", (d,), "normal", 1.0, 0.1))
        spec.append((f"{prefix}.bias", (d,), "normal", 0.0, 0.02))

    linear("patch_proj", p * p * 3, d)
    spec.append(("cls_token", (1, d), "normal", 0.0, 0.02))
    spec.append(("pos_embed", (tokens, d), "normal", 0.0, 0.02))
    for i in range(depth):
        b = f"blocks.{i}"
        norm(f"{b}.norm1")
        linear(f"{b}.qkv", d, 3 * d)
        linear(f"{b}.proj", d, d)
        norm(f"{b}.norm2")
        linear(f"{b}.fc1", d, hidden)
        linear(f"{b}.fc2", hidden, d)
        spec.append((f"{b}.ls1", (d,), "uniform", ls_lo, ls_hi))
        spec.append((f"{b}.ls2", (d,), "uniform", ls_lo, ls_hi))
    norm("norm")
    return spec


def cut(core: np.ndarray, patch: int, stride: int) -> np.ndarray:
    """The sliding windows of a core [E, E, 3] at least one patch wide,
    row by row: [N, patch, patch, 3]."""
    h, w = core.shape[:2]
    return np.stack([core[y:y + patch, x:x + patch]
                     for y in range(0, h - patch + 1, stride)
                     for x in range(0, w - patch + 1, stride)])


def bicubic_matrix(n_in: int, n_out: int) -> np.ndarray:
    """[n_out, n_in] weights of ``jax.image.resize``'s antialiased bicubic
    along one axis (jax._src.image.scale.compute_weight_mat), float64."""
    inv_scale = n_in / n_out
    kernel_scale = max(inv_scale, 1.0)
    sample = (np.arange(n_out) + 0.5) * inv_scale - 0.5
    x = np.abs(sample[None, :] - np.arange(n_in)[:, None]) / kernel_scale
    w = np.where(x < 1.0, ((1.5 * x - 2.5) * x) * x + 1.0,
                 np.where(x < 2.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, 0.0))
    total = w.sum(axis=0, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * np.finfo(np.float32).eps, w / np.where(total != 0, total, 1), 0.0)
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return np.where(inside[None, :], w, 0.0).T


def features(weights: Dict[str, torch.Tensor], config: Dict, patches: torch.Tensor,
             num: Numerics) -> torch.Tensor:
    """CLS features [N, D] of uint8 windows [N, S, S, 3] on the device."""
    m = config["model"]
    d, depth, heads, hd, _, tokens = _dims(config)
    size, p = int(m["img_size"]), int(m["patch_size"])
    eps = float(m["layer_norm_eps"])
    x = patches.to(torch.float32) / 255.0
    n, s = x.shape[0], x.shape[1]
    if s != size:
        r = torch.as_tensor(bicubic_matrix(s, size), dtype=torch.float32, device=x.device)
        x = torch.einsum("Hh,nhwc->nHwc", r, x)
        x = torch.einsum("Ww,nhwc->nhWc", r, x)
    mean = torch.as_tensor(IMAGENET_MEAN, device=x.device)
    std = torch.as_tensor(IMAGENET_STD, device=x.device)
    x = (x - mean) / std
    g = size // p
    x = x.reshape(n, g, p, g, p, 3).permute(0, 1, 3, 2, 4, 5).reshape(n, g * g, p * p * 3)
    x = num.linear(x, weights["patch_proj.weight"], weights["patch_proj.bias"])
    x = torch.cat([weights["cls_token"].expand(n, 1, d), x], dim=1) + weights["pos_embed"]
    for i in range(depth):
        b = f"blocks.{i}"
        h = layer_norm(x, weights[f"{b}.norm1.weight"], weights[f"{b}.norm1.bias"], eps)
        qkv = num.linear(h, weights[f"{b}.qkv.weight"], weights[f"{b}.qkv.bias"])
        q, k, v = qkv.view(n, tokens, 3, heads, hd).permute(2, 0, 3, 1, 4)  # [N, H, T, hd] each
        att = torch.softmax(num.matmul(q, k.transpose(-1, -2)) / math.sqrt(hd), dim=-1)
        o = num.matmul(att, v).transpose(1, 2).reshape(n, tokens, d)
        x = x + weights[f"{b}.ls1"] * num.linear(o, weights[f"{b}.proj.weight"], weights[f"{b}.proj.bias"])
        h = layer_norm(x, weights[f"{b}.norm2.weight"], weights[f"{b}.norm2.bias"], eps)
        h = num.linear(F.gelu(num.linear(h, weights[f"{b}.fc1.weight"], weights[f"{b}.fc1.bias"])),
                       weights[f"{b}.fc2.weight"], weights[f"{b}.fc2.bias"])
        x = x + weights[f"{b}.ls2"] * h
    return layer_norm(x[:, 0], weights["norm.weight"], weights["norm.bias"], eps)


def extract(weights: Dict[str, torch.Tensor], config: Dict, cores: List[np.ndarray], device,
            tf32: bool = False, chunk: int = 64) -> List[torch.Tensor]:
    """Each core's features [N_patches, D], in chunks of ``chunk`` windows."""
    ext = config["extraction"]
    num = Numerics(tf32)
    out = []
    with torch.no_grad(), num.active():
        for core in cores:
            windows = torch.as_tensor(cut(core, int(ext["patch_size"]), int(ext["stride"])),
                                      device=device)
            out.append(torch.cat([features(weights, config, windows[i:i + chunk], num)
                                  for i in range(0, len(windows), chunk)]))
    return out


def patch_flops(config: Dict, window: int) -> float:
    """Useful FLOPs of one window: the resize (where the window is not the
    input size), the embedding, and each block's projections, MLP and
    attention."""
    m = config["model"]
    d, depth, _, _, hidden, tokens = _dims(config)
    size, p = int(m["img_size"]), int(m["patch_size"])
    resize = 0 if window == size else 2 * 3 * size * window * (window + size)
    embed = 2 * (tokens - 1) * p * p * 3 * d
    block = 2 * tokens * d * (3 * d + d + 2 * hidden) + 4 * tokens * tokens * d
    return float(resize + embed + depth * block)


def count(config: Dict, record: Dict) -> Dict:
    """The work of one step's cores (``record["patches"]``, each core's
    window count): useful FLOPs of the real windows, and one K3 call a
    block a batch at the padded batch, each core's last batch padded (the
    roofline holds these calls against the program's own count)."""
    d, depth, heads, hd, _, tokens = _dims(config)
    ext = config["extraction"]
    batch = int(ext["batch_size"])
    real = sum(int(n) for n in record["patches"])
    batches = sum(-(-int(n) // batch) for n in record["patches"])
    k3 = kernels.attention_fwd(batch, heads, tokens, tokens, hd)
    return {"flops": real * patch_flops(config, int(ext["patch_size"])),
            "kernels": {"k3": [k3] * (batches * depth)}}

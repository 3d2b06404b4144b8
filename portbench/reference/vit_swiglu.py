"""UNI2-h (a ViT/14 with a packed SwiGLU MLP and register tokens) feature
extraction from TMA cores, plain.

The windows are cut, scaled, resized and normalised as in ``reference/vit.py``
(``cut``, ``bicubic_matrix``), then cut into patches of ``patch_size`` (each
a row-major H, W, C vector) and embedded by a Linear.  The position
embedding covers the patches only and is added to them; then the class
token and the ``reg_tokens`` register tokens are put in front:
[cls, reg x R, patches].  Each block: x += ls1 * proj(attention(LN(x))),
the heads sliced out of one qkv projection as timm lays them out;
h = fc1(LN(x)), a, b = h.chunk(2), x += ls2 * fc2(silu(a) * b) (timm's
``SwiGLUPacked``: the SiLU takes the first half of fc1's rows).  LayerNorm
eps from the configuration.  The feature is the final LayerNorm of the
class token.
"""

from __future__ import annotations

import math
from typing import Dict, List

import torch
import torch.nn.functional as F

from portbench.harness.draw import WeightSpec
from portbench.reference import kernels
from portbench.reference.numerics import Numerics, layer_norm
from portbench.reference.vit import IMAGENET_MEAN, IMAGENET_STD, bicubic_matrix, cut


def _dims(config: Dict):
    """(width, depth, heads, head width, fc1's width, register tokens,
    patches, tokens) of the configuration's model."""
    m = config["model"]
    if m.get("mlp_layer") != "swiglu_packed" or not m.get("no_embed_class"):
        raise ValueError("reference/vit_swiglu.py holds a packed SwiGLU ViT whose position "
                         "embedding covers the patches only")
    d, depth, heads = int(m["embed_dim"]), int(m["depth"]), int(m["num_heads"])
    reg = int(m.get("reg_tokens", 0))
    patches = (int(m["img_size"]) // int(m["patch_size"])) ** 2
    return d, depth, heads, d // heads, int(d * float(m["mlp_ratio"])), reg, patches, patches + 1 + reg


def weight_spec(config: Dict) -> WeightSpec:
    """Every parameter under the port's state-dict name.  Linear weights
    and biases uniform in +-1/sqrt(fan_in); class token, register tokens and
    position embedding N(0, 0.02^2); LayerNorm scales around 1, shifts
    around 0; the LayerScale factors uniform in ``assumed.layer_scale``."""
    m = config["model"]
    d, depth, _, _, hidden, reg, patches, _ = _dims(config)
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
    spec.append(("pos_embed", (patches, d), "normal", 0.0, 0.02))
    if reg:
        spec.append(("reg_token", (reg, d), "normal", 0.0, 0.02))
    for i in range(depth):
        b = f"blocks.{i}"
        norm(f"{b}.norm1")
        linear(f"{b}.qkv", d, 3 * d)
        linear(f"{b}.proj", d, d)
        norm(f"{b}.norm2")
        linear(f"{b}.fc1", d, hidden)
        linear(f"{b}.fc2", hidden // 2, d)
        spec.append((f"{b}.ls1", (d,), "uniform", ls_lo, ls_hi))
        spec.append((f"{b}.ls2", (d,), "uniform", ls_lo, ls_hi))
    norm("norm")
    return spec


def features(weights: Dict[str, torch.Tensor], config: Dict, patches: torch.Tensor,
             num: Numerics) -> torch.Tensor:
    """CLS features [N, D] of uint8 windows [N, S, S, 3] on the device."""
    m = config["model"]
    d, depth, heads, hd, _, reg, _, tokens = _dims(config)
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
    front = [weights["cls_token"].expand(n, 1, d)]
    if reg:
        front.append(weights["reg_token"].expand(n, reg, d))
    x = torch.cat(front + [x + weights["pos_embed"]], dim=1)
    for i in range(depth):
        b = f"blocks.{i}"
        h = layer_norm(x, weights[f"{b}.norm1.weight"], weights[f"{b}.norm1.bias"], eps)
        qkv = num.linear(h, weights[f"{b}.qkv.weight"], weights[f"{b}.qkv.bias"])
        q, k, v = qkv.view(n, tokens, 3, heads, hd).permute(2, 0, 3, 1, 4)  # [N, H, T, hd] each
        att = torch.softmax(num.matmul(q, k.transpose(-1, -2)) / math.sqrt(hd), dim=-1)
        o = num.matmul(att, v).transpose(1, 2).reshape(n, tokens, d)
        x = x + weights[f"{b}.ls1"] * num.linear(o, weights[f"{b}.proj.weight"], weights[f"{b}.proj.bias"])
        h = layer_norm(x, weights[f"{b}.norm2.weight"], weights[f"{b}.norm2.bias"], eps)
        a, gate = num.linear(h, weights[f"{b}.fc1.weight"], weights[f"{b}.fc1.bias"]).chunk(2, dim=-1)
        h = num.linear(F.silu(a) * gate, weights[f"{b}.fc2.weight"], weights[f"{b}.fc2.bias"])
        x = x + weights[f"{b}.ls2"] * h
    return layer_norm(x[:, 0], weights["norm.weight"], weights["norm.bias"], eps)


def extract(weights: Dict[str, torch.Tensor], config: Dict, cores: List, device,
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
    input size), the embedding, and each block's projections, its packed
    SwiGLU (fc1 D -> hidden, fc2 hidden / 2 -> D) and attention over every
    token, class and register tokens included."""
    m = config["model"]
    d, depth, _, _, hidden, _, patches, tokens = _dims(config)
    size, p = int(m["img_size"]), int(m["patch_size"])
    resize = 0 if window == size else 2 * 3 * size * window * (window + size)
    embed = 2 * patches * p * p * 3 * d
    block = (2 * tokens * d * (3 * d + d) + 2 * tokens * (d * hidden + (hidden // 2) * d)
             + 4 * tokens * tokens * d)
    return float(resize + embed + depth * block)


def count(config: Dict, record: Dict) -> Dict:
    """The work of one step's cores (``record["patches"]``, each core's
    window count): useful FLOPs of the real windows, and one K3 call a
    block a batch at the padded batch, each core's last batch padded."""
    _, depth, heads, hd, _, _, _, tokens = _dims(config)
    batch = int(config["extraction"]["batch_size"])
    real = sum(int(n) for n in record["patches"])
    batches = sum(-(-int(n) // batch) for n in record["patches"])
    k3 = kernels.attention_fwd(batch, heads, tokens, tokens, hd)
    return {"flops": real * patch_flops(config, int(config["extraction"]["patch_size"])),
            "kernels": {"k3": [k3] * (batches * depth)}}

"""ViT encoder (UNI-style ViT-L/16) for TMA patch feature extraction.

Counterpart of ``multimodal_fusion_tpu.models.vit``: the same architecture
(timm's ViT with LayerScale, LayerNorm eps 1e-6, exact GELU, the CLS feature
after the final LayerNorm), batched over images [B, H, W, C].  The patch
embedding is a Linear over HWC row-major patch vectors, as in the JAX
package, so ``load_timm_vit_weights`` transposes timm's conv weight the
same way.  Attention goes through ``ops.attention.attention``: on a CUDA
tensor ``auto`` runs the fused kernel K3, reading q, k and v straight out
of the fused qkv projection.

Weights: a seeded random init (``torch_linear``), a converted timm state
dict (``load_timm_vit_weights``), or the JAX model's own parameters
(``vit_params_from_jax``), which is how the tests hold the port to the
JAX package.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from multimodal_fusion_tpu_torch.models.common import torch_linear
from multimodal_fusion_tpu_torch.ops.attention import VALID_IMPLS, attention
from multimodal_fusion_tpu_torch.ops.resize import resize

# ImageNet normalisation used by the timm transform for UNI.
IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)

LN_EPS = 1e-6  # flax nnx.LayerNorm and timm's ViT; torch's default is 1e-5


class ViTBlock(nn.Module):
    def __init__(self, dim: int, num_heads: int, mlp_ratio: float,
                 init_values: Optional[float], generator: torch.Generator):
        super().__init__()
        dev = generator.device
        self.norm1 = nn.LayerNorm(dim, eps=LN_EPS, device=dev)
        self.qkv = torch_linear(dim, 3 * dim, generator)
        self.proj = torch_linear(dim, dim, generator)
        self.norm2 = nn.LayerNorm(dim, eps=LN_EPS, device=dev)
        hidden = int(dim * mlp_ratio)
        self.fc1 = torch_linear(dim, hidden, generator)
        self.fc2 = torch_linear(hidden, dim, generator)
        self.num_heads = num_heads
        self.head_dim = dim // num_heads
        self.attn_impl = "auto"  # see set_attention_impl
        if init_values is not None:
            self.ls1 = nn.Parameter(torch.full((dim,), float(init_values), device=dev))
            self.ls2 = nn.Parameter(torch.full((dim,), float(init_values), device=dev))
        else:
            self.ls1 = self.ls2 = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # [B, T, D]
        b, t, d = x.shape
        qkv = self.qkv(self.norm1(x)).view(b, t, 3, self.num_heads, self.head_dim)
        # [B, T, H, hd] strided views of the fused projection
        out = attention(qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2], impl=self.attn_impl)
        out = self.proj(out.reshape(b, t, d))
        if self.ls1 is not None:
            out = out * self.ls1
        x = x + out
        h = self.fc2(F.gelu(self.fc1(self.norm2(x)), approximate="none"))
        if self.ls2 is not None:
            h = h * self.ls2
        return x + h


class ViT(nn.Module):
    """ViT backbone returning the CLS feature (num_classes=0 semantics).
    Parameters live on ``generator``'s device."""

    def __init__(
        self,
        img_size: int = 224,
        patch_size: int = 16,
        embed_dim: int = 1024,
        depth: int = 24,
        num_heads: int = 16,
        mlp_ratio: float = 4.0,
        init_values: Optional[float] = 1e-5,
        in_chans: int = 3,
        *,
        generator: torch.Generator,
    ):
        super().__init__()
        dev = generator.device
        self.patch_size = patch_size
        self.embed_dim = embed_dim
        n_patches = (img_size // patch_size) ** 2
        self.patch_proj = torch_linear(patch_size * patch_size * in_chans, embed_dim, generator)
        self.cls_token = nn.Parameter(torch.zeros(1, embed_dim, device=dev))
        self.pos_embed = nn.Parameter(
            0.02 * torch.randn(n_patches + 1, embed_dim, generator=generator, device=dev)
        )
        self.blocks = nn.ModuleList(
            [ViTBlock(embed_dim, num_heads, mlp_ratio, init_values, generator) for _ in range(depth)]
        )
        self.norm = nn.LayerNorm(embed_dim, eps=LN_EPS, device=dev)

    @property
    def input_size(self) -> int:
        """Input resolution, from the positional embedding."""
        n_grid = int(round((self.pos_embed.shape[0] - 1) ** 0.5))
        return n_grid * self.patch_size

    def patchify(self, img: torch.Tensor) -> torch.Tensor:
        """[B, H, W, C] -> [B, N_patches, P*P*C] (or [H, W, C] ->
        [N_patches, P*P*C]) in row-major patch order, HWC inside a patch."""
        unbatched = img.dim() == 3
        x = img[None] if unbatched else img
        b, h, w, c = x.shape
        p = self.patch_size
        x = x.reshape(b, h // p, p, w // p, p, c).permute(0, 1, 3, 2, 4, 5)
        x = x.reshape(b, (h // p) * (w // p), p * p * c)
        return x[0] if unbatched else x

    def forward(self, img: torch.Tensor) -> torch.Tensor:
        """Images [B, H, W, C] -> CLS features [B, embed_dim] (one image
        [H, W, C] -> [embed_dim])."""
        unbatched = img.dim() == 3
        x = img[None] if unbatched else img
        tokens = self.patch_proj(self.patchify(x))
        cls = self.cls_token[None].expand(tokens.shape[0], -1, -1)
        tokens = torch.cat([cls, tokens], dim=1) + self.pos_embed
        for blk in self.blocks:
            tokens = blk(tokens)
        # the final LayerNorm is per token, so normalising the CLS token
        # alone gives norm(tokens)[:, 0]
        out = self.norm(tokens[:, 0])
        return out[0] if unbatched else out


def set_attention_impl(model: ViT, impl: str) -> None:
    """Select the attention implementation of every block: 'auto' or
    'pallas' (K3: the kernel on CUDA tensors, its plain version on CPU),
    'pallas_interpret' (K3's plain version) or 'xla' (einsum formulation)."""
    if impl not in VALID_IMPLS:
        raise ValueError(f"unknown attention impl {impl!r}")
    for blk in model.blocks:
        blk.attn_impl = impl


def vit_large_16(generator: torch.Generator, init_values: float = 1e-5) -> ViT:
    """UNI architecture: ViT-L/16, 1024-d, 24 blocks, LayerScale 1e-5."""
    return ViT(embed_dim=1024, depth=24, num_heads=16, init_values=init_values,
               generator=generator)


def preprocess_patch(patch_u8: np.ndarray, size: int = 224) -> np.ndarray:
    """uint8 [H, W, 3] -> normalised float32 [size, size, 3] (timm transform
    semantics: bicubic antialiased resize to ``size`` + ImageNet mean/std),
    on the host."""
    img = patch_u8.astype(np.float32) / 255.0
    if img.shape[0] != size or img.shape[1] != size:
        img = resize(torch.from_numpy(img), (size, size), "bicubic").numpy()
    return (img - IMAGENET_MEAN) / IMAGENET_STD


def load_timm_vit_weights(model: ViT, state: Mapping[str, np.ndarray]) -> int:
    """Load a timm ViT state dict (converted to numpy, e.g. via
    ``np.savez(path, **{k: v.numpy() for k, v in sd.items()})``).  Returns
    the number of tensors loaded.  Same key map as the JAX package."""
    n = 0

    def setp(param: torch.Tensor, value) -> None:
        nonlocal n
        with torch.no_grad():
            param.copy_(torch.as_tensor(np.asarray(value)).reshape(param.shape))
        n += 1

    if "patch_embed.proj.weight" in state:
        w = np.asarray(state["patch_embed.proj.weight"])  # [D, C, P, P]
        # conv -> linear over [P*P*C] patch vectors (row-major HWC order)
        w = np.transpose(w, (2, 3, 1, 0)).reshape(-1, w.shape[0])  # [P*P*C, D]
        setp(model.patch_proj.weight, w.T)
        setp(model.patch_proj.bias, state["patch_embed.proj.bias"])
    if "cls_token" in state:
        setp(model.cls_token, state["cls_token"])
    if "pos_embed" in state:
        setp(model.pos_embed, state["pos_embed"])
    for i, blk in enumerate(model.blocks):
        p = f"blocks.{i}."
        if f"{p}norm1.weight" not in state:
            continue
        setp(blk.norm1.weight, state[f"{p}norm1.weight"])
        setp(blk.norm1.bias, state[f"{p}norm1.bias"])
        setp(blk.qkv.weight, state[f"{p}attn.qkv.weight"])
        setp(blk.qkv.bias, state[f"{p}attn.qkv.bias"])
        setp(blk.proj.weight, state[f"{p}attn.proj.weight"])
        setp(blk.proj.bias, state[f"{p}attn.proj.bias"])
        setp(blk.norm2.weight, state[f"{p}norm2.weight"])
        setp(blk.norm2.bias, state[f"{p}norm2.bias"])
        setp(blk.fc1.weight, state[f"{p}mlp.fc1.weight"])
        setp(blk.fc1.bias, state[f"{p}mlp.fc1.bias"])
        setp(blk.fc2.weight, state[f"{p}mlp.fc2.weight"])
        setp(blk.fc2.bias, state[f"{p}mlp.fc2.bias"])
        if blk.ls1 is not None and f"{p}ls1.gamma" in state:
            setp(blk.ls1, state[f"{p}ls1.gamma"])
            setp(blk.ls2, state[f"{p}ls2.gamma"])
    if "norm.weight" in state:
        setp(model.norm.weight, state["norm.weight"])
        setp(model.norm.bias, state["norm.bias"])
    return n


def vit_params_from_jax(state: Mapping) -> Dict[str, torch.Tensor]:
    """The port's ViT state dict from the JAX ViT's parameters, given flat
    as ``{path: np.ndarray}`` (a path is a tuple such as
    ``('blocks', 0, 'qkv', 'kernel')`` or its dotted string).  Linear
    ``kernel`` [in, out] becomes ``weight`` [out, in]; LayerNorm ``scale``
    becomes ``weight``; biases, ``cls_token``, ``pos_embed`` and the
    LayerScale ``ls1``/``ls2`` keep their names.  Load the result with
    ``model.load_state_dict``."""
    out: Dict[str, torch.Tensor] = {}
    for key, value in state.items():
        name = ".".join(str(p) for p in key) if isinstance(key, tuple) else str(key)
        prefix, _, leaf = name.rpartition(".")
        arr = np.asarray(value, dtype=np.float32)
        if leaf == "kernel":
            out[f"{prefix}.weight"] = torch.from_numpy(np.ascontiguousarray(arr.T))
        elif leaf == "scale":
            out[f"{prefix}.weight"] = torch.from_numpy(arr.copy())
        else:
            out[name] = torch.from_numpy(arr.copy())
    return out

"""Image resizing with ``jax.image.resize`` semantics.

The extraction path resizes with ``bicubic`` (Keys cubic, a = -0.5) to the
model's input size and upsamples small cores with ``lanczos3``.  Both are
separable: each resized axis is one [out, in] weight matrix, built as
``jax._src.image.scale.compute_weight_mat`` builds it (kernel widened by
1/scale when downscaling, i.e. antialiased; weights normalised per output;
outputs whose sample point lies outside the input set to zero), and applied
as a matrix product.  ``F.interpolate(mode="bicubic")`` is not the same
function: it uses a = -0.75, no antialias, and has no Lanczos.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import numpy as np
import torch

METHODS = ("bicubic", "lanczos3")


def _keys_cubic(x: np.ndarray) -> np.ndarray:
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = np.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return np.where(x >= 2.0, 0.0, out)


def _lanczos3(x: np.ndarray) -> np.ndarray:
    radius = 3.0
    y = radius * np.sin(np.pi * x) * np.sin(np.pi * x / radius)
    out = np.where(x > 1e-3, y / np.where(x != 0, np.pi ** 2 * x ** 2, 1.0), 1.0)
    return np.where(x > radius, 0.0, out)


_KERNELS = {"bicubic": _keys_cubic, "lanczos3": _lanczos3}


@functools.lru_cache(maxsize=64)
def weight_matrix(in_size: int, out_size: int, method: str) -> np.ndarray:
    """float32 [out_size, in_size] resampling matrix of one axis (read-only)."""
    if method not in METHODS:
        raise ValueError(f"unknown resize method {method!r} (expected one of {METHODS})")
    # float32 arithmetic in jax's order (Python scalars stay weak under
    # numpy's promotion rules), so the matrices agree with jax's to an ulp
    f32 = np.float32
    inv_scale = f32(1.0) / f32(out_size / in_size)
    kernel_scale = max(inv_scale, f32(1.0))  # antialias: widen the kernel when downscaling
    sample_f = (np.arange(out_size, dtype=f32) + 0.5) * inv_scale - 0.5
    x = np.abs(sample_f[None, :] - np.arange(in_size, dtype=f32)[:, None]) / kernel_scale
    w = _KERNELS[method](x).astype(f32)  # [in, out]
    total = w.sum(axis=0, keepdims=True, dtype=f32)
    w = np.where(np.abs(total) > 1000.0 * float(np.finfo(f32).eps),
                 w / np.where(total != 0, total, f32(1.0)), f32(0.0))
    inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    w = np.where(inside[None, :], w, f32(0.0))
    out = np.ascontiguousarray(w.T, dtype=f32)  # [out, in]
    out.setflags(write=False)
    return out


Weights = Tuple[Optional[torch.Tensor], Optional[torch.Tensor]]


def resize_weights(in_hw: Tuple[int, int], size: Tuple[int, int], method: str,
                   device=None, dtype=torch.float32) -> Weights:
    """The (H, W) axes' matrices as tensors on ``device``, None for an axis
    whose size does not change.  A caller that resizes many batches of one
    shape builds them once: each build is a synchronous host upload."""
    return tuple(
        None if n == out else torch.tensor(weight_matrix(n, out, method), dtype=dtype, device=device)
        for n, out in zip(in_hw, size)
    )


def apply_resize(x: torch.Tensor, weights: Weights) -> torch.Tensor:
    """Resize channels-last images [..., H, W, C] with ``resize_weights``."""
    wh, ww = weights
    if wh is not None:
        x = torch.einsum("Hh,...hwc->...Hwc", wh, x)
    if ww is not None:
        x = torch.einsum("Ww,...hwc->...hWc", ww, x)
    return x


def resize(x: torch.Tensor, size: Tuple[int, int], method: str) -> torch.Tensor:
    """Resize the two spatial axes of channels-last images [..., H, W, C]
    to ``size`` = (H', W'); an axis whose size does not change is left as
    it is (as ``jax.image.resize`` does).  Float input, same dtype out."""
    in_hw = (x.shape[-3], x.shape[-2])
    return apply_resize(x, resize_weights(in_hw, size, method, x.device, x.dtype))

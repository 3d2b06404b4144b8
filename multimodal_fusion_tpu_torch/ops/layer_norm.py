"""LayerNorm in flax's one-pass form: the wrapper of CUDA kernel K5.

K5 (``csrc/layer_norm.cu``) replaces no Pallas TPU kernel: on the TPU XLA
fuses the norm into its neighbours, while on the card the composite
PyTorch ops of ``plain_layer_norm`` cost about a dozen launches forward and
two dozen backward, each a pass over the tensor.  ``layer_norm`` takes the
plain version on CPU tensors, or where the caller asks for it with
``impl="plain"`` (``utils/export.py`` does, since a ctypes launch cannot
enter a traced graph); on a CUDA tensor it runs one kernel forward and one
(with a small sum of partials) backward, through
``torch.autograd.Function``, or raises, under tracing too.  Float32
forward and backward, bfloat16 forward (statistics in float32); widths up
to ``MAX_WIDTH``.

``layer_norm.launches`` and ``layer_norm_bwd.launches`` count the wrapper
calls that launched; the tracer's counter ``layer_norm.fused``
(``utils.profiling.count``) counts the forward's, so the program's log
shows the fused norm engaged.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from multimodal_fusion_tpu_torch.ops import _cuda
from multimodal_fusion_tpu_torch.utils import profiling

MAX_WIDTH = 1024  # mirrors csrc/layer_norm.cu: MAX_D
IMPLS = ("auto", "plain")


def plain_layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                     eps: float) -> torch.Tensor:
    """flax ``nnx.LayerNorm`` over the last dim in composite ops: the
    one-pass variance E[x^2] - E[x]^2 clipped at 0, the scale folded into
    rsqrt(var + eps)."""
    mu = x.mean(dim=-1, keepdim=True)
    var = ((x * x).mean(dim=-1, keepdim=True) - mu * mu).clamp_min(0.0)
    return (x - mu) * (torch.rsqrt(var + eps) * weight) + bias


@functools.cache  # loaded and typed once per process
def _lib():
    lib = _cuda.load("layer_norm")
    lib.mmf_layer_norm_fwd.argtypes = (
        [ctypes.c_int] + [ctypes.c_void_p] * 6 + [ctypes.c_int] * 2 + [ctypes.c_float, ctypes.c_void_p])
    lib.mmf_layer_norm_fwd.restype = ctypes.c_int
    lib.mmf_layer_norm_bwd.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    lib.mmf_layer_norm_bwd.restype = ctypes.c_int
    lib.mmf_layer_norm_bwd_capacity.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
    lib.mmf_layer_norm_bwd_capacity.restype = ctypes.c_int
    return lib


@functools.cache
def _bwd_capacity(index: int, width: int) -> int:
    """The backward's largest grid at ``width`` on card ``index``, the
    rows of its partials' workspace (the kernel's choice, by occupancy)."""
    blocks = ctypes.c_int(0)
    with torch.cuda.device(index):
        _cuda.check(_lib().mmf_layer_norm_bwd_capacity(width, ctypes.byref(blocks)),
                    "layer_norm backward capacity")
    return blocks.value


def _check(x: torch.Tensor, *params: torch.Tensor) -> int:
    """The width of ``x`` [..., D] after checking its device, dtype and
    ``params`` ([D] each, x's device and dtype)."""
    if x.device.type != "cuda":
        raise ValueError(f"layer_norm: unsupported device {x.device}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"layer_norm: x must be float32 or bfloat16, got {x.dtype}")
    width = x.shape[-1] if x.dim() else 0
    if not 1 <= width <= MAX_WIDTH:
        raise ValueError(f"layer_norm: width {width} outside the kernel's 1..{MAX_WIDTH}")
    for p in params:
        if p.shape != (width,) or p.device != x.device or p.dtype != x.dtype:
            raise ValueError(f"layer_norm: parameter {tuple(p.shape)} {p.dtype} on {p.device}, "
                             f"expected [{width}] {x.dtype} on {x.device}")
    return width


def layer_norm_fwd(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, eps: float):
    """(y, mu, rstd) of K5's forward for x [..., D], weight and bias [D]: y
    in x's dtype, mu and rstd float32 [rows] (rstd negative where the raw
    variance was below 0).  Counts in ``layer_norm.launches``."""
    width = _check(x, weight, bias)
    x = x.contiguous()
    rows = x.numel() // width
    y = torch.empty_like(x)
    mu, rstd = torch.empty((2, rows), dtype=torch.float32, device=x.device)
    if rows:
        err = _cuda.call(x.device, _lib().mmf_layer_norm_fwd, int(x.dtype == torch.bfloat16),
                         x.data_ptr(), weight.contiguous().data_ptr(), bias.contiguous().data_ptr(),
                         y.data_ptr(), mu.data_ptr(), rstd.data_ptr(), rows, width, float(eps))
        _cuda.check(err, "layer_norm kernel")
        layer_norm.launches += 1
        profiling.count("layer_norm.fused")
    return y, mu, rstd


def layer_norm_bwd(dy: torch.Tensor, x: torch.Tensor, weight: torch.Tensor, mu: torch.Tensor,
                   rstd: torch.Tensor):
    """(dx, dw, db) of K5's backward for float32 dy and x [..., D], weight
    [D] and the forward's mu and rstd [rows]."""
    width = _check(x, weight)
    if x.dtype != torch.float32 or dy.dtype != torch.float32:
        raise ValueError(f"layer_norm_bwd: the backward kernel takes float32, got {x.dtype}")
    if dy.shape != x.shape or dy.device != x.device:
        raise ValueError(f"layer_norm_bwd: dy {tuple(dy.shape)} does not match x {tuple(x.shape)}")
    dy, x = dy.contiguous(), x.contiguous()
    rows = x.numel() // width
    dx = torch.empty_like(x)
    dw, db = (torch.empty if rows else torch.zeros)((2, width), dtype=torch.float32, device=x.device)
    if rows:
        index = x.device.index if x.device.index is not None else torch.cuda.current_device()
        blocks = _bwd_capacity(index, width)
        part = torch.empty((2, blocks, width), dtype=torch.float32, device=x.device)
        err = _cuda.call(x.device, _lib().mmf_layer_norm_bwd, dy.data_ptr(), x.data_ptr(),
                         weight.contiguous().data_ptr(), mu.data_ptr(), rstd.data_ptr(),
                         dx.data_ptr(), dw.data_ptr(), db.data_ptr(), part.data_ptr(), rows, width,
                         blocks)
        _cuda.check(err, "layer_norm backward kernel")
        layer_norm_bwd.launches += 1
    return dx, dw, db


layer_norm_bwd.launches = 0


class _FusedLayerNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, weight, bias, eps):
        y, mu, rstd = layer_norm_fwd(x, weight, bias, eps)
        ctx.save_for_backward(x, weight, mu, rstd)
        return y

    @staticmethod
    def backward(ctx, dy):
        x, weight, mu, rstd = ctx.saved_tensors
        dx, dw, db = layer_norm_bwd(dy, x, weight, mu, rstd)
        return dx, dw, db, None


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-6, impl: str = "auto") -> torch.Tensor:
    """flax's LayerNorm of ``x`` [..., D] (``plain_layer_norm``'s function):
    with ``impl="auto"``, the plain version on CPU tensors and K5 on CUDA
    tensors; with ``impl="plain"``, the plain version on any device.  K5
    raises under ``torch.export`` or ``torch.compile``, which cannot trace
    its ctypes launch: a traced caller asks for ``"plain"``."""
    if impl not in IMPLS:
        raise ValueError(f"layer_norm: unknown impl {impl!r}, expected one of {IMPLS}")
    if impl == "plain" or x.device.type == "cpu":
        return plain_layer_norm(x, weight, bias, eps)
    if torch.compiler.is_compiling():
        raise RuntimeError("layer_norm: K5 launches through ctypes, which a trace cannot enter; "
                           "trace with impl='plain' (LayerNorm.impl)")
    return _FusedLayerNorm.apply(x, weight, bias, eps)


layer_norm.launches = 0

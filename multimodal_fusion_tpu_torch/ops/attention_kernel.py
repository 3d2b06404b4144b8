"""Fused attention forward: the wrapper of CUDA kernel K3.

The kernel (``csrc/attention.cu``) replaces the Pallas TPU kernel
``_attn_kernel`` (pallas_attention.py:130, called at :347 from
``_fused_attention_hxd``).  ``attention_fwd`` launches it on CUDA tensors
and takes ``ops.attention.plain_fused_attention`` on CPU tensors; on a
CUDA tensor it launches the kernel or raises.  ``attention_fwd.launches``
counts the launches.

The kernel reads q, k and v in place through their strides (the head dim
must be contiguous), so slices of a fused [B, T, 3, H, hd] projection go in
without a copy.  o comes back as a contiguous [B, Tq, H, hd] (or
[Tq, H, hd]) in the input dtype, m and l as float32 [B, H, Tq] (or
[H, Tq]).
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from multimodal_fusion_tpu_torch.ops import _cuda
from multimodal_fusion_tpu_torch.ops.attention import (
    _drop_threshold,
    batched_layout,
    plain_fused_attention,
)

MAX_HEAD_DIM = 128


def _lib():
    lib = _cuda.load("attention")
    fn = lib.mmf_attention_fwd
    fn.argtypes = (
        [ctypes.c_int] + [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 + [ctypes.c_longlong] * 10
        + [ctypes.c_float, ctypes.c_float, ctypes.c_uint, ctypes.c_uint, ctypes.c_int,
           ctypes.c_void_p]
    )
    fn.restype = ctypes.c_int
    return lib


def attention_fwd(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    kv_mask: Optional[torch.Tensor] = None,
    *,
    scale: Optional[float] = None,
    dropout_rate: float = 0.0,
    seed: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(o, m, l) of K3 for q [(B,) Tq, H, hd], k and v [(B,) Tk, H, hd] and
    an optional kv_mask [(B,) Tk] (True = keep).  ``seed`` is the int32
    dropout seed, needed when ``dropout_rate`` > 0."""
    if q.device.type == "cpu":
        return plain_fused_attention(q, k, v, kv_mask, scale=scale, dropout_rate=dropout_rate,
                                     seed=seed)
    if q.device.type != "cuda":
        raise ValueError(f"attention_fwd: unsupported device {q.device}")
    if any(t.device != q.device for t in (k, v)):
        raise ValueError("attention_fwd: q, k and v on different devices")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"attention_fwd: q, k, v must share float32 or bfloat16, got "
                         f"{q.dtype}, {k.dtype}, {v.dtype}")
    q, k, v, kv_mask, unbatched = batched_layout(q, k, v, kv_mask)
    b, t_q, heads, hd = q.shape
    t_k = k.shape[1]
    if hd > MAX_HEAD_DIM:
        raise ValueError(f"attention_fwd: head dim {hd} > {MAX_HEAD_DIM}")
    if scale is None:
        scale = 1.0 / (hd ** 0.5)
    rate = float(dropout_rate)
    threshold = _drop_threshold(rate)
    if rate > 0.0 and seed is None:
        raise ValueError("dropout_rate > 0 requires a seed")
    q, k, v = (t if t.stride(-1) == 1 else t.contiguous() for t in (q, k, v))
    o = torch.empty((b, t_q, heads, hd), dtype=q.dtype, device=q.device)
    m = torch.empty((b, heads, t_q), dtype=torch.float32, device=q.device)
    l = torch.empty((b, heads, t_q), dtype=torch.float32, device=q.device)
    if kv_mask is not None:
        kv_mask = kv_mask.to(torch.uint8).contiguous()
        mask_ptr, mask_sb = kv_mask.data_ptr(), (t_k if kv_mask.shape[0] > 1 else 0)
    else:
        mask_ptr, mask_sb = None, 0
    if b * t_q * heads > 0:
        lib = _lib()
        with torch.cuda.device(q.device):
            stream = torch.cuda.current_stream().cuda_stream
            err = lib.mmf_attention_fwd(
                int(q.dtype == torch.bfloat16), q.data_ptr(), k.data_ptr(), v.data_ptr(),
                mask_ptr, o.data_ptr(), m.data_ptr(), l.data_ptr(),
                b, heads, t_q, t_k, hd,
                q.stride(0), q.stride(1), q.stride(2),
                k.stride(0), k.stride(1), k.stride(2),
                v.stride(0), v.stride(1), v.stride(2), mask_sb,
                float(scale), float(1.0 / (1.0 - rate)), threshold,
                (int(seed) & 0xFFFFFFFF) if rate > 0.0 else 0, int(rate > 0.0), stream,
            )
        _cuda.check(err, "attention kernel")
        attention_fwd.launches += 1
    if unbatched:
        return o[0], m[0], l[0]
    return o, m, l


attention_fwd.launches = 0

"""Fused attention forward and backward: the wrappers of CUDA kernels K3
and K4.

K3 (``csrc/attention.cu``) replaces the Pallas TPU kernel ``_attn_kernel``
(pallas_attention.py:130, called at :347 from ``_fused_attention_hxd``);
K4 (``csrc/attention_bwd.cu``) replaces ``_attn_bwd_kernel`` (:373, called
at :553 from ``_fused_attention_bwd_hxd``).  ``attention_fwd`` and
``attention_bwd`` launch them on CUDA tensors and take the plain versions
(``ops.attention.plain_fused_attention``, ``plain_fused_attention_bwd``)
on CPU tensors; on a CUDA tensor they launch the kernel or raise.
``attention_fwd.launches`` and ``attention_bwd.launches`` count the
wrapper calls that launched (K4 is two kernel launches behind one call).

The kernels read q, k, v (and do) in place through their strides (the
head dim must be contiguous), so slices of a fused [B, T, 3, H, hd]
projection go in without a copy.  o, dq, dk and dv come back contiguous
[B, T, H, hd] (or [T, H, hd]) in the input dtype; m, l and dsum are
float32 [B, H, Tq] (or [H, Tq]).  The dropout seed is one int32 for the
batch or an int32 tensor [B] of per-case seeds.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from multimodal_fusion_tpu_torch.ops import _cuda
from multimodal_fusion_tpu_torch.ops.attention import (
    _check_seeds,
    _drop_threshold,
    batched_layout,
    plain_fused_attention,
    plain_fused_attention_bwd,
)

MAX_HEAD_DIM = 128


_TAIL = [ctypes.c_float, ctypes.c_float, ctypes.c_uint, ctypes.c_uint, ctypes.c_int, ctypes.c_void_p]


def _lib():
    lib = _cuda.load("attention")
    fn = lib.mmf_attention_fwd
    fn.argtypes = (
        [ctypes.c_int] + [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5 + [ctypes.c_longlong] * 10 + _TAIL
    )
    fn.restype = ctypes.c_int
    return lib


def _bwd_lib():
    lib = _cuda.load("attention_bwd")
    fn = lib.mmf_attention_bwd
    fn.argtypes = (
        [ctypes.c_int] + [ctypes.c_void_p] * 12 + [ctypes.c_int] * 5 + [ctypes.c_longlong] * 13 + _TAIL
    )
    fn.restype = ctypes.c_int
    return lib


def _check_inputs(name: str, q, *others) -> None:
    if q.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {q.device}")
    if any(t.device != q.device for t in others):
        raise ValueError(f"{name}: inputs on different devices")
    if not all(t.dtype == q.dtype for t in others) or q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"{name}: inputs must share float32 or bfloat16, got "
                         f"{[t.dtype for t in (q, *others)]}")


def _mask_arg(kv_mask, t_k):
    """(mask tensor kept alive, its pointer, its batch stride)."""
    if kv_mask is None:
        return None, None, 0
    kv_mask = kv_mask.to(torch.uint8).contiguous()
    return kv_mask, kv_mask.data_ptr(), (t_k if kv_mask.shape[0] > 1 else 0)


def _seed_args(seed, rate, b, device):
    """(seeds tensor kept alive, its pointer, the scalar seed as uint32)."""
    if rate <= 0.0:
        return None, None, 0
    if seed is None:
        raise ValueError("dropout_rate > 0 requires a seed")
    if isinstance(seed, torch.Tensor):
        _check_seeds(seed, b)
        seeds = seed.to(device=device, dtype=torch.int32).contiguous()
        return seeds, seeds.data_ptr(), 0
    return None, None, int(seed) & 0xFFFFFFFF


def _contiguous_hd(*ts):
    return tuple(t if t.stride(-1) == 1 else t.contiguous() for t in ts)


def attention_fwd(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    kv_mask: Optional[torch.Tensor] = None,
    *,
    scale: Optional[float] = None,
    dropout_rate: float = 0.0,
    seed=None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(o, m, l) of K3 for q [(B,) Tq, H, hd], k and v [(B,) Tk, H, hd] and
    an optional kv_mask [(B,) Tk] (True = keep).  ``seed`` is the int32
    dropout seed or an int32 tensor [B] of per-case seeds, needed when
    ``dropout_rate`` > 0."""
    if q.device.type == "cpu":
        return plain_fused_attention(q, k, v, kv_mask, scale=scale, dropout_rate=dropout_rate,
                                     seed=seed)
    _check_inputs("attention_fwd", q, k, v)
    q, k, v, kv_mask, unbatched = batched_layout(q, k, v, kv_mask)
    b, t_q, heads, hd = q.shape
    t_k = k.shape[1]
    if hd > MAX_HEAD_DIM:
        raise ValueError(f"attention_fwd: head dim {hd} > {MAX_HEAD_DIM}")
    if scale is None:
        scale = 1.0 / (hd ** 0.5)
    rate = float(dropout_rate)
    threshold = _drop_threshold(rate)
    seeds, seeds_ptr, seed_u32 = _seed_args(seed, rate, b, q.device)
    q, k, v = _contiguous_hd(q, k, v)
    o = torch.empty((b, t_q, heads, hd), dtype=q.dtype, device=q.device)
    m = torch.empty((b, heads, t_q), dtype=torch.float32, device=q.device)
    l = torch.empty((b, heads, t_q), dtype=torch.float32, device=q.device)
    kv_mask, mask_ptr, mask_sb = _mask_arg(kv_mask, t_k)
    if b * t_q * heads > 0:
        lib = _lib()
        with torch.cuda.device(q.device):
            stream = torch.cuda.current_stream().cuda_stream
            err = lib.mmf_attention_fwd(
                int(q.dtype == torch.bfloat16), q.data_ptr(), k.data_ptr(), v.data_ptr(),
                mask_ptr, seeds_ptr, o.data_ptr(), m.data_ptr(), l.data_ptr(),
                b, heads, t_q, t_k, hd,
                q.stride(0), q.stride(1), q.stride(2),
                k.stride(0), k.stride(1), k.stride(2),
                v.stride(0), v.stride(1), v.stride(2), mask_sb,
                float(scale), float(1.0 / (1.0 - rate)), threshold, seed_u32, int(rate > 0.0),
                stream,
            )
        _cuda.check(err, "attention kernel")
        attention_fwd.launches += 1
    if unbatched:
        return o[0], m[0], l[0]
    return o, m, l


attention_fwd.launches = 0


def attention_bwd(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    do: torch.Tensor,
    m: torch.Tensor,
    l: torch.Tensor,
    dsum: torch.Tensor,
    kv_mask: Optional[torch.Tensor] = None,
    *,
    scale: Optional[float] = None,
    dropout_rate: float = 0.0,
    seed=None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) of K4 for q and do [(B,) Tq, H, hd], k and v
    [(B,) Tk, H, hd], the forward's m and l and dsum = rowsum(do * o)
    (float32 [(B,) H, Tq]), the forward's kv_mask and dropout seed."""
    if q.device.type == "cpu":
        return plain_fused_attention_bwd(q, k, v, do, m, l, dsum, kv_mask, scale=scale,
                                         dropout_rate=dropout_rate, seed=seed)
    _check_inputs("attention_bwd", q, k, v, do)
    q, k, v, kv_mask, unbatched = batched_layout(q, k, v, kv_mask)
    if unbatched:
        do, m, l, dsum = do[None], m[None], l[None], dsum[None]
    b, t_q, heads, hd = q.shape
    t_k = k.shape[1]
    if do.shape != q.shape:
        raise ValueError(f"attention_bwd: do {tuple(do.shape)} does not match q {tuple(q.shape)}")
    stats = []
    for name, t in (("m", m), ("l", l), ("dsum", dsum)):
        if t.shape != (b, heads, t_q) or t.device != q.device:
            raise ValueError(f"attention_bwd: {name} {tuple(t.shape)} on {t.device}, expected "
                             f"[{b}, {heads}, {t_q}] on {q.device}")
        stats.append(t.to(torch.float32).contiguous())
    m, l, dsum = stats
    if hd > MAX_HEAD_DIM:
        raise ValueError(f"attention_bwd: head dim {hd} > {MAX_HEAD_DIM}")
    if scale is None:
        scale = 1.0 / (hd ** 0.5)
    rate = float(dropout_rate)
    threshold = _drop_threshold(rate)
    seeds, seeds_ptr, seed_u32 = _seed_args(seed, rate, b, q.device)
    q, k, v, do = _contiguous_hd(q, k, v, do)
    dq = torch.empty((b, t_q, heads, hd), dtype=q.dtype, device=q.device)
    dk = torch.empty((b, t_k, heads, hd), dtype=q.dtype, device=q.device)
    dv = torch.empty((b, t_k, heads, hd), dtype=q.dtype, device=q.device)
    kv_mask, mask_ptr, mask_sb = _mask_arg(kv_mask, t_k)
    if b * heads * (t_q + t_k) > 0:
        lib = _bwd_lib()
        with torch.cuda.device(q.device):
            stream = torch.cuda.current_stream().cuda_stream
            err = lib.mmf_attention_bwd(
                int(q.dtype == torch.bfloat16), q.data_ptr(), k.data_ptr(), v.data_ptr(),
                do.data_ptr(), mask_ptr, seeds_ptr, m.data_ptr(), l.data_ptr(), dsum.data_ptr(),
                dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                b, heads, t_q, t_k, hd,
                q.stride(0), q.stride(1), q.stride(2),
                k.stride(0), k.stride(1), k.stride(2),
                v.stride(0), v.stride(1), v.stride(2),
                do.stride(0), do.stride(1), do.stride(2), mask_sb,
                float(scale), float(1.0 / (1.0 - rate)), threshold, seed_u32, int(rate > 0.0),
                stream,
            )
        _cuda.check(err, "attention backward kernel")
        attention_bwd.launches += 1
    if unbatched:
        return dq[0], dk[0], dv[0]
    return dq, dk, dv


attention_bwd.launches = 0

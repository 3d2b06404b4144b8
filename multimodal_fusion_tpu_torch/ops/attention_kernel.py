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
wrapper calls that launched (one call may be two kernel launches), and
``.route_launches`` counts them per route.  The tracer's counter
``attention_fwd.run_listed`` (``utils.profiling.count``) counts K3's float32
``general`` launches with a key mask: those list the runs of 16 keys that
hold a valid key and skip the rest.  The tracer's counter
``attention_bwd.one_pass`` counts K4's float32 ``general`` calls that take
one pass (each pair of a q row and a key formed once; the kernel chooses it
by shape, where the short side's gradient fits its shared memory, as at
mfmf_config1's blocks 2 and 3); the wrapper knows them by their workspace,
the general route's only one.

Routes (``_route``): where one side is at most ``NARROW`` (16) rows or
keys, the narrow routes keep that side whole in shared memory and spread
the long side over the threads (``narrow_q``: Tq <= 16, MFMF's blocks 1
and 2; ``narrow_k``: Tk <= 16, its block 3); otherwise the general route
tiles both sides (the ViT).  ``route=`` forces one, as the card tests do to
hold the routes against each other on the same inputs.

The kernels read q, k, v (and do) in place through their strides when
every row is 16-byte aligned (the head dim contiguous, the base pointer
and each stride a multiple of 16 bytes), so slices of a fused [B, T, 3, H,
hd] projection go in without a copy; otherwise the wrapper copies the
tensor to a contiguous one with hd padded to 16 bytes.  o, dq, dk and dv
come back contiguous [B, T, H, hd] (or [T, H, hd]) in the input dtype; m,
l and dsum are
float32 [B, H, Tq] (or [H, Tq]).  The dropout seed is one int32 for the
batch or an int32 tensor [B] of per-case seeds.
"""

from __future__ import annotations

import ctypes
import functools
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
from multimodal_fusion_tpu_torch.utils import profiling

MAX_HEAD_DIM = 128
NARROW = 16  # mirrors csrc/attention_common.cuh: NARROW
ROUTES = ("general", "narrow_q", "narrow_k")  # index = the C entries' route code


def _route(t_q: int, t_k: int, hd: int) -> str:
    """The kernels' route for a shape: ``narrow_k`` when Tk <= NARROW and
    Tk <= Tq, ``narrow_q`` when Tq <= NARROW (and Tq < Tk), else
    ``general``."""
    if hd > MAX_HEAD_DIM:
        raise ValueError(f"attention: head dim {hd} > {MAX_HEAD_DIM}")
    if min(t_q, t_k) > NARROW:
        return "general"
    return "narrow_k" if t_k <= t_q else "narrow_q"


def _check_route(route: Optional[str], t_q: int, t_k: int, hd: int) -> str:
    """``route`` itself if the shape allows it, the shape's route if None."""
    by_shape = _route(t_q, t_k, hd)
    if route is None:
        return by_shape
    if route not in ROUTES:
        raise ValueError(f"attention: unknown route {route!r}, expected one of {ROUTES}")
    if (route == "narrow_q" and t_q > NARROW) or (route == "narrow_k" and t_k > NARROW):
        raise ValueError(f"attention: route {route!r} needs its narrow side <= {NARROW}, got "
                         f"Tq {t_q}, Tk {t_k}")
    return route


_TAIL = [ctypes.c_float, ctypes.c_float, ctypes.c_uint, ctypes.c_uint, ctypes.c_int, ctypes.c_void_p]


@functools.cache  # loaded and typed once per process
def _lib():
    lib = _cuda.load("attention")
    fn = lib.mmf_attention_fwd
    fn.argtypes = (
        [ctypes.c_int] * 2 + [ctypes.c_void_p] * 9 + [ctypes.c_int] * 5 + [ctypes.c_longlong] * 10 + _TAIL
    )
    fn.restype = ctypes.c_int
    lib.mmf_attention_fwd_workspace.argtypes = [ctypes.c_int] * 6  # route, B, H, Tq, Tk, hd
    lib.mmf_attention_fwd_workspace.restype = ctypes.c_longlong
    return lib


@functools.cache
def _bwd_lib():
    lib = _cuda.load("attention_bwd")
    fn = lib.mmf_attention_bwd
    fn.argtypes = (
        [ctypes.c_int] * 2 + [ctypes.c_void_p] * 13 + [ctypes.c_int] * 5 + [ctypes.c_longlong] * 13 + _TAIL
    )
    fn.restype = ctypes.c_int
    lib.mmf_attention_bwd_workspace.argtypes = [ctypes.c_int] * 7  # is_bf16, route, B, H, Tq, Tk, hd
    lib.mmf_attention_bwd_workspace.restype = ctypes.c_longlong
    return lib


def _workspace(size_fn, *args, device):
    """(float32 workspace kept alive, its pointer) of ``size_fn(*args)``
    bytes; (None, None) for none."""
    nbytes = int(size_fn(*args))
    if nbytes == 0:
        return None, None
    ws = torch.empty(nbytes // 4, dtype=torch.float32, device=device)
    return ws, ws.data_ptr()


def _check_inputs(name: str, q, *others) -> None:
    if q.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {q.device}")
    if any(t.device != q.device for t in others):
        raise ValueError(f"{name}: inputs on different devices")
    if not all(t.dtype == q.dtype for t in others) or q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"{name}: inputs must share float32 or bfloat16, got "
                         f"{[t.dtype for t in (q, *others)]}")


def _mask_arg(kv_mask, t_k):
    """(mask tensor kept alive, its pointer, its batch stride).  The kernels
    read one byte per key, 0 = masked: the bool mask of ``batched_layout``
    as it is."""
    if kv_mask is None:
        return None, None, 0
    kv_mask = kv_mask.contiguous()
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


def _aligned_rows(*ts):
    """Each tensor [B, T, H, hd] as it is when every row it holds starts on
    16 bytes (base pointer and batch, token and head strides multiples of
    16 bytes, hd contiguous), else a contiguous copy with hd zero-padded to
    a multiple of 16 bytes (the kernels read hd from the caller and never
    the padding)."""
    out = []
    for t in ts:
        size = t.element_size()
        if (t.stride(-1) == 1 and t.data_ptr() % 16 == 0
                and all(st * size % 16 == 0 for st in t.stride()[:3])):
            out.append(t)
            continue
        per = 16 // size
        pad = -t.shape[-1] % per
        out.append(torch.nn.functional.pad(t, (0, pad)) if pad
                   else t.clone(memory_format=torch.contiguous_format))
    return tuple(out)


def attention_fwd(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    kv_mask: Optional[torch.Tensor] = None,
    *,
    scale: Optional[float] = None,
    dropout_rate: float = 0.0,
    seed=None,
    route: Optional[str] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(o, m, l) of K3 for q [(B,) Tq, H, hd], k and v [(B,) Tk, H, hd] and
    an optional kv_mask [(B,) Tk] (True = keep).  ``seed`` is the int32
    dropout seed or an int32 tensor [B] of per-case seeds, needed when
    ``dropout_rate`` > 0.  ``route``: one of ``ROUTES``, or None for the
    shape's own (``_route``)."""
    if q.device.type == "cpu":
        if route is not None:  # the plain version serves every route
            _check_route(route, q.shape[-3], k.shape[-3], q.shape[-1])
        return plain_fused_attention(q, k, v, kv_mask, scale=scale, dropout_rate=dropout_rate,
                                     seed=seed)
    _check_inputs("attention_fwd", q, k, v)
    q, k, v, kv_mask, unbatched = batched_layout(q, k, v, kv_mask)
    b, t_q, heads, hd = q.shape
    t_k = k.shape[1]
    route = _check_route(route, t_q, t_k, hd)
    code = ROUTES.index(route)
    if scale is None:
        scale = 1.0 / (hd ** 0.5)
    rate = float(dropout_rate)
    threshold = _drop_threshold(rate)
    seeds, seeds_ptr, seed_u32 = _seed_args(seed, rate, b, q.device)
    q, k, v = _aligned_rows(q, k, v)
    o = torch.empty((b, t_q, heads, hd), dtype=q.dtype, device=q.device)
    m, l = torch.empty((2, b, heads, t_q), dtype=torch.float32, device=q.device)
    kv_mask, mask_ptr, mask_sb = _mask_arg(kv_mask, t_k)
    if b * t_q * heads > 0:
        lib = _lib()
        ws, ws_ptr = _workspace(lib.mmf_attention_fwd_workspace, code, b, heads, t_q, t_k, hd,
                                device=q.device)
        err = _cuda.call(
            q.device, lib.mmf_attention_fwd,
            int(q.dtype == torch.bfloat16), code, q.data_ptr(), k.data_ptr(), v.data_ptr(),
            mask_ptr, seeds_ptr, o.data_ptr(), m.data_ptr(), l.data_ptr(), ws_ptr,
            b, heads, t_q, t_k, hd, *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], mask_sb,
            float(scale), float(1.0 / (1.0 - rate)), threshold, seed_u32, int(rate > 0.0),
        )
        _cuda.check(err, "attention kernel")
        attention_fwd.launches += 1
        attention_fwd.route_launches[route] += 1
        if route == "general" and mask_ptr is not None and q.dtype == torch.float32:
            profiling.count("attention_fwd.run_listed")
    if unbatched:
        return o[0], m[0], l[0]
    return o, m, l


attention_fwd.launches = 0
attention_fwd.route_launches = dict.fromkeys(ROUTES, 0)


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
    route: Optional[str] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) of K4 for q and do [(B,) Tq, H, hd], k and v
    [(B,) Tk, H, hd], the forward's m and l and dsum = rowsum(do * o)
    (float32 [(B,) H, Tq]), the forward's kv_mask and dropout seed.
    ``route``: one of ``ROUTES``, or None for the shape's own."""
    if q.device.type == "cpu":
        if route is not None:  # the plain version serves every route
            _check_route(route, q.shape[-3], k.shape[-3], q.shape[-1])
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
    route = _check_route(route, t_q, t_k, hd)
    code = ROUTES.index(route)
    if scale is None:
        scale = 1.0 / (hd ** 0.5)
    rate = float(dropout_rate)
    threshold = _drop_threshold(rate)
    seeds, seeds_ptr, seed_u32 = _seed_args(seed, rate, b, q.device)
    q, k, v, do = _aligned_rows(q, k, v, do)
    dq = torch.empty((b, t_q, heads, hd), dtype=q.dtype, device=q.device)
    dk = torch.empty((b, t_k, heads, hd), dtype=q.dtype, device=q.device)
    dv = torch.empty((b, t_k, heads, hd), dtype=q.dtype, device=q.device)
    kv_mask, mask_ptr, mask_sb = _mask_arg(kv_mask, t_k)
    if b * heads * (t_q + t_k) > 0:
        lib = _bwd_lib()
        is_bf16 = int(q.dtype == torch.bfloat16)
        ws, ws_ptr = _workspace(lib.mmf_attention_bwd_workspace, is_bf16, code, b, heads, t_q, t_k, hd,
                                device=q.device)
        err = _cuda.call(
            q.device, lib.mmf_attention_bwd,
            is_bf16, code, q.data_ptr(), k.data_ptr(), v.data_ptr(),
            do.data_ptr(), mask_ptr, seeds_ptr, m.data_ptr(), l.data_ptr(), dsum.data_ptr(),
            dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), ws_ptr,
            b, heads, t_q, t_k, hd, *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            *do.stride()[:3], mask_sb,
            float(scale), float(1.0 / (1.0 - rate)), threshold, seed_u32, int(rate > 0.0),
        )
        _cuda.check(err, "attention backward kernel")
        attention_bwd.launches += 1
        attention_bwd.route_launches[route] += 1
        if route == "general" and ws is not None:
            profiling.count("attention_bwd.one_pass")
    if unbatched:
        return dq[0], dk[0], dv[0]
    return dq, dk, dv


attention_bwd.launches = 0
attention_bwd.route_launches = dict.fromkeys(ROUTES, 0)

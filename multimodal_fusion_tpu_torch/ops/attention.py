"""Multi-head attention: plain formulations and the dispatch.

Counterpart of ``multimodal_fusion_tpu.ops.pallas_attention``.  The public
layout is the JAX package's, [Tq, H, hd] for q and [Tk, H, hd] for k and v,
plus an optional leading batch dimension B that takes the place of
``jax.vmap``; a ``kv_mask`` (True = keep) is [Tk] or [B, Tk].

- ``plain_fused_attention`` is the plain PyTorch version of the fused
  kernel K3 (``_attn_kernel``): scores and softmax in float32, an online
  softmax over 512-key chunks from a -1e30 running max, masked scores
  REPLACED by ``NEG_INF``, the pre-dropout exp-sum ``l`` kept apart from
  the row max ``m``, the 1/l normalisation deferred to the end, the hash
  dropout applied to the unnormalised probabilities after ``l`` is summed,
  and p cast to v's dtype before the P.V product.  It returns (o, m, l).
- ``plain_fused_attention_bwd`` is the plain version of the backward
  kernel K4 (``_attn_bwd_kernel``): p = exp(s - m) / l recomputed per
  512-key chunk from the saved row statistics, ds = p (dp - dsum) scale
  with dsum = rowsum(do * o) given, zero cotangent on masked keys, the same
  hash dropout mask, ds rounded to k's dtype before the dq and dk products
  and the dropped p to do's dtype before the dv product.
- ``fused_attention`` goes through ``FusedAttention``, a
  ``torch.autograd.Function``: its forward is K3 (``ops.attention_kernel``)
  on CUDA tensors and the plain version on CPU tensors; it saves q, k, v,
  o, m, l, the mask and the seeds, and its backward computes dsum in
  PyTorch and runs K4 (the plain version on CPU tensors).  kv_mask and the
  seeds get no gradient.
- ``xla_attention`` is the einsum -> softmax -> einsum formulation, with
  Bernoulli dropout drawn from a ``torch.Generator``.
- ``attention`` dispatches by ``impl`` as the JAX package does, except that
  ``auto`` launches K3 on every CUDA tensor: the JAX package's crossover
  (``AUTO_MIN_SCORE_ELEMS``) was measured on a TPU and does not carry over.

Dropout mask: a murmur3 fmix32 hash of the absolute (head, q, k) index with
uint32 wraparound, so any tiling draws the same mask.  The seed is either
one int32 for the whole batch or an int32 tensor [B] with one seed per
case.  Under ``jax.vmap`` with one unbatched key the JAX kernel hashes the
same (head, q, k) indices with the same seed for every batch element, so
every case draws the same mask (a scalar seed here); with per-case keys,
as the survival trainer vmaps them, each case's ``fused_attention`` draws
its own seed (pallas_attention.py:658) and so its own mask (a seed tensor
[B] here).
"""

from __future__ import annotations

import contextlib
import contextvars
from typing import Optional, Tuple, Union

import torch

from multimodal_fusion_tpu_torch.ops.masked import NEG_INF

VALID_IMPLS = ("auto", "xla", "pallas", "pallas_interpret")

K_CHUNK = 512  # keys per online-softmax step (pallas_attention._K_CHUNK)
INIT_MAX = -1e30  # running-max start: a fully masked chunk never forms inf - inf
_U32 = 0xFFFFFFFF

# an int32 dropout seed, an int32 tensor [B] of per-case seeds, or a
# generator to draw one seed from
Seed = Union[int, torch.Tensor, torch.Generator, None]


# ---------------------------------------------------------------------------
# Hash dropout mask, bit-exact with pallas_attention._keep_mask.  uint32
# arithmetic is emulated in int64: every value stays in [0, 2**32).
# ---------------------------------------------------------------------------


def _drop_threshold(rate: float) -> int:
    """uint32 threshold: keep iff hash >= threshold, P(keep) = 1 - rate."""
    if not 0.0 <= rate < 1.0:
        raise ValueError(f"dropout rate must be in [0, 1), got {rate}")
    return min(int(round(rate * 2.0 ** 32)), 2 ** 32 - 1)


def _mul32(a: torch.Tensor, c: int) -> torch.Tensor:
    """(a * c) mod 2**32 for int64 ``a`` in [0, 2**32) and a constant ``c``,
    split in 16-bit halves so no intermediate leaves int64."""
    c &= _U32
    lo = a & 0xFFFF
    hi = a >> 16
    return (lo * c + (((hi * c) & 0xFFFF) << 16)) & _U32


def _hash_keep(z: torch.Tensor, threshold: int) -> torch.Tensor:
    """murmur3 fmix32 avalanche over uint32 values (in int64) -> keep mask."""
    z = z ^ (z >> 16)
    z = _mul32(z, 0x85EBCA6B)
    z = z ^ (z >> 13)
    z = _mul32(z, 0xC2B2AE35)
    z = z ^ (z >> 16)
    return z >= threshold


def _seed_u32(seed, device=None) -> torch.Tensor:
    """A scalar seed or a [B] seed tensor as uint32 values in int64, shaped
    [1 or B, 1, 1, 1] to broadcast over [B, H, Q, K]."""
    if isinstance(seed, torch.Tensor):
        return (seed.to(device=device, dtype=torch.int64) & _U32).view(-1, 1, 1, 1)
    return torch.tensor(int(seed) & _U32, dtype=torch.int64, device=device).view(1, 1, 1, 1)


def _keep_mask(seed, h0: int, q0: int, k0: int, shape, t_q: int, t_k: int,
               rate: float, device=None) -> torch.Tensor:
    """Keep mask [1 or B, H, Q, K] for an [H, Q, K] block at absolute
    offsets (h0, q0, k0); ``seed`` is a scalar or a [B] tensor of per-case
    seeds."""
    kw = dict(dtype=torch.int64, device=device)
    h_idx = (h0 + torch.arange(shape[0], **kw)).view(-1, 1, 1) & _U32
    q_idx = (q0 + torch.arange(shape[1], **kw)).view(1, -1, 1) & _U32
    k_idx = (k0 + torch.arange(shape[2], **kw)).view(1, 1, -1) & _U32
    lin = (_mul32(h_idx, t_q) + q_idx) & _U32
    lin = (_mul32(lin, t_k) + k_idx) & _U32
    z = (_mul32(lin, 0x9E3779B9)[None] + _seed_u32(seed, device)) & _U32
    return _hash_keep(z, _drop_threshold(rate))


def dropout_keep_reference(seed: int, heads: int, t_q: int, t_k: int, rate: float,
                           device=None) -> torch.Tensor:
    """The kernels' full [H, Tq, Tk] keep mask for a seed (an int32 as the
    JAX wrapper draws it, or its uint32 value)."""
    return _keep_mask(seed, 0, 0, 0, (heads, t_q, t_k), t_q, t_k, rate, device)[0]


def draw_seed(seed: Seed):
    """The dropout seed: ``seed`` itself (an int32, or an int32 tensor [B]
    of per-case seeds), or one int32 drawn from a ``torch.Generator`` (the
    counterpart of the JAX wrapper's ``jax.random.bits`` draw,
    pallas_attention.py:658)."""
    if isinstance(seed, torch.Generator):
        return int(torch.randint(-2 ** 31, 2 ** 31, (1,), generator=seed,
                                 device=seed.device, dtype=torch.int64).item())
    if seed is None:
        raise ValueError("dropout_rate > 0 requires a seed")
    if isinstance(seed, torch.Tensor):
        if seed.dim() != 1 or seed.dtype not in (torch.int32, torch.int64):
            raise ValueError(f"per-case seeds must be an integer tensor [B], got "
                             f"{seed.dtype} {tuple(seed.shape)}")
        return seed
    return int(seed)


def draw_case_seeds(generator: torch.Generator, n: int) -> torch.Tensor:
    """``n`` int32 per-case dropout seeds drawn from ``generator`` on its
    device."""
    return torch.randint(-2 ** 31, 2 ** 31, (n,), generator=generator,
                         device=generator.device, dtype=torch.int64).to(torch.int32)


# ---------------------------------------------------------------------------
# Layout helpers
# ---------------------------------------------------------------------------


def batched_layout(q, k, v, kv_mask):
    """Add the batch dimension to unbatched [T, H, hd] inputs and check the
    shapes.  Returns (q, k, v, kv_mask as bool [B or 1, Tk] or None,
    unbatched)."""
    unbatched = q.dim() == 3
    if unbatched:
        q, k, v = q[None], k[None], v[None]
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(f"attention: q/k/v must be [T, H, hd] or [B, T, H, hd], got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, _, h, hd = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[2] != h or k.shape[3] != hd:
        raise ValueError(f"attention: k {tuple(k.shape)} and v {tuple(v.shape)} do not "
                         f"match q {tuple(q.shape)}")
    if kv_mask is not None:
        kv_mask = kv_mask.to(device=q.device, dtype=torch.bool)
        if kv_mask.dim() == 1:
            kv_mask = kv_mask[None]
        if kv_mask.dim() != 2 or kv_mask.shape[1] != k.shape[1] or kv_mask.shape[0] not in (1, b):
            raise ValueError(f"attention: kv_mask {tuple(kv_mask.shape)} does not match "
                             f"k {tuple(k.shape)}")
    return q, k, v, kv_mask, unbatched


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------


def plain_fused_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    kv_mask: Optional[torch.Tensor] = None,
    *,
    scale: Optional[float] = None,
    dropout_rate: float = 0.0,
    seed=None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K3 in plain PyTorch.  Returns (o in the input layout and dtype,
    row max m, pre-dropout exp-sum l), m and l float32 [H, Tq] (or
    [B, H, Tq]).  ``seed``: an int32, or an int32 tensor [B] of per-case
    seeds."""
    q, k, v, kv_mask, unbatched = batched_layout(q, k, v, kv_mask)
    _check_seeds(seed, q.shape[0])
    _, t_q, heads, hd = q.shape
    t_k = k.shape[1]
    if scale is None:
        scale = 1.0 / (hd ** 0.5)
    rate = float(dropout_rate)
    _drop_threshold(rate)
    if rate > 0.0 and seed is None:
        raise ValueError("dropout_rate > 0 requires a seed")
    # [B, H, T, hd]; scores accumulate in float32 whatever the input dtype
    # (bf16 products are exact in float32)
    qh = q.permute(0, 2, 1, 3).float()
    kh = k.permute(0, 2, 1, 3).float()
    vh = v.permute(0, 2, 1, 3)
    shape = qh.shape[:3] + (1,)
    m = torch.full(shape, INIT_MAX, dtype=torch.float32, device=q.device)
    l = torch.zeros(shape, dtype=torch.float32, device=q.device)
    acc = torch.zeros(qh.shape, dtype=torch.float32, device=q.device)
    for c0 in range(0, t_k, K_CHUNK):
        c1 = min(c0 + K_CHUNK, t_k)
        s = (qh @ kh[:, :, c0:c1].transpose(-1, -2)) * scale
        if kv_mask is not None:
            s = torch.where(kv_mask[:, None, None, c0:c1], s, NEG_INF)  # REPLACE
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        pe = torch.exp(s - m_new)
        l = l * alpha + pe.sum(dim=-1, keepdim=True)
        if rate > 0.0:
            keep = _keep_mask(seed, 0, 0, c0, (heads, t_q, c1 - c0), t_q, t_k, rate, q.device)
            pe = torch.where(keep, pe * (1.0 / (1.0 - rate)), 0.0)
        acc = acc * alpha + pe.to(v.dtype).float() @ vh[:, :, c0:c1].float()
        m = m_new
    o = (acc * (1.0 / l)).to(q.dtype).permute(0, 2, 1, 3)
    m, l = m[..., 0], l[..., 0]
    if unbatched:
        return o[0], m[0], l[0]
    return o, m, l


def plain_fused_attention_bwd(
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
    """K4 in plain PyTorch.  q and do [(B,) Tq, H, hd], k and v
    [(B,) Tk, H, hd], the forward's m and l and dsum = rowsum(do * o), all
    float32 [(B,) H, Tq].  Returns (dq, dk, dv) in the inputs' layout and
    dtype."""
    q, k, v, kv_mask, unbatched = batched_layout(q, k, v, kv_mask)
    if unbatched:
        do, m, l, dsum = do[None], m[None], l[None], dsum[None]
    _check_seeds(seed, q.shape[0])
    _, t_q, heads, hd = q.shape
    t_k = k.shape[1]
    if scale is None:
        scale = 1.0 / (hd ** 0.5)
    rate = float(dropout_rate)
    _drop_threshold(rate)
    if rate > 0.0 and seed is None:
        raise ValueError("dropout_rate > 0 requires a seed")
    qh, kh, vh, doh = (x.permute(0, 2, 1, 3).float() for x in (q, k, v, do))
    m, dsum = m[..., None].float(), dsum[..., None].float()
    r = 1.0 / l[..., None].float()  # reciprocal once per row, as the kernels do
    dq = torch.zeros(qh.shape, dtype=torch.float32, device=q.device)
    dk = torch.zeros(kh.shape, dtype=torch.float32, device=q.device)
    dv = torch.zeros(kh.shape, dtype=torch.float32, device=q.device)
    inv = 1.0 / (1.0 - rate)
    for c0 in range(0, t_k, K_CHUNK):
        c1 = min(c0 + K_CHUNK, t_k)
        kc, vc = kh[:, :, c0:c1], vh[:, :, c0:c1]
        s = (qh @ kc.transpose(-1, -2)) * scale
        if kv_mask is not None:
            masked = ~kv_mask[:, None, None, c0:c1]
            s = torch.where(masked, NEG_INF, s)  # REPLACE
        p = torch.exp(s - m) * r
        dp = doh @ vc.transpose(-1, -2)  # dL/d(drop(p))
        pd = p
        if rate > 0.0:
            keep = _keep_mask(seed, 0, 0, c0, (heads, t_q, c1 - c0), t_q, t_k, rate, q.device)
            pd = torch.where(keep, p * inv, 0.0)
            dp = torch.where(keep, dp * inv, 0.0)
        ds = p * (dp - dsum) * scale
        if kv_mask is not None:
            ds = torch.where(masked, 0.0, ds)  # masked scores are constants
        ds = ds.to(k.dtype).float()
        pd = pd.to(do.dtype).float()
        dq += ds @ kc
        dk[:, :, c0:c1] = ds.transpose(-1, -2) @ qh
        dv[:, :, c0:c1] = pd.transpose(-1, -2) @ doh
    out = tuple(g.permute(0, 2, 1, 3).to(x.dtype) for g, x in ((dq, q), (dk, k), (dv, v)))
    if unbatched:
        return tuple(g[0] for g in out)
    return out


def _check_seeds(seed, b: int) -> None:
    if isinstance(seed, torch.Tensor) and seed.shape != (b,):
        raise ValueError(f"per-case seeds {tuple(seed.shape)} do not match batch {b}")


def xla_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    kv_mask: Optional[torch.Tensor] = None,
    dropout_rate: float = 0.0,
    generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """einsum -> softmax -> einsum in the input dtype, with inverted
    Bernoulli dropout on the probabilities drawn from ``generator``."""
    hd = q.shape[-1]
    scores = torch.einsum("...qhd,...khd->...hqk", q, k) / (hd ** 0.5)
    if kv_mask is not None:
        mask = kv_mask.to(device=q.device, dtype=torch.bool)
        scores = torch.where(mask[..., None, None, :], scores, NEG_INF)
    attn = torch.softmax(scores, dim=-1)
    if dropout_rate > 0.0 and generator is not None:
        keep = 1.0 - dropout_rate
        draw = torch.bernoulli(torch.full_like(attn, keep), generator=generator).bool()
        attn = torch.where(draw, attn / keep, 0.0)
    return torch.einsum("...hqk,...khd->...qhd", attn, v)


# ---------------------------------------------------------------------------
# Dispatch
# ---------------------------------------------------------------------------


class FusedAttention(torch.autograd.Function):
    """o = softmax(q k^T scale) v through K3, differentiable in q, k and v
    through K4 (the counterpart of the JAX custom VJP ``_attention_hxd``).
    ``plain`` selects the kernels' plain versions on any device; otherwise
    the kernels run on CUDA tensors and the plain versions on CPU
    tensors."""

    @staticmethod
    def forward(ctx, q, k, v, kv_mask, seed, scale, rate, plain):
        # imported here: the kernel module imports this one for its plain versions
        from multimodal_fusion_tpu_torch.ops.attention_kernel import attention_fwd

        fwd = plain_fused_attention if plain else attention_fwd
        o, m, l = fwd(q, k, v, kv_mask, scale=scale, dropout_rate=rate, seed=seed)
        ctx.save_for_backward(q, k, v, o, m, l)
        ctx.kv_mask, ctx.seed = kv_mask, seed
        ctx.scale, ctx.rate, ctx.plain = scale, rate, plain
        return o

    @staticmethod
    def backward(ctx, do):
        from multimodal_fusion_tpu_torch.ops.attention_kernel import attention_bwd

        q, k, v, o, m, l = ctx.saved_tensors
        # softmax-transpose row term sum_k(dL/dp * p) = rowsum(do * o), valid
        # through dropout (pallas_attention.py:593-598)
        dsum = (do.float() * o.float()).sum(-1).transpose(-1, -2).contiguous()  # [(B,) H, Tq]
        bwd = plain_fused_attention_bwd if ctx.plain else attention_bwd
        dq, dk, dv = bwd(q, k, v, do.to(q.dtype), m, l, dsum, ctx.kv_mask, scale=ctx.scale,
                         dropout_rate=ctx.rate, seed=ctx.seed)
        return dq, dk, dv, None, None, None, None, None


def fused_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    kv_mask: Optional[torch.Tensor] = None,
    *,
    scale: Optional[float] = None,
    dropout_rate: float = 0.0,
    seed: Seed = None,
    plain: bool = False,
) -> torch.Tensor:
    """softmax(q k^T / sqrt(hd)) v through K3 and, for its gradient, K4:
    the kernels on CUDA tensors, their plain versions on CPU tensors (or
    on any device with ``plain``)."""
    rate = float(dropout_rate)
    _drop_threshold(rate)
    seed_i = draw_seed(seed) if rate > 0.0 else None
    if scale is None:
        scale = 1.0 / (q.shape[-1] ** 0.5)
    return FusedAttention.apply(q, k, v, kv_mask, seed_i, float(scale), rate, plain)


# Escape hatch kept from the JAX package (GSPMD traces there): every impl
# resolves to 'xla' inside ``force_xla()``.
_FORCE_XLA: contextvars.ContextVar[bool] = contextvars.ContextVar(
    "mmf_torch_attention_force_xla", default=False
)


@contextlib.contextmanager
def force_xla():
    tok = _FORCE_XLA.set(True)
    try:
        yield
    finally:
        _FORCE_XLA.reset(tok)


def attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    kv_mask: Optional[torch.Tensor] = None,
    impl: str = "auto",
    dropout_rate: float = 0.0,
    seed: Seed = None,
    train: bool = False,
) -> torch.Tensor:
    """Multi-head attention with implementation dispatch.

    impl: 'auto' and 'pallas' run K3 and, for the gradient, K4 (the
    kernels on CUDA tensors, their plain versions on CPU tensors);
    'pallas_interpret' runs their plain versions on any device; 'xla' the
    einsum formulation, differentiated by autograd.  Dropout applies when
    ``train`` is set and a ``seed`` is given: K3 hashes an int32 seed, an
    int32 tensor [B] of per-case seeds, or one seed drawn from a generator;
    'xla' draws Bernoulli masks from a generator (or one seeded with the
    int)."""
    if _FORCE_XLA.get():
        impl = "xla"
    if impl not in VALID_IMPLS:
        raise ValueError(f"unknown attention impl {impl!r}")
    rate = float(dropout_rate) if (train and seed is not None) else 0.0
    if impl == "xla":
        gen = seed
        if rate > 0.0 and not isinstance(seed, torch.Generator):
            gen = torch.Generator(device=q.device).manual_seed(int(seed))
        return xla_attention(q, k, v, kv_mask, rate, gen)
    return fused_attention(q, k, v, kv_mask, dropout_rate=rate, seed=seed,
                           plain=impl == "pallas_interpret")

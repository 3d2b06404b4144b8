"""The port's attention backward (K4's plain version and the autograd
Function whose forward is K3 and whose backward is K4) against the JAX
package on the CPU.

The JAX side runs the Pallas kernels in interpret mode
(``_fused_attention_bwd_hxd(..., interpret=True)`` for K4 itself, and
``jax.grad`` through ``fused_attention(..., interpret=True)``, whose custom
VJP runs it); the port side runs ``plain_fused_attention_bwd`` and
``torch.autograd.grad`` through ``fused_attention``.  Inputs come from numpy
seeds.  Tolerances: float32 rtol 1e-5, atol 1e-5 (both sides sum the same
float32 products in other orders); bf16 relative L2 <= 2e-2 per output (ds
and p are rounded to bf16 before the second products on both sides, where
a last-bit difference in float32 can flip a rounding; the JAX kernel also
accumulates dk and dv in bf16 across its q tiles).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_fusion_tpu.ops import pallas_attention as jpa
from multimodal_fusion_tpu.ops.masked import NEG_INF as JAX_NEG_INF
from multimodal_fusion_tpu_torch.ops import attention as tpa
from multimodal_fusion_tpu_torch.ops.attention_kernel import attention_bwd, attention_fwd


def _seed_of(key) -> int:
    """The int32 seed ``fused_attention`` draws from ``key``
    (pallas_attention.py:658)."""
    return int(np.asarray(jax.lax.bitcast_convert_type(
        jax.random.bits(key, (1, 1), jnp.uint32), jnp.int32))[0, 0])


def _draw(rng, *shapes):
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def _jax_bwd(q, k, v, do, mask=None, rate=0.0, seed=None, dtype=jnp.float32):
    """(dq, dk, dv) [T, H, hd] of the JAX K4 on one case, fed the JAX
    forward's m and l and dsum = rowsum(do * o), all in interpret mode."""
    qh, kh, vh, doh = (jnp.transpose(jnp.asarray(x).astype(dtype), (1, 0, 2)) for x in (q, k, v, do))
    t_q, t_k, hd = q.shape[0], k.shape[0], q.shape[-1]
    bias = None if mask is None else jnp.where(jnp.asarray(mask)[None, :], 0.0, JAX_NEG_INF).astype(
        jnp.float32)
    seed_arr = None if rate == 0.0 else jnp.asarray([[seed]], jnp.int32)
    q_tile = jpa._round_up(max(16, min(t_q, 512, (2 << 20) // max(t_k, 1))), 16)
    scale = 1.0 / hd ** 0.5
    o, m, l = jpa._fused_attention_hxd(qh, kh, vh, bias, seed_arr, scale, q_tile, rate, True)
    dsum = jnp.sum(doh.astype(jnp.float32) * o.astype(jnp.float32), axis=-1, keepdims=True)
    grads = jpa._fused_attention_bwd_hxd(qh, kh, vh, bias, seed_arr, doh, m, l, dsum, scale,
                                         q_tile, rate, True)
    # owned copies: torch reads them, never a view of a JAX buffer
    stats = tuple(np.array(x[..., 0]) for x in (m, l, dsum))
    return tuple(np.array(jnp.transpose(g, (1, 0, 2)).astype(jnp.float32)) for g in grads), stats


def _port_bwd(q, k, v, do, stats, mask=None, rate=0.0, seed=None, dtype=torch.float32):
    t = [torch.as_tensor(x).to(dtype) for x in (q, k, v, do)]
    m, l, dsum = (torch.tensor(x) for x in stats)
    got = tpa.plain_fused_attention_bwd(*t, m, l, dsum, None if mask is None else torch.as_tensor(mask),
                                        dropout_rate=rate, seed=seed)
    assert all(g.dtype == dtype for g in got)
    return tuple(g.float().numpy() for g in got)


def _close(got, want, bf16=False):
    for a, b, name in zip(got, want, ("dq", "dk", "dv")):
        if bf16:
            rel = np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)
            assert rel <= 2e-2, (name, rel)
        else:
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5, err_msg=name)


@pytest.mark.parametrize(
    "case",
    ["self_partial_tiles", "cross_kv_mask", "all_masked", "dropout", "hd16", "hd64_three_chunks",
     # the forms the narrow routes serve, and the NARROW boundary
     "narrow_q_ragged_three_chunks", "narrow_k", "one_by_one", "tk16", "tk17",
     "narrow_q_all_masked"],
)
def test_plain_attention_bwd_matches_jax_kernel(case):
    rng = np.random.default_rng(sum(map(ord, case)))
    tq, tk, h, hd, mask, rate, seed = {
        "self_partial_tiles": (257, 257, 4, 32, None, 0.0, None),
        "cross_kv_mask": (5, 90, 2, 32, rng.random(90) > 0.3, 0.0, None),
        "all_masked": (8, 24, 2, 16, np.zeros(24, bool), 0.0, None),
        "dropout": (70, 90, 2, 32, rng.random(90) > 0.25, 0.1, -1399772917),
        "hd16": (33, 50, 8, 16, rng.random(50) > 0.3, 0.0, None),
        "hd64_three_chunks": (40, 1100, 2, 64, None, 0.0, None),
        "narrow_q_ragged_three_chunks": (5, 1100, 2, 16, np.arange(1100) < 777, 0.0, None),
        "narrow_k": (300, 5, 2, 16, None, 0.0, None),
        "one_by_one": (1, 1, 2, 16, None, 0.0, None),
        "tk16": (24, 16, 2, 16, rng.random(16) > 0.3, 0.1, 7),
        "tk17": (24, 17, 2, 16, rng.random(17) > 0.3, 0.1, 7),
        "narrow_q_all_masked": (5, 40, 2, 16, np.zeros(40, bool), 0.0, None),
    }[case]
    q, do = _draw(rng, (tq, h, hd), (tq, h, hd))
    k, v = _draw(rng, (tk, h, hd), (tk, h, hd))
    want, stats = _jax_bwd(q, k, v, do, mask, rate, seed)
    got = _port_bwd(q, k, v, do, stats, mask, rate, seed)
    _close(got, want)
    if case in ("all_masked", "narrow_q_all_masked"):
        # every score is a constant: no gradient into q or k; dv flows
        # through the uniform p
        assert not got[0].any() and not got[1].any() and np.abs(got[2]).max() > 0


def test_plain_attention_bwd_per_case_seeds_match_jax():
    """Batch 3, one seed per case (the trainer's vmap over per-case keys):
    each case of the batched plain version is the JAX kernel on that case
    with its own seed."""
    rng = np.random.default_rng(5)
    b, tq, tk, h, hd = 3, 33, 40, 2, 16
    q, do = _draw(rng, (b, tq, h, hd), (b, tq, h, hd))
    k, v = _draw(rng, (b, tk, h, hd), (b, tk, h, hd))
    mask = rng.random((b, tk)) > 0.3
    seeds = [_seed_of(kk) for kk in jax.random.split(jax.random.key(5), b)]
    wants, stats = zip(*[_jax_bwd(q[i], k[i], v[i], do[i], mask[i], 0.4, seeds[i]) for i in range(b)])
    stacked = tuple(np.stack(s) for s in zip(*stats))
    got = _port_bwd(q, k, v, do, stacked, mask, 0.4, torch.as_tensor(seeds, dtype=torch.int32))
    _close(got, tuple(np.stack(w) for w in zip(*wants)))


def test_plain_attention_bwd_bf16_matches_jax_kernel():
    rng = np.random.default_rng(6)
    q, do = _draw(rng, (130, 4, 64), (130, 4, 64))
    k, v = _draw(rng, (300, 4, 64), (300, 4, 64))
    mask = rng.random(300) > 0.2
    want, stats = _jax_bwd(q, k, v, do, mask, dtype=jnp.bfloat16)
    _close(_port_bwd(q, k, v, do, stats, mask, dtype=torch.bfloat16), want, bf16=True)


def _loss_jax(q, k, v, mask=None):
    return jnp.sum(jpa.fused_attention(q, k, v, mask, interpret=True) ** 2)


def _grads_port(q, k, v, mask=None, **kw):
    t = [torch.as_tensor(x).requires_grad_(True) for x in (q, k, v)]
    out = tpa.fused_attention(*t, None if mask is None else torch.as_tensor(mask), **kw)
    grads = torch.autograd.grad((out ** 2).sum(), t)
    return tuple(g.numpy() for g in grads)


@pytest.mark.parametrize(
    "tq,tk,heads,hd,mask_kind",
    [
        (257, 257, 4, 64, None),  # partial edge q tiles
        (33, 50, 2, 32, "ragged"),  # cross attention with a kv mask
        (8, 24, 2, 16, "all"),  # all-masked bag: zero dq and dk, uniform-p dv
    ],
)
def test_fused_attention_autograd_matches_jax_grad(tq, tk, heads, hd, mask_kind):
    """torch.autograd.grad through the port's FusedAttention (plain K3 and
    K4 on CPU tensors) against jax.grad through the JAX custom VJP, the
    cases of the JAX package's own gradient test."""
    rng = np.random.default_rng(11 + tq)
    q = rng.standard_normal((tq, heads, hd)).astype(np.float32)
    k, v = _draw(rng, (tk, heads, hd), (tk, heads, hd))
    mask = {None: None, "ragged": rng.random(tk) > 0.3, "all": np.zeros(tk, bool)}[mask_kind]
    args = [jnp.asarray(x) for x in (q, k, v)] + ([] if mask is None else [jnp.asarray(mask)])
    want = jax.grad(_loss_jax, argnums=(0, 1, 2))(*args)
    before = (attention_fwd.launches, attention_bwd.launches)
    got = _grads_port(q, k, v, mask)
    assert (attention_fwd.launches, attention_bwd.launches) == before  # no kernel on the CPU
    for a, b, name in zip(got, want, "qkv"):
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-5, atol=1e-5, err_msg=f"d{name}")
    if mask_kind == "all":
        assert not got[0].any() and not got[1].any()


def test_fused_attention_autograd_batch_matches_jax_vmap_grad():
    rng = np.random.default_rng(12)
    q, k, v = _draw(rng, (3, 40, 2, 32), (3, 48, 2, 32), (3, 48, 2, 32))

    def loss(a, b, c):
        return jnp.sum(jax.vmap(lambda x, y, z: jpa.fused_attention(x, y, z, interpret=True))(a, b, c) ** 2)

    want = jax.grad(loss, argnums=(0, 1, 2))(*(jnp.asarray(x) for x in (q, k, v)))
    for a, b in zip(_grads_port(q, k, v), want):
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("rate", [0.1, 0.4])
def test_per_case_seeds_match_jax_vmap_with_per_case_keys(rate):
    """The survival trainer vmaps per-case keys, so each case draws its own
    seed and its own mask: the port's seed tensor [B] of bits(key_b) gives
    the output and the gradients of jax.vmap(fused_attention) with those
    keys."""
    rng = np.random.default_rng(31)
    b, tq, tk, heads, hd = 3, 33, 40, 2, 16
    q, k, v = _draw(rng, (b, tq, heads, hd), (b, tk, heads, hd), (b, tk, heads, hd))
    mask = rng.random((b, tk)) > 0.3
    keys = jax.random.split(jax.random.key(5), b)
    seeds = torch.as_tensor([_seed_of(kk) for kk in keys], dtype=torch.int32)

    def fwd(a, bb, c):
        return jax.vmap(lambda x, y, z, m, kk: jpa.fused_attention(
            x, y, z, m, dropout_rate=rate, dropout_key=kk, interpret=True,
        ))(a, bb, c, jnp.asarray(mask), keys)

    jq, jk, jv = (jnp.asarray(x) for x in (q, k, v))
    want_o = np.asarray(fwd(jq, jk, jv))
    want_g = jax.grad(lambda a, bb, c: jnp.sum(fwd(a, bb, c) ** 2), argnums=(0, 1, 2))(jq, jk, jv)
    got_o = tpa.fused_attention(*(torch.as_tensor(x) for x in (q, k, v)), torch.as_tensor(mask),
                                dropout_rate=rate, seed=seeds).numpy()
    np.testing.assert_allclose(got_o, want_o, rtol=1e-5, atol=1e-5)
    for a, bb in zip(_grads_port(q, k, v, mask, dropout_rate=rate, seed=seeds), want_g):
        np.testing.assert_allclose(a, np.asarray(bb), rtol=1e-5, atol=1e-5)
    # one shared seed (vmap over an unbatched key) is a different draw
    shared = tpa.fused_attention(*(torch.as_tensor(x) for x in (q, k, v)), torch.as_tensor(mask),
                                 dropout_rate=rate, seed=int(seeds[0])).numpy()
    assert np.allclose(shared[0], got_o[0]) and not np.allclose(shared[1:], got_o[1:])


def test_attention_dispatch_is_differentiable_on_cpu():
    """'auto' and 'pallas' go through the autograd Function on CPU tensors
    (K3's and K4's plain versions); their gradients equal 'xla''s, which
    autograd differentiates through the einsum form."""
    rng = np.random.default_rng(8)
    q, k, v = _draw(rng, (2, 9, 4, 16), (2, 30, 4, 16), (2, 30, 4, 16))
    mask = torch.as_tensor(rng.random((2, 30)) > 0.3)
    grads = {}
    for impl in tpa.VALID_IMPLS:
        t = [torch.as_tensor(x).requires_grad_(True) for x in (q, k, v)]
        out = tpa.attention(*t, mask, impl=impl)
        grads[impl] = torch.autograd.grad((out ** 2).sum(), t)
    for impl in ("auto", "pallas", "pallas_interpret"):
        for a, b in zip(grads[impl], grads["xla"]):
            torch.testing.assert_close(a, b, rtol=2e-5, atol=2e-5)


def test_plain_attention_bwd_rejects_bad_inputs():
    q = torch.zeros((5, 2, 8))
    stats = torch.zeros((2, 5))
    with pytest.raises(ValueError):
        tpa.plain_fused_attention_bwd(q, q, q, q, stats, stats + 1, stats, dropout_rate=0.1)  # no seed
    with pytest.raises(ValueError):
        tpa.plain_fused_attention_bwd(q, q, q, q, stats, stats + 1, stats, dropout_rate=0.1,
                                      seed=torch.zeros(3, dtype=torch.int32))  # unbatched, 3 seeds

"""The port's attention (K3's plain version and the dispatch) against the
JAX package on the CPU.

The JAX side runs the Pallas kernel in interpret mode
(``fused_attention(..., interpret=True)``, and ``_fused_attention_hxd`` for
the row statistics m and l); the port side runs ``plain_fused_attention``.
Inputs come from numpy seeds.  Tolerances: float32 o within 2e-5 (the two
sides sum the dots in different orders; the JAX package's own kernel tests
use 2e-5 against XLA); m within 1e-5 absolute plus 1e-6 relative (a
float32 ulp or two of the largest dot) and exactly -1e9 on an all-masked
row; l within 1e-5 relative; bf16 o within 2e-2 (p is cast to
bf16 before P.V, and a last-bit difference in f32 p can flip one bf16
rounding).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_fusion_tpu.ops import pallas_attention as jpa
from multimodal_fusion_tpu.ops.masked import NEG_INF as JAX_NEG_INF
from multimodal_fusion_tpu_torch.ops import attention as tpa
from multimodal_fusion_tpu_torch.ops.attention_kernel import (
    NARROW,
    ROUTES,
    _check_route,
    _route,
    attention_bwd,
    attention_fwd,
)
from multimodal_fusion_tpu_torch.ops.masked import NEG_INF


def _inputs(seed, shape_q, shape_kv, scale=1.0):
    rng = np.random.default_rng(seed)
    q = (rng.standard_normal(shape_q) * scale).astype(np.float32)
    k = (rng.standard_normal(shape_kv) * scale).astype(np.float32)
    v = rng.standard_normal(shape_kv).astype(np.float32)
    return q, k, v


def _jax_stats(q, k, v, mask=None, rate=0.0, seed=None, dtype=jnp.float32):
    """(o [Tq, H, hd], m [H, Tq], l [H, Tq]) of the JAX kernel, interpret mode."""
    qh, kh, vh = (jnp.transpose(jnp.asarray(x, dtype), (1, 0, 2)) for x in (q, k, v))
    t_q, t_k, hd = q.shape[0], k.shape[0], q.shape[-1]
    bias = None if mask is None else jnp.where(jnp.asarray(mask)[None, :], 0.0, JAX_NEG_INF)
    seed_arr = None if rate == 0.0 else jnp.asarray([[seed]], jnp.int32)
    q_tile = jpa._round_up(max(16, min(t_q, 512, (2 << 20) // max(t_k, 1))), 16)
    o, m, l = jpa._fused_attention_hxd(
        qh, kh, vh, None if bias is None else bias.astype(jnp.float32), seed_arr,
        1.0 / hd ** 0.5, q_tile, rate, True,
    )
    return (np.asarray(jnp.transpose(o, (1, 0, 2)).astype(jnp.float32)),
            np.asarray(m[..., 0]), np.asarray(l[..., 0]))


def _port(q, k, v, mask=None, rate=0.0, seed=None, dtype=torch.float32):
    o, m, l = tpa.plain_fused_attention(
        torch.as_tensor(q).to(dtype), torch.as_tensor(k).to(dtype), torch.as_tensor(v).to(dtype),
        None if mask is None else torch.as_tensor(mask), dropout_rate=rate, seed=seed,
    )
    return o.float().numpy(), m.numpy(), l.numpy()


def _check_stats(got, want, o_tol=2e-5):
    np.testing.assert_allclose(got[0], want[0], rtol=o_tol, atol=o_tol)
    np.testing.assert_allclose(got[1], want[1], rtol=1e-6, atol=1e-5)
    np.testing.assert_allclose(got[2], want[2], rtol=1e-5, atol=0)


@pytest.mark.parametrize(
    "tq,tk,heads,hd",
    [
        (257, 257, 4, 64),  # ViT-L token count: ragged against every tile
        (8, 100, 4, 32),  # cross-attention, tiny q
        (16, 16, 2, 16),  # aligned small
        (40, 1100, 2, 8),  # three 512-key chunks, the last one ragged
        # the forms the narrow routes serve (MFMF: 5 tokens against a bag,
        # a bag against 5 tokens, hd 16) and the NARROW boundary
        (5, 1100, 2, 16),
        (300, 5, 2, 16),
        (1, 1, 2, 16),
        (24, 16, 2, 16),
        (24, 17, 2, 16),
    ],
)
def test_plain_fused_attention_matches_jax_kernel(tq, tk, heads, hd):
    q, k, v = _inputs(tq + tk, (tq, heads, hd), (tk, heads, hd))
    _check_stats(_port(q, k, v), _jax_stats(q, k, v))


def test_plain_fused_attention_kv_mask():
    q, k, v = _inputs(0, (12, 2, 32), (40, 2, 32))
    mask = np.random.default_rng(0).random(40) > 0.4
    got = _port(q, k, v, mask)
    _check_stats(got, _jax_stats(q, k, v, mask))
    # masked keys are equivalent to removed keys
    keep = np.flatnonzero(mask)
    np.testing.assert_allclose(got[0], _port(q, k[keep], v[keep])[0], rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("magnitude", [1.0, 40.0])
def test_plain_fused_attention_all_masked_row(magnitude):
    """An all-masked bag averages v uniformly (m is exactly NEG_INF, l = Tk),
    also when |scaled scores| >= 32, where an additive -1e9 would keep the
    score order: masking REPLACES."""
    q, k, v = _inputs(1, (4, 2, 16), (24, 2, 16), scale=magnitude)
    mask = np.zeros(24, bool)
    got = _port(q, k, v, mask)
    _check_stats(got, _jax_stats(q, k, v, mask))
    assert np.all(got[1] == np.float32(NEG_INF))
    np.testing.assert_allclose(got[0], np.broadcast_to(v.mean(0), got[0].shape), rtol=2e-5, atol=2e-5)
    pmask = np.random.default_rng(2).random(24) > 0.4
    _check_stats(_port(q, k, v, pmask), _jax_stats(q, k, v, pmask))


@pytest.mark.parametrize(
    "tq,tk,kind",
    [
        (5, 1100, "ragged"),  # narrow_q: three 512-key chunks, ragged valid lengths
        (5, 40, "all"),  # narrow_q, every key masked
        (300, 5, "ragged"),  # narrow_k
    ],
)
def test_plain_fused_attention_narrow_forms_masked(tq, tk, kind):
    """K3's plain version (what the wrapper takes for CPU tensors, on any
    route) against the JAX kernel at the narrow routes' shapes with masks."""
    q, k, v = _inputs(tq * tk, (tq, 2, 16), (tk, 2, 16))
    rng = np.random.default_rng(tq + tk)
    mask = np.arange(tk) < rng.integers(2, tk + 1) if kind == "ragged" else np.zeros(tk, bool)
    route = _route(tq, tk, 16)
    got = attention_fwd(*(torch.as_tensor(x) for x in (q, k, v)), torch.as_tensor(mask), route=route)
    _check_stats(tuple(t.float().numpy() for t in got), _jax_stats(q, k, v, mask))
    if kind == "all":
        assert np.all(got[1].numpy() == np.float32(NEG_INF))


@pytest.mark.parametrize(
    "tq,tk,want",
    [
        (5, 512, "narrow_q"),  # MFMF block 1
        (5, 4096, "narrow_q"),  # block 2
        (4096, 5, "narrow_k"),  # block 3
        (257, 257, "general"),  # the ViT
        (1, 1, "narrow_k"),
        (16, 16, "narrow_k"),
        (16, 17, "narrow_q"),
        (17, 16, "narrow_k"),
        (17, 17, "general"),
        (300, 16, "narrow_k"),
        (300, 17, "general"),
        (5, 1100, "narrow_q"),
    ],
)
def test_route_boundaries(tq, tk, want):
    assert _route(tq, tk, 16) == want
    assert _check_route(None, tq, tk, 16) == want
    assert _check_route("general", tq, tk, 16) == "general"  # the general route serves every shape


def test_forced_routes_refuse_shapes_they_do_not_serve():
    assert NARROW == 16 and ROUTES == ("general", "narrow_q", "narrow_k")
    with pytest.raises(ValueError):
        _check_route("narrow_q", NARROW + 1, 5, 16)
    with pytest.raises(ValueError):
        _check_route("narrow_k", 5, NARROW + 1, 16)
    with pytest.raises(ValueError):
        _check_route("flash", 5, 5, 16)
    with pytest.raises(ValueError):
        _route(5, 5, 136)  # head dim above 128
    q = torch.zeros((20, 2, 16))
    with pytest.raises(ValueError):
        attention_fwd(q, q[:5], q[:5], route="narrow_q")


def test_cpu_tensors_never_count_a_launch():
    """On CPU tensors the wrappers take the plain versions, on every route,
    and count no launch."""
    q, k, v = (torch.as_tensor(x) for x in _inputs(12, (2, 5, 2, 16), (2, 40, 2, 16)))
    before = (attention_fwd.launches, dict(attention_fwd.route_launches),
              attention_bwd.launches, dict(attention_bwd.route_launches))
    for route in (None, "general", "narrow_q"):
        o, m, l = attention_fwd(q, k, v, route=route)
        dsum = (o * o).sum(-1).transpose(1, 2)
        attention_bwd(q, k, v, o, m, l, dsum, route=route)
    assert (attention_fwd.launches, attention_fwd.route_launches,
            attention_bwd.launches, attention_bwd.route_launches) == before


def test_plain_fused_attention_bf16():
    q, k, v = _inputs(2, (257, 4, 64), (257, 4, 64))
    got = _port(q, k, v, dtype=torch.bfloat16)
    want = _jax_stats(q, k, v, dtype=jnp.bfloat16)
    _check_stats(got, want, o_tol=2e-2)
    o = tpa.plain_fused_attention(*(torch.as_tensor(x).to(torch.bfloat16) for x in (q, k, v)))[0]
    assert o.dtype == torch.bfloat16


@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_plain_fused_attention_batch_stands_for_vmap(rate):
    """A leading batch dimension gives what jax.vmap of the kernel gives,
    dropout included: every batch element hashes the same (head, q, k)
    indices, as the JAX kernel does under vmap."""
    q, k, v = _inputs(3, (3, 65, 4, 32), (3, 70, 4, 32))
    mask = np.random.default_rng(3).random((3, 70)) > 0.3
    key = jax.random.PRNGKey(11)
    seed = int(np.asarray(jax.lax.bitcast_convert_type(
        jax.random.bits(key, (1, 1), jnp.uint32), jnp.int32))[0, 0])
    want = jax.vmap(lambda a, b, c, msk: jpa.fused_attention(
        a, b, c, msk, dropout_rate=rate, dropout_key=key if rate else None, interpret=True,
    ))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(mask))
    want_m, want_l = [], []
    for i in range(3):
        _, m, l = _jax_stats(q[i], k[i], v[i], mask[i], rate, seed)
        want_m.append(m)
        want_l.append(l)
    got = _port(q, k, v, mask, rate, seed if rate else None)
    _check_stats(got, (np.asarray(want), np.stack(want_m), np.stack(want_l)))


@pytest.mark.parametrize("tq,tk", [(40, 300), (600, 32)])
def test_plain_fused_attention_dropout_matches_jax(tq, tk):
    """Hash dropout from the int32 seed the JAX wrapper draws: the same
    mask, so the same o; m and l are the pre-dropout statistics."""
    q, k, v = _inputs(4, (tq, 2, 32), (tk, 2, 32))
    key = jax.random.PRNGKey(5)
    want_o = np.asarray(jpa.fused_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                            dropout_rate=0.1, dropout_key=key, interpret=True))
    seed = int(np.asarray(jax.lax.bitcast_convert_type(
        jax.random.bits(key, (1, 1), jnp.uint32), jnp.int32))[0, 0])
    got = _port(q, k, v, rate=0.1, seed=seed)
    np.testing.assert_allclose(got[0], want_o, rtol=2e-5, atol=2e-5)
    _check_stats(got, _jax_stats(q, k, v, rate=0.1, seed=seed))
    _, m0, l0 = _port(q, k, v)
    np.testing.assert_array_equal(got[1], m0)
    np.testing.assert_array_equal(got[2], l0)


@pytest.mark.parametrize("seed", [0, 1, 12345, 2**31 - 1, 2**31, 2**31 + 7, 2**32 - 1])
@pytest.mark.parametrize("rate", [0.1, 0.5])
def test_dropout_keep_reference_bit_equal(seed, rate):
    want = np.asarray(jpa.dropout_keep_reference(seed, 3, 17, 29, rate))
    got = tpa.dropout_keep_reference(seed, 3, 17, 29, rate).numpy()
    np.testing.assert_array_equal(got, want)
    # the int32 form of the same seed (as the JAX wrapper draws it) agrees
    signed = seed - 2**32 if seed >= 2**31 else seed
    np.testing.assert_array_equal(tpa.dropout_keep_reference(signed, 3, 17, 29, rate).numpy(), want)


def test_xla_formulation_matches_jax():
    q, k, v = _inputs(6, (30, 3, 16), (45, 3, 16))
    mask = np.random.default_rng(6).random(45) > 0.3
    for msk in (None, mask):
        want = np.asarray(jpa.xla_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                            None if msk is None else jnp.asarray(msk)))
        got = tpa.xla_attention(torch.as_tensor(q), torch.as_tensor(k), torch.as_tensor(v),
                                None if msk is None else torch.as_tensor(msk)).numpy()
        np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)


def test_xla_dropout_draws_from_the_generator():
    q, k, v = (torch.as_tensor(x) for x in _inputs(7, (64, 2, 16), (64, 2, 16)))
    a = tpa.xla_attention(q, k, v, None, 0.5, torch.Generator().manual_seed(3))
    b = tpa.xla_attention(q, k, v, None, 0.5, torch.Generator().manual_seed(3))
    c = tpa.xla_attention(q, k, v, None, 0.5, torch.Generator().manual_seed(4))
    assert torch.equal(a, b) and not torch.equal(a, c)
    # inverted dropout: the expectation is the undropped output
    many = torch.stack([tpa.xla_attention(q, k, v, None, 0.5, torch.Generator().manual_seed(s))
                        for s in range(200)]).mean(0)
    want = tpa.xla_attention(q, k, v)
    assert float((many - want).abs().mean()) < 0.1 * float(want.abs().mean())


@pytest.mark.parametrize("impl", tpa.VALID_IMPLS)
def test_attention_dispatch_on_cpu(impl):
    """Every impl computes the same attention on CPU tensors: 'auto' and
    'pallas' take K3's plain version there, as 'pallas_interpret' does."""
    q, k, v = _inputs(8, (2, 33, 4, 16), (2, 50, 4, 16))
    mask = np.random.default_rng(8).random((2, 50)) > 0.3
    want = np.asarray(jax.vmap(lambda a, b, c, m: jpa.attention(a, b, c, m, impl="xla"))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(mask)))
    before = attention_fwd.launches
    got = tpa.attention(torch.as_tensor(q), torch.as_tensor(k), torch.as_tensor(v),
                        torch.as_tensor(mask), impl=impl).numpy()
    assert attention_fwd.launches == before  # no kernel on the CPU
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)
    # dropout applies only with train=True and a seed
    plain = tpa.attention(torch.as_tensor(q), torch.as_tensor(k), torch.as_tensor(v),
                          impl=impl, dropout_rate=0.5, seed=3)
    dropped = tpa.attention(torch.as_tensor(q), torch.as_tensor(k), torch.as_tensor(v),
                            impl=impl, dropout_rate=0.5, seed=3, train=True)
    assert not torch.equal(plain, dropped)


def test_attention_dispatch_rejects_unknown_and_honours_force_xla():
    q, k, v = (torch.as_tensor(x) for x in _inputs(9, (5, 2, 8), (7, 2, 8)))
    with pytest.raises(ValueError):
        tpa.attention(q, k, v, impl="flash")
    with pytest.raises(ValueError):
        tpa.plain_fused_attention(q, k, v, dropout_rate=0.1)  # no seed
    gen = torch.Generator().manual_seed(1)
    with tpa.force_xla():
        got = tpa.attention(q, k, v, impl="pallas", dropout_rate=0.5, seed=gen, train=True)
    want = tpa.xla_attention(q, k, v, None, 0.5, torch.Generator().manual_seed(1))
    assert torch.equal(got, want)
    # a generator seed for K3 draws the int32 seed from it
    a = tpa.fused_attention(q, k, v, dropout_rate=0.3, seed=torch.Generator().manual_seed(2))
    s = tpa.draw_seed(torch.Generator().manual_seed(2))
    b = tpa.fused_attention(q, k, v, dropout_rate=0.3, seed=s)
    assert torch.equal(a, b)

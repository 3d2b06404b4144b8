"""The port's ``ops/losses.py`` against the JAX package's on the CPU: every
function's value and its gradient with respect to every float input.

Inputs come from numpy seeds and go to both sides as the same float32
arrays.  Tolerances: values and gradients within rtol 1e-5 and an absolute
1e-5 times max(1, the largest magnitude of the JAX result) (the same
float32 arithmetic in other orders; the SVD and eigen solvers are LAPACK
on both sides here, and eigenvector gradients carry 1 / gap factors).
The "svd" impl of ``rank1_svd_loss`` keeps the backend's singular-vector
signs, so its fixtures are the JAX package's own sign-canonical ones
(``tests/test_losses.py:_sign_canonical_features``: strictly positive
entries, the dominant direction unambiguous); the "gram" impl fixes the
signs itself and takes generic features (near-rank-1 ones put the Gram
matrix's trailing eigenvalues within rounding of each other).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_fusion_tpu.ops import losses as jl
from multimodal_fusion_tpu_torch.ops import losses as tl


def _sign_canonical_features(rng, B=6, D=16, M=3):
    base = np.abs(rng.standard_normal((B, D, 1))) + 0.5
    f = base + 0.05 * rng.standard_normal((B, D, M))
    return np.abs(f).astype(np.float32)


def _generic_features(rng, B=6, D=16, M=3):
    return rng.standard_normal((B, D, M)).astype(np.float32)


def _both(jfn, tfn, *arrays, argnums=None, weights_seed=0):
    """Value and gradients of a scalar or array function on both sides.  An
    array output is reduced with fixed random weights so every element's
    gradient counts.  Returns ((jax value, jax grads), (port value, port
    grads)) as numpy."""
    argnums = tuple(range(len(arrays))) if argnums is None else tuple(argnums)
    jargs = [jnp.asarray(a) for a in arrays]
    jval = np.asarray(jfn(*jargs))
    w = np.random.default_rng(weights_seed).standard_normal(jval.shape).astype(np.float32)

    def jscalar(*xs):
        return jnp.sum(jfn(*xs) * w)

    jgrads = jax.grad(jscalar, argnums=argnums)(*jargs)
    targs = [torch.tensor(a, requires_grad=i in argnums) for i, a in enumerate(arrays)]
    tout = tfn(*targs)
    (tout * torch.as_tensor(w)).sum().backward()
    tgrads = [targs[i].grad for i in argnums]
    return (jval, [np.asarray(g) for g in jgrads]), (tout.detach().numpy(), [g.numpy() for g in tgrads])


def _close(got, want, err_msg=""):
    scale = max(1.0, float(np.abs(want).max())) if np.size(want) else 1.0
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * scale, err_msg=err_msg)


def _assert_both(jfn, tfn, *arrays, argnums=None):
    (jv, jg), (tv, tg) = _both(jfn, tfn, *arrays, argnums=argnums)
    _close(tv, jv)
    for i, (a, b) in enumerate(zip(tg, jg)):
        _close(a, b, err_msg=f"gradient {i}")


def test_bce_and_mse_match_jax():
    rng = np.random.default_rng(0)
    probs = rng.uniform(0.0, 1.0, 20).astype(np.float32)
    probs[:2] = [0.0, 1.0]  # the clamp
    targets = (rng.random(20) > 0.5).astype(np.float32)
    _assert_both(jl.binary_cross_entropy, tl.binary_cross_entropy, probs, targets, argnums=(0,))
    a, b = rng.standard_normal((2, 5, 3)).astype(np.float32)
    for red in ("mean", "sum", "none"):
        _assert_both(lambda x, y: jl.mse_loss(x, y, red), lambda x, y: tl.mse_loss(x, y, red), a, b)


@pytest.mark.parametrize("M", [3, 7])
def test_jacobi_eigh_matches_jax(M):
    """The autograd Function with the closed-form adjoint against the JAX
    package's ``_jacobi_eigh_desc`` on Gram matrices of unit columns (the
    "gram" impl's input), eigenvalues also against numpy's eigh; the raw
    unrolled Jacobi, gradient through the rotations, at M <= 4 (the JAX
    side differentiates 8 * M (M - 1) / 2 rotations op by op)."""
    rng = np.random.default_rng(M)
    X = rng.standard_normal((4, 2 * M, M)).astype(np.float32)
    X = X / np.linalg.norm(X, axis=1, keepdims=True)
    G = np.einsum("bdm,bdn->bmn", X, X).astype(np.float32)
    pairs = [(jl._jacobi_eigh_desc, lambda g: tl._jacobi_eigh_desc.apply(g, 8))]
    if M <= 4:
        pairs.append((jl._jacobi_eigh_impl, tl._jacobi_eigh_impl))
    for j, t in pairs:
        for out in (0, 1):
            _assert_both(lambda g: j(g)[out], lambda g: t(g)[out], G)
    lam, V = tl._jacobi_eigh_desc.apply(torch.as_tensor(G), 8)
    np.testing.assert_allclose(lam.numpy(), np.linalg.eigh(G.astype(np.float64))[0][:, ::-1],
                               rtol=1e-5, atol=1e-5)
    assert issubclass(tl._jacobi_eigh_desc, torch.autograd.Function)


def test_jacobi_eigh_degenerate_spectrum_matches_jax():
    """A diagonal, degenerate input (the atan2 origin) and a repeated
    eigenvalue (the adjoint's gap clamp): finite, equal to JAX."""
    G = np.stack([np.diag([2.0, 2.0, 1.0]), np.diag([3.0, 1.0, 1.0])]).astype(np.float32)
    G[1, 0, 1] = G[1, 1, 0] = 0.5
    for j, t in ((jl._jacobi_eigh_impl, tl._jacobi_eigh_impl),
                 (jl._jacobi_eigh_desc, lambda g: tl._jacobi_eigh_desc.apply(g, 8))):
        (jv, jg), (tv, tg) = _both(lambda g: j(g)[0], lambda g: t(g)[0], G)
        assert np.isfinite(tg[0]).all()
        _close(tv, jv)
        _close(tg[0], jg[0])


def test_rank1_factors_gram_matches_jax():
    rng = np.random.default_rng(1)
    f = _generic_features(rng, B=5, D=24, M=4)
    f = f / (np.linalg.norm(f, axis=1, keepdims=True) + 1e-8)
    for out in (0, 1):
        _assert_both(lambda x: jl._rank1_factors_gram(x)[out],
                     lambda x: tl._rank1_factors_gram(x)[out], f)


@pytest.mark.parametrize("impl,chunk,B,D,M", [
    ("svd", None, 6, 16, 3), ("svd", 3, 7, 32, 7), ("svd", 99, 4, 24, 5),
    ("gram", None, 6, 16, 3), ("gram", 3, 7, 32, 7), ("gram", None, 4, 24, 5),
])
def test_rank1_svd_loss_matches_jax(impl, chunk, B, D, M):
    rng = np.random.default_rng(B * D + M)
    f = (_sign_canonical_features if impl == "svd" else _generic_features)(rng, B=B, D=D, M=M)
    for out in (0, 1):
        _assert_both(lambda x: jl.rank1_svd_loss(x, 0.1, 0.2, 0.5, chunk, impl=impl)[out],
                     lambda x: tl.rank1_svd_loss(x, 0.1, 0.2, 0.5, chunk, impl=impl)[out], f)


def test_rank1_svd_loss_generic_inputs_match_jax():
    """Generic (signed) features at the flagship's settings (tau 1.0,
    lambda1 0.1): the signs the two LAPACK calls choose agree here, as the
    loss2 term shows."""
    rng = np.random.default_rng(7)
    for B, D, M in ((8, 32, 3), (6, 32, 7)):
        f = _generic_features(rng, B, D, M)
        _assert_both(lambda x: jl.rank1_svd_loss(x, 1.0, 1.0, 0.1)[0],
                     lambda x: tl.rank1_svd_loss(x, 1.0, 1.0, 0.1)[0], f)


def test_rank1_gram_falls_back_to_svd_when_m_exceeds_d():
    rng = np.random.default_rng(2)
    f = _sign_canonical_features(rng, B=4, D=3, M=5)
    a = tl.rank1_svd_loss(torch.as_tensor(f), 0.1, 0.1, 1.0, impl="gram")
    b = tl.rank1_svd_loss(torch.as_tensor(f), 0.1, 0.1, 1.0, impl="svd")
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    _assert_both(lambda x: jl.rank1_svd_loss(x, 0.1, 0.1, 1.0, impl="gram")[0],
                 lambda x: tl.rank1_svd_loss(x, 0.1, 0.1, 1.0, impl="gram")[0], f)


def test_rank1_svd_loss_from_dict_matches_jax():
    rng = np.random.default_rng(3)
    f = _sign_canonical_features(rng, B=5, D=16, M=3)
    names = ["tma", "clinical", "wsi"]  # sorted order differs from insertion order
    j = jl.rank1_svd_loss_from_dict({n: jnp.asarray(f[:, :, i]) for i, n in enumerate(names)}, 0.1, 0.1, 1.0)
    t = tl.rank1_svd_loss_from_dict({n: torch.as_tensor(f[:, :, i]) for i, n in enumerate(names)},
                                    0.1, 0.1, 1.0)
    _close(t[0].numpy(), np.asarray(j[0]))
    _close(t[1].numpy(), np.asarray(j[1]))


def test_rank1_svd_loss_degenerate_inputs_finite_where_jax_is():
    """A zero modality column in one case and two identical columns in
    another: the gradients are finite exactly where the JAX package's are
    (neither side guards the SVD's backward)."""
    rng = np.random.default_rng(4)
    f = _sign_canonical_features(rng, B=5, D=16, M=3)
    f[1, :, 2] = 0.0
    f[3, :, 1] = f[3, :, 0]
    (jv, jg), (tv, tg) = _both(lambda x: jl.rank1_svd_loss(x, 0.1, 0.1, 1.0)[0],
                               lambda x: tl.rank1_svd_loss(x, 0.1, 0.1, 1.0)[0], f)
    np.testing.assert_array_equal(np.isfinite(tv), np.isfinite(jv))
    np.testing.assert_array_equal(np.isfinite(tg[0]), np.isfinite(jg[0]))


def test_pairwise_gram_and_volume_loss_match_jax():
    rng = np.random.default_rng(5)
    a, o1, o2 = (rng.standard_normal((5, 8)).astype(np.float32) * 0.5 for _ in range(3))
    _assert_both(lambda x, y, z: jl._pairwise_gram(x, [y, z]),
                 lambda x, y, z: tl._pairwise_gram(x, [y, z]), a, o1, o2)
    _assert_both(lambda x, y, z: jl.volume_loss([x, y, z], 0.5)[0],
                 lambda x, y, z: tl.volume_loss([x, y, z], 0.5)[0], a, o1, o2)
    j = jl.volume_loss([jnp.asarray(a), jnp.asarray(o1)], 0.5, label_smoothing=0.0)
    t = tl.volume_loss([torch.as_tensor(a), torch.as_tensor(o1)], 0.5, label_smoothing=0.0)
    _close(t[0].numpy(), np.asarray(j[0]))
    assert t[1].dtype == torch.float32
    _close(t[1].numpy(), np.asarray(j[1]))


def test_clip_cox_and_aucm_match_jax():
    rng = np.random.default_rng(6)
    a, o = rng.standard_normal((2, 6, 8)).astype(np.float32)
    scale = np.float32(np.log(1 / 0.07))
    _assert_both(jl.clip_alignment_loss, tl.clip_alignment_loss, a, o, scale)

    risk = rng.standard_normal(10).astype(np.float32)
    time = rng.integers(1, 6, 10).astype(np.float32)  # ties
    event = (rng.random(10) > 0.4).astype(np.float32)
    _assert_both(jl.cox_ph_loss, tl.cox_ph_loss, risk, time, event, argnums=(0,))
    none = np.zeros(10, np.float32)  # no events: the denominator clamps at 1
    _assert_both(jl.cox_ph_loss, tl.cox_ph_loss, risk, time, none, argnums=(0,))

    y_pred = rng.standard_normal(12).astype(np.float32)
    y_true = np.array([0, 1] * 6, np.int32)
    a_, b_, alpha = (np.float32(v) for v in (0.3, -0.2, 0.7))
    _assert_both(lambda p, x, y, z: jl.aucm_loss(p, jnp.asarray(y_true), x, y, z, 1.0),
                 lambda p, x, y, z: tl.aucm_loss(p, torch.as_tensor(y_true), x, y, z, 1.0),
                 y_pred, a_, b_, alpha)
    # gradient reversal: alpha's gradient is the negated derivative
    x = torch.tensor(2.0, requires_grad=True)
    (tl._ascend.apply(x) * 3.0).backward()
    assert float(x.grad) == -3.0 and issubclass(tl._ascend, torch.autograd.Function)

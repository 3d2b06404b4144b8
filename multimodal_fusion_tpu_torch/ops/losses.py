"""Loss functions (counterpart of ``multimodal_fusion_tpu.ops.losses``):
classification, rank-1 SVD and Gram-volume alignment, CLIP, Cox partial
likelihood and the AUCM margin loss.

References into the original stack:
- rank-1 SVD loss: alignment/trainer.py:227-322 and
  downstream_survival/models/svd_gate_random_clam.py:107-157 (identical math)
- volume loss: alignment/trainer.py:157-225
- CLIP bidirectional InfoNCE: downstream_survival/models/clip_gate_random_clam.py:40-88
- AUCM min-max margin loss: libauc.losses.AUCMLoss as consumed by
  downstream_survival/models/auc_clam.py:292-320
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch


# ---------------------------------------------------------------------------
# Classification losses
# ---------------------------------------------------------------------------

def cross_entropy(
    logits: torch.Tensor,
    labels: torch.Tensor,
    label_smoothing: float = 0.0,
    reduction: str = "mean",
) -> torch.Tensor:
    """Softmax cross entropy with integer labels over the last axis of
    ``logits`` (torch.nn.CrossEntropyLoss, as the JAX package writes it)."""
    n_classes = logits.shape[-1]
    logp = torch.log_softmax(logits, dim=-1)
    onehot = torch.nn.functional.one_hot(labels.long(), n_classes).to(logits.dtype)
    if label_smoothing > 0.0:
        onehot = onehot * (1.0 - label_smoothing) + label_smoothing / n_classes
    nll = -(onehot * logp).sum(dim=-1)
    if reduction == "mean":
        return nll.mean()
    if reduction == "sum":
        return nll.sum()
    return nll


def binary_cross_entropy(probs: torch.Tensor, targets: torch.Tensor,
                         eps: float = 1e-7) -> torch.Tensor:
    """BCE on probabilities (torch.nn.functional.binary_cross_entropy)."""
    p = probs.clamp(eps, 1.0 - eps)
    return -(targets * torch.log(p) + (1.0 - targets) * torch.log(1.0 - p)).mean()


def mse_loss(pred: torch.Tensor, target: torch.Tensor, reduction: str = "mean") -> torch.Tensor:
    d = (pred - target) ** 2
    if reduction == "mean":
        return d.mean()
    if reduction == "sum":
        return d.sum()
    return d


# ---------------------------------------------------------------------------
# Rank-1 SVD alignment loss
# ---------------------------------------------------------------------------

def _jacobi_eigh_impl(G: torch.Tensor, n_sweeps: int = 8) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched symmetric eigendecomposition of tiny [B, M, M] matrices by
    unrolled cyclic Jacobi: (eigenvalues descending, matching eigenvector
    columns).  8 sweeps reach ~1e-7 of eigh at M = 8.

    Differentiable through the rotations: each rotation writes new rows and
    columns out of place (``index_copy``), so no tensor autograd saved is
    overwritten.  Training paths use :class:`_jacobi_eigh_desc`, which pairs
    this forward with the closed-form adjoint instead of backpropagating
    through the ~M^2 * n_sweeps rotations."""
    B, M, _ = G.shape
    A = G
    V = torch.eye(M, dtype=G.dtype, device=G.device).expand(B, M, M)
    planes = [(p, q, torch.tensor([p, q], device=G.device))
              for p in range(M - 1) for q in range(p + 1, M)]
    for _ in range(n_sweeps):
        for p, q, pq in planes:
            apq = A[:, p, q]
            y = 2.0 * apq
            x = A[:, q, q] - A[:, p, p]
            # atan2's gradient is 0/0 at the exact origin (a diagonal and
            # degenerate plane): sanitise both operands so the unselected
            # branch never produces NaN cotangents
            origin = (y == 0.0) & (x == 0.0)
            theta = 0.5 * torch.atan2(torch.where(origin, 0.0, y), torch.where(origin, 1.0, x))
            c = torch.cos(theta)[:, None]
            s = torch.sin(theta)[:, None]
            rp, rq = A[:, p, :], A[:, q, :]
            A = A.index_copy(1, pq, torch.stack([c * rp - s * rq, s * rp + c * rq], dim=1))
            cp, cq = A[:, :, p], A[:, :, q]
            A = A.index_copy(2, pq, torch.stack([c * cp - s * cq, s * cp + c * cq], dim=2))
            vp, vq = V[:, :, p], V[:, :, q]
            V = V.index_copy(2, pq, torch.stack([c * vp - s * vq, s * vp + c * vq], dim=2))
    lam = torch.diagonal(A, dim1=1, dim2=2)  # [B, M], unordered
    order = torch.argsort(-lam, dim=1, stable=True)  # descending, ties by index
    lam = torch.gather(lam, 1, order)
    V = torch.gather(V, 2, order[:, None, :].expand(B, M, M))
    return lam, V


class _jacobi_eigh_desc(torch.autograd.Function):  # noqa: N801 (the JAX package's name)
    """(eigenvalues descending, eigenvectors) of symmetric [B, M, M] ``G``:
    ``_jacobi_eigh_desc.apply(G, n_sweeps)``, the :func:`_jacobi_eigh_impl`
    forward with the closed-form symmetric-eigh adjoint (Giles 2008):

        A_bar = V (diag(lam_bar) + F * (V^T V_bar)) V^T,
        F_ij = 1 / (lam_j - lam_i) off the diagonal, 0 on it,

    symmetrised since A is symmetric.  Where eigenvalues collide the gap is
    clamped (F = 0 within 1e-8), so rotations inside an eigenspace carry no
    signal."""

    @staticmethod
    def forward(ctx, G, n_sweeps):
        with torch.no_grad():
            lam, V = _jacobi_eigh_impl(G, n_sweeps)
        ctx.save_for_backward(lam, V)
        return lam, V

    @staticmethod
    def backward(ctx, lam_bar, V_bar):
        lam, V = ctx.saved_tensors
        gap = lam[:, None, :] - lam[:, :, None]  # [B, i, j] = lam_j - lam_i
        eps = 1e-8
        F = torch.where(gap.abs() > eps, 1.0 / torch.where(gap == 0.0, 1.0, gap), 0.0)
        inner = F * torch.einsum("bij,bik->bjk", V, V_bar)
        inner = inner + torch.eye(lam.shape[1], dtype=lam.dtype, device=lam.device) * lam_bar[:, :, None]
        Abar = torch.einsum("bij,bjk,blk->bil", V, inner, V)
        return (Abar + Abar.transpose(1, 2)) * 0.5, None


def _rank1_factors_gram(feats: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(S, U1) of per-sample [D, M] matrices from the [M, M] Gram matrix's
    eigendecomposition: sigma = sqrt(eig(X^T X)), U1 = X v1 / sigma1.
    Eigenvalues are clamped at 1e-12 so the sqrt and the division keep
    finite gradients on exactly degenerate inputs.  U1's sign per sample is
    the one with a non-negative coordinate sum (eigenvector signs are
    arbitrary, and loss2 is not invariant under per-sample flips)."""
    G = torch.einsum("bdm,bdn->bmn", feats, feats)
    lam, V = _jacobi_eigh_desc.apply(G, 8)
    lam = lam.clamp_min(1e-12)
    S = torch.sqrt(lam)  # [B, M]
    U1 = torch.einsum("bdm,bm->bd", feats, V[:, :, 0]) / S[:, :1]
    sign = torch.where(U1.sum(dim=1, keepdim=True) >= 0, 1.0, -1.0)
    return S, U1 * sign.detach()


def _svd_rank1(feats: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(S [B, M], U1 [B, D]) of ``torch.linalg.svd`` of feats [B, D, M],
    with the backend's signs of U1."""
    U, S, _ = torch.linalg.svd(feats, full_matrices=False)  # U [B, D, M]
    return S, U[:, :, 0]


def rank1_svd_loss(
    features: torch.Tensor,
    tau1: float,
    tau2: float,
    lambda1: float,
    loss2_chunk_size: Optional[int] = None,
    impl: str = "svd",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Rank-1 spectral alignment loss of ``features`` [B, D, M] (B samples,
    D feature dim, M modalities).

    Per sample, L2-normalise each modality column, take the SVD and push the
    spectral mass onto sigma_1 (loss1 = CE(S / tau1, class 0)); then InfoNCE
    over the dominant left-singular directions across the batch (loss2,
    optionally in groups of ``loss2_chunk_size``).

    ``impl="svd"`` (default) keeps ``torch.linalg.svd``'s signs of U1, as the
    reference and the JAX package keep their backends'; loss2 depends on
    them.  ``impl="gram"`` takes (S, U1) from the Gram matrix
    (:func:`_rank1_factors_gram`, positive-sum signs) and falls back to
    "svd" when M > D.

    Returns (loss1 + lambda1 * loss2, mean singular values [M])."""
    eps = 1e-8
    norms = torch.linalg.norm(features, dim=1, keepdim=True)  # [B, 1, M]
    feats = features / (norms + eps)

    if impl == "gram" and features.shape[2] <= features.shape[1]:
        S, U1 = _rank1_factors_gram(feats)  # S [B, M], U1 [B, D]
    else:
        S, U1 = _svd_rank1(feats)
    svd_values = S.mean(dim=0)

    B = U1.shape[0]
    loss1 = cross_entropy(S / tau1, torch.zeros(S.shape[0], dtype=torch.int64, device=S.device))
    if loss2_chunk_size is None or loss2_chunk_size >= B:
        logits = U1 @ U1.T / tau2
        loss2 = cross_entropy(logits, torch.arange(B, device=U1.device))
    else:
        c = max(1, int(loss2_chunk_size))
        full = (B // c) * c
        total = torch.zeros((), dtype=U1.dtype, device=U1.device)
        if full > 0:
            groups = U1[:full].reshape(-1, c, U1.shape[1])  # [G, c, D]
            logits_gc = torch.einsum("gxd,gyd->gxy", groups, groups) / tau2
            targets = torch.arange(c, device=U1.device).repeat(full // c)
            total = total + cross_entropy(logits_gc.reshape(-1, c), targets, reduction="sum")
        if full < B:
            tail = U1[full:]
            logits_t = tail @ tail.T / tau2
            total = total + cross_entropy(logits_t, torch.arange(tail.shape[0], device=U1.device),
                                          reduction="sum")
        loss2 = total / B

    return loss1 + lambda1 * loss2, svd_values


def rank1_svd_loss_from_dict(
    aligned: Dict[str, torch.Tensor],
    tau1: float,
    tau2: float,
    lambda1: float,
    loss2_chunk_size: Optional[int] = None,
    impl: str = "svd",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Stack a dict of per-modality [B, D] features (sorted keys) and apply
    :func:`rank1_svd_loss`."""
    feats = torch.stack([aligned[k] for k in sorted(aligned)], dim=-1)  # [B, D, M]
    return rank1_svd_loss(feats, tau1, tau2, lambda1, loss2_chunk_size, impl=impl)


# ---------------------------------------------------------------------------
# Gram-volume contrastive loss
# ---------------------------------------------------------------------------

def _pairwise_gram(anchor: torch.Tensor, others: Sequence[torch.Tensor]) -> torch.Tensor:
    """G[b1, b2] = Gram matrix of [anchor[b1], others[0][b2], ...]:
    anchor [B1, D], each other [B2, D] -> G [B1, B2, K+1, K+1]."""
    B1, B2 = anchor.shape[0], others[0].shape[0]
    aa = (anchor * anchor).sum(-1)[:, None].expand(B1, B2)
    a_o = [anchor @ o.T for o in others]
    oo = [[(o1 * o2).sum(-1)[None, :].expand(B1, B2) for o2 in others] for o1 in others]
    rows = [torch.stack([aa] + a_o, dim=-1)]  # [B1, B2, K+1]
    for i in range(len(others)):
        rows.append(torch.stack([a_o[i]] + oo[i], dim=-1))
    return torch.stack(rows, dim=-2)  # [B1, B2, K+1, K+1]


# cuSOLVER's batched symmetric eigensolver (``cusolverDnXsyevBatched``,
# which ``torch.linalg.eigvalsh`` calls for a batch of small matrices on the
# card) refuses a batch of 2^21 matrix entries or more with
# CUSOLVER_STATUS_INVALID_VALUE: 16384 8 x 8 matrices pass, 32768 fail (H100,
# CUDA 12.8, torch 2.11).  The volume loss at batch 512 holds 262144 of them.
EIGH_BATCH_ENTRIES = 2 ** 20


def eigvalsh_chunked(G: torch.Tensor) -> torch.Tensor:
    """``torch.linalg.eigvalsh`` of [..., K, K] in calls of at most
    ``EIGH_BATCH_ENTRIES`` matrix entries (the matrices are independent, so
    the values are those of one call)."""
    K = G.shape[-1]
    flat = G.reshape(-1, K, K)
    step = max(1, EIGH_BATCH_ENTRIES // (K * K))
    parts = [torch.linalg.eigvalsh(flat[i:i + step]) for i in range(0, flat.shape[0], step)]
    return torch.cat(parts).reshape(G.shape[:-1])


def volume_loss(
    feature_list: Sequence[torch.Tensor],
    tau1: float,
    label_smoothing: float = 0.1,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Bidirectional CE over negative Gram volumes: vol(b1, b2) =
    sqrt(|det G(b1, b2)|), matching pairs (the diagonal) should have the
    smallest volume, so logits = -vol / tau1.

    The eigenvalue monitor (second output) stays float32, as in the JAX
    package (the reference escapes to float64 for it; it is logging only,
    so no gradient flows through it)."""
    anchor, others = feature_list[0], list(feature_list[1:])
    G = _pairwise_gram(anchor, others)
    with torch.no_grad():
        evals = eigvalsh_chunked(G).clamp_min(0.0)  # [B1, B2, K+1] ascending
    vol = torch.sqrt(torch.linalg.det(G).abs())  # [B1, B2]

    B = vol.shape[0]
    targets = torch.arange(B, device=vol.device)
    loss = 0.5 * (cross_entropy(-vol / tau1, targets, label_smoothing=label_smoothing)
                  + cross_entropy(-vol.T / tau1, targets, label_smoothing=label_smoothing))
    svd_values = torch.sort(evals.mean(dim=(0, 1))).values.flip(0)
    return loss, svd_values


# ---------------------------------------------------------------------------
# CLIP bidirectional InfoNCE
# ---------------------------------------------------------------------------

def clip_alignment_loss(anchor: torch.Tensor, other: torch.Tensor,
                        logit_scale: torch.Tensor) -> torch.Tensor:
    """Bidirectional InfoNCE between L2-normalised anchor and other [B, D],
    with the conventional 0.5 mean.  Not the CLIP group loss of
    ``ClipGateRandomClam``, which keeps the reference's multi-pair form
    (``models/svd_gate.py``)."""
    a = anchor / (torch.linalg.norm(anchor, dim=-1, keepdim=True) + 1e-8)
    o = other / (torch.linalg.norm(other, dim=-1, keepdim=True) + 1e-8)
    logits = logit_scale * (a @ o.T)
    targets = torch.arange(a.shape[0], device=a.device)
    return 0.5 * (cross_entropy(logits, targets) + cross_entropy(logits.T, targets))


# ---------------------------------------------------------------------------
# Cox proportional-hazards partial likelihood
# ---------------------------------------------------------------------------

def cox_ph_loss(risk: torch.Tensor, time: torch.Tensor, event: torch.Tensor,
                eps: float = 1e-8) -> torch.Tensor:
    """Negative Cox partial log-likelihood (Breslow ties) of log-risk
    scores ``risk`` [N], follow-up ``time`` [N] and ``event`` [N] (1 = event
    observed, 0 = censored); the mean over the observed events."""
    at_risk = time[None, :] >= time[:, None]  # risk set of i: time_j >= time_i
    log_denom = torch.logsumexp(torch.where(at_risk, risk[None, :], float("-inf")), dim=1)
    pl = (risk - log_denom) * event
    n_events = event.sum().clamp_min(1.0)
    return -pl.sum() / n_events


# ---------------------------------------------------------------------------
# AUCM margin loss (libauc.losses.AUCMLoss semantics)
# ---------------------------------------------------------------------------

class _ascend(torch.autograd.Function):  # noqa: N801 (the JAX package's name)
    """Identity whose gradient is negated: descending a loss of
    ``_ascend.apply(x)`` ascends it in ``x`` (the AUCM dual variable
    alpha)."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return -g


def aucm_loss(
    y_pred: torch.Tensor,
    y_true: torch.Tensor,
    a: torch.Tensor,
    b: torch.Tensor,
    alpha: torch.Tensor,
    margin: float = 1.0,
) -> torch.Tensor:
    """AUC-margin min-max surrogate with learnable scalars (a, b, alpha) on
    score margins ``y_pred`` [N] and binary labels ``y_true`` [N]; the
    positive ratio p comes from the batch (libauc's imratio-free mode).

    The objective is min over (w, a, b), max over alpha: alpha passes
    through a gradient reversal (:class:`_ascend`), so one ordinary optimizer
    over all parameters runs the saddle dynamics.  As in the JAX package:
    no alpha >= 0 projection (libauc's PESG clips it), and a/b/alpha are
    optimised (the reference's Adam never registers libauc's tensors, so
    there they stay 0)."""
    alpha = _ascend.apply(alpha)
    y = y_true.to(y_pred.dtype)
    pos = (y == 1).to(y_pred.dtype)
    neg = 1.0 - pos
    p = pos.mean()
    loss = (
        (1.0 - p) * ((y_pred - a) ** 2 * pos).mean()
        + p * ((y_pred - b) ** 2 * neg).mean()
        + 2.0 * alpha * (p * (1.0 - p) * margin + (p * y_pred * neg - (1.0 - p) * y_pred * pos).mean())
        - p * (1.0 - p) * alpha ** 2
    )
    return loss.squeeze()

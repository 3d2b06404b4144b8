"""Fused combined similarity: CUDA kernel K1 and its plain PyTorch version.

Counterpart of ``multimodal_fusion_tpu.ops.pallas_similarity``.  The kernel
(``csrc/similarity.cu``) replaces the Pallas TPU kernel ``_sim_kernel``
(pallas_similarity.py:56, called at :186 from
``pallas_combined_similarity_rect``).  It is compute-bound on the H100 (true
f32 FMAs for the feature dot); the source note says what its tiling does
about that.  It reads feature rows with 16-byte loads: ``padded_rows``
hands it rows as they are when they allow that, else a zero-padded copy.

Staging is the Pallas wrapper's: positions pre-scaled by sqrt(lambda_g),
lambda_h folded into the row and column norms and the dot coefficient,
features staged in bf16 under ``bf16_exact`` (lossless by precondition).
``similarity_rect_plain`` repeats that staging in PyTorch, with its feature
term evaluated in float64; it is what CPU tensors get and what the kernel is
held against on the card.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from multimodal_fusion_tpu_torch.ops import _cuda


def similarity_rect_plain(
    row_features: torch.Tensor,
    row_positions: torch.Tensor,
    col_features: torch.Tensor,
    col_positions: torch.Tensor,
    lambda_h: float = 1.0,
    lambda_g: float = 1.0,
    bf16_exact: bool = False,
) -> torch.Tensor:
    """[M, N] combined similarity in plain PyTorch, with K1's staging.

    The feature term (norms and dot) accumulates in float64 and rounds to
    float32 once.  A float32 GEMM sums the dot in another order than the
    norms, which leaves errors of order 1e-5 on K's diagonal at D = 1024 --
    more than K1's own, whose norms and dot share one summation order."""
    fi = row_features.float()
    fj = col_features.float()
    if bf16_exact:
        fi = fi.to(torch.bfloat16).float()
        fj = fj.to(torch.bfloat16).float()
    fi64, fj64 = fi.double(), fj.double()
    fa = lambda_h * torch.sum(fi64 * fi64, dim=1, keepdim=True)  # [M, 1]
    fb = lambda_h * torch.sum(fj64 * fj64, dim=1)  # [N]
    arg = torch.clamp_min((fa + fb[None, :]) + (-2.0 * lambda_h) * (fi64 @ fj64.T), 0.0).float()
    g_scale = float(lambda_g) ** 0.5
    pi = row_positions.float() * g_scale
    pj = col_positions.float() * g_scale
    for p in range(pi.shape[1]):
        diff = pi[:, p, None] - pj[None, :, p]
        arg = arg + diff * diff
    return torch.exp(-arg)


def padded_rows(x: torch.Tensor) -> torch.Tensor:
    """Feature rows ``x`` [R, D] as K1 reads them, 16 bytes at a time: ``x``
    itself when it is contiguous, its base pointer on 16 bytes and D a
    multiple of 16 bytes (4 float32 or 8 bfloat16 values); otherwise a
    contiguous copy with D zero-padded up to that multiple.  Zeros add
    nothing to K1's dot or norms, so K is the same either way."""
    per = 16 // x.element_size()
    if x.is_contiguous() and x.shape[1] % per == 0 and x.data_ptr() % 16 == 0:
        return x
    pad = -x.shape[1] % per
    if pad:
        return torch.nn.functional.pad(x, (0, pad))
    return x.clone(memory_format=torch.contiguous_format)


@functools.cache  # loaded and typed once per process
def _lib():
    lib = _cuda.load("similarity")
    for fn in (lib.mmf_similarity_f32, lib.mmf_similarity_bf16):
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def similarity_rect(
    row_features: torch.Tensor,
    row_positions: torch.Tensor,
    col_features: torch.Tensor,
    col_positions: torch.Tensor,
    lambda_h: float = 1.0,
    lambda_g: float = 1.0,
    bf16_exact: bool = False,
) -> torch.Tensor:
    """[M, N] combined similarity: K1 on CUDA tensors, the plain version on
    CPU tensors.  ``similarity_rect.launches`` counts kernel launches."""
    if row_features.device.type == "cpu":
        return similarity_rect_plain(
            row_features, row_positions, col_features, col_positions,
            lambda_h, lambda_g, bf16_exact,
        )
    if row_features.device.type != "cuda":
        raise ValueError(f"similarity_rect: unsupported device {row_features.device}")
    m, d = row_features.shape
    n = col_features.shape[0]
    n_pos = row_positions.shape[1]
    if col_features.shape[1] != d or col_positions.shape[1] != n_pos:
        raise ValueError("similarity_rect: row/col feature or position widths differ")
    if row_positions.shape[0] != m or col_positions.shape[0] != n:
        raise ValueError("similarity_rect: positions and features disagree on row counts")
    tensors = (row_features, row_positions, col_features, col_positions)
    if any(t.device != row_features.device for t in tensors):
        raise ValueError("similarity_rect: inputs on different devices")
    feat_dtype = torch.bfloat16 if bf16_exact else torch.float32
    # the build's square call passes each input twice: staged once
    fi = padded_rows(row_features.to(feat_dtype))
    fj = fi if col_features is row_features else padded_rows(col_features.to(feat_dtype))
    g_scale = float(lambda_g) ** 0.5
    pi = (row_positions.float() * g_scale).contiguous()
    pj = pi if col_positions is row_positions else (col_positions.float() * g_scale).contiguous()
    out = torch.empty((m, n), dtype=torch.float32, device=row_features.device)
    if m == 0 or n == 0:
        return out
    lib = _lib()
    fn = lib.mmf_similarity_bf16 if bf16_exact else lib.mmf_similarity_f32
    err = _cuda.call(
        row_features.device, fn,
        fi.data_ptr(), pi.data_ptr(), fj.data_ptr(), pj.data_ptr(), out.data_ptr(),
        m, n, fi.shape[1], n_pos, float(lambda_h),
    )
    _cuda.check(err, "similarity kernel")
    similarity_rect.launches += 1
    return out


similarity_rect.launches = 0


def combined_similarity_auto(
    features: torch.Tensor,
    positions: torch.Tensor,
    lambda_h: float = 1.0,
    lambda_g: float = 1.0,
    bf16_exact: bool = False,
) -> torch.Tensor:
    """The build's square [N, N] similarity (counterpart of both
    ``pallas_combined_similarity`` and the ``combined_similarity_auto``
    dispatcher).  On CUDA, K1 at every N: the TPU's ``MIN_PALLAS_N = 1024``
    crossover was a TPU measurement and does not carry over.  On the CPU,
    K1's plain version."""
    return similarity_rect(
        features, positions, features, positions, lambda_h, lambda_g, bf16_exact
    )

"""Operations and bytes of one launch of the port's attention kernels, as
the shapes and masks need them.

K3 (the forward) computes s = q k^T and o = p v: 4 * H * hd FLOPs per query
and kept key.  K4 (the backward, recomputing p) computes s, dp, dq, dk and
dv: 10 * H * hd FLOPs per query and kept key, the convention of
FlashAttention's papers.  Bytes: each input read once and each output
written once at the input width, only the kept keys' rows of k and v (and
their gradients), the row statistics in float32 and one byte a key of mask.
Queries count whole: the kernels take no query mask.
"""

from __future__ import annotations

from typing import Optional, Tuple


def attention_fwd(b: int, h: int, t_q: int, t_k: int, hd: int, itemsize: int = 4,
                  kept_keys: Optional[int] = None, masked: bool = False) -> Tuple[float, float]:
    """(operations, bytes) of K3 over [b, t_q | t_k, h, hd]; ``kept_keys``
    the keys the mask keeps summed over the batch (default all)."""
    keys = b * t_k if kept_keys is None else kept_keys
    ops = 4.0 * h * hd * t_q * keys
    nbytes = (h * hd * itemsize * (2 * b * t_q + 2 * keys)  # q read, o written; k, v read
              + 2 * 4 * b * h * t_q  # m and l written
              + (b * t_k if masked else 0))
    return ops, float(nbytes)


def attention_bwd(b: int, h: int, t_q: int, t_k: int, hd: int, itemsize: int = 4,
                  kept_keys: Optional[int] = None, masked: bool = False) -> Tuple[float, float]:
    """(operations, bytes) of K4: q, do read and dq written; k, v read and
    dk, dv written; m, l and dsum read."""
    keys = b * t_k if kept_keys is None else kept_keys
    ops = 10.0 * h * hd * t_q * keys
    nbytes = (h * hd * itemsize * (3 * b * t_q + 4 * keys)
              + 3 * 4 * b * h * t_q
              + (b * t_k if masked else 0))
    return ops, float(nbytes)

"""Device resolution and float32 precision for the PyTorch port.

Every entry point of the port takes ``device=None``, which means the CUDA
card: a run on the CPU happens only when the caller asks for it
(``device="cpu"``), as the tests do.  Asking for CUDA without a card raises
instead of falling back.

TF32 is switched off for matmuls and cuDNN: the norm-expansion distances
``||a||^2 + ||b||^2 - 2 a.b`` cancel catastrophically at reduced precision
(large-magnitude slide coordinates turn into negative "distances" and
``exp(+huge)``), which is why the JAX package runs those dots at HIGHEST.
"""

from __future__ import annotations

from typing import Optional, Union

import torch


def strict_fp32() -> None:
    """Run float32 matmuls and convolutions in true float32 (no TF32)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """``None`` -> ``cuda``; raises when CUDA is asked for and absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA device requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run on the CPU"
        )
    strict_fp32()
    return dev

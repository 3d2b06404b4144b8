"""float32 as the configurations state it (TF32 off), and the control, TF32.

The control is the reference computed in the precision just below the
stated one.  On the card that is cuBLAS's own TF32 mode, switched on for the
reference's matmuls only; the CPU has no TF32, so there ``linear`` and
``matmul`` round their operands to TF32's 10-bit mantissa instead.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to TF32 (8-bit exponent, 10-bit mantissa), to nearest
    with ties away from zero, as the card converts; the gradient passes
    through unchanged."""
    bits = x.detach().contiguous().view(torch.int32)
    rounded = ((bits + 0x1000) & -0x2000).view(torch.float32)
    return x + (rounded - x).detach()


class Numerics:
    """The precision of one reference run: float32 (``tf32`` False) or the
    TF32 control."""

    def __init__(self, tf32: bool = False):
        self.tf32 = tf32

    def _operand(self, x: torch.Tensor) -> torch.Tensor:
        return tf32_round(x) if self.tf32 and x.device.type != "cuda" else x

    def linear(self, x, weight, bias=None):
        return F.linear(self._operand(x), self._operand(weight), bias)

    def matmul(self, a, b):
        return torch.matmul(self._operand(a), self._operand(b))

    @contextlib.contextmanager
    def active(self):
        """The card's matmul precision for this run, restored after."""
        saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
                 torch.get_float32_matmul_precision())
        torch.backends.cuda.matmul.allow_tf32 = self.tf32
        torch.backends.cudnn.allow_tf32 = self.tf32
        torch.set_float32_matmul_precision("high" if self.tf32 else "highest")
        try:
            yield self
        finally:
            torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved[:2]
            torch.set_float32_matmul_precision(saved[2])


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, eps: float) -> torch.Tensor:
    return F.layer_norm(x, (x.shape[-1],), weight, bias, eps)

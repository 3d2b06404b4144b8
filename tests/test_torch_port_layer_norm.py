"""The LayerNorm wrapper on the CPU: the composite formula, bit for bit.

Kernel K5 itself runs only on the card (``tests/test_torch_port_cuda.py``);
here the wrapper must leave every CPU number as the composite ops gave it.
"""

import numpy as np
import pytest
import torch

from multimodal_fusion_tpu_torch.models.common import LayerNorm
from multimodal_fusion_tpu_torch.ops.layer_norm import layer_norm, layer_norm_bwd


def _composite(x, weight, bias, eps):
    # models/common.py:LayerNorm.forward as the port wrote it before K5
    mu = x.mean(dim=-1, keepdim=True)
    var = ((x * x).mean(dim=-1, keepdim=True) - mu * mu).clamp_min(0.0)
    return (x - mu) * (torch.rsqrt(var + eps) * weight) + bias


def _inputs(shape, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(np.float32) * 3.0 + 0.5
    flat = x.reshape(-1, shape[-1])
    flat[0] = 0.75  # a constant row: variance 0
    flat[-1] = 0.0  # an all-zero padding row
    w = (1.0 + 0.1 * rng.standard_normal(shape[-1])).astype(np.float32)
    b = (0.02 * rng.standard_normal(shape[-1])).astype(np.float32)
    dy = rng.standard_normal(shape).astype(np.float32)
    return [torch.as_tensor(a) for a in (x, w, b, dy)]


def _value_and_grads(fn, x, w, b, dy):
    leaves = [t.clone().requires_grad_(True) for t in (x, w, b)]
    y = fn(*leaves, 1e-6)
    y.backward(dy)
    return [y.detach()] + [t.grad for t in leaves]


@pytest.mark.parametrize("shape", [(2, 5, 128), (3, 7, 36), (64, 18), (4, 1024)],
                         ids=["config1_width", "width36", "width18", "width1024"])
def test_layer_norm_on_cpu_is_the_composite_bit_for_bit(shape):
    x, w, b, dy = _inputs(shape, sum(shape))
    got = _value_and_grads(layer_norm, x, w, b, dy)
    want = _value_and_grads(_composite, x, w, b, dy)
    for name, g, t in zip(("y", "dx", "dw", "db"), got, want):
        assert torch.equal(g, t), name
    module = LayerNorm(shape[-1])
    with torch.no_grad():
        module.weight.copy_(w)
        module.bias.copy_(b)
    assert torch.equal(module(x), want[0])


def test_layer_norm_wrapper_takes_the_kernel_off_the_cpu_or_raises():
    before = (layer_norm.launches, layer_norm_bwd.launches)
    x, w, b, _ = _inputs((3, 16), 0)
    layer_norm(x, w, b)  # the plain version: no launch
    assert (layer_norm.launches, layer_norm_bwd.launches) == before
    meta = torch.zeros((3, 16), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        layer_norm(meta, meta[0], meta[0])
    assert (layer_norm.launches, layer_norm_bwd.launches) == before


def test_layer_norm_impl_plain_and_tracing(monkeypatch):
    """``impl="plain"`` takes the composite ops on any device; ``"auto"``
    off the CPU raises under tracing, which cannot enter K5's launch,
    instead of taking the plain version unasked."""
    x, w, b, _ = _inputs((3, 16), 1)
    assert torch.equal(layer_norm(x, w, b, impl="plain"), _composite(x, w, b, 1e-6))
    with pytest.raises(ValueError, match="unknown impl"):
        layer_norm(x, w, b, impl="kernel")
    meta = torch.zeros((3, 16), device="meta")
    assert layer_norm(meta, meta[0], meta[0], impl="plain").device.type == "meta"
    monkeypatch.setattr(torch.compiler, "is_compiling", lambda: True)
    with pytest.raises(RuntimeError, match="impl='plain'"):
        layer_norm(meta, meta[0], meta[0])
    assert torch.equal(layer_norm(x, w, b), _composite(x, w, b, 1e-6))  # the CPU traces the plain version


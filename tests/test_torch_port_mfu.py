"""MFU accounting in the port (``utils/mfu``) against the JAX package's
on the CPU: the analytic byte model and the byte count of nested trees
equal JAX's on the same inputs, and a CPU ``measure_device`` counts a
matmul's FLOPs and reports JAX's keys.  Times on the CPU are host times
at nominal peaks and say nothing about a card."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_fusion_tpu.utils import mfu as jmfu
from multimodal_fusion_tpu_torch.utils import mfu

TREES = {
    "flat": lambda lib: {"a": lib.ones((4, 8), "float32"), "b": lib.ones((2,), "bfloat16")},
    "none": lambda lib: {"a": lib.ones((3,), "float32"), "b": None},
    "nested": lambda lib: {"params": {"w": lib.ones((5, 7), "float32"),
                                      "layers": [lib.ones((3, 3), "float32"), None]},
                           "batch": (lib.ones((2, 4, 6), "bfloat16"), lib.ones((9,), "int32"))},
}


class _Torch:
    @staticmethod
    def ones(shape, dtype):
        return torch.ones(shape, dtype=getattr(torch, dtype))


class _Numpy:
    @staticmethod
    def ones(shape, dtype):
        return np.ones(shape, np.float16 if dtype == "bfloat16" else dtype)  # 2 bytes, as bf16


class _Jax:
    @staticmethod
    def ones(shape, dtype):
        return jnp.ones(shape, getattr(jnp, dtype))


@pytest.mark.parametrize("lib", [_Torch, _Numpy])
@pytest.mark.parametrize("tree", sorted(TREES))
def test_tree_bytes_matches_jax(tree, lib):
    assert mfu.tree_bytes(TREES[tree](lib)) == jmfu.tree_bytes(TREES[tree](_Jax)) > 0


@pytest.mark.parametrize("mode", ["train", "eval"])
@pytest.mark.parametrize("terms", [
    dict(input_bytes=10.0, weight_bytes=100.0, trainable_bytes=40.0, hbm_activation_bytes=5.0),
    dict(input_bytes=3.5e6, weight_bytes=2.25e8),
])
def test_analytic_step_bytes_matches_jax(terms, mode):
    assert mfu.analytic_step_bytes(**terms, mode=mode) == jmfu.analytic_step_bytes(**terms, mode=mode)


def test_measure_device_counts_a_matmul_on_the_cpu():
    a = torch.ones((256, 256))
    rep = mfu.measure_device(lambda x: x @ x, (a,), iters=3, dtype="float32", work_items=256)
    want = jmfu.measure_device(lambda x: x @ x, (jnp.ones((256, 256)),), iters=3, dtype="float32",
                               work_items=256)
    # a host can beat the CPU row's nominal peak, which sets suspect_roofline
    assert set(rep) - {"suspect_roofline"} == set(want) - {"suspect_roofline"}
    assert rep["flops_per_call"] == 2 * 256 ** 3
    assert rep["device_kind"] == "cpu" and rep["sec_per_call"] > 0 and rep["items_per_sec"] > 0
    assert rep["bytes_model"] == "none" and rep["bound"] == "compute"
    assert rep["fraction_of_roofline"] == pytest.approx(rep["mfu"])
    kind, bf16, f32, bw = mfu.chip_peaks("cpu")
    assert kind == "cpu" and rep["peak_tflops"] == f32 / 1e12
    # nothing the counter can see: timing only
    opaque = mfu.measure_device(lambda x: None, (a,), iters=2)
    assert opaque["flops_per_call"] is None and "mfu" not in opaque


def test_measure_device_flags_an_impossible_roofline():
    """A byte count far above what the call moves puts its memory bound
    below the time it took: the report flags it instead of publishing a
    share of the roofline above 1."""
    a = torch.ones((128, 128))
    rep = mfu.measure_device(lambda x: x @ x, (a,), iters=2, bytes_override=1e15)
    assert rep["bytes_model"] == "analytic" and rep["bound"] == "memory"
    assert rep.get("suspect_roofline") is True
    honest = mfu.measure_device(lambda x: x @ x, (a,), iters=2, flops_override=1.0,
                                bytes_override=3 * a.numel() * 4)
    assert "suspect_roofline" not in honest and honest["flops_per_call"] == 1.0


@pytest.mark.parametrize("name, row", [
    ("NVIDIA H100 80GB HBM3", (989e12, 67e12, 3.35e12)),
    ("NVIDIA H100 PCIe", (756e12, 51e12, 2.0e12)),
    ("NVIDIA Unlisted Card", (989e12, 67e12, 3.35e12)),  # the H100 SXM row
])
def test_chip_peaks_reads_the_card_name(monkeypatch, name, row):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda device=None: name)
    assert mfu.chip_peaks() == (name.lower(), *row)

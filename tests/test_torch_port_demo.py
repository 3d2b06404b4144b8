"""The port's demo (``multimodal_fusion_tpu_torch/demo/example_usage.py``)
against the JAX package's (``demo/example_usage.py``) on the CPU: it runs
as a module with ``--device cpu``, refuses to run without a card by
default, prints the JAX demo's lines, and with the JAX demo models'
weights carried across (``survival_params_from_jax``) gives their
evaluation logits, probabilities and loss within 1e-5."""

import importlib.util
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from flax import nnx

from multimodal_fusion_tpu.models.factory import ModelFactory as JaxFactory
from multimodal_fusion_tpu_torch.demo import example_usage as demo
from multimodal_fusion_tpu_torch.models.factory import ModelFactory
from multimodal_fusion_tpu_torch.models.jax_params import survival_params_from_jax

REPO = Path(__file__).resolve().parents[1]
_spec = importlib.util.spec_from_file_location("jax_demo", REPO / "demo" / "example_usage.py")
jax_demo = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(jax_demo)


def _run(*flags):
    return subprocess.run([sys.executable, "-m", "multimodal_fusion_tpu_torch.demo.example_usage",
                           *flags], capture_output=True, text=True, timeout=300, cwd=REPO,
                          env=dict(os.environ, PYTHONPATH=str(REPO)))


def _labels(text):
    """Each printed line's label (the text before its colon, or the line)."""
    return [ln.split(":")[0] for ln in text.splitlines() if ln.strip()]


def test_demo_runs_on_the_cpu_and_prints_the_jax_demos_lines(capsys):
    res = _run("--device", "cpu")
    assert res.returncode == 0, res.stderr[-2000:]
    assert "Demo complete" in res.stdout and "failed" not in res.stdout
    for model_type in demo.MODEL_TYPES:
        jax_demo.demonstrate(model_type)
    want = _labels(capsys.readouterr().out)
    got = _labels(res.stdout)
    assert got[0] == "torch device" and got[1:-1] == want and got[-1] == "Demo complete."


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the run without a card")
def test_demo_raises_without_a_card():
    res = _run()
    assert res.returncode != 0 and "torch.cuda.is_available() is False" in res.stderr


@pytest.mark.parametrize("model_type", demo.MODEL_TYPES)
def test_demo_matches_the_jax_demo(model_type, capsys):
    jmodel = JaxFactory.create_model(jax_demo.make_config(model_type), seed=0)
    jcase = jax_demo.create_mock_case()
    label = np.asarray(1)
    want = jmodel(jcase, label, train=False)
    want_loss = jmodel.loss_fn(want["logits"], label[None], want)
    model = ModelFactory.create_model(demo.make_config(model_type), seed=0, device="cpu")
    model.load_state_dict(survival_params_from_jax(nnx.to_pure_dict(nnx.state(jmodel, nnx.Param))),
                          strict=True)
    got = demo.demonstrate(model_type, "cpu", model)
    assert f"=== {model_type} ===" in capsys.readouterr().out
    np.testing.assert_allclose(got["logits"].numpy(), np.asarray(want["logits"]), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(got["probabilities"].numpy(), np.asarray(want["probabilities"]),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got["loss"].numpy(), np.asarray(want_loss).reshape(-1), rtol=1e-5,
                               atol=1e-5)
    assert np.isfinite(got["train_loss"].numpy()).all()

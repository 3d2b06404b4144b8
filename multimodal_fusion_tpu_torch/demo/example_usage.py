"""Demo: fusion forward pass on toy embeddings, in the PyTorch port
(counterpart of ``demo/example_usage.py``).

Builds ``svd_gate_random_clam`` and ``deep_supervise_svd_gate_random``
through the port's factory, runs an evaluation forward, the loss and a
training forward (dropout and random modality dropping, drawn from an
explicit ``torch.Generator``) on one mock case of [4, 1024] bags, and
prints the result shapes::

    python -m multimodal_fusion_tpu_torch.demo.example_usage               # the CUDA card
    python -m multimodal_fusion_tpu_torch.demo.example_usage --device cpu

Like every entry point of the port it runs on the CUDA card unless
``--device`` names another device, and raises without a card.  The mock
case is the JAX demo's (the same numpy draws); the models' weights are
drawn by the port's factory.
"""

from __future__ import annotations

import argparse
from typing import Dict, Optional

import numpy as np
import torch

from multimodal_fusion_tpu_torch.config import ModelConfig
from multimodal_fusion_tpu_torch.device import resolve_device
from multimodal_fusion_tpu_torch.models.factory import ModelFactory

FEATURE_DIM = 1024
N_INSTANCES = 4
MODEL_TYPES = ("svd_gate_random_clam", "deep_supervise_svd_gate_random")


def create_mock_case(seed: int = 0, device=None) -> Dict[str, Dict[str, torch.Tensor]]:
    """Mock multimodal case: wsi/tma bags of [4, 1024] + tabular vectors,
    with a leading case axis of 1 (the port's models take windows)."""
    rng = np.random.default_rng(seed)
    channels = {
        "wsi=features": rng.standard_normal((N_INSTANCES, FEATURE_DIM)),
        "tma=cd3=features": rng.standard_normal((N_INSTANCES, FEATURE_DIM)),
        "tma=cd8=features": rng.standard_normal((N_INSTANCES, FEATURE_DIM)),
        "clinical=val": rng.standard_normal((1, 16)),
        "clinical=mask": np.ones((1, 16)),
    }
    return {
        "channels": {k: torch.as_tensor(v[None], dtype=torch.float32, device=device)
                     for k, v in channels.items()},
        "masks": {k: torch.ones((1, N_INSTANCES), dtype=torch.bool, device=device)
                  for k in ("wsi=features", "tma=cd3=features", "tma=cd8=features")},
    }


def make_config(model_type: str) -> ModelConfig:
    return ModelConfig(
        model_type=model_type,
        n_classes=2,
        input_dim=FEATURE_DIM,
        model_size="64*32",
        dropout=0.25,
        output_dim=128,
        channels_used_in_model=[
            "wsi=features",
            "tma=cd3=features",
            "tma=cd8=features",
            "clinical=val",
            "clinical=mask",
        ],
        channel_input_dims={"clinical=val": 16},
        enable_svd=True,
        enable_dynamic_gate=True,
        enable_random_loss=True,
    )


def demonstrate(model_type: str, device=None, model: Optional[torch.nn.Module] = None
                ) -> Dict[str, torch.Tensor]:
    """Print the demo's lines for ``model_type`` (``model``: its weights,
    default the factory's at seed 0) and return the evaluation logits and
    probabilities and both losses."""
    print(f"\n=== {model_type} ===")
    if model is None:
        model = ModelFactory.create_model(make_config(model_type), seed=0, device=device)
    case = create_mock_case(device=device)
    label = torch.ones(1, dtype=torch.int64, device=device)

    with torch.no_grad():
        result = model(case, label, train=False)
        loss = model.loss_fn(result["logits"], label, result)
    print(f"logits:        {tuple(result['logits'].shape)}")
    print(f"probabilities: {tuple(result['probabilities'].shape)} -> "
          f"{result['probabilities'][0].cpu().numpy()}")
    print(f"predictions:   {tuple(result['predictions'].shape)} -> {int(result['predictions'][0])}")
    print(f"loss:          {float(loss[0]):.4f}")
    aux = [k for k in result if k.endswith("_loss")]
    if aux:
        print(f"aux losses:    {aux}")

    # training-mode pass exercises dropout / random modality dropping
    generator = torch.Generator(device=device).manual_seed(0)
    with torch.no_grad():
        result_train = model(case, label, generator=generator, train=True)
        loss_train = model.loss_fn(result_train["logits"], label, result_train)
    print(f"train loss:    {float(loss_train[0]):.4f}")
    return {"logits": result["logits"], "probabilities": result["probabilities"],
            "loss": loss, "train_loss": loss_train}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="Fusion forward pass on toy embeddings")
    p.add_argument("--device", type=str, default=None,
                   help="torch device; default: the CUDA card (cpu runs on the host)")
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    name = torch.cuda.get_device_name(device) if device.type == "cuda" else "host"
    print(f"torch device: {device} ({name})")
    failed = []
    for model_type in MODEL_TYPES:
        try:
            demonstrate(model_type, device)
        except Exception as e:  # report each model, then fail the run
            print(f"{model_type} failed: {e}")
            failed.append(model_type)
    print("\nDemo complete.")
    return 1 if failed else 0


if __name__ == "__main__":
    raise SystemExit(main())

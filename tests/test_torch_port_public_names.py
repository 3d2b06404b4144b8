"""The port's remaining public names against the JAX package's on the CPU:
the channel helpers, ``io.h5io``'s ``read_channel``, ``has_channel`` and
``PatientH5`` on one HDF5 fixture, ``train.checkpoint.load_subtree``, the
package re-exports, every CLI's ``script_main`` and the ``mmf-torch-*``
console scripts."""

import importlib
import tomllib
from pathlib import Path

import numpy as np
import pytest
import torch

import multimodal_fusion_tpu as jpkg
import multimodal_fusion_tpu_torch as tpkg
from multimodal_fusion_tpu import channels as jchannels
from multimodal_fusion_tpu.io import h5io as jh5io
from multimodal_fusion_tpu.io.fixtures import make_synthetic_dataset
from multimodal_fusion_tpu.train import checkpoint as jcheckpoint
from multimodal_fusion_tpu_torch import channels
from multimodal_fusion_tpu_torch.io import h5io
from multimodal_fusion_tpu_torch.train import checkpoint

ROOT = Path(__file__).resolve().parents[1]
CLIS = sorted(p.stem for p in (ROOT / "multimodal_fusion_tpu_torch" / "cli").glob("*.py")
              if p.stem != "__init__")
SAMPLE = ["wsi=features", "tma=cd3=features", "clinical=val", "clinical=mask", "blood=ori_val",
          "hypergraph=edge_index", "tma_cell_density=mask"]


def test_channel_helpers_match_jax(capsys):
    assert channels.get_available_channels() == jchannels.get_available_channels()
    channels.print_available_channels()
    mine = capsys.readouterr().out
    jchannels.print_available_channels()
    assert mine == capsys.readouterr().out and "ICD channels: icd" in mine
    for ch in SAMPLE:
        assert channels.channel_group(ch) == jchannels.channel_group(ch)
        assert channels.is_mask_channel(ch) == jchannels.is_mask_channel(ch)
        assert channels.mask_channel_for(ch) == jchannels.mask_channel_for(ch)


def test_package_reexports_match_jax():
    assert tpkg.TMA_MARKERS == jpkg.TMA_MARKERS
    assert tpkg.get_available_channels() == jpkg.get_available_channels()
    assert tpkg.parse_channels(["wsi", "clinical_mask"]) == jpkg.parse_channels(["wsi", "clinical_mask"])


def test_h5_helpers_match_jax(tmp_path):
    make_synthetic_dataset(tmp_path, n_patients=2, seed=1, min_wsi_patches=4, max_wsi_patches=9,
                           feature_dim=8, markers=("cd3",))
    path = next(tmp_path.rglob("*.h5"))
    for ch in ("wsi=features", "tma=cd3=features", "clinical=val", "clinical=mask"):
        np.testing.assert_array_equal(h5io.read_channel(path, ch), jh5io.read_channel(path, ch))
        assert h5io.has_channel(path, ch) and jh5io.has_channel(path, ch)
    assert not h5io.has_channel(path, "tma=cd8=features")
    mine, theirs = h5io.PatientH5(path), jh5io.PatientH5(path)
    assert mine.channels() == theirs.channels()
    mine.write("wsi=reconstructed_features", np.ones((3, 8), np.float32))
    assert mine.has("wsi=reconstructed_features") and theirs.has("wsi=reconstructed_features")
    np.testing.assert_array_equal(theirs.read("wsi=reconstructed_features"),
                                  mine.read("wsi=reconstructed_features"))
    with pytest.raises(KeyError):
        mine.read("tma=cd8=features")


def test_load_subtree_matches_jax(tmp_path):
    rng = np.random.default_rng(0)
    model = {"encoder.0.weight": rng.standard_normal((4, 3)).astype(np.float32),
             "encoder.0.bias": rng.standard_normal(4).astype(np.float32)}
    opt = {"step": np.array(7)}
    checkpoint.save_state(tmp_path / "port.npz", {"model": model, "opt": opt})
    jcheckpoint.save_state(tmp_path / "jax.npz", {"model": model, "opt": opt})
    template = {k: np.zeros_like(v) for k, v in model.items()}
    for path in ("port.npz", "jax.npz"):
        got = checkpoint.load_subtree(tmp_path / path, template, "model")
        want = jcheckpoint.load_subtree(tmp_path / path, template, "model")
        assert set(got) == set(want) == set(model)
        for k in model:
            np.testing.assert_array_equal(got[k], want[k])
            np.testing.assert_array_equal(got[k], model[k])
    tensors = checkpoint.load_subtree(tmp_path / "port", {k: torch.zeros(v.shape) for k, v in
                                                          model.items()}, "model")
    assert all(torch.equal(tensors[k], torch.as_tensor(model[k])) for k in model)
    for side in (checkpoint, jcheckpoint):
        with pytest.raises(KeyError):
            side.load_subtree(tmp_path / "port.npz", {"absent": np.zeros(1)}, "model")
        with pytest.raises(ValueError, match="shape mismatch"):
            side.load_subtree(tmp_path / "port.npz", {"encoder.0.bias": np.zeros(5)}, "model")


@pytest.mark.parametrize("cli", CLIS)
def test_script_main_returns_zero(monkeypatch, cli):
    """The console-script wrapper exits with ``script_main``'s value: 0
    after a run, whatever result ``main`` hands its programmatic callers."""
    module = importlib.import_module(f"multimodal_fusion_tpu_torch.cli.{cli}")
    seen = []
    monkeypatch.setattr(module, "main", lambda argv=None: seen.append(argv) or {"result": 1})
    assert module.script_main(["--flag"]) == 0 and seen == [["--flag"]]


def test_console_scripts_resolve():
    scripts = tomllib.loads((ROOT / "pyproject.toml").read_text())["project"]["scripts"]
    port = {k: v for k, v in scripts.items() if k.startswith("mmf-torch-")}
    jax = {k: v for k, v in scripts.items() if not k.startswith("mmf-torch-")}
    assert sorted(port) == sorted(k.replace("mmf-", "mmf-torch-", 1) for k in jax)
    assert len(port) == len(CLIS) == 11
    for name, target in port.items():
        module, func = target.split(":")
        assert module == jax[name.replace("mmf-torch-", "mmf-")].split(":")[0].replace(
            "multimodal_fusion_tpu.", "multimodal_fusion_tpu_torch.", 1)
        assert callable(getattr(importlib.import_module(module), func)), name

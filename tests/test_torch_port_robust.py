"""The missing-modality robustness sweep in the port (``utils/robust``)
against the JAX package's on the CPU.

One ``svd_gate_random_clam_detach`` run is trained by the JAX package's
``main_survival`` and carried into a port results dir (configs, persisted
splits, fold checkpoints through ``survival_params_from_jax``).  At
drop_prob 0 no draw is made, so both sweeps' auc, acc and loss agree
within 1e-5.  Above 0 the port draws from a ``torch.Generator``, not from
jax.random (ROADMAP "Random numbers"), so its rows are held to its own
``evaluate_fold`` under the same seed.
"""

import json
import shutil

import numpy as np
import pytest
from flax import nnx

from multimodal_fusion_tpu import config as jconfig
from multimodal_fusion_tpu.cli.main_survival import main as jax_main_survival
from multimodal_fusion_tpu.io.fixtures import make_synthetic_dataset
from multimodal_fusion_tpu.models.factory import ModelFactory as JaxFactory
from multimodal_fusion_tpu.train.checkpoint import load_state as jax_load_state
from multimodal_fusion_tpu.utils.robust import robustness_sweep as jax_sweep
from multimodal_fusion_tpu_torch.config import Configs
from multimodal_fusion_tpu_torch.data.splits import load_fold_split
from multimodal_fusion_tpu_torch.models.factory import ModelFactory
from multimodal_fusion_tpu_torch.models.jax_params import survival_params_from_jax
from multimodal_fusion_tpu_torch.train.checkpoint import save_model
from multimodal_fusion_tpu_torch.utils import robust
from multimodal_fusion_tpu_torch.utils.results_io import load_results_context
from multimodal_fusion_tpu_torch.utils.visualization import plot_robust_results

CHANNELS = ["wsi=features", "tma=cd3=features", "clinical=val", "clinical=mask"]
COLUMNS = ["fold", "drop_prob", "auc", "acc", "loss"]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(data root, CSV, the JAX results dir, the port results dir)."""
    root = tmp_path_factory.mktemp("robust")
    csv_path = make_synthetic_dataset(root, n_patients=10, seed=5, min_wsi_patches=16,
                                      max_wsi_patches=30, feature_dim=32, n_tma_patches=3)
    jres = jax_main_survival([
        "--csv_path", str(csv_path), "--data_root_dir", str(root),
        "--results_dir", str(root / "results"), "--exp_code", "rb",
        "--model_type", "svd_gate_random_clam_detach",
        "--target_channels", *CHANNELS, "--channels_used_in_model", *CHANNELS,
        "--input_dim", "32", "--model_size", "32*16", "--output_dim", "32",
        "--k", "2", "--max_epochs", "1", "--batch_size", "4",
        "--enable_svd", "--enable_dynamic_gate", "--seed", "0",
    ])
    pres = root / "port"
    pres.mkdir()
    for f in list(jres.glob("configs_*.json")) + list(jres.glob("splits_*.csv")):
        shutil.copy(f, pres / f.name)
    configs = jconfig.Configs.load(next(jres.glob("configs_*.json")))
    for fold in (0, 1):
        jm = JaxFactory.create_model(configs.model_config, seed=configs.experiment_config.seed)
        _, params, rest = nnx.split(jm, nnx.Param, ...)
        restored, _ = jax_load_state(jres / f"s_{fold}_checkpoint.npz", {"params": params, "rest": rest})
        model = ModelFactory.create_model(Configs.load(next(pres.glob("configs_*.json"))).model_config,
                                          device="cpu")
        model.load_state_dict(survival_params_from_jax(nnx.to_pure_dict(restored["params"])))
        save_model(pres / f"s_{fold}_checkpoint.npz", model)
    return root, csv_path, jres, pres


def _assert_rows_agree(got, want):
    assert [{k: r[k] for k in ("fold", "drop_prob")} for r in got] == \
        [{k: r[k] for k in ("fold", "drop_prob")} for r in want]
    for g, w in zip(got, want):
        for k in ("auc", "acc", "loss"):
            np.testing.assert_allclose(g[k], w[k], rtol=1e-5, atol=1e-5, err_msg=k)


def test_sweep_matches_jax_and_reads_persisted_splits(runs, tmp_path, monkeypatch):
    root, csv_path, jres, pres = runs
    want = jax_sweep(jres, csv_path, root, drop_probs=(0.0,), output_path=tmp_path / "jax")

    def refuse(*a, **kw):
        raise AssertionError("sweep re-derived splits instead of loading splits_<fold>.csv")

    with monkeypatch.context() as m:
        m.setattr(robust, "create_k_fold_splits", refuse)
        got = robust.robustness_sweep(pres, csv_path, root, drop_probs=(0.0, 0.5),
                                      output_path=tmp_path / "port", device="cpu")
    assert [(r["fold"], r["drop_prob"]) for r in got] == [(0, 0.0), (0, 0.5), (1, 0.0), (1, 0.5)]
    _assert_rows_agree([r for r in got if r["drop_prob"] == 0.0], want)
    # the files: JAX's columns, read back by the plotting helper
    lines = (tmp_path / "port.csv").read_text().splitlines()
    assert lines[0] == ",".join(COLUMNS) and len(lines) == 5
    assert json.loads((tmp_path / "port.json").read_text()) == got
    plot = plot_robust_results(tmp_path / "port.json", tmp_path / "plot")
    assert plot is None or plot.exists()

    # above 0: the port's own evaluate_fold under the same seed
    configs, dataset, trainer, folds = load_results_context(pres, csv_path, root, device="cpu")
    for row in got:
        split = load_fold_split(pres / f"splits_{row['fold']}.csv", dataset.case_ids)
        res = trainer.evaluate_fold(dataset, split, row["fold"],
                                    drop_prob=row["drop_prob"] or None, seed=0)
        assert (res["auc"], res["acc"], res["loss"]) == (row["auc"], row["acc"], row["loss"])


def test_sweep_derives_splits_without_the_persisted_ones(runs, tmp_path):
    """A results dir without splits_<fold>.csv: both packages derive the
    same splits from the seed and agree at drop_prob 0."""
    root, csv_path, jres, pres = runs
    for src, name in ((jres, "jax_bare"), (pres, "port_bare")):
        shutil.copytree(src, tmp_path / name, ignore=shutil.ignore_patterns("splits_*.csv"))
    want = jax_sweep(tmp_path / "jax_bare", csv_path, root, drop_probs=(0.0,), folds=[1])
    got = robust.robustness_sweep(tmp_path / "port_bare", csv_path, root, drop_probs=(0.0,),
                                  folds=[1], device="cpu")
    _assert_rows_agree(got, want)
    assert (tmp_path / "port_bare" / "robustness.csv").exists()

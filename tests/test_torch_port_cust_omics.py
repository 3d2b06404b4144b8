"""CustOmics, the one model that reads the hypergraph build's output, in
the port against the JAX package on the CPU: its three layers, the data
path from the ``hypergraph/`` group to the window's dense incidence, the
trainer (also for SVDPool's SVD group loss and GateAUCMIL's AUCM group
loss), the training CLI and ``predict``.

The fixture is one HDF5 dataset (the JAX package's
``make_synthetic_dataset``, 16-d features, the TMA markers' rows also
written flat as ``tma/features`` for the build) into which the JAX
package's ``process_dataset`` writes each slide's ``hypergraph/`` group.
Tolerances: the layers within rtol 1e-5, atol 1e-6 (float32 in other
orders); the trainer's per-epoch losses rtol 1e-4, atol 1e-6 and test
probabilities 1e-4 (sums in other orders, compounded over Adam steps),
as ``tests/test_torch_port_flagship_train.py`` holds the flagship's;
the window's incidence and edge weights exactly.
"""

import csv
import json

import h5py
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from multimodal_fusion_tpu import config as jconfig
from multimodal_fusion_tpu.cli import main_survival as jcli
from multimodal_fusion_tpu.data.batching import make_window as jax_make_window
from multimodal_fusion_tpu.data.multimodal import MultimodalDataset as JaxDataset
from multimodal_fusion_tpu.hypergraph.build import process_dataset
from multimodal_fusion_tpu.io.fixtures import make_synthetic_dataset
from multimodal_fusion_tpu.models import hypergraph_fusion as jhg
from multimodal_fusion_tpu.models.factory import ModelFactory as JaxFactory
from multimodal_fusion_tpu.train.survival import SurvivalTrainer as JaxTrainer
from multimodal_fusion_tpu_torch import config as tconfig
from multimodal_fusion_tpu_torch.cli import main_survival as cli
from multimodal_fusion_tpu_torch.data import splits as tsplits
from multimodal_fusion_tpu_torch.data.batching import make_window
from multimodal_fusion_tpu_torch.data.multimodal import MultimodalDataset
from multimodal_fusion_tpu_torch.models import hypergraph_fusion as thg
from multimodal_fusion_tpu_torch.models.factory import ModelFactory, survival_params_from_jax
from multimodal_fusion_tpu_torch.train.survival import SurvivalTrainer
from multimodal_fusion_tpu_torch.utils.predict import predict

D = 16
TOL = dict(rtol=1e-5, atol=1e-6)
HG_TARGETS = ["hypergraph=wsi_super_features", "hypergraph=tma_features",
              "hypergraph=edge_index", "hypergraph=edge_weights", "clinical=val", "clinical=mask"]
HG_MODEL = ["hypergraph=wsi_super_features", "hypergraph=tma_features", "clinical=val",
            "clinical=mask"]
BAGS = ["wsi=features", "tma=cd3=features", "tma=cd8=features", "clinical=val", "clinical=mask"]


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """12 patients, WSI bags of 24-40 patches, 2 markers of 3 patches, the
    tabular groups; the JAX build's hypergraph/ group (6 super-patches, 2
    groups, k 2, 3 hyperedges) in every file."""
    root = tmp_path_factory.mktemp("cust_omics")
    csv_path = make_synthetic_dataset(root, n_patients=12, seed=3, min_wsi_patches=24,
                                      max_wsi_patches=40, feature_dim=D, n_tma_patches=3,
                                      markers=("cd3", "cd8"))
    with open(csv_path, newline="") as f:
        rows = list(csv.DictReader(f))
    for r in rows:
        with h5py.File(root / r["h5_file_path"], "a") as f:
            f["tma/features"] = np.concatenate([np.asarray(f[f"tma/{m}/features"])
                                                for m in ("cd3", "cd8")])
    stats, summary = process_dataset(csv_path, root, 6, 2, 2, 3, save_similarity=False)
    assert summary["files"] == 12 and all("error" not in s for s in stats)
    return root, csv_path


# ----------------------------------------------------------------------
# the three layers


def _linear_to_port(layer):
    return {"weight": torch.as_tensor(np.asarray(layer.kernel[...]).T.copy()),
            "bias": torch.as_tensor(np.asarray(layer.bias[...]))}


def _graph(rng, G=3, N=13, E=9, pad=3):
    """Nodes, incidence and masks of G cases padded to N nodes, the last
    ``pad`` padded (no incidence); one hyperedge empty, one node isolated."""
    x = rng.standard_normal((G, N, 10)).astype(np.float32)
    H = (rng.random((G, N, E)) < 0.4).astype(np.float32)
    mask = np.ones((G, N), bool)
    mask[:, N - pad:] = False
    H[:, N - pad:] = 0.0
    H[:, :, 0] = 0.0
    H[:, 2, :] = 0.0
    w = rng.uniform(0.2, 1.5, (G, E)).astype(np.float32)
    return x, H, mask, w


@pytest.mark.parametrize("weighted", [True, False])
def test_hypergraph_conv_matches_jax(weighted):
    rng = np.random.default_rng(0)
    x, H, _, w = _graph(rng)
    jconv = jhg.HypergraphConv(10, 7, nnx.Rngs(0))
    jconv.bias[...] = jnp.asarray(rng.standard_normal(7).astype(np.float32))
    want = jax.vmap(lambda a, b, c: jconv(a, b, c if weighted else None))(x, H, w)
    conv = thg.HypergraphConv(10, 7, torch.Generator().manual_seed(0))
    conv.load_state_dict({"lin.weight": torch.as_tensor(np.asarray(jconv.lin.kernel[...]).T.copy()),
                          "bias": torch.as_tensor(np.asarray(jconv.bias[...]))})
    got = conv(torch.as_tensor(x), torch.as_tensor(H), torch.as_tensor(w) if weighted else None)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    # an isolated or padded node has degree 0: its row is the bias alone
    np.testing.assert_allclose(got[:, 2].detach().numpy(), np.broadcast_to(conv.bias.detach(), (3, 7)),
                               **TOL)


@pytest.mark.parametrize("masked", [True, False])
def test_masked_batch_norm_and_attention_pool_match_jax(masked):
    rng = np.random.default_rng(1)
    x, _, mask, _ = _graph(rng)
    m = mask if masked else None
    jbn = jhg.MaskedBatchNorm(10, nnx.Rngs(0))
    jbn.scale[...] = jnp.asarray(rng.uniform(0.5, 1.5, 10).astype(np.float32))
    jbn.bias[...] = jnp.asarray(rng.standard_normal(10).astype(np.float32))
    bn = thg.MaskedBatchNorm(10)
    bn.load_state_dict({"weight": torch.as_tensor(np.asarray(jbn.scale[...])),
                        "bias": torch.as_tensor(np.asarray(jbn.bias[...]))})
    jpool = jhg.GlobalAttentionPool(10, nnx.Rngs(1))
    pool = thg.GlobalAttentionPool(10, torch.Generator().manual_seed(0))
    pool.gate_nn["0"].load_state_dict(_linear_to_port(jpool.gate_fc1))
    pool.gate_nn["2"].load_state_dict(_linear_to_port(jpool.gate_fc2))
    tm = None if m is None else torch.as_tensor(m)
    if masked:
        want_bn = jax.vmap(lambda a, b: jbn(a, b, False))(x, m)
        want_pool = jax.vmap(jpool)(x, m)
    else:
        want_bn = jax.vmap(lambda a: jbn(a, None, False))(x)
        want_pool = jax.vmap(lambda a: jpool(a, None))(x)
    with torch.no_grad():
        np.testing.assert_allclose(bn(torch.as_tensor(x), tm).numpy(), np.asarray(want_bn), **TOL)
        got_pool = pool(torch.as_tensor(x), tm)
    np.testing.assert_allclose(got_pool.numpy(), np.asarray(want_pool)[:, 0], **TOL)
    if masked:  # padded nodes change neither: their values do not reach the output
        x2 = x.copy()
        x2[~mask] = 1e3
        with torch.no_grad():
            np.testing.assert_allclose(pool(torch.as_tensor(x2), tm).numpy(), got_pool.numpy(), **TOL)
            valid = bn(torch.as_tensor(x2), tm).numpy()[mask]
        np.testing.assert_allclose(valid, np.asarray(want_bn)[mask], **TOL)


# ----------------------------------------------------------------------
# the data path: hypergraph/ group -> dataset -> window


def test_both_datasets_batch_the_same_incidence(data):
    """The JAX build's hypergraph/ group read by both packages' datasets:
    the same raw arrays, and windows with the same dense incidence, edge
    weights and node masks."""
    root, csv_path = data
    jds, ds = JaxDataset(csv_path, root, HG_TARGETS), MultimodalDataset(csv_path, root, HG_TARGETS)
    assert jds.case_ids == ds.case_ids and len(ds) == 12
    raws, jraws, labels = [], [], []
    for cid in ds.case_ids:
        raw, label = ds.get_case(cid)
        jraw, jlabel = jds.get_case(cid)
        assert set(raw) == set(jraw) and label == jlabel
        for k in raw:
            np.testing.assert_array_equal(raw[k], jraw[k], err_msg=k)
        raws.append(raw)
        jraws.append(jraw)
        labels.append(label)
    got, want = make_window(raws, labels), jax_make_window(jraws, labels)
    for k in ("hypergraph=incidence", "hypergraph=edge_weights"):
        np.testing.assert_array_equal(got["channels"][k], np.asarray(want["channels"][k]), err_msg=k)
    for k in want["masks"]:
        np.testing.assert_array_equal(got["masks"][k], np.asarray(want["masks"][k]), err_msg=k)
    inc = got["channels"]["hypergraph=incidence"]
    assert inc.shape == (12, 128, 128) and inc.sum() > 0  # 64 + 64 padded nodes
    assert not (got["channels"]["hypergraph=edge_weights"] == 1.0).all()


# ----------------------------------------------------------------------
# the trainer


def _configs(key, channels, targets, **model):
    mc = jconfig.ModelConfig(model_type=key, n_classes=2, input_dim=D, model_size="8*4",
                             dropout=0.0, output_dim=8, inst_number=8, base_weight=0.9,
                             subtyping=True, channels_used_in_model=list(channels),
                             channel_input_dims={"clinical=val": 16}, tau1=1.0, tau2=1.0,
                             lambda1=0.1)
    mc.extra.update(model)
    ec = jconfig.ExperimentConfig(exp_name="t", seed=7, k_folds=3, max_epochs=2, batch_size=4,
                                  lr=1e-3, optimizer="adam", weight_decay=1e-5,
                                  scheduler="plateau", min_epochs=0,
                                  scheduler_params={"mode": "min", "patience": 15, "factor": 0.5},
                                  target_channels=list(targets))
    ec.extra["verbose"] = False
    jc = jconfig.Configs(experiment_config=ec, model_config=mc)
    return jc, tconfig.Configs.from_dict(json.loads(json.dumps(jc.to_dict())))


TRAIN_CASES = {
    "cust_omics": (HG_MODEL, HG_TARGETS, {"hypergraph_hidden_dims": [12, 10],
                                          "hypergraph_node_dim": D, "hypergraph_dropout": 0.0}),
    "svd_pool": (BAGS, BAGS, {}),
    "gate_auc_mil": (BAGS, BAGS, {}),
}


@pytest.mark.parametrize("key", list(TRAIN_CASES))
def test_train_fold_matches_jax_trainer(data, tmp_path, key):
    """Both trainers from the JAX fold model's weights, at dropout 0 (no
    draws on either side): the per-epoch losses, the metrics and the test
    probabilities; for cust_omics, ``predict`` over the run's directory
    equals ``evaluate_fold`` with its extra config keys read back."""
    root, csv_path = data
    channels, targets, extra = TRAIN_CASES[key]
    jc, tc = _configs(key, channels, targets, **extra)
    jds, ds = JaxDataset(csv_path, root, targets), MultimodalDataset(csv_path, root, targets)
    split = tsplits.create_k_fold_splits(ds.labels, 3, 7)[0]
    want = JaxTrainer(jc, tmp_path / "jax").train_fold(jds, split, 0)
    tr = SurvivalTrainer(tc, tmp_path / "port", device="cpu")
    jmodel = JaxFactory.create_model(jc.model_config, seed=jc.experiment_config.seed)

    def build(fold_idx):
        model = ModelFactory.create_model(tc.model_config, seed=0, device="cpu")
        model.load_state_dict(survival_params_from_jax(nnx.to_pure_dict(nnx.state(jmodel, nnx.Param))))
        return model

    tr._build_model = build
    got = tr.train_fold(ds, split, 0)
    for k in ("train_loss", "val_loss"):
        np.testing.assert_allclose([h[k] for h in got["history"]], [h[k] for h in want["history"]],
                                   rtol=1e-4, atol=1e-6, err_msg=k)
    for k in ("val_auc", "test_auc", "val_acc", "test_acc"):
        np.testing.assert_allclose(got[k], want[k], atol=1e-6, err_msg=k)
    pj = json.loads((tmp_path / "jax" / "fold_0_summary.json").read_text())["patient_results"]
    pt = json.loads((tmp_path / "port" / "fold_0_summary.json").read_text())["patient_results"]
    assert list(pt) == list(pj)
    for pid in pj:
        np.testing.assert_allclose(pt[pid]["prob"], pj[pid]["prob"], atol=1e-4)
    if key == "cust_omics":
        tc.save(tmp_path / "port" / "configs_t.json")
        res = predict(tmp_path / "port", csv_path, root, folds=[0], device="cpu")
        direct = SurvivalTrainer(tconfig.Configs.load(tmp_path / "port" / "configs_t.json"),
                                 tmp_path / "port", device="cpu").evaluate_fold(
            ds, tsplits.FoldSplit(np.array([], int), np.array([], int), np.arange(len(ds))), 0)
        assert res["n_cases_scored"] == 12
        by_case = {r["case_id"]: r["prob_1"] for r in res["cases"]}
        np.testing.assert_allclose([by_case[c] for c in direct["patient_ids"]],
                                   [p[1] for p in direct["probs"]], atol=1e-6)
        saved = json.loads((tmp_path / "port" / "configs_t.json").read_text())["model_config"]
        assert saved["hypergraph_hidden_dims"] == [12, 10] and saved["hypergraph_node_dim"] == D


# ----------------------------------------------------------------------
# the training CLI


def test_main_survival_trains_cust_omics_like_the_jax_cli(data, tmp_path, capsys):
    """``main_survival --model_type cust_omics --device cpu`` on the built
    fixture writes the JAX CLI's files, and ``predict`` over its directory
    equals ``evaluate_fold`` run directly."""
    root, csv_path = data
    flags = ["--csv_path", str(csv_path), "--data_root_dir", str(root), "--exp_code", "hg",
             "--model_type", "cust_omics", "--target_channels", *HG_TARGETS,
             "--channels_used_in_model", *HG_MODEL, "--input_dim", str(D), "--model_size", "8*4",
             "--output_dim", "8", "--k", "2", "--max_epochs", "1", "--batch_size", "4",
             "--seed", "0"]
    jdir = jcli.main(flags + ["--results_dir", str(tmp_path / "jax")])
    tdir = cli.main(flags + ["--results_dir", str(tmp_path / "port"), "--device", "cpu"])
    names = {p.name for p in jdir.iterdir()}
    assert {p.name for p in tdir.iterdir()} == names
    assert {"configs_hg.json", "s_0_checkpoint.npz", "s_1_checkpoint.npz", "summary.csv"} <= names
    got, want = (json.loads((d / "configs_hg.json").read_text()) for d in (tdir, jdir))
    got["experiment_config"].pop("results_dir")
    want["experiment_config"].pop("results_dir")
    assert got == want
    res = predict(tdir, csv_path, root, folds=[1], device="cpu")
    tr = SurvivalTrainer(tconfig.Configs.load(tdir / "configs_hg.json"), tdir, device="cpu")
    ds = MultimodalDataset(csv_path, root, HG_TARGETS)
    direct = tr.evaluate_fold(ds, tsplits.FoldSplit(np.array([], int), np.array([], int),
                                                    np.arange(len(ds))), 1)
    by_case = {r["case_id"]: r["prob_1"] for r in res["cases"]}
    assert res["n_cases_scored"] == 12
    np.testing.assert_allclose([by_case[c] for c in direct["patient_ids"]],
                               [p[1] for p in direct["probs"]], atol=1e-6)

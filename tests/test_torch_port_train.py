"""The port's survival training slice against the JAX package on the CPU:
``SurvivalTrainer.train_fold`` / ``evaluate_fold`` on MFMF, and the pieces
under it (dataset, splits, window batching, optimizers, schedules, metrics,
checkpoints, the fold logger, configs, channels, masked helpers, the loss).

The trainer test runs both trainers on one synthetic HDF5 dataset from the
same initial weights (the JAX fold model's, carried across by
``mfmf_params_from_jax``); at MFMF's default attention dropout of 0 the
forward draws no random numbers and both take the window order from numpy,
so the whole loss trajectory is compared.  Tolerances: per-epoch losses rtol
1e-4, atol 1e-6 (float32 sums in other orders, compounded over Adam steps);
AUCs 1e-6; test probabilities 1e-4.
"""

import csv
import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import nnx

from multimodal_fusion_tpu import channels as jchannels
from multimodal_fusion_tpu import config as jconfig
from multimodal_fusion_tpu.data import batching as jbatching
from multimodal_fusion_tpu.data import splits as jsplits
from multimodal_fusion_tpu.data.multimodal import MultimodalDataset as JaxDataset
from multimodal_fusion_tpu.io.fixtures import make_synthetic_dataset
from multimodal_fusion_tpu.models.factory import ModelFactory as JaxFactory
from multimodal_fusion_tpu.ops import losses as jlosses
from multimodal_fusion_tpu.ops import masked as jmasked
from multimodal_fusion_tpu.train import metrics as jmetrics
from multimodal_fusion_tpu.train import optim as joptim
from multimodal_fusion_tpu.train.survival import EarlyStopping as JaxEarlyStopping
from multimodal_fusion_tpu.train.survival import SurvivalTrainer as JaxTrainer
from multimodal_fusion_tpu.utils.logging import FoldLogger as JaxFoldLogger
from multimodal_fusion_tpu_torch import channels as tchannels
from multimodal_fusion_tpu_torch import config as tconfig
from multimodal_fusion_tpu_torch.data import batching as tbatching
from multimodal_fusion_tpu_torch.data import splits as tsplits
from multimodal_fusion_tpu_torch.data.multimodal import MultimodalDataset
from multimodal_fusion_tpu_torch.models.mfmf import mfmf_params_from_jax
from multimodal_fusion_tpu_torch.ops import losses as tlosses
from multimodal_fusion_tpu_torch.ops import masked as tmasked
from multimodal_fusion_tpu_torch.train import checkpoint as tckpt
from multimodal_fusion_tpu_torch.train import metrics as tmetrics
from multimodal_fusion_tpu_torch.train import optim as toptim
from multimodal_fusion_tpu_torch.train.survival import EarlyStopping, SurvivalTrainer
from multimodal_fusion_tpu_torch.utils.logging import FoldLogger

SHORTHANDS = ["wsi", "cd3", "cd8", "clinical_mask", "blood_mask"]


@pytest.fixture(scope="module")
def mfmf_data(tmp_path_factory):
    """12 patients, 16-d features, WSI bags of 16-40 patches with their
    reconstruction, 2 TMA markers, 2 tabular groups with masks."""
    root = tmp_path_factory.mktemp("mfmf")
    csv_path = make_synthetic_dataset(root, n_patients=12, seed=3, min_wsi_patches=16,
                                      max_wsi_patches=40, feature_dim=16, markers=("cd3", "cd8"),
                                      with_reconstructed=True)
    chans = tchannels.parse_channels(SHORTHANDS)
    return root, csv_path, chans


def _configs(chans, **exp):
    mc = jconfig.ModelConfig(model_type="mfmf", n_classes=2, input_dim=16, model_size="8*4",
                             dropout=0.25, output_dim=32, channels_used_in_model=chans,
                             channel_input_dims={"clinical=val": 16, "blood=val": 24})
    mc.extra.update(attention_num_heads=8, attention_impl="pallas_interpret")
    ec = jconfig.ExperimentConfig(exp_name="t", seed=7, k_folds=3, max_epochs=2, batch_size=4,
                                  lr=1e-3, optimizer="adam", weight_decay=1e-5, scheduler="plateau",
                                  scheduler_params={"mode": "min", "patience": 15, "factor": 0.5},
                                  min_epochs=0, **exp)
    ec.extra["verbose"] = False
    jc = jconfig.Configs(experiment_config=ec, model_config=mc)
    tc = tconfig.Configs.from_dict(json.loads(json.dumps(jc.to_dict())))
    tc.model_config.extra["attention_impl"] = "auto"
    return jc, tc


def _port_model_from_jax(jc, tc, fold_idx):
    """The port's MFMF with the JAX trainer's initial weights of the fold."""
    from multimodal_fusion_tpu_torch.models.factory import ModelFactory

    jm = JaxFactory.create_model(jc.model_config, seed=jc.experiment_config.seed + fold_idx)
    model = ModelFactory.create_model(tc.model_config, seed=0, device="cpu")
    model.load_state_dict(mfmf_params_from_jax(nnx.to_pure_dict(nnx.state(jm, nnx.Param))))
    return model


def _port_trainer(jc, tc, log_dir, **exp):
    for k, v in exp.items():
        setattr(tc.experiment_config, k, v)
    tr = SurvivalTrainer(tc, log_dir, device="cpu")
    tr._build_model = lambda fold_idx: _port_model_from_jax(jc, tc, fold_idx)
    return tr


def _read(path):
    return json.loads(path.read_text())


def test_train_fold_matches_jax_trainer(mfmf_data, tmp_path):
    root, csv_path, chans = mfmf_data
    jc, tc = _configs(chans)
    jds = JaxDataset(csv_path, root, chans)
    ds = MultimodalDataset(csv_path, root, chans)
    splits = tsplits.create_k_fold_splits(ds.labels, 3, 7)
    want = JaxTrainer(jc, tmp_path / "jax").train_fold(jds, splits[0], 0)

    tr = _port_trainer(jc, tc, tmp_path / "port")
    got = tr.train_fold(ds, splits[0], 0)
    for key in ("train_loss", "val_loss"):
        np.testing.assert_allclose([h[key] for h in got["history"]],
                                   [h[key] for h in want["history"]], rtol=1e-4, atol=1e-6,
                                   err_msg=key)
    for key in ("val_auc", "test_auc", "val_acc", "test_acc"):
        np.testing.assert_allclose(got[key], want[key], atol=1e-6, err_msg=key)
    assert [h["lr"] for h in got["history"]] == [h["lr"] for h in want["history"]]
    pj = _read(tmp_path / "jax" / "fold_0_summary.json")["patient_results"]
    pt = _read(tmp_path / "port" / "fold_0_summary.json")["patient_results"]
    assert list(pt) == list(pj)
    for pid in pj:
        assert pt[pid]["label"] == pj[pid]["label"]
        np.testing.assert_allclose(pt[pid]["prob"], pj[pid]["prob"], atol=1e-4)
    for name in ("splits_0.csv", "fold_0_epochs.csv", "fold_0_summary.json", "fold_0_logger.json",
                 "s_0_checkpoint.npz"):
        assert (tmp_path / "port" / name).exists() and (tmp_path / "jax" / name).exists(), name
    assert (tmp_path / "port" / "splits_0.csv").read_text() == (tmp_path / "jax" / "splits_0.csv").read_text()
    with open(tmp_path / "port" / "fold_0_epochs.csv") as f, open(tmp_path / "jax" / "fold_0_epochs.csv") as g:
        assert next(csv.reader(f)) == next(csv.reader(g))

    # the host window path gives the device tables' history exactly
    host = _port_trainer(jc, tc, tmp_path / "host", device_data=False).train_fold(ds, splits[0], 0)
    for a, b in zip(host["history"], got["history"]):
        assert (a["train_loss"], a["val_loss"], a["val_auc"]) == (b["train_loss"], b["val_loss"], b["val_auc"])

    # eval-only path from the fold checkpoint: the fold's test results
    res = tr.evaluate_fold(ds, splits[0], 0)
    np.testing.assert_allclose(res["probs"], [pt[p]["prob"] for p in res["patient_ids"]], atol=1e-6)
    assert res["auc"] == got["test_auc"]
    with pytest.raises(ValueError, match="drop_prob"):
        tr.evaluate_fold(ds, splits[0], 0, drop_prob=0.5)


def test_trainer_raises_on_unported_options(mfmf_data, tmp_path, capsys):
    """mesh_shape without a launcher (a world of 1) prints the JAX package's
    message and trains unsharded (sharded runs: test_torch_port_parallel.py);
    remat trains MFMF to the history it has without remat; bfloat16
    evaluation is taken."""
    root, csv_path, chans = mfmf_data
    _, tc = _configs(chans, mesh_shape={"data": 2})
    assert SurvivalTrainer(tc, tmp_path, device="cpu").mesh is None
    assert "needs 2 devices, have 1; running unsharded" in capsys.readouterr().out
    ds = MultimodalDataset(csv_path, root, chans)
    split = tsplits.create_k_fold_splits(ds.labels, 3, 7)[0]
    histories = []
    for remat in (False, True):
        _, tc = _configs(chans, remat=remat)
        tc.experiment_config.max_epochs = 1
        tr = SurvivalTrainer(tc, tmp_path / f"remat_{remat}", device="cpu")
        assert tr.remat is remat
        histories.append(tr.train_fold(ds, split, 0)["history"])
    for a, b in zip(*histories):
        assert (a["train_loss"], a["val_loss"]) == (b["train_loss"], b["val_loss"])
        assert np.isfinite(a["train_loss"])
    _, tc = _configs(chans)
    tc.model_config.extra["compute_dtype"] = "bfloat16"
    assert SurvivalTrainer(tc, tmp_path, device="cpu").compute_dtype == torch.bfloat16


def test_dataset_matches_jax(mfmf_data):
    root, csv_path, chans = mfmf_data
    jds = JaxDataset(csv_path, root, chans)
    ds = MultimodalDataset(csv_path, root, chans)
    assert ds.case_ids == jds.case_ids and ds.label_to_int == jds.label_to_int
    np.testing.assert_array_equal(ds.labels, jds.labels)
    for cid in ds.case_ids[:4]:
        (raw, label), (jraw, jlabel) = ds.get_case(cid), jds.get_case(cid)
        assert label == jlabel and set(raw) == set(jraw)
        for ch in raw:
            np.testing.assert_array_equal(raw[ch], jraw[ch])
    # a channel no file has filters every case out, as in the JAX dataset
    assert len(MultimodalDataset(csv_path, root, chans + ["tma=cd68=features"])) == 0


def test_make_window_matches_jax():
    rng = np.random.default_rng(0)
    raws, labels = [], []
    for i in range(3):
        n = int(rng.integers(10, 70))
        raws.append({
            "wsi=features": rng.standard_normal((n, 8)).astype(np.float32),
            "tma=cd3=features": rng.standard_normal((int(rng.integers(1, 9)), 8)).astype(np.float32),
            "clinical=val": rng.standard_normal((1, 5)).astype(np.float32),
            "hypergraph=group_labels": rng.integers(0, 4, n).astype(np.int64),
        })
        labels.append(i % 2)
    for buckets in (None, (16, 256)):
        want = jbatching.make_window(raws, labels, buckets)
        got = tbatching.make_window(raws, labels, buckets)
        assert got.keys() == want.keys()
        for k in ("channels", "masks"):
            assert got[k].keys() == want[k].keys()
            for ch in want[k]:
                assert got[k][ch].dtype == np.asarray(want[k][ch]).dtype
                np.testing.assert_array_equal(got[k][ch], np.asarray(want[k][ch]))
        np.testing.assert_array_equal(got["label"], np.asarray(want["label"]))


@pytest.mark.parametrize(
    "labels,seed",
    [
        ([0, 1] * 10, 0),
        ([0] * 13 + [1] * 7, 5),
        (list(np.random.default_rng(2).permutation([0] * 13 + [1] * 10 + [2] * 7)), 11),  # 3 classes
        ([2, 0, 1, 1, 2, 0, 0, 2, 1, 1, 0, 2, 2, 1, 0, 0, 1], 11),  # held-out folds too small at k=5
        (list(np.random.default_rng(3).integers(0, 2, 41)), 1234),
    ],
)
@pytest.mark.filterwarnings("ignore:The least populated class")
def test_create_k_fold_splits_identical_to_sklearn(labels, seed):
    for k in (2, 3, 5):
        try:
            want = jsplits.create_k_fold_splits(labels, k, seed)
        except ValueError as e:  # sklearn refuses: so does the port, with its message
            with pytest.raises(ValueError, match="cannot be greater"):
                tsplits.create_k_fold_splits(labels, k, seed)
            assert "cannot be greater" in str(e)
            continue
        got = tsplits.create_k_fold_splits(labels, k, seed)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            for part in ("train_idx", "val_idx", "test_idx"):
                np.testing.assert_array_equal(getattr(g, part), getattr(w, part))


@pytest.mark.parametrize("fmt", ["records", "dict"])
def test_fixed_split_identical_to_jax(tmp_path, fmt):
    pids = [f"P-{i:03d}" for i in range(30)]
    labels = [i % 3 == 0 for i in range(30)]
    train, test = [f"p{i}" for i in range(24)][::-1], [f"p{i}" for i in range(24, 30)]
    if fmt == "records":
        spec = ([{"patient_id": p, "dataset": "training"} for p in train]
                + [{"patient_id": p, "dataset": "test"} for p in test])
    else:
        spec = {"train": train, "test": test}
    path = tmp_path / "split.json"
    path.write_text(json.dumps(spec))
    want = jsplits.create_k_fold_splits(labels, 4, 9, patient_ids=pids, fixed_split_path=path)
    got = tsplits.create_k_fold_splits(labels, 4, 9, patient_ids=pids, fixed_split_path=path)
    for g, w in zip(got, want):
        for part in ("train_idx", "val_idx", "test_idx"):
            np.testing.assert_array_equal(getattr(g, part), getattr(w, part))
    path.write_text(json.dumps({"train": ["x"], "test": []}))
    with pytest.raises(ValueError, match="matched no dataset"):
        tsplits.create_k_fold_splits(labels, 4, 9, patient_ids=pids, fixed_split_path=path)


def test_fold_split_csv_and_sampler_match_jax(tmp_path):
    split = tsplits.create_k_fold_splits([0, 1] * 8, 4, 2)[1]
    ids = [f"case_{i}" for i in range(16)]
    tsplits.save_fold_split(split, ids, tmp_path / "t.csv")
    jsplits.save_fold_split(split, ids, tmp_path / "j.csv")
    assert (tmp_path / "t.csv").read_text() == (tmp_path / "j.csv").read_text()
    back = tsplits.load_fold_split(tmp_path / "t.csv", ids)
    for part in ("train_idx", "val_idx", "test_idx"):
        np.testing.assert_array_equal(getattr(back, part), getattr(split, part))
    labels = [0] * 9 + [1] * 3
    a, b = tsplits.WeightedRandomSampler(labels, 4), jsplits.WeightedRandomSampler(labels, 4)
    for _ in range(3):
        np.testing.assert_array_equal(a.sample_epoch(), b.sample_epoch())


@pytest.mark.parametrize("opt", ["adam", "sgd", "adamw"])
def test_optimizer_steps_match_optax(opt):
    """Three steps of the port's torch optimizer against the JAX package's
    optax chain with the update scaled by -lr, as its trainer applies it."""
    rng = np.random.default_rng(1)
    w0 = rng.standard_normal((4, 6)).astype(np.float32)
    grads = [rng.standard_normal((4, 6)).astype(np.float32) for _ in range(3)]
    lr, wd = 1e-2, 1e-2
    tx = joptim.make_optimizer(opt, wd)
    params = jnp.asarray(w0)
    state = tx.init(params)
    p = torch.nn.Parameter(torch.as_tensor(w0.copy()))
    topt = toptim.make_optimizer(opt, wd, [p], lr=lr)
    for g in grads:
        upd, state = tx.update(jnp.asarray(g), state, params)
        params = optax.apply_updates(params, jax.tree.map(lambda u: -lr * u, upd))
        p.grad = torch.as_tensor(g)
        topt.step()
    np.testing.assert_allclose(p.detach().numpy(), np.asarray(params), rtol=1e-5, atol=1e-6)
    with pytest.raises(NotImplementedError):
        toptim.make_optimizer("lamb", 0.0, [p])


@pytest.mark.parametrize(
    "cfg",
    [
        None,
        {"type": "step", "step_size": 3, "gamma": 0.5},
        {"type": "cosine", "T_max": 7, "eta_min": 1e-5},
        {"type": "cosine_warm_restart", "T_0": 2, "T_mult": 2},
        {"type": "exponential", "gamma": 0.8},
        {"type": "plateau", "mode": "min", "patience": 1, "factor": 0.5},
    ],
)
def test_lr_schedule_matches_jax(cfg):
    a, b = toptim.LRSchedule(0.1, dict(cfg or {})), joptim.LRSchedule(0.1, dict(cfg or {}))
    metrics = [1.0, 0.99995, 0.9, 0.95, 0.96, 0.97, 0.5, 0.6, 0.7, 0.8, 0.9, 1.0]
    for epoch, m in enumerate(metrics):
        assert a.lr_for_epoch(epoch) == b.lr_for_epoch(epoch)
        a.plateau_step(m)
        b.plateau_step(m)
    p = torch.nn.Parameter(torch.zeros(1))
    opt = toptim.make_optimizer("adam", 0.0, [p])
    toptim.set_lr(opt, 0.25)
    assert opt.param_groups[0]["lr"] == 0.25


def test_metrics_match_jax():
    rng = np.random.default_rng(2)
    probs = np.round(rng.random(40), 1)  # ties
    labels = rng.integers(0, 2, 40)
    assert tmetrics.binary_auroc(probs, labels) == jmetrics.binary_auroc(probs, labels)
    assert np.isnan(tmetrics.binary_auroc(probs, np.zeros(40, int)))
    pm = rng.random((30, 3))
    lm = rng.integers(0, 3, 30)
    assert tmetrics.multiclass_auroc_macro(pm, lm) == jmetrics.multiclass_auroc_macro(pm, lm)
    t, e, r = rng.integers(1, 10, 25), rng.integers(0, 2, 25), np.round(rng.random(25), 1)
    assert tmetrics.concordance_index(r, t, e) == jmetrics.concordance_index(r, t, e)
    preds = rng.integers(0, 3, 30)
    assert tmetrics.accuracy(preds, lm) == jmetrics.accuracy(preds, lm)
    assert tmetrics.per_class_accuracy(preds, lm, 4).keys() == jmetrics.per_class_accuracy(preds, lm, 4).keys()


def test_early_stopping_matches_jax():
    scores = [float("nan"), 0.5, 0.5, 0.6, 0.55, 0.55, 0.55, 0.7, 0.1, 0.1, 0.1]
    for mode in ("max", "min"):
        a = EarlyStopping(patience=2, stop_epoch=3, mode=mode)
        b = JaxEarlyStopping(patience=2, stop_epoch=3, mode=mode)
        for epoch, s in enumerate(scores):
            assert a.step(epoch, s) == b.step(epoch, s)
            assert (a.early_stop, a.counter) == (b.early_stop, b.counter)
    with pytest.raises(ValueError):
        EarlyStopping(mode="best")


def test_checkpoint_round_trip(tmp_path):
    lin = torch.nn.Linear(3, 2)
    state = {"params": lin.state_dict(), "step": np.int64(7)}
    path = tckpt.save_state(tmp_path / "ck", state, extra={"epoch": 4})
    assert path.name == "ck.npz" and path.exists()
    template = {"params": torch.nn.Linear(3, 2).state_dict(), "step": np.int64(0)}
    back, extras = tckpt.load_state(tmp_path / "ck", template)  # suffix-less path resolves
    assert int(extras["epoch"]) == 4 and int(back["step"]) == 7
    for k, v in lin.state_dict().items():
        assert torch.equal(back["params"][k], v) and back["params"][k].dtype == v.dtype
    with pytest.raises(ValueError, match="shape mismatch"):
        tckpt.load_state(path, {"params": torch.nn.Linear(4, 2).state_dict(), "step": np.int64(0)})
    with pytest.raises(KeyError, match="missing"):
        tckpt.load_state(path, {"other": np.zeros(1)})
    other = torch.nn.Linear(3, 2)
    tckpt.save_model(tmp_path / "m.npz", lin, extra={"fold": 1})
    assert int(tckpt.load_model(tmp_path / "m.npz", other)["fold"]) == 1
    assert torch.equal(other.weight, lin.weight)


def test_fold_logger_writes_the_jax_files(tmp_path):
    val = {"preds": np.array([0, 1, 1, 0]), "labels": np.array([0, 1, 0, 0]), "loss": 0.5,
           "auc": 0.75, "acc": 0.75}
    for mod, d in ((FoldLogger, "t"), (JaxFoldLogger, "j")):
        lg = mod(tmp_path / d, 2, n_classes=3)
        lg.log_epoch(0, 1e-4, 0.7, val, 1.5)
        lg.log_epoch(1, 1e-4, 0.6, val, 1.25)
        lg.finalize({"fold": 2, "val_auc": np.float32(0.5), "history": []})
    for name in ("fold_2_epochs.csv", "fold_2_logger.json"):
        assert (tmp_path / "t" / name).read_text() == (tmp_path / "j" / name).read_text()


def test_configs_json_round_trip_with_jax(tmp_path):
    jc, _ = _configs(["wsi=features"])
    jc.experiment_config.extra["aligned_channels_map"] = {"a": "b"}
    jc.save(tmp_path / "j.json")
    tc = tconfig.Configs.load(tmp_path / "j.json")
    tc.save(tmp_path / "t.json")
    assert (tmp_path / "t.json").read_text() == (tmp_path / "j.json").read_text()
    ref = {"exp_code": "x", "num_splits": 4, "reg": 0.1, "opt": "sgd",
           "scheduler_config": {"type": "step", "step_size": 3}}
    a, b = tconfig.ExperimentConfig.from_dict(ref), jconfig.ExperimentConfig.from_dict(ref)
    assert a.to_dict() == b.to_dict()
    assert tconfig.model_size_dims(1024, "64*32") == jconfig.model_size_dims(1024, "64*32")
    with pytest.raises(ValueError):
        tconfig.model_size_dims(1024, "huge")


def test_parse_channels_matches_jax():
    assert tchannels.CHANNEL_MAPPINGS == jchannels.CHANNEL_MAPPINGS
    for spec in (["wsi", "tma", "clinical", "pathological", "blood", "icd", "tma_cell_density"],
                 ["cd3_patches", "clinical_ori_mask", "wsi=features", "tma=cd3=features"], []):
        assert tchannels.parse_channels(spec) == jchannels.parse_channels(spec)
    with pytest.raises(ValueError, match="Invalid channel"):
        tchannels.parse_channels(["nope"])


def test_masked_helpers_and_cross_entropy_match_jax():
    rng = np.random.default_rng(4)
    x = rng.standard_normal((3, 7)).astype(np.float32)
    m = rng.random((3, 7)) > 0.4
    m[1] = False
    np.testing.assert_allclose(tmasked.masked_softmax(torch.as_tensor(x), torch.as_tensor(m)).numpy(),
                               np.asarray(jmasked.masked_softmax(jnp.asarray(x), jnp.asarray(m))),
                               rtol=1e-6, atol=1e-7)
    feats = rng.standard_normal((7, 5)).astype(np.float32)
    np.testing.assert_allclose(tmasked.masked_mean(torch.as_tensor(feats), torch.as_tensor(m[0])).numpy(),
                               np.asarray(jmasked.masked_mean(jnp.asarray(feats), jnp.asarray(m[0]))),
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_array_equal(tmasked.pad_to(torch.as_tensor(feats), 9, dim=0, value=-1).numpy(),
                                  np.asarray(jmasked.pad_to(jnp.asarray(feats), 9, axis=0, value=-1)))
    with pytest.raises(ValueError):
        tmasked.pad_to(torch.as_tensor(feats), 3)
    np.testing.assert_array_equal(tmasked.length_mask(3, 6).numpy(), np.asarray(jmasked.length_mask(3, 6)))
    for n in (1, 64, 65, 4096, 4097, 32768, 40000):
        assert tmasked.bucket_size(n) == jmasked.bucket_size(n)
    logits = rng.standard_normal((6, 3)).astype(np.float32)
    labels = rng.integers(0, 3, 6)
    for red in ("mean", "sum", "none"):
        for ls in (0.0, 0.1):
            got = tlosses.cross_entropy(torch.as_tensor(logits), torch.as_tensor(labels), ls, red)
            want = jlosses.cross_entropy(jnp.asarray(logits), jnp.asarray(labels), ls, red)
            np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-7)


def test_prefetched_windows_abort_and_error(mfmf_data, tmp_path):
    """Closing the consumer early stops the producer; a producer error is
    re-raised in the consumer, not taken for the end of the data."""
    root, csv_path, chans = mfmf_data
    ds = MultimodalDataset(csv_path, root, chans)
    _, tc = _configs(chans)
    tr = SurvivalTrainer(tc, tmp_path, device="cpu")
    order = np.arange(len(ds))
    got = [chunk for chunk, _ in tr._windows_prefetched(ds, order, 3)]
    assert got == [chunk for chunk, _ in tr._windows(ds, order, 3)]
    gen = tr._windows_prefetched(ds, order, 1, depth=1)
    next(gen)
    gen.close()  # returns: the producer saw the stop flag

    class Broken:
        case_ids = ds.case_ids

        def get_case(self, cid):
            if cid == ds.case_ids[5]:
                raise OSError("read failed")
            return ds.get_case(cid)

    with pytest.raises(OSError, match="read failed"):
        list(tr._windows_prefetched(Broken(), order, 2))

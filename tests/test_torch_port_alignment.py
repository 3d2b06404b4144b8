"""Alignment pretraining in the port (``data/alignment.py``,
``models/alignment.py``, ``train/alignment.py``, ``cli/run_alignment.py``)
and its load-time use by the survival side, against the JAX package on the
CPU.

Both packages read the same NPZ files (``make_alignment_npz_fixtures``, one
seed); the models start from the same weights (the JAX model's parameters
through ``alignment_params_from_jax``).  The trainers draw the same batches
(numpy seeds in both), so at lambda2 = 0 their trajectories agree to float32
rounding: losses within rtol 1e-4, the same validation steps, best step and
early-stop count.  With lambda2 > 0 the match predictor's dropout draws
differ (jax.random against a torch generator), so that run is held
statistically, at the bar of ``tests/test_alignment_trained_parity.py``
(best validation losses within 2x).

The marker lists are sorted: the JAX trainer's batch dicts cross ``jit``,
which rebuilds them in sorted key order, so its volume loss anchors on the
alphabetically first marker where the reference and the port anchor on the
first of the list (``test_volume_anchor_order``).
"""

import csv
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from multimodal_fusion_tpu.cli import main_survival as jcli_survival
from multimodal_fusion_tpu.cli import run_alignment as jcli
from multimodal_fusion_tpu.data.alignment import TMANpzAlignedWithNegDataset as JaxDataset
from multimodal_fusion_tpu.data.multimodal import MultimodalDataset as JaxMultimodal
from multimodal_fusion_tpu.io.fixtures import make_alignment_npz_fixtures as jax_npz_fixtures
from multimodal_fusion_tpu.io.fixtures import make_synthetic_dataset
from multimodal_fusion_tpu.models.alignment import MultiModalAlignmentModel as JaxModel
from multimodal_fusion_tpu.train.alignment import MultiModalAlignmentTrainer as JaxTrainer
from multimodal_fusion_tpu.train.alignment import make_alignment_apply_fn as jax_apply_fn
from multimodal_fusion_tpu.utils.torch_import import import_alignment_checkpoint
from multimodal_fusion_tpu_torch.cli import main_survival as cli_survival
from multimodal_fusion_tpu_torch.cli import run_alignment as cli
from multimodal_fusion_tpu_torch.data.alignment import TMANpzAlignedWithNegDataset
from multimodal_fusion_tpu_torch.data.multimodal import MultimodalDataset
from multimodal_fusion_tpu_torch.io.fixtures import make_alignment_npz_fixtures
from multimodal_fusion_tpu_torch.models.alignment import (
    MultiModalAlignmentModel,
    infer_alignment_arch,
    infer_alignment_markers,
)
from multimodal_fusion_tpu_torch.models.jax_params import alignment_params_from_jax
from multimodal_fusion_tpu_torch.train.alignment import (
    MultiModalAlignmentTrainer,
    make_alignment_apply_fn,
)
from multimodal_fusion_tpu_torch.train.checkpoint import save_model
from multimodal_fusion_tpu_torch.utils import results_io
from multimodal_fusion_tpu_torch.utils.predict import predict
from multimodal_fusion_tpu_torch.utils.serve import ScoringServer

MARKERS = ["cd3", "cd8", "he"]
D = 16
TEMPLATE = "{marker}.npz"


@pytest.fixture(scope="module")
def npz_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("npz")
    make_alignment_npz_fixtures(root, n_cores=12, patches_per_core=2, feature_dim=D, markers=MARKERS)
    return root


def _views(cls, root, markers=MARKERS, **kw):
    ds = cls(root, markers, filename_template=TEMPLATE, mismatch_ratio=1.0, **kw)
    keys = ds.normalized_keys
    return ds, ds.split_by_ids_with_neg({"train": keys[:18], "val": keys[18:]}, seed=3)


def _models(markers=MARKERS, num_layers=2, seed=3):
    jm = JaxModel(markers, feature_dim=D, num_layers=num_layers, rngs=nnx.Rngs(seed))
    pm = MultiModalAlignmentModel(markers, feature_dim=D, num_layers=num_layers,
                                  generator=torch.Generator().manual_seed(0))
    pm.load_state_dict(alignment_params_from_jax(nnx.to_pure_dict(nnx.state(jm, nnx.Param))),
                       strict=True)
    return jm, pm


def test_npz_fixtures_and_dataset_match_jax(npz_dir, tmp_path):
    """The fixture files, the normalised keys, the patch-level samples,
    collate's positives and negatives, the device tables and the split
    membership equal the JAX package's; intersection refuses a missing NPZ
    file, union zero-fills it."""
    jax_npz_fixtures(tmp_path, n_cores=12, patches_per_core=2, feature_dim=D, markers=MARKERS)
    for mk in MARKERS:
        with np.load(npz_dir / f"{mk}.npz") as got, np.load(tmp_path / f"{mk}.npz") as want:
            assert got.files == want.files
            assert all(np.array_equal(got[k], want[k]) for k in got.files)
    jds, jviews = _views(JaxDataset, npz_dir)
    ds, views = _views(TMANpzAlignedWithNegDataset, npz_dir)
    assert ds.normalized_keys == jds.normalized_keys and len(ds) == 24
    assert ds.neg_pool == jds.neg_pool and len(ds.neg_pool) == 24
    for i in (0, 7, 23):
        assert all(np.array_equal(ds[i][m], jds[i][m]) for m in MARKERS)
    for name in ("train", "val"):
        assert views[name].indices == jviews[name].indices
        assert views[name].neg_pool == jviews[name].neg_pool
        for batch_id in (0, 3):
            pos, neg = views[name].collate([0, 2, 1], batch_id)
            jpos, jneg = jviews[name].collate([0, 2, 1], batch_id)
            for m in MARKERS:
                np.testing.assert_array_equal(pos[m], jpos[m])
                np.testing.assert_array_equal(neg[m], jneg[m])
        for got, want in zip(views[name].device_tables(), jviews[name].device_tables()):
            assert all(np.array_equal(got[m], want[m]) for m in MARKERS)
    assert ds.get_negatives_for_batch(5, 4) == jds.get_negatives_for_batch(5, 4)

    (tmp_path / "he.npz").unlink()
    with pytest.raises(FileNotFoundError, match="intersection"):
        TMANpzAlignedWithNegDataset(tmp_path, MARKERS, filename_template=TEMPLATE)
    with pytest.warns(UserWarning, match="zero-filled"):
        union = TMANpzAlignedWithNegDataset(tmp_path, MARKERS, filename_template=TEMPLATE,
                                            align_mode="union")
    assert len(union) == 24 and not union[0]["he"].any()


def test_model_forward_and_weights_match_jax(tmp_path):
    """Eval forward and predict_match within 1e-5 with the carried weights;
    the port's state dict loads into a JAX model through
    ``import_alignment_checkpoint`` with nothing left over; the checkpoint's
    depth, width and markers are read back."""
    jm, pm = _models(num_layers=3)
    rng = np.random.default_rng(0)
    x = {m: rng.standard_normal((5, D)).astype(np.float32) for m in MARKERS}
    got = make_alignment_apply_fn(pm)(x)
    want = jax_apply_fn(jm)(x)
    for m in MARKERS:
        np.testing.assert_allclose(got[m], want[m], rtol=1e-5, atol=1e-5)
    fused = rng.standard_normal((7, D * len(MARKERS))).astype(np.float32)
    np.testing.assert_allclose(pm.predict_match(torch.as_tensor(fused)).detach().numpy(),
                               np.asarray(jm.predict_match(jnp.asarray(fused))), rtol=1e-5, atol=1e-5)

    other = JaxModel(MARKERS, feature_dim=D, num_layers=3, rngs=nnx.Rngs(9))
    sd = {k: v.numpy() for k, v in pm.state_dict().items()}
    assert import_alignment_checkpoint(other, sd) == []
    np.testing.assert_allclose(np.asarray(jax_apply_fn(other)(x)["he"]), got["he"], rtol=1e-5, atol=1e-5)

    path = save_model(tmp_path / "a.npz", pm)
    assert infer_alignment_arch(path) == (3, D)
    assert infer_alignment_markers(path) == MARKERS
    with pytest.raises(ValueError, match="alignment model"):
        infer_alignment_arch(save_model(tmp_path / "b.npz", torch.nn.Linear(2, 2)))


def _train_pair(npz_dir, tmp_path, markers=MARKERS, jax_markers=None, steps=12, **kw):
    """Both trainers from the same weights over the same views; returns
    (JAX result, JAX trainer, port result, port trainer)."""
    jax_markers = jax_markers or markers
    jm, _ = _models(jax_markers)
    _, pm = _models(markers)
    pm.load_state_dict(alignment_params_from_jax(nnx.to_pure_dict(nnx.state(jm, nnx.Param))))
    opts = dict(learning_rate=1e-3, tau2=0.5, early_stopping_patience=2,
                early_stopping_min_delta=0.05)
    opts.update(kw)
    jt = JaxTrainer(jm, scan_steps=1, **opts)
    pt = MultiModalAlignmentTrainer(pm, **opts)
    run = dict(max_steps=steps, batch_size=5, val_interval=4, seed=5)
    jo = jt.train(_views(JaxDataset, npz_dir, jax_markers)[1]["train"],
                  _views(JaxDataset, npz_dir, jax_markers)[1]["val"],
                  save_path=tmp_path / "jax.npz", **run)
    views = _views(TMANpzAlignedWithNegDataset, npz_dir, markers)[1]
    po = pt.train(views["train"], views["val"], save_path=tmp_path / "port.npz", **run)
    return jo, jt, po, pt


def _assert_same_run(jo, jt, po, pt, tmp_path):
    jh, ph = jo["history"], po["history"]
    assert ph["steps"] == jh["steps"]
    np.testing.assert_allclose(ph["train_loss"], jh["train_loss"], rtol=1e-4)
    np.testing.assert_allclose(np.asarray(ph["svd_values"]), np.asarray(jh["svd_values"]),
                               rtol=1e-4, atol=1e-5)
    assert [v["step"] for v in ph["val_loss"]] == [v["step"] for v in jh["val_loss"]]
    np.testing.assert_allclose([v["loss"] for v in ph["val_loss"]],
                               [v["loss"] for v in jh["val_loss"]], rtol=1e-4)
    assert pt.early_stop_counter == jt.early_stop_counter
    np.testing.assert_allclose(po["best_val_loss"], jo["best_val_loss"], rtol=1e-4)
    with np.load(tmp_path / "port.npz") as got, np.load(tmp_path / "jax.npz") as want:
        assert int(got["__extra__/step"]) == int(want["__extra__/step"])


@pytest.mark.parametrize("loss_type,svd_impl", [("volume", "gram"), ("rank1", "gram"),
                                                ("rank1", "svd")])
def test_train_matches_jax(npz_dir, tmp_path, loss_type, svd_impl):
    """lambda2 = 0: the loss trajectory, SVD values, validation losses and
    steps, best step and early-stop count of the JAX trainer."""
    jo, jt, po, pt = _train_pair(npz_dir, tmp_path, loss_type=loss_type, svd_impl=svd_impl,
                                 lambda2=0.0)
    _assert_same_run(jo, jt, po, pt, tmp_path)


def test_volume_anchor_order(npz_dir, tmp_path):
    """With an unsorted marker list the JAX trainer anchors the volume loss
    on the alphabetically first marker (its batch dicts cross jit in sorted
    key order): it follows the port given the sorted list, while the port
    given the unsorted list anchors on its first marker, as the reference
    does."""
    unsorted = ["cd8", "he", "cd3"]
    jo, jt, po, pt = _train_pair(npz_dir, tmp_path, markers=MARKERS, jax_markers=unsorted,
                                 loss_type="volume", lambda2=0.0)
    _assert_same_run(jo, jt, po, pt, tmp_path)
    _, pm = _models(unsorted)
    views = _views(TMANpzAlignedWithNegDataset, npz_dir, unsorted)[1]
    pos, _ = views["train"].collate([0, 1, 2, 3, 4], 0)
    own = MultiModalAlignmentTrainer(pm, loss_type="volume", lambda2=0.0, tau2=0.5)
    batch = {m: torch.as_tensor(v) for m, v in pos.items()}
    with torch.no_grad():
        loss_unsorted = float(own._loss(batch, None, None, False)[0])
        loss_sorted = float(own._loss({m: batch[m] for m in MARKERS}, None, None, False)[0])
    assert abs(loss_unsorted - loss_sorted) > 1e-3


def test_loss_im_validate_and_training(npz_dir, tmp_path):
    """lambda2 = 0.1 (rank1): validate() has no dropout and matches the
    JAX trainer's within 1e-5; training draws the predictor's dropout from
    another stream, so its best validation loss is held within 2x of the
    JAX trainer's; the predictor never moves."""
    jm, pm = _models()
    jt = JaxTrainer(jm, scan_steps=1, learning_rate=1e-3, lambda2=0.1, tau2=0.5)
    pt = MultiModalAlignmentTrainer(pm, learning_rate=1e-3, lambda2=0.1, tau2=0.5)
    jval = _views(JaxDataset, npz_dir)[1]["val"]
    val = _views(TMANpzAlignedWithNegDataset, npz_dir)[1]["val"]
    np.testing.assert_allclose(pt.validate(val, 4), jt.validate(jval, batch_size=4), rtol=1e-5)
    before = {k: v.clone() for k, v in pm.mlp_predictor.state_dict().items()}
    jo, _, po, _ = _train_pair(npz_dir, tmp_path, steps=16, lambda2=0.1, early_stopping_patience=0)
    assert np.isfinite(po["history"]["train_loss"]).all()
    assert 0.5 <= po["best_val_loss"] / jo["best_val_loss"] <= 2.0
    pt.train(_views(TMANpzAlignedWithNegDataset, npz_dir)[1]["train"], val, max_steps=3,
             batch_size=5, val_interval=3)
    assert all(torch.equal(v, before[k]) for k, v in pm.mlp_predictor.state_dict().items())


def test_batches_lr_and_options_give_identical_histories(npz_dir, monkeypatch):
    """The port draws the JAX trainer's batches (the positions its host
    collate sees) and learning rates; scan_steps 1 and 8 and device_data on
    and off give identical histories; negatives are required for loss_IM;
    a mesh_shape without a launcher trains unsharded."""
    seen = {"jax": [], "port": []}
    for name, cls in (("jax", JaxDataset), ("port", TMANpzAlignedWithNegDataset)):
        view = _views(cls, npz_dir)[1]["train"]
        original = type(view).collate
        monkeypatch.setattr(type(view), "collate",
                            lambda self, p, b, _o=original, _n=name: (seen[_n].append(
                                (list(map(int, p)), b)), _o(self, p, b))[1])
        model = _models()[0 if name == "jax" else 1]
        trainer = (JaxTrainer(model, scan_steps=1, lambda2=0.1) if name == "jax"
                   else MultiModalAlignmentTrainer(model, lambda2=0.1))
        trainer.train(view, view, max_steps=9, batch_size=5, val_interval=100, seed=7,
                      device_data=False)
        monkeypatch.undo()
    assert seen["port"] == seen["jax"] and len(seen["port"]) == 10  # the probe, then 9 steps
    jt = JaxTrainer(_models()[0], learning_rate=3e-4)
    pt = MultiModalAlignmentTrainer(_models()[1], learning_rate=3e-4)
    assert [pt._lr_for_epoch(e) for e in (0, 1, 57, 100, 199, 250)] == \
        [jt._lr_for_epoch(e) for e in (0, 1, 57, 100, 199, 250)]

    def history(**kw):
        scan = kw.pop("scan_steps", 1)
        pt = MultiModalAlignmentTrainer(_models()[1], learning_rate=1e-3, lambda2=0.1,
                                        scan_steps=scan)
        views = _views(TMANpzAlignedWithNegDataset, npz_dir)[1]
        return pt.train(views["train"], views["val"], max_steps=10, batch_size=4,
                        val_interval=4, seed=5, **kw)["history"]

    base = history(device_data=False)
    assert history(device_data=False, scan_steps=8) == base
    assert history(device_data=True) == base

    ds = TMANpzAlignedWithNegDataset(npz_dir, MARKERS, filename_template=TEMPLATE,
                                     mismatch_ratio=0.0)
    with pytest.raises(RuntimeError, match="Negative features"):
        MultiModalAlignmentTrainer(_models()[1], lambda2=0.1).train(ds, ds, max_steps=2, batch_size=4)
    # a mesh_shape without a launcher trains unsharded, as in the JAX package
    assert MultiModalAlignmentTrainer(_models()[1], mesh_shape={"data": 2}).mesh is None


def test_run_alignment_cli_writes_the_jax_cli_files(npz_dir, tmp_path):
    """The JAX CLI's flags plus --device, the same 8:1:1 split membership,
    and the same files: the checkpoint, ``.history.json`` with the same keys
    and config, ``.scalars.csv`` with the same columns and rows."""
    assert {a.dest for a in cli.build_parser()._actions} == \
        {a.dest for a in jcli.build_parser()._actions} | {"device"}
    flags = ["--base_dir", str(npz_dir), "--filename_template", TEMPLATE, "--markers", *MARKERS,
             "--feature_dim", str(D), "--num_layers", "2", "--loss_type", "rank1",
             "--lambda2", "0", "--max_steps", "6", "--batch_size", "4", "--val_interval", "3",
             "--seed", "11"]
    jout = jcli.main(flags + ["--save_path", str(tmp_path / "jax.npz"), "--scan_steps", "1"])
    out = cli.main(flags + ["--save_path", str(tmp_path / "port.npz"), "--device", "cpu"])
    assert np.isfinite(out["best_val_loss"]) and len(out["history"]["train_loss"]) == 6
    for side in ("jax", "port"):
        assert (tmp_path / f"{side}.npz").exists()
    got = json.loads((tmp_path / "port.npz.history.json").read_text())
    want = json.loads((tmp_path / "jax.npz.history.json").read_text())
    assert got.keys() == want.keys() and got["history"].keys() == want["history"].keys()
    assert [v["step"] for v in got["history"]["val_loss"]] == \
        [v["step"] for v in want["history"]["val_loss"]]
    config = dict(got["config"])
    assert config.pop("device") == "cpu" and config.pop("save_path").endswith("port.npz")
    want["config"].pop("save_path")
    assert config == {**want["config"], "scan_steps": 8}
    with open(tmp_path / "port.npz.scalars.csv") as f, open(tmp_path / "jax.npz.scalars.csv") as g:
        rows, jrows = list(csv.reader(f)), list(csv.reader(g))
    assert rows[0] == jrows[0] and len(rows) == len(jrows) == 3
    # the split: 24 samples -> 19 train, 2 val, 3 test, as the JAX CLI draws them
    assert len(jout["history"]["train_loss"]) == len(out["history"]["train_loss"])
    assert infer_alignment_arch(tmp_path / "port.npz") == (2, D)
    if not torch.cuda.is_available():  # the default device is the card
        with pytest.raises(RuntimeError, match="CUDA"):
            cli.main(flags + ["--save_path", str(tmp_path / "x.npz")])


# ---------------------------------------------------------------------------
# load-time alignment: the dataset, the survival CLI, predict and serve
# ---------------------------------------------------------------------------

ALIGN_CH = "tma=cd3=features"
SURVIVAL_FLAGS = [
    "--exp_code", "al", "--model_type", "clam_mlp",
    "--target_channels", "wsi=features", ALIGN_CH,
    "--channels_used_in_model", "wsi=features", ALIGN_CH,
    "--input_dim", "32", "--model_size", "8*4", "--output_dim", "8",
    "--k", "2", "--max_epochs", "1", "--batch_size", "4", "--seed", "0",
]


@pytest.fixture(scope="module")
def survival_data(tmp_path_factory):
    """An HDF5 fixture and one alignment checkpoint (depth 3, modality
    ``tma=cd3=features`` and a second one, ``cd8``) in each package's
    layout, same weights."""
    root = tmp_path_factory.mktemp("aligned")
    csv_path = make_synthetic_dataset(root, n_patients=8, seed=5, min_wsi_patches=6,
                                      max_wsi_patches=20, feature_dim=32, markers=("cd3", "cd8"))
    mods = sorted([ALIGN_CH, "cd8"])
    jm = JaxModel(mods, feature_dim=32, num_layers=3, rngs=nnx.Rngs(7))
    pm = MultiModalAlignmentModel(mods, feature_dim=32, num_layers=3,
                                  generator=torch.Generator().manual_seed(0))
    pm.load_state_dict(alignment_params_from_jax(nnx.to_pure_dict(nnx.state(jm, nnx.Param))))
    from multimodal_fusion_tpu.train.checkpoint import save_model as jax_save_model

    jax_save_model(root / "jax_align.npz", jm)
    save_model(root / "port_align.npz", pm)
    return root, csv_path, jm


def test_dataset_alignment_matches_jax(survival_data):
    """``aligned_<channel>`` features at load time, identity and colon
    (channel:modality) mappings, within 1e-5 of the JAX dataset's."""
    root, csv_path, jm = survival_data
    chans = ["wsi=features", ALIGN_CH, "tma=cd8=features"]
    align = {ALIGN_CH: ALIGN_CH, "tma=cd8=features": "cd8"}
    fn = results_io.load_alignment_model(root / "port_align.npz", align, "cpu")
    ds = MultimodalDataset(csv_path, root, chans, align_channels=align, alignment_apply_fn=fn)
    jds = JaxMultimodal(csv_path, root, chans, align_channels=align, alignment_apply_fn=jax_apply_fn(jm))
    assert ds.case_ids == jds.case_ids
    for cid in ds.case_ids[:3]:
        raw, _ = ds.get_case(cid)
        jraw, _ = jds.get_case(cid)
        assert sorted(raw) == sorted(jraw)
        for ch in align:
            np.testing.assert_allclose(raw[f"aligned_{ch}"], jraw[f"aligned_{ch}"], rtol=1e-5, atol=1e-5)
            assert np.abs(raw[f"aligned_{ch}"] - raw[ch]).max() > 1e-3
    with pytest.raises(ValueError, match="not in channels"):
        MultimodalDataset(csv_path, root, ["wsi=features"], align_channels={ALIGN_CH: ALIGN_CH})


def test_survival_cli_predict_and_serve_with_alignment(survival_data, tmp_path):
    """The survival CLI loads an alignment checkpoint (colon mapping kept in
    the configs as the JAX CLI keeps it); ``predict`` and ``ScoringServer``
    over its directory load the model once, read the same aligned features
    as the JAX dataset and score like ``evaluate_fold``; a named but missing
    checkpoint raises."""
    root, csv_path, jm = survival_data
    data = ["--csv_path", str(csv_path), "--data_root_dir", str(root),
            "--aligned_channels", f"{ALIGN_CH}:{ALIGN_CH}", "tma=cd8=features:cd8",
            "--target_channels", "wsi=features", ALIGN_CH, "tma=cd8=features"]
    flags = [f for f in SURVIVAL_FLAGS]
    flags[flags.index("--target_channels"):flags.index("--channels_used_in_model")] = []
    log_dir = cli_survival.main(flags + data + [
        "--results_dir", str(tmp_path / "port"), "--device", "cpu",
        "--alignment_model_path", str(root / "port_align.npz")])
    jdir = jcli_survival.main(flags + data + [
        "--results_dir", str(tmp_path / "jax"), "--alignment_model_path", str(root / "jax_align.npz")])
    got = json.loads(next(log_dir.glob("configs_*.json")).read_text())["experiment_config"]
    want = json.loads(next(jdir.glob("configs_*.json")).read_text())["experiment_config"]
    for key in ("aligned_channels", "aligned_channels_map"):
        assert got[key] == want[key]
    assert got["aligned_channels_map"] == {ALIGN_CH: ALIGN_CH, "tma=cd8=features": "cd8"}

    configs = results_io.load_configs(log_dir)
    ds = results_io.build_dataset(configs, csv_path, root, device="cpu")
    jds = JaxMultimodal(csv_path, root, configs.experiment_config.target_channels,
                        align_channels=got["aligned_channels_map"], alignment_apply_fn=jax_apply_fn(jm))
    for cid in ds.case_ids[:2]:
        np.testing.assert_allclose(ds.get_case(cid)[0]["aligned_tma=cd8=features"],
                                   jds.get_case(cid)[0]["aligned_tma=cd8=features"], rtol=1e-5, atol=1e-5)

    res = predict(log_dir, csv_path, root, folds=[0], device="cpu", output_path=tmp_path / "p")
    _, _, trainer, _ = results_io.load_results_context(log_dir, csv_path, root, folds=[0], device="cpu")
    from multimodal_fusion_tpu_torch.data.splits import FoldSplit

    empty = np.zeros((0,), np.int64)
    direct = trainer.evaluate_fold(ds, FoldSplit(empty, empty, np.arange(len(ds))), 0)
    probs = {r["case_id"]: float(r["prob_1"]) for r in res["cases"]}
    assert max(abs(probs[c] - p[1]) for c, p in zip(direct["patient_ids"], direct["probs"])) <= 1e-6

    calls = []
    original = results_io.load_alignment_model
    results_io.load_alignment_model = lambda *a, **k: calls.append(1) or original(*a, **k)
    try:
        server = ScoringServer(log_dir, root, folds=[0], device="cpu")
        with open(csv_path, newline="") as f:
            rows = [{k: r[k] for k in ("patient_id", "case_id", "h5_file_path")}
                    for r in csv.DictReader(f)]
        for _ in range(2):
            out = server.score_rows(rows)
    finally:
        results_io.load_alignment_model = original
    assert len(calls) == 1
    served = {r["case_id"]: float(r["prob_1"]) for r in out["cases"]}
    assert max(abs(served[c] - probs[c]) for c in probs) <= 1e-6

    configs.experiment_config.alignment_model_path = str(tmp_path / "absent.npz")
    with pytest.raises(FileNotFoundError, match="alignment_model_path"):
        results_io.load_alignment(configs, "cpu")


def test_dump_alignment_features_and_visualization_cli(survival_data, tmp_path):
    """``dump_alignment_features`` of an svd_gate model with the JAX model's
    weights matches the JAX dump within 1e-5; the visualization CLI dumps a
    trained directory's test split (plots are None without matplotlib)."""
    from multimodal_fusion_tpu import config as jconfig
    from multimodal_fusion_tpu.models.factory import ModelFactory as JaxFactory
    from multimodal_fusion_tpu.utils.visualization import dump_alignment_features as jax_dump
    from multimodal_fusion_tpu_torch import config as tconfig
    from multimodal_fusion_tpu_torch.cli import alignment_visualization as cli_vis
    from multimodal_fusion_tpu_torch.models.factory import ModelFactory
    from multimodal_fusion_tpu_torch.models.jax_params import survival_params_from_jax
    from multimodal_fusion_tpu_torch.utils.visualization import dump_alignment_features

    root, csv_path, _ = survival_data
    chans = ["wsi=features", ALIGN_CH, "clinical=val", "clinical=mask"]
    jc = jconfig.ModelConfig(model_type="svd_gate_random_clam", n_classes=2, input_dim=32,
                             model_size="8*4", dropout=0.1, output_dim=8,
                             channels_used_in_model=chans, channel_input_dims={"clinical=val": 16})
    jmodel = JaxFactory.create_model(jc, seed=0)
    model = ModelFactory.create_model(tconfig.ModelConfig.from_dict(jc.to_dict()), device="cpu")
    model.load_state_dict(survival_params_from_jax(nnx.to_pure_dict(nnx.state(jmodel, nnx.Param))))
    ds = MultimodalDataset(csv_path, root, chans)
    jds = JaxMultimodal(csv_path, root, chans)
    got = np.load(dump_alignment_features(model, ds, [0, 1, 2], tmp_path / "port"))
    want = np.load(jax_dump(jmodel, jds, [0, 1, 2], tmp_path / "jax.npz"))
    assert sorted(got.files) == sorted(want.files) and any(k.startswith("aligned__") for k in got.files)
    for k in got.files:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-5, err_msg=k)
    assert json.loads((tmp_path / "port.json").read_text()) == json.loads((tmp_path / "jax.json").read_text())

    log_dir = cli_survival.main(SURVIVAL_FLAGS[:3] + ["svd_gate_random_clam"] + SURVIVAL_FLAGS[4:] + [
        "--csv_path", str(csv_path), "--data_root_dir", str(root), "--enable_svd",
        "--results_dir", str(tmp_path / "r"), "--device", "cpu"])
    outputs = cli_vis.main(["--results_dir", str(log_dir), "--csv_path", str(csv_path),
                            "--data_root_dir", str(root), "--fold_idx", "1", "--plots",
                            "--device", "cpu"])
    dump = np.load(outputs[0])
    assert outputs[0] == log_dir / "svd_features" / "fold_1_features.npz"
    assert dump["labels"].shape[0] == dump["aligned__tma=features"].shape[0] > 0


def test_stage_timer_device_trace_and_ablation_summary(npz_dir, tmp_path, capsys):
    """verbose_timing reports the trainer's three stages; device_trace
    writes a Chrome trace of the block; analyze_ablation ranks history
    files by their best validation loss."""
    from multimodal_fusion_tpu_torch.utils.profiling import device_trace
    from multimodal_fusion_tpu_torch.utils.visualization import analyze_ablation

    _, pm = _models()
    tr = MultiModalAlignmentTrainer(pm, lambda2=0.0, verbose_timing=True)
    views = _views(TMANpzAlignedWithNegDataset, npz_dir)[1]
    with device_trace(str(tmp_path / "trace")) as prof:
        tr.train(views["train"], views["val"], max_steps=4, batch_size=5, val_interval=2)
    assert prof is not None and (tmp_path / "trace" / "trace.json").exists()
    assert {"data_loading", "train_step", "validation"} <= set(tr.timer.summary())
    assert tr.timer.summary()["train_step"]["count"] == 4
    assert "train_step" in capsys.readouterr().out
    for name, losses in (("a", [0.5, 0.2]), ("b", [0.9]), ("c", [0.1, 0.7])):
        (tmp_path / f"{name}.history.json").write_text(json.dumps(
            {"history": {"val_loss": [{"step": i, "loss": v} for i, v in enumerate(losses)]},
             "config": {"name": name}}))
    rows = analyze_ablation(sorted(tmp_path.glob("*.history.json")))
    assert [r["config"]["name"] for r in rows] == ["c", "a", "b"]
    assert [r["best_val_loss"] for r in rows] == [0.1, 0.2, 0.9]

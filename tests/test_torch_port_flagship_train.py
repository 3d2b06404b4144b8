"""Flagship training in the port against the JAX package on the CPU:
``SurvivalTrainer.train_fold`` with the window group losses (rank-1 SVD,
CLIP, AUCM, Cox), the validation group loss of AUC-CLAM, the survival
``time`` / ``event`` columns, ``remat``, and a trained-parity run.

The trajectory tests run both trainers on one synthetic HDF5 dataset from
the same initial weights (the JAX fold model's, carried across by
``survival_params_from_jax``), at dropout 0 with the random partial loss
off, so that both runs draw no random numbers and take the window order
from numpy.  Tolerances: per-epoch losses rtol 1e-4, atol 1e-6 (float32
sums in other orders, compounded over Adam steps); AUCs and accuracies
1e-6; test probabilities 1e-4; the C-index 1e-6.  The trained-parity test
trains each package from its own initial weights with dropout on, on a
separable fixture, and holds the test AUCs within 0.02 of each other (the
bar of ``tests/test_trained_parity.py``).
"""

import csv
import json

import numpy as np
import pytest
import torch
from flax import nnx

from multimodal_fusion_tpu import config as jconfig
from multimodal_fusion_tpu.data.multimodal import MultimodalDataset as JaxDataset
from multimodal_fusion_tpu.io.fixtures import make_synthetic_dataset
from multimodal_fusion_tpu.models.factory import ModelFactory as JaxFactory
from multimodal_fusion_tpu.train.survival import SurvivalTrainer as JaxTrainer
from multimodal_fusion_tpu_torch import channels as tchannels
from multimodal_fusion_tpu_torch import config as tconfig
from multimodal_fusion_tpu_torch.data import splits as tsplits
from multimodal_fusion_tpu_torch.data.multimodal import MultimodalDataset
from multimodal_fusion_tpu_torch.models.factory import ModelFactory
from multimodal_fusion_tpu_torch.models.svd_gate import survival_params_from_jax
from multimodal_fusion_tpu_torch.train.survival import SurvivalTrainer

FLAGSHIP = ["wsi", "cd3", "cd8", "clinical_mask", "blood_mask"]
BAGS = ["wsi", "cd3", "cd8"]


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """12 patients, 16-d features, WSI bags of 16-40 patches (and their
    reconstruction, which the ``wsi`` shorthand names), 2 TMA markers, 2
    tabular groups with masks; the CSV carries ``time`` and ``event``
    (the Cox test reads them; the other models ignore them)."""
    root = tmp_path_factory.mktemp("flagship_train")
    csv_path = make_synthetic_dataset(root, n_patients=12, seed=3, min_wsi_patches=16,
                                      max_wsi_patches=40, feature_dim=16, markers=("cd3", "cd8"),
                                      with_reconstructed=True)
    with open(csv_path, newline="") as f:
        rows = list(csv.DictReader(f))
    rng = np.random.default_rng(5)
    timed = root / "timed.csv"
    with open(timed, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=list(rows[0]) + ["time", "event"])
        w.writeheader()
        for r in rows:
            w.writerow({**r, "time": f"{rng.uniform(1, 60):.3f}", "event": int(rng.random() < 0.6)})
    return root, csv_path, timed


def _configs(key, shorthands, **model):
    chans = tchannels.parse_channels(shorthands)
    base = dict(model_type=key, n_classes=2, input_dim=16, model_size="8*4", dropout=0.0,
                output_dim=16, inst_number=8, base_weight=0.9, subtyping=True,
                channels_used_in_model=chans,
                channel_input_dims={"clinical=val": 16, "blood=val": 24},
                enable_svd=True, enable_dynamic_gate=True, enable_random_loss=False,
                tau1=1.0, tau2=1.0, lambda1=0.1)
    base.update(model)
    mc = jconfig.ModelConfig(**base)
    ec = jconfig.ExperimentConfig(exp_name="t", seed=7, k_folds=3, max_epochs=2, batch_size=4,
                                  lr=1e-3, optimizer="adam", weight_decay=1e-5, scheduler="plateau",
                                  scheduler_params={"mode": "min", "patience": 15, "factor": 0.5},
                                  min_epochs=0)
    ec.extra["verbose"] = False
    jc = jconfig.Configs(experiment_config=ec, model_config=mc)
    tc = tconfig.Configs.from_dict(json.loads(json.dumps(jc.to_dict())))
    return jc, tc, chans


def _port_trainer(jc, tc, log_dir):
    """The port's trainer, building each fold's model with the JAX
    trainer's initial weights of that fold."""
    tr = SurvivalTrainer(tc, log_dir, device="cpu")

    def build(fold_idx):
        jm = JaxFactory.create_model(jc.model_config, seed=jc.experiment_config.seed + fold_idx)
        model = ModelFactory.create_model(tc.model_config, seed=0, device="cpu")
        model.load_state_dict(survival_params_from_jax(nnx.to_pure_dict(nnx.state(jm, nnx.Param))))
        return model

    tr._build_model = build
    return tr


def _read(path):
    return json.loads(path.read_text())


CASES = [
    ("svd_gate_random_clam", FLAGSHIP, {}),
    ("clip_gate_random_clam", FLAGSHIP, {}),
    ("auc_clam", BAGS, {}),
    ("cox_svd_gate_random_clam", FLAGSHIP, {}),
]


@pytest.mark.parametrize("key,shorthands,model", CASES, ids=[c[0] for c in CASES])
def test_train_fold_matches_jax_trainer(data, tmp_path, key, shorthands, model):
    root, csv_path, timed = data
    csv_used = timed if key.startswith("cox") else csv_path
    jc, tc, chans = _configs(key, shorthands, **model)
    jds = JaxDataset(csv_used, root, chans)
    ds = MultimodalDataset(csv_used, root, chans)
    assert ds.has_survival_time == key.startswith("cox")
    split = tsplits.create_k_fold_splits(ds.labels, 3, 7)[0]
    jtr = JaxTrainer(jc, tmp_path / "jax")
    want = jtr.train_fold(jds, split, 0)
    tr = _port_trainer(jc, tc, tmp_path / "port")
    got = tr.train_fold(ds, split, 0)

    for k in ("train_loss", "val_loss"):
        np.testing.assert_allclose([h[k] for h in got["history"]], [h[k] for h in want["history"]],
                                   rtol=1e-4, atol=1e-6, err_msg=k)
    for k in ("val_auc", "test_auc", "val_acc", "test_acc"):
        np.testing.assert_allclose(got[k], want[k], atol=1e-6, err_msg=k)
    pj = _read(tmp_path / "jax" / "fold_0_summary.json")["patient_results"]
    pt = _read(tmp_path / "port" / "fold_0_summary.json")["patient_results"]
    assert list(pt) == list(pj)
    for pid in pj:
        np.testing.assert_allclose(pt[pid]["prob"], pj[pid]["prob"], atol=1e-4)
    assert (tmp_path / "port" / "splits_0.csv").read_text() == (tmp_path / "jax" / "splits_0.csv").read_text()

    if key.startswith("cox"):
        # the risk head's scores and the C-index on the fold's test cases
        jres = jtr.evaluate_fold(jds, split, 0)
        res = tr.evaluate_fold(ds, split, 0)
        np.testing.assert_allclose(res["risk"], jres["risk"], rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(res["c_index"], jres["c_index"], atol=1e-6)
    if key == "auc_clam":
        # a, b and alpha train; the validation group loss reads the model
        # as built (a = b = alpha = 0), which val_loss above holds to JAX
        assert tr._fold_state.auc_alpha.item() != 0.0


def test_remat_gives_bit_equal_gradients(data):
    """One window of the flagship at dropout 0.25 with the random partial
    loss on: remat on and off give the same loss and bit-equal gradients
    (the generator's draws are replayed for the recompute)."""
    root, csv_path, _ = data
    jc, tc, chans = _configs("svd_gate_random_clam", FLAGSHIP, dropout=0.25, enable_random_loss=True)
    ds = MultimodalDataset(csv_path, root, chans)
    grads, losses = {}, {}
    for remat in (False, True):
        tc.experiment_config.remat = remat
        tr = SurvivalTrainer(tc, root / f"remat_{remat}", device="cpu")
        model = ModelFactory.create_model(tc.model_config, seed=3, device="cpu")
        opt = torch.optim.SGD(model.parameters(), lr=0.0)
        _, window = next(tr._windows(ds, list(range(8)), 8))
        gen = torch.Generator().manual_seed(11)
        losses[remat] = tr._train_step(model, opt, tr._to_device(window), gen)
        grads[remat] = {n: p.grad for n, p in model.named_parameters() if p.grad is not None}
        grads[remat]["<generator state after the step>"] = gen.get_state()
    assert torch.equal(losses[False], losses[True])
    assert grads[False].keys() == grads[True].keys() and len(grads[False]) > 20
    for name, g in grads[False].items():
        assert torch.equal(g, grads[True][name]), name


def test_remat_holds_no_branch_activations(data):
    """What the forward leaves for the backward pass, remat off and on:
    with it on, each CLAM branch is a checkpointed segment, so no
    [G, N, hidden] activation of a branch is held, and the held activation
    bytes (the inputs and the parameters aside) fall below a third."""
    root, csv_path, _ = data
    _, tc, chans = _configs("svd_gate_random_clam", FLAGSHIP, dropout=0.25, enable_random_loss=True)
    ds = MultimodalDataset(csv_path, root, chans)
    tr = SurvivalTrainer(tc, root / "held", device="cpu")
    window = tr._to_device(next(tr._windows(ds, list(range(8)), 8))[1])
    hidden = tconfig.model_size_dims(16, "8*4")[1]
    held = {}
    for remat in (False, True):
        model = ModelFactory.create_model(tc.model_config, seed=3, device="cpu")
        model.remat = remat
        skip = {t.untyped_storage().data_ptr() for t in [*model.parameters(),
                *window["channels"].values(), *window["masks"].values()]}
        saved = {}

        def pack(t):
            if t.untyped_storage().data_ptr() not in skip:
                saved[t.untyped_storage().data_ptr()] = (tuple(t.shape), t.untyped_storage().nbytes())
            return t

        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            model({"channels": window["channels"], "masks": window["masks"]}, window["label"],
                  generator=torch.Generator().manual_seed(1), train=True)
        branch = [shape for shape, _ in saved.values() if len(shape) == 3 and shape[-1] == hidden]
        held[remat] = (sum(n for _, n in saved.values()), branch)
    assert held[False][1] and not held[True][1]
    assert held[True][0] < held[False][0] / 3, held


def _separable_dataset(root, n_cases=32, d=24):
    """Class-1 bags shifted by +1.2 per dim: linearly separable at bag
    level (``tests/test_trained_parity.py``'s fixture)."""
    import h5py

    rng = np.random.default_rng(0)
    rows = []
    for i in range(n_cases):
        label = i % 2
        shift = 1.2 if label == 1 else 0.0
        with h5py.File(root / f"case_{i}.h5", "w") as f:
            f["wsi/features"] = (rng.standard_normal((int(rng.integers(12, 20)), d)) + shift).astype(np.float32)
            f["tma/cd3/features"] = (rng.standard_normal((4, d)) + shift).astype(np.float32)
        rows.append({"patient_id": i + 1, "case_id": f"case_{i}",
                     "label": "deceased" if label else "living", "h5_file_path": f"case_{i}.h5"})
    csv_path = root / "dataset.csv"
    with open(csv_path, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=["patient_id", "case_id", "label", "h5_file_path"])
        w.writeheader()
        w.writerows(rows)
    return csv_path


def test_trained_flagship_auc_matches_jax(tmp_path):
    """Each package trains the flagship from its own initial weights, with
    dropout 0.25 and the SVD group loss, on the same fold of a separable
    fixture: test AUCs within 0.02."""
    csv_path = _separable_dataset(tmp_path)
    chans = ["wsi=features", "tma=cd3=features"]
    mc = jconfig.ModelConfig(model_type="svd_gate_random_clam", n_classes=2, input_dim=24,
                             model_size="16*8", dropout=0.25, output_dim=16, inst_number=3,
                             base_weight=0.7, channels_used_in_model=chans, enable_svd=True,
                             enable_dynamic_gate=True, enable_random_loss=False, tau1=0.1,
                             tau2=0.1, lambda1=1.0, lambda2=0.0)
    ec = jconfig.ExperimentConfig(exp_name="golden", seed=0, k_folds=2, max_epochs=6, batch_size=4,
                                  lr=2e-3, patience=50, min_epochs=0, monitor_metric="auc",
                                  monitor_mode="max", weighted_sampling=True)
    ec.extra["verbose"] = False
    jc = jconfig.Configs(experiment_config=ec, model_config=mc)
    tc = tconfig.Configs.from_dict(json.loads(json.dumps(jc.to_dict())))
    ds = MultimodalDataset(csv_path, tmp_path, chans)
    split = tsplits.create_k_fold_splits(ds.labels, 2, 0)[0]
    want = JaxTrainer(jc, tmp_path / "jax").train_fold(JaxDataset(csv_path, tmp_path, chans), split, 0)
    got = SurvivalTrainer(tc, tmp_path / "port", device="cpu").train_fold(ds, split, 0)
    assert got["test_auc"] >= 0.9 and want["test_auc"] >= 0.9
    assert abs(got["test_auc"] - want["test_auc"]) <= 0.02


@pytest.mark.parametrize("key", ["auc_clam", "cox_svd_gate_random_clam"])
def test_group_loss_models_match_jax(data, key):
    """auc_clam and cox_svd_gate_random_clam: every JAX parameter carried
    across by ``survival_params_from_jax`` (auc_a/auc_b/auc_alpha,
    risk_head, risk_head_logits included), the eval forward's logits and
    risk, and the group loss on the window's results with ``label``,
    ``time`` and ``event``, value and gradient with respect to the logits
    (AUC-CLAM) or the risk and the aligned features (Cox), within 1e-5."""
    import jax
    import jax.numpy as jnp

    from multimodal_fusion_tpu.data.batching import make_window

    root, _, timed = data
    jc, tc, chans = _configs(key, BAGS if key == "auc_clam" else FLAGSHIP)
    jm = JaxFactory.create_model(jc.model_config, seed=4)
    for name, value in (("auc_a", 0.3), ("auc_b", -0.2), ("auc_alpha", 0.7)):  # away from 0
        if hasattr(jm, name):
            getattr(jm, name)[...] = jnp.asarray(value)
    sd = survival_params_from_jax(nnx.to_pure_dict(nnx.state(jm, nnx.Param)))
    model = ModelFactory.create_model(tc.model_config, seed=0, device="cpu")
    assert set(sd) == set(model.state_dict())
    model.load_state_dict(sd)
    ds = MultimodalDataset(timed, root, chans)
    cases = [ds.get_case(c) for c in ds.case_ids[:6]]
    window = make_window([c[0] for c in cases], [c[1] for c in cases])
    time_ = np.asarray([ds.case_to_time[c] for c in ds.case_ids[:6]], np.float32)
    event = np.asarray([ds.case_to_event[c] for c in ds.case_ids[:6]], np.float32)

    graphdef, state = nnx.split(jm)

    def one(c, m, label):
        return nnx.merge(graphdef, state)({"channels": c, "masks": m}, label, train=False)

    want = jax.vmap(one)(window["channels"], window["masks"], window["label"])
    case = {"channels": {k: torch.as_tensor(np.array(v)) for k, v in window["channels"].items()},
            "masks": {k: torch.as_tensor(np.array(v)) for k, v in window["masks"].items()}}
    label = torch.as_tensor(np.array(window["label"]), dtype=torch.int64)
    with torch.no_grad():
        got = model(case, label)
    np.testing.assert_allclose(got["logits"].numpy(), np.asarray(want["logits"])[:, 0], rtol=1e-5, atol=1e-6)
    if key == "auc_clam":
        names = ["logits"]
        jin = {"logits": want["logits"], "label": window["label"]}
        tin = {"logits": got["logits"], "label": label}
    else:
        np.testing.assert_allclose(got["risk"].numpy(), np.asarray(want["risk"])[:, 0], rtol=1e-5, atol=1e-6)
        names = ["risk", "aligned_features_stack"]
        jin = {"risk": want["risk"], "aligned_features_stack": want["aligned_features_stack"],
               "label": window["label"], "time": jnp.asarray(time_), "event": jnp.asarray(event)}
        tin = {"risk": got["risk"], "aligned_features_stack": got["aligned_features_stack"],
               "label": label, "time": torch.as_tensor(time_), "event": torch.as_tensor(event)}
    jval, jgrad = jax.value_and_grad(
        lambda xs: jm.group_loss_fn({**jin, **xs}))({n: jin[n] for n in names})
    xs = {n: tin[n].clone().requires_grad_() for n in names}
    tval = model.group_loss_fn({**tin, **xs})
    tval.backward()
    np.testing.assert_allclose(tval.item(), float(jval), rtol=1e-5, atol=1e-6)
    for n in names:
        want_g = np.asarray(jgrad[n])
        want_g = want_g[:, 0] if n in ("logits", "risk") else want_g
        np.testing.assert_allclose(xs[n].grad.numpy(), want_g, rtol=1e-5, atol=1e-6, err_msg=n)

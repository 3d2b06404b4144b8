"""The VAE in the port (``models/vae.py``, ``data/vae_patches.py``,
``train/vae.py``, ``utils/tbevents.py`` and the two CLIs) against the JAX
package on the CPU.

The models start from the same weights (the JAX VAE's parameters through
``vae_params_from_jax``).  Deterministic paths (the eval forward, the loss
and its gradients, the reconstruction writer) agree within 1e-5.  One
training step given the draws the JAX side made (its dropout keep masks and
its reparameterisation noise) updates the parameters to within 1e-5.
Whole runs draw from other streams (jax.random against torch generators),
so ``fit`` is held statistically, at the bar of
``tests/test_vae_trained_parity.py`` (validation losses within 2x); its
batch order, patch subsample and schedules are the JAX package's exactly.
"""

import csv
import json
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from multimodal_fusion_tpu.cli import train_vae as jcli_train
from multimodal_fusion_tpu.data.vae_patches import WSIVAEDataset as JaxPatches
from multimodal_fusion_tpu.data.vae_patches import split_train_val as jax_split
from multimodal_fusion_tpu.io.fixtures import make_synthetic_dataset
from multimodal_fusion_tpu.io.h5io import read_channel
from multimodal_fusion_tpu.models.common import split_keys
from multimodal_fusion_tpu.models.vae import VAE as JaxVAE
from multimodal_fusion_tpu.models.vae import vae_loss as jax_vae_loss
from multimodal_fusion_tpu.train.vae import VAETrainer as JaxTrainer
from multimodal_fusion_tpu.train.vae import generate_reconstructed_wsi as jax_generate
from multimodal_fusion_tpu.utils.torch_import import import_vae_checkpoint
from multimodal_fusion_tpu_torch.cli import generate_reconstructed_wsi as cli_generate
from multimodal_fusion_tpu_torch.cli import train_vae as cli_train
from multimodal_fusion_tpu_torch.data.multimodal import MultimodalDataset
from multimodal_fusion_tpu_torch.data.vae_patches import WSIVAEDataset, split_train_val
from multimodal_fusion_tpu_torch.models.jax_params import vae_params_from_jax
from multimodal_fusion_tpu_torch.models.vae import VAE, infer_vae_arch, vae_loss
from multimodal_fusion_tpu_torch.train.checkpoint import save_model
from multimodal_fusion_tpu_torch.train.vae import VAETrainer, generate_reconstructed_wsi

D, HIDDEN, LATENT = 16, [32, 24], 8
TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """4 cases of 120-160 WSI patches x 16 (the 20% subsample), two of them
    'living'."""
    root = tmp_path_factory.mktemp("vae")
    csv_path = make_synthetic_dataset(root, n_patients=4, seed=3, min_wsi_patches=120,
                                      max_wsi_patches=160, feature_dim=D, markers=("cd3",))
    return root, csv_path


def _models(seed=0):
    jm = JaxVAE(input_dim=D, encoder_hidden=HIDDEN, decoder_hidden=HIDDEN[::-1],
                latent_dim=LATENT, rngs=nnx.Rngs(seed))
    pm = VAE(input_dim=D, encoder_hidden=HIDDEN, decoder_hidden=HIDDEN[::-1], latent_dim=LATENT,
             generator=torch.Generator().manual_seed(1))
    pm.load_state_dict(vae_params_from_jax(nnx.to_pure_dict(nnx.state(jm, nnx.Param))), strict=True)
    return jm, pm


def _port_state(jax_state):
    return vae_params_from_jax(nnx.to_pure_dict(jax_state))


def test_vae_model_matches_jax(tmp_path):
    """Eval forward, encode, decode, and vae_loss's value and gradients
    within 1e-5; the port's state dict loads into the JAX VAE through
    ``import_vae_checkpoint`` with nothing left over; the architecture is
    read back from a checkpoint."""
    jm, pm = _models()
    x = np.random.default_rng(0).standard_normal((10, D)).astype(np.float32)
    for got, want in zip(pm(torch.as_tensor(x)), jm(jnp.asarray(x))):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    z = pm.encode(torch.as_tensor(x))
    np.testing.assert_allclose(z.detach().numpy(), np.asarray(jm.encode(jnp.asarray(x))), **TOL)
    np.testing.assert_allclose(pm.decode(z).detach().numpy(),
                               np.asarray(jm.decode(jnp.asarray(z.detach().numpy()))), **TOL)

    def jax_loss(params):
        m = nnx.merge(graphdef, params, rest)
        return jax_vae_loss(jnp.asarray(x), *m(jnp.asarray(x)))[0]

    graphdef, params, rest = nnx.split(jm, nnx.Param, ...)
    value, grads = jax.value_and_grad(jax_loss)(params)
    loss = vae_loss(torch.as_tensor(x), *pm(torch.as_tensor(x)))
    loss[0].backward()
    np.testing.assert_allclose(float(loss[0].detach()), float(value), rtol=1e-5)
    want = _port_state(grads)
    for name, p in pm.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(), err_msg=name, **TOL)

    other = JaxVAE(input_dim=D, encoder_hidden=HIDDEN, decoder_hidden=HIDDEN[::-1],
                   latent_dim=LATENT, rngs=nnx.Rngs(5))
    assert import_vae_checkpoint(other, {k: v.numpy() for k, v in pm.state_dict().items()}) == []
    np.testing.assert_allclose(np.asarray(other.reconstruct(jnp.asarray(x))),
                               pm.reconstruct(torch.as_tensor(x)).detach().numpy(), **TOL)
    assert infer_vae_arch(save_model(tmp_path / "v.npz", pm)) == (D, HIDDEN, HIDDEN[::-1], LATENT)
    with pytest.raises(ValueError, match="complete VAE"):
        infer_vae_arch(save_model(tmp_path / "e.npz", pm.encoder))


def test_train_step_with_jax_draws_matches_jax():
    """One AdamW step given the JAX side's dropout keep masks and noise:
    the loss and every updated parameter within 1e-5."""
    jm, pm = _models()
    x = np.random.default_rng(1).standard_normal((12, D)).astype(np.float32)
    jt = JaxTrainer(jm, learning_rate=1e-3, weight_decay=1e-2)
    pt = VAETrainer(pm, learning_rate=1e-3, weight_decay=1e-2)
    key = jax.random.key(7)
    state, _, loss, _, _ = jt._train_step(jt.state, jt.opt_state, jnp.asarray(x), key, 1e-3)
    k_enc, k_rep, k_dec = split_keys(key, 3)
    draws = {
        "encoder": [torch.as_tensor(np.array(
            jax.random.bernoulli(split_keys(k_enc, 2)[0], 0.9, (12, HIDDEN[0]))))],
        "eps": torch.as_tensor(np.array(jax.random.normal(k_rep, (12, LATENT), jnp.float32))),
        "decoder": [torch.as_tensor(np.array(
            jax.random.bernoulli(split_keys(k_dec, 2)[0], 0.9, (12, HIDDEN[1]))))],
    }
    got_loss, _, _ = pt._step(torch.as_tensor(x), None, draws)
    np.testing.assert_allclose(float(got_loss), float(loss), rtol=1e-5)
    want = _port_state(nnx.state(nnx.merge(jt.graphdef, state), nnx.Param))
    for name, p in pm.state_dict().items():
        np.testing.assert_allclose(p.numpy(), want[name].numpy(), err_msg=name, **TOL)


def test_patch_dataset_matches_jax(data):
    """``patch_index`` before and after resamples, the batches, the
    materialised table and the 80/20 split equal the JAX dataset's; without
    a label filter every case is kept."""
    root, csv_path = data
    ds = WSIVAEDataset(csv_path, root, label_filter="living", seed=9)
    jds = JaxPatches(csv_path, root, label_filter="living", seed=9)
    assert ds.case_ids == jds.case_ids and len(ds.case_ids) == 2
    for _ in range(3):
        assert ds.patch_index == jds.patch_index
        ds.resample_patches()
        jds.resample_patches()
    np.testing.assert_array_equal(ds.materialize(), jds.materialize())
    for got, want in zip(ds.batches(16, np.random.default_rng(2)), jds.batches(16, np.random.default_rng(2))):
        np.testing.assert_array_equal(got, want)
    (tr, va), (jtr, jva) = split_train_val(ds, seed=4), jax_split(jds, seed=4)
    np.testing.assert_array_equal(tr.positions, jtr.positions)
    np.testing.assert_array_equal(va.materialize(), jva.materialize())
    assert len(WSIVAEDataset(csv_path, root, label_filter=" ", seed=9).case_ids) == 4


def test_schedules_match_jax():
    """plateau_step, resample_interval and lr_at_floor give the JAX
    trainer's sequences for one sequence of validation losses."""
    jt = JaxTrainer(_models()[0], learning_rate=1e-3, plateau_patience=2, min_lr=2e-4)
    pt = VAETrainer(_models()[1], learning_rate=1e-3, plateau_patience=2, min_lr=2e-4)
    vals = [1.0, 0.99995, 0.9, 0.95, 0.91, 0.9, 0.92, 0.93, 0.94, 0.95, 0.96, 0.97, 0.98, 0.99,
            1.0, 0.5, 0.6, 0.7, 0.8, 0.9]
    got, want = [], []
    for v in vals:
        for tr, out in ((pt, got), (jt, want)):
            tr.plateau_step(v)
            out.append((tr.lr, tr.lr_reduce_count, tr._plateau_count, tr._plateau_best,
                        tr.resample_interval(100), tr.lr_at_floor))
    assert got == want and got[-1][1] == 3 and got[-1][5]


def test_fit_options_resume_and_event_files(data, tmp_path):
    """fit over 3 epochs: the validation loss within 2x of the JAX
    trainer's; scan_steps 1 and 8 and device_data on and off give
    identical histories; resume restores the epoch, optimizer and plateau
    state; the TensorBoard records carry the JAX trainer's tags and steps,
    with the values of the port's history."""
    from tensorboard.backend.event_processing.event_file_loader import EventFileLoader

    root, csv_path = data

    def run(side, device_data=True, scan_steps=1, resample=True, ckpt=None):
        jm, pm = _models()
        ds = (JaxPatches if side == "jax" else WSIVAEDataset)(csv_path, root, seed=9)
        split = (jax_split if side == "jax" else split_train_val)(ds, seed=9)
        cls = JaxTrainer if side == "jax" else VAETrainer
        tr = cls(jm if side == "jax" else pm, learning_rate=1e-3, scan_steps=scan_steps,
                 checkpoint_dir=ckpt, tb_log_dir=None if ckpt is None else ckpt / "tb",
                 scalar_log_path=None if ckpt is None else ckpt / "scalars.csv")
        return tr, tr.fit(*split, epochs=3, batch_size=32, seed=2, device_data=device_data,
                          resample=resample)

    _, want = run("jax", ckpt=tmp_path / "jax")
    tr, got = run("port", ckpt=tmp_path / "port")
    assert 0.5 <= got["best_val_loss"] / want["best_val_loss"] <= 2.0
    assert np.isfinite(got["history"]["train_loss"]).all()
    assert got["history"].keys() == want["history"].keys()
    assert got["history"]["lr"] == want["history"]["lr"]
    base = run("port", device_data=False)[1]["history"]
    assert run("port", device_data=False, scan_steps=8)[1]["history"] == base
    assert run("port", device_data=True)[1]["history"] == base

    def scalars(path):
        out = []
        for e in EventFileLoader(str(next(path.glob("events.out.tfevents.*")))).Load():
            for v in e.summary.value:
                val = v.simple_value if v.HasField("simple_value") else v.tensor.float_val[0]
                out.append((v.tag, e.step, val))
        return out

    from multimodal_fusion_tpu.utils.tbevents import TBEventWriter as JaxWriter
    from multimodal_fusion_tpu_torch.utils.tbevents import TBEventWriter

    for cls, name in ((TBEventWriter, "w_port"), (JaxWriter, "w_jax")):
        with cls(tmp_path / name) as w:
            for tag, value, step in (("Train/Loss", 1.25, 0), ("Val/Loss", -3.5e-4, 0),
                                     ("Train/LRReduceCount", 2.0, 17)):
                w.add_scalar(tag, value, step)
    assert scalars(tmp_path / "w_port") == scalars(tmp_path / "w_jax") == [
        ("Train/Loss", 0, 1.25), ("Val/Loss", 0, np.float32(-3.5e-4)), ("Train/LRReduceCount", 17, 2.0)]
    events, jevents = scalars(tmp_path / "port" / "tb"), scalars(tmp_path / "jax" / "tb")
    assert [(t, s) for t, s, _ in events] == [(t, s) for t, s, _ in jevents] and len(events) == 15
    assert [v for t, _, v in events if t == "Val/Loss"] == \
        pytest.approx(got["history"]["val_loss"], rel=1e-6)
    with open(tmp_path / "port" / "scalars.csv") as f, open(tmp_path / "jax" / "scalars.csv") as g:
        assert next(csv.reader(f)) == next(csv.reader(g))
    assert sorted(p.name for p in (tmp_path / "port").iterdir()) == \
        sorted(p.name for p in (tmp_path / "jax").iterdir())

    tr._plateau_count, tr._plateau_best, tr.lr_reduce_count, tr.lr = 3, 0.123, 1, 5e-4
    tr.save_checkpoint("latest")
    again = VAETrainer(_models()[1], checkpoint_dir=tmp_path / "port")
    assert again.resume("latest")
    assert (again.epoch, again._plateau_count, again._plateau_best, again.lr_reduce_count,
            again.lr) == (2, 3, 0.123, 1, 5e-4)
    assert again.history == tr.history
    got_opt, want_opt = again.optimizer.state_dict()["state"], tr.optimizer.state_dict()["state"]
    assert got_opt.keys() == want_opt.keys() and len(got_opt) == 14
    assert all(torch.equal(got_opt[i][k], want_opt[i][k]) for i in got_opt for k in got_opt[i])
    assert all(torch.equal(a, b) for a, b in zip(again.model.state_dict().values(),
                                                   tr.model.state_dict().values()))
    # a mesh_shape without a launcher trains unsharded, as in the JAX package
    assert VAETrainer(_models()[1], mesh_shape={"data": 2}).mesh is None


def test_clis_and_reconstruction_match_jax(data, tmp_path):
    """The training CLI takes the JAX CLI's flags plus --device and writes
    its files; the reconstruction writer (and its CLI, from best.npz)
    writes features within 1e-5 of the JAX writer's for the same weights,
    which the port's MultimodalDataset reads back exactly."""
    src, csv_path = data
    root = tmp_path / "data"
    shutil.copytree(src, root)
    jroot = tmp_path / "jdata"
    shutil.copytree(src, jroot)
    assert {a.dest for a in cli_train.build_parser()._actions} == \
        {a.dest for a in jcli_train.build_parser()._actions} | {"device"}
    flags = ["--csv_path", str(root / "dataset.csv"), "--data_root_dir", str(root),
             "--input_dim", str(D), "--hidden_dims", *map(str, HIDDEN), "--latent_dim", str(LATENT),
             "--epochs", "2", "--batch_size", "64", "--lr", "1e-4"]
    out = cli_train.main(flags + ["--checkpoint_dir", str(tmp_path / "port"), "--device", "cpu"])
    jcli_train.main(flags + ["--checkpoint_dir", str(tmp_path / "jax")])
    assert len(out["history"]["val_loss"]) == 2
    assert sorted(p.name for p in (tmp_path / "port").iterdir()) == \
        sorted(p.name for p in (tmp_path / "jax").iterdir())

    done = cli_generate.main(["--csv_path", str(root / "dataset.csv"), "--data_root_dir", str(root),
                              "--checkpoint", str(tmp_path / "port" / "best.npz"),
                              "--input_dim", str(D), "--hidden_dims", *map(str, HIDDEN),
                              "--latent_dim", str(LATENT), "--device", "cpu"])
    assert len(done) == 4

    jm, pm = _models(seed=4)
    done = generate_reconstructed_wsi(pm, root / "dataset.csv", root, batch_size=50)
    assert done == jax_generate(jm, jroot / "dataset.csv", jroot, batch_size=32)
    ds = MultimodalDataset(root / "dataset.csv", root, ["wsi=reconstructed_features"])
    with open(root / "dataset.csv", newline="") as f:
        rows = list(csv.DictReader(f))
    for row in rows:
        got = read_channel(root / row["h5_file_path"], "wsi=reconstructed_features")
        want = read_channel(jroot / row["h5_file_path"], "wsi=reconstructed_features")
        np.testing.assert_allclose(got, want, **TOL)
        np.testing.assert_array_equal(ds.get_case(row["case_id"])[0]["wsi=reconstructed_features"], got)
    feats = read_channel(root / rows[0]["h5_file_path"], "wsi=features")
    np.testing.assert_array_equal(
        read_channel(root / rows[0]["h5_file_path"], "wsi=reconstructed_features"),
        pm.reconstruct(torch.as_tensor(feats)).detach().numpy())
    assert json.loads((tmp_path / "port" / "best_history.json").read_text()).keys() == \
        json.loads((tmp_path / "jax" / "best_history.json").read_text()).keys()

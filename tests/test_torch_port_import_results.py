"""Reference-checkpoint import in the port (``utils/torch_import``,
``cli/import_torch_results``) against the JAX package's on the CPU.

The reference checkpoints are the port models' own ``state_dict``s (the
port's parameters carry the reference names), saved by ``torch.save`` in
the three forms the reference trainers write: a raw ``state_dict``, one
wrapped in ``model_state_dict``, and one whose keys torch.compile prefixed
with ``_orig_mod.``.  Both packages import the same files; the port's
imported parameters are held to the JAX model's through
``survival_params_from_jax`` (exactly: a copy), the unused keys must be the
same lists, and ``predict`` over the two converted dirs agrees within 1e-5.
"""

import csv
import json

import numpy as np
import pytest
import torch
from flax import nnx

from multimodal_fusion_tpu import config as jconfig
from multimodal_fusion_tpu.cli.import_torch_results import import_results_dir as jax_import_results_dir
from multimodal_fusion_tpu.io.fixtures import make_synthetic_dataset
from multimodal_fusion_tpu.models.factory import ModelFactory as JaxFactory
from multimodal_fusion_tpu.models.vae import VAE as JaxVAE
from multimodal_fusion_tpu.utils import torch_import as jax_import
from multimodal_fusion_tpu.utils.predict import predict as jax_predict
from multimodal_fusion_tpu_torch import config as tconfig
from multimodal_fusion_tpu_torch.cli import import_torch_results as cli_import
from multimodal_fusion_tpu_torch.models.alignment import MultiModalAlignmentModel
from multimodal_fusion_tpu_torch.models.factory import ModelFactory
from multimodal_fusion_tpu_torch.models.jax_params import survival_params_from_jax, vae_params_from_jax
from multimodal_fusion_tpu_torch.models.vae import VAE
from multimodal_fusion_tpu_torch.train.checkpoint import load_model
from multimodal_fusion_tpu_torch.utils import torch_import
from multimodal_fusion_tpu_torch.utils.predict import predict

D_IN = 16
BAGS = ["wsi=features", "tma=cd3=features", "tma=cd8=features"]
TABULAR = ["clinical=val", "clinical=mask"]
HG = ["hypergraph=wsi_super_features", "hypergraph=tma_features"]
FORMS = ("plain", "wrapped", "prefixed")


def _config(model_type, **extra):
    chans = (HG if model_type == "cust_omics" else BAGS) + TABULAR
    kw = dict(model_type=model_type, n_classes=2, input_dim=D_IN, model_size="8*4", dropout=0.25,
              output_dim=8, inst_number=8, base_weight=0.7, subtyping=True,
              channels_used_in_model=chans, channel_input_dims={"clinical=val": D_IN})
    return jconfig.ModelConfig(**{**kw, **extra})


def _port(mc, seed=0):
    return ModelFactory.create_model(tconfig.ModelConfig.from_dict(mc.to_dict()), seed=seed,
                                     device="cpu")


def _reference_form(sd, form):
    """A state dict as a reference trainer saves it."""
    sd = {k: v.clone() for k, v in sd.items()}
    if form == "wrapped":
        return {"model_state_dict": sd}
    if form == "prefixed":
        return {"model_state_dict": {f"_orig_mod.{k}": v for k, v in sd.items()}}
    return sd


def _save(path, sd, form):
    torch.save(_reference_form(sd, form), path)
    return path


@pytest.mark.parametrize("form", FORMS)
def test_load_torch_state_dict_matches_jax(tmp_path, form):
    sd = _port(_config("svd_gate_random_clam")).state_dict()
    path = _save(tmp_path / "ckpt.pt", sd, form)
    got, want = torch_import.load_torch_state_dict(path), jax_import.load_torch_state_dict(path)
    assert list(got) == list(want) == list(sd)
    for k in sd:
        np.testing.assert_array_equal(got[k], want[k])
        np.testing.assert_array_equal(got[k], sd[k].numpy())


ZOO = [k for k in ModelFactory.available_models() if k != "mfmf"]


@pytest.mark.parametrize("key", ZOO)
def test_survival_import_matches_jax(tmp_path, key):
    """Every family the JAX importer maps: the same keys used, the same
    parameters left at their initial values, the same unused keys."""
    mc = _config(key)
    src = _port(mc, seed=0).state_dict()
    path = _save(tmp_path / "s_0_checkpoint.pt", src, FORMS[len(key) % 3])
    model = _port(mc, seed=1)
    jmodel = JaxFactory.create_model(mc, seed=1)
    left = torch_import.import_survival_checkpoint(model, path)
    assert left == jax_import.import_survival_checkpoint(jmodel, path)
    skip = torch_import._survival_skip(model)
    imported = [k for k in src if not k.startswith(skip)]
    assert sorted(set(src) - set(imported)) == left  # every key not imported is reported
    back = survival_params_from_jax(nnx.to_pure_dict(nnx.state(jmodel, nnx.Param)))
    got = model.state_dict()
    for name in imported:
        assert torch.equal(got[name], src[name]), name
        assert torch.equal(back[name], src[name]), name


def test_sequential_entries_pair_positionally(tmp_path):
    """A reference whose Sequentials place activations and dropout
    elsewhere (other indices, the same Linear order) imports on both
    sides; a Sequential with another count of Linears raises KeyError."""
    mc = _config("svd_gate_random_clam", enable_svd=True, enable_dynamic_gate=True)
    src = _port(mc).state_dict()
    renumber = {".0.": ".0.", ".3.": ".2.", ".6.": ".4."}  # no dropout entries

    def shifted(k):
        for prefix in ("TCPClassifier.", "Classifier."):
            if k.startswith(prefix):
                head, idx, leaf = k.rsplit(".", 2)
                return f"{head}{renumber.get(f'.{idx}.', f'.{idx}.')}{leaf}"
        return k

    sd = {shifted(k): v for k, v in src.items()}
    assert sd.keys() != src.keys()
    model, jmodel = _port(mc, seed=1), JaxFactory.create_model(mc, seed=1)
    assert torch_import.import_survival_checkpoint(model, sd) == []
    assert jax_import.import_survival_checkpoint(jmodel, sd) == []
    back = survival_params_from_jax(nnx.to_pure_dict(nnx.state(jmodel, nnx.Param)))
    for name, t in model.state_dict().items():
        assert torch.equal(t, src[name]) and torch.equal(back[name], src[name]), name
    tcp = next(k for k in sd if k.startswith("TCPClassifier.") and k.endswith(".2.weight"))
    short = {k: v for k, v in sd.items() if k != tcp and k != tcp.replace("weight", "bias")}
    for side, target in (("port", _port(mc)), ("jax", JaxFactory.create_model(mc, seed=1))):
        importer = torch_import if side == "port" else jax_import
        with pytest.raises(KeyError, match="Linear entries"):
            importer.import_survival_checkpoint(target, short)


def test_wrong_architecture_raises_on_both_sides(tmp_path):
    mil = _config("mil", channels_used_in_model=["wsi=features"])
    path = _save(tmp_path / "mil.pt", _port(mil).state_dict(), "plain")
    clam = _config("clam", channels_used_in_model=["wsi=features"])
    with pytest.raises(KeyError):
        torch_import.import_survival_checkpoint(_port(clam), path)
    with pytest.raises(KeyError):
        jax_import.import_survival_checkpoint(JaxFactory.create_model(clam, seed=0), path)
    mfmf = _port(_config("mfmf", channels_used_in_model=["wsi=features", "wsi=reconstructed_features"]
                         + BAGS[1:] + TABULAR))
    with pytest.raises(NotImplementedError):  # the port's MFMF is no family the importer maps
        torch_import.import_survival_checkpoint(mfmf, path)


def test_vae_import_matches_jax(tmp_path):
    src = VAE(input_dim=D_IN, encoder_hidden=[12, 10], decoder_hidden=[10, 12], latent_dim=6,
              generator=torch.Generator().manual_seed(0)).state_dict()
    path = _save(tmp_path / "vae.pt", {**src, "extra.step": torch.tensor(3.0)}, "prefixed")
    model = VAE(input_dim=D_IN, encoder_hidden=[12, 10], decoder_hidden=[10, 12], latent_dim=6,
                generator=torch.Generator().manual_seed(1))
    jmodel = JaxVAE(input_dim=D_IN, encoder_hidden=[12, 10], decoder_hidden=[10, 12], latent_dim=6,
                    rngs=nnx.Rngs(1))
    left = torch_import.import_vae_checkpoint(model, path)
    assert left == jax_import.import_vae_checkpoint(jmodel, path) == ["extra.step"]
    back = vae_params_from_jax(nnx.to_pure_dict(nnx.state(jmodel, nnx.Param)))
    for name, t in model.state_dict().items():
        assert torch.equal(t, src[name]) and torch.equal(back[name], src[name]), name


def _write_csv(path, rows):
    with open(path, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=list(rows[0]))
        w.writeheader()
        w.writerows(rows)


@pytest.fixture(scope="module")
def reference_dir(tmp_path_factory):
    """(data root, CSV, a reference results dir): the JAX package's config,
    three fold checkpoints of the flagship, one in each reference form, a
    persisted split and a reference alignment model named by the config."""
    root = tmp_path_factory.mktemp("import")
    csv_path = make_synthetic_dataset(root, n_patients=8, seed=6, min_wsi_patches=4,
                                      max_wsi_patches=30, feature_dim=D_IN, markers=("cd3", "cd8"))
    src = root / "reference"
    src.mkdir()
    chans = BAGS + TABULAR
    mc = _config("svd_gate_random_clam", channels_used_in_model=chans)
    ec = jconfig.ExperimentConfig(exp_name="ref", seed=3, k_folds=3, batch_size=4,
                                  target_channels=chans)
    align = MultiModalAlignmentModel(["cd3", "cd8"], feature_dim=D_IN, num_layers=2,
                                     generator=torch.Generator().manual_seed(4))
    torch.save({"model_state_dict": align.state_dict()}, src / "align.pt")
    ec.alignment_model_path = "align.pt"  # relative: resolved next to the results dir
    jconfig.Configs(experiment_config=ec, model_config=mc).save(src / "configs_ref.json")
    for fold, form in enumerate(FORMS):
        _save(src / f"s_{fold}_checkpoint.pt", _port(mc, seed=10 + fold).state_dict(), form)
    _write_csv(src / "splits_0.csv", [{"train": "case_0", "val": "case_1", "test": "case_2"}])
    return root, csv_path, src, align


def test_import_results_dir_matches_jax(reference_dir, tmp_path, capsys):
    root, csv_path, src, align = reference_dir
    got = cli_import.import_results_dir(src, tmp_path / "port", device="cpu")
    want = jax_import_results_dir(src, tmp_path / "jax")
    assert got["folds"] == want["folds"] == [0, 1, 2]
    assert got["unmapped_keys"] == want["unmapped_keys"] == {}
    assert sorted(p.name for p in (tmp_path / "port").iterdir()) == sorted(
        p.name for p in (tmp_path / "jax").iterdir())
    assert (tmp_path / "port" / "splits_0.csv").read_text() == (src / "splits_0.csv").read_text()
    # the converted alignment model: the config points at it, and it holds
    # the reference's weights
    cfg = json.loads((tmp_path / "port" / "configs_ref.json").read_text())
    assert cfg["experiment_config"]["alignment_model_path"] == got["alignment_model"]
    conv = MultiModalAlignmentModel(["cd3", "cd8"], feature_dim=D_IN, num_layers=2,
                                    generator=torch.Generator().manual_seed(0))
    load_model(got["alignment_model"], conv)
    for name, t in align.state_dict().items():
        assert torch.equal(conv.state_dict()[name], t), name
    # predict over the two converted dirs (both align cd3/cd8 at load time:
    # the config names no aligned channels, so the features pass as read)
    for d in ("port", "jax"):
        raw = json.loads((tmp_path / d / "configs_ref.json").read_text())
        raw["experiment_config"]["alignment_model_path"] = None
        (tmp_path / d / "configs_ref.json").write_text(json.dumps(raw))
    p = predict(tmp_path / "port", csv_path, root, output_path=tmp_path / "pp", device="cpu")
    j = jax_predict(tmp_path / "jax", csv_path, root, output_path=tmp_path / "jp")
    assert p["folds"] == j["folds"] == [0, 1, 2] and p["n_cases_scored"] == j["n_cases_scored"] == 8
    for g, w in zip(p["cases"], j["cases"]):
        assert g["case_id"] == w["case_id"] and int(g["prediction"]) == int(w["prediction"])
        for col in ("risk", "prob_0", "prob_1", "fold_0_prob_1", "fold_1_prob_1", "fold_2_prob_1"):
            np.testing.assert_allclose(float(g[col]), float(w[col]), rtol=0, atol=1e-5, err_msg=col)
    # the CLI, with a missing alignment model: the same warning as the JAX CLI
    raw = json.loads((src / "configs_ref.json").read_text())
    raw["experiment_config"]["alignment_model_path"] = "absent.pt"
    missing = tmp_path / "missing_src"
    missing.mkdir()
    (missing / "configs_ref.json").write_text(json.dumps(raw))
    (missing / "s_0_checkpoint.pt").write_bytes((src / "s_0_checkpoint.pt").read_bytes())
    capsys.readouterr()
    assert cli_import.script_main(["--src_dir", str(missing), "--out_dir", str(tmp_path / "cli"),
                                   "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "WARNING: alignment_model_path 'absent.pt' not found" in out
    assert json.loads(out.strip().splitlines()[-1])["folds"] == [0]
    with pytest.raises(FileNotFoundError):
        cli_import.import_results_dir(tmp_path / "jax", tmp_path / "none", device="cpu")

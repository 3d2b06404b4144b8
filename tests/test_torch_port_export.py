"""``torch.export`` serving artifacts in the port (``utils/export``,
``cli/export_model``) against the JAX package's StableHLO artifacts on the
CPU.

A tiny flagship results dir is trained by the JAX package's
``main_survival`` and carried into a port results dir
(``survival_params_from_jax``); the detach variant and MFMF are seeded
JAX models carried the same way.  Both packages export the same fold for
the CPU, and both artifacts score a batch of 3, which neither exported
(the port exports at an example batch of 2, JAX at a symbolic one):
probabilities and risk within 1e-5.  The alignment and VAE artifacts are
held the same way (``alignment_params_from_jax``, ``vae_params_from_jax``).
"""

import json
import shutil

import numpy as np
import pytest
import torch
from flax import nnx

from multimodal_fusion_tpu import config as jconfig
from multimodal_fusion_tpu.cli.main_survival import main as jax_main_survival
from multimodal_fusion_tpu.io.fixtures import make_synthetic_dataset
from multimodal_fusion_tpu.models.alignment import MultiModalAlignmentModel as JaxAlign
from multimodal_fusion_tpu.models.factory import ModelFactory as JaxFactory
from multimodal_fusion_tpu.models.vae import VAE as JaxVAE
from multimodal_fusion_tpu.train.checkpoint import load_state as jax_load_state
from multimodal_fusion_tpu.train.checkpoint import save_model as jax_save_model
from multimodal_fusion_tpu.train.checkpoint import save_state as jax_save_state
from multimodal_fusion_tpu.utils import export as jexport
from multimodal_fusion_tpu_torch.cli import export_model as cli_export
from multimodal_fusion_tpu_torch.config import Configs
from multimodal_fusion_tpu_torch.models.alignment import MultiModalAlignmentModel
from multimodal_fusion_tpu_torch.models.factory import ModelFactory
from multimodal_fusion_tpu_torch.models.jax_params import (
    alignment_params_from_jax,
    survival_params_from_jax,
    vae_params_from_jax,
)
from multimodal_fusion_tpu_torch.models.mfmf import mfmf_params_from_jax
from multimodal_fusion_tpu_torch.models.vae import VAE
from multimodal_fusion_tpu_torch.train.checkpoint import load_model, save_model, save_state
from multimodal_fusion_tpu_torch.utils import export

D = 32
WSI, TMA = 24, 4
TOL = dict(rtol=1e-5, atol=1e-5)
FLAG_CHANNELS = ["wsi=features", "tma=cd3=features"]
MFMF_CHANNELS = ["wsi=features", "wsi=reconstructed_features", "tma=cd3=features",
                 "clinical=val", "clinical=mask"]


def _port_model(results_dir, fold=0):
    configs = Configs.load(next(results_dir.glob("configs_*.json")))
    model = ModelFactory.create_model(configs.model_config, device="cpu")
    load_model(results_dir / f"s_{fold}_checkpoint.npz", model)
    return model.eval()


def _carry(jres, pres, folds, to_port=survival_params_from_jax):
    """The JAX dir's configs and fold checkpoints as a port results dir."""
    pres.mkdir()
    cfg = next(jres.glob("configs_*.json"))
    shutil.copy(cfg, pres / cfg.name)
    configs = jconfig.Configs.load(cfg)
    for fold in folds:
        jm = JaxFactory.create_model(configs.model_config, seed=configs.experiment_config.seed)
        _, params, rest = nnx.split(jm, nnx.Param, ...)
        restored, _ = jax_load_state(jres / f"s_{fold}_checkpoint.npz",
                                     {"params": params, "rest": rest})
        model = ModelFactory.create_model(Configs.load(pres / cfg.name).model_config, device="cpu")
        model.load_state_dict(to_port(nnx.to_pure_dict(restored["params"])))
        save_model(pres / f"s_{fold}_checkpoint.npz", model)
    return pres


def _seeded_jax_dir(root, name, mc):
    jres = root / f"jax_{name}"
    jres.mkdir()
    ec = jconfig.ExperimentConfig(exp_name=name, seed=2, k_folds=2, batch_size=4,
                                  target_channels=list(mc.channels_used_in_model))
    jconfig.Configs(experiment_config=ec, model_config=mc).save(jres / f"configs_{name}.json")
    jm = JaxFactory.create_model(mc, seed=7)
    _, params, rest = nnx.split(jm, nnx.Param, ...)
    jax_save_state(jres / "s_0_checkpoint.npz", {"params": params, "rest": rest})
    return jres


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    """{name: (JAX results dir, port results dir)} and the data root."""
    root = tmp_path_factory.mktemp("export")
    csv_path = make_synthetic_dataset(root, n_patients=10, seed=5, min_wsi_patches=16,
                                      max_wsi_patches=WSI, feature_dim=D, n_tma_patches=3)
    log_dir = jax_main_survival([
        "--csv_path", str(csv_path), "--data_root_dir", str(root),
        "--results_dir", str(root / "results"), "--exp_code", "exp0",
        "--model_type", "svd_gate_random_clam",
        "--target_channels", *FLAG_CHANNELS, "--channels_used_in_model", *FLAG_CHANNELS,
        "--input_dim", str(D), "--model_size", "32*16", "--output_dim", "32",
        "--k", "2", "--max_epochs", "1", "--batch_size", "4",
        "--enable_svd", "--enable_dynamic_gate", "--seed", "0",
    ])
    out = {"svd_gate_random_clam": (log_dir, _carry(log_dir, root / "port_flag", (0, 1)))}
    detach = jconfig.ModelConfig(model_type="svd_gate_random_clam_detach", n_classes=2, input_dim=D,
                                 model_size="16*8", dropout=0.25, output_dim=16,
                                 channels_used_in_model=FLAG_CHANNELS + ["clinical=val"],
                                 channel_input_dims={"clinical=val": 16}, enable_svd=True,
                                 enable_dynamic_gate=True)
    jres = _seeded_jax_dir(root, "detach", detach)
    out["svd_gate_random_clam_detach"] = (jres, _carry(jres, root / "port_detach", (0,)))
    mfmf = jconfig.ModelConfig(model_type="mfmf", n_classes=2, input_dim=D, model_size="16*8",
                               dropout=0.0, output_dim=32, channels_used_in_model=MFMF_CHANNELS,
                               channel_input_dims={"clinical=val": D})
    mfmf.extra.update(attention_num_heads=4)
    jres = _seeded_jax_dir(root, "mfmf", mfmf)
    out["mfmf"] = (jres, _carry(jres, root / "port_mfmf", (0,), mfmf_params_from_jax))
    return out


def _inputs(channels, batch, seed=3, dims=None):
    """A padded window in the exported layout: bags of WSI / TMA patches
    with some padding masked off, tabular groups [B, 1, dim]."""
    rng = np.random.default_rng(seed)
    chans, masks = {}, {}
    for ch in channels:
        if ch.startswith(("wsi=", "tma=")):
            n = WSI if ch.startswith("wsi") else TMA
            chans[ch] = rng.standard_normal((batch, n, D)).astype(np.float32)
            masks[ch] = np.arange(n)[None] < rng.integers(1, n + 1, (batch, 1))
        elif ch.endswith("=mask"):
            chans[ch] = (rng.random((batch, 1, (dims or {}).get(ch, D))) > 0.3).astype(np.float32)
        else:
            chans[ch] = rng.standard_normal((batch, 1, (dims or {}).get(ch, D))).astype(np.float32)
    return chans, masks


def _live(model, chans, masks):
    with torch.no_grad():
        res = model({"channels": {k: torch.as_tensor(v) for k, v in chans.items()},
                     "masks": {k: torch.as_tensor(v) for k, v in masks.items()}},
                    torch.zeros(len(next(iter(chans.values()))), dtype=torch.int64), train=False)
    risk = res["risk"] if "risk" in res else res["logits"][:, 1]
    return res["probabilities"].numpy(), risk.numpy()


@pytest.mark.parametrize("name", ["svd_gate_random_clam", "svd_gate_random_clam_detach", "mfmf"])
def test_survival_artifact_matches_jax(dirs, tmp_path, name):
    jres, pres = dirs[name]
    programs, meta = export.export_serving_fn(pres, wsi_patches=WSI, tma_patches=TMA,
                                              platforms=["cpu"])
    blob, jmeta = jexport.export_serving_fn(jres, wsi_patches=WSI, tma_patches=TMA,
                                            platforms=["cpu"])
    assert meta == jmeta and meta["batch"] == "symbolic"
    art = export.load_serving_artifact(export.write_serving_artifact(tmp_path / "port", programs, meta),
                                       device="cpu")
    jart = jexport.load_serving_artifact(jexport.write_serving_artifact(tmp_path / "jax", blob, jmeta))
    chans, masks = _inputs(meta["channels"], 3, dims=meta["channel_input_dims"])
    probs, risk = art.call(chans, masks)
    want_probs, want_risk = jart.call(chans, masks)
    assert probs.shape == (3, 2) and risk.shape == (3,)
    np.testing.assert_allclose(probs, want_probs, **TOL)
    np.testing.assert_allclose(risk, want_risk, **TOL)
    live_probs, live_risk = _live(_port_model(pres), chans, masks)
    np.testing.assert_allclose(probs, live_probs, **TOL)
    np.testing.assert_allclose(risk, live_risk, **TOL)


def test_export_takes_the_plain_formulations(dirs, monkeypatch):
    """The exporter traces MFMF with attention's einsum form and the
    LayerNorms' composite ops: the kernels' ctypes launches cannot enter
    a traced graph, and on the card a traced K5 raises."""
    from multimodal_fusion_tpu_torch.models.common import LayerNorm

    traced = []
    plain_export = torch.export.export

    def spy(module, *args, **kwargs):
        traced.append(module.model)
        return plain_export(module, *args, **kwargs)

    monkeypatch.setattr(torch.export, "export", spy)
    export.export_serving_fn(dirs["mfmf"][1], wsi_patches=WSI, tma_patches=TMA, platforms=["cpu"])
    norms = [m.impl for m in traced[0].modules() if isinstance(m, LayerNorm)]
    assert len(norms) == 9 and set(norms) == {"plain"}
    assert {blk.attn_impl for blk in traced[0].attention_blocks.values()} == {"xla"}


def test_fixed_batch_and_refusals(dirs, tmp_path, monkeypatch):
    """--fixed_batch exports batch 1 on both sides; a hypergraph channel is
    refused with the JAX package's message; a load for a platform the
    artifact lacks raises, and so does a load for the card without one."""
    jres, pres = dirs["svd_gate_random_clam"]
    programs, meta = export.export_serving_fn(pres, wsi_patches=WSI, tma_patches=TMA,
                                              platforms=["cpu"], symbolic_batch=False)
    assert meta["batch"] == 1
    assert jexport.export_serving_fn(jres, wsi_patches=WSI, tma_patches=TMA, platforms=["cpu"],
                                     symbolic_batch=False)[1]["batch"] == 1
    path = export.write_serving_artifact(tmp_path / "fixed", programs, meta)
    art = export.load_serving_artifact(path, device="cpu")
    chans, masks = _inputs(FLAG_CHANNELS, 1)
    np.testing.assert_allclose(art.call(chans, masks)[0], _live(_port_model(pres), chans, masks)[0],
                               **TOL)
    with pytest.raises(Exception):  # the program is fixed at one case
        art.call(*_inputs(FLAG_CHANNELS, 3))

    for side in (export, jexport):
        cfg = jconfig.ModelConfig(model_type="cust_omics", input_dim=D,
                                  channels_used_in_model=["hypergraph=wsi_super_features"])
        with pytest.raises(NotImplementedError, match="serve cust_omics/hypergraph models through "
                                                      "cli.predict"):
            side._channel_specs(cfg, WSI, TMA, 1, "cpu") if side is export else \
                side._channel_specs(cfg, WSI, TMA, 1)

    meta_path = path.with_suffix(".json")
    meta_path.write_text(json.dumps({**meta, "platforms": ["cuda"]}))
    with pytest.raises(ValueError, match="no program for platform 'cpu'"):
        export.load_serving_artifact(path, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA device requested"):
        export.load_serving_artifact(path)
    with pytest.raises(RuntimeError, match="CUDA device requested"):
        export.export_serving_fn(pres, wsi_patches=WSI, tma_patches=TMA)  # default: cpu and cuda


def test_tabular_mask_takes_its_values_width(dirs, tmp_path):
    """A tabular mask is exported at its group's values' width (16 here,
    against an input width of 32), where the JAX exporter's spec takes the
    input width and the export fails."""
    jres, pres = dirs["svd_gate_random_clam"]
    cfg = json.loads(next(pres.glob("configs_*.json")).read_text())
    chans = FLAG_CHANNELS + ["clinical=val", "clinical=mask"]
    cfg["model_config"].update(channels_used_in_model=chans, channel_input_dims={"clinical=val": 16})
    for d in ("port", "jax"):
        (tmp_path / d).mkdir()
        (tmp_path / d / "configs_m.json").write_text(json.dumps(cfg))
    model = ModelFactory.create_model(Configs.load(tmp_path / "port" / "configs_m.json").model_config,
                                      seed=4, device="cpu")
    save_model(tmp_path / "port" / "s_0_checkpoint.npz", model)
    programs, meta = export.export_serving_fn(tmp_path / "port", wsi_patches=WSI, tma_patches=TMA,
                                              platforms=["cpu"])
    art = export.load_serving_artifact(export.write_serving_artifact(tmp_path / "a", programs, meta),
                                       device="cpu")
    dims = {"clinical=val": 16, "clinical=mask": 16}
    x, m = _inputs(chans, 3, dims=dims)
    for got, want in zip(art.call(x, m), _live(model.eval(), x, m)):
        np.testing.assert_allclose(got, want, **TOL)
    jm = JaxFactory.create_model(jconfig.Configs.load(tmp_path / "jax" / "configs_m.json").model_config,
                                 seed=0)
    _, params, rest = nnx.split(jm, nnx.Param, ...)
    jax_save_state(tmp_path / "jax" / "s_0_checkpoint.npz", {"params": params, "rest": rest})
    with pytest.raises(Exception):
        jexport.export_serving_fn(tmp_path / "jax", wsi_patches=WSI, tma_patches=TMA,
                                  platforms=["cpu"])


def _alignment_pair(tmp_path):
    jm = JaxAlign(["cd3", "cd8"], feature_dim=D, num_layers=2, rngs=nnx.Rngs(3))
    jpath = jax_save_model(tmp_path / "jax_align.npz", jm)
    model = MultiModalAlignmentModel(["cd3", "cd8"], feature_dim=D, num_layers=2,
                                     generator=torch.Generator().manual_seed(0))
    model.load_state_dict(alignment_params_from_jax(nnx.to_pure_dict(nnx.state(jm, nnx.Param))),
                          strict=False)
    return jpath, save_model(tmp_path / "port_align.npz", model)


def _vae_pair(tmp_path):
    jm = JaxVAE(input_dim=D, encoder_hidden=[24, 16], decoder_hidden=[16, 24], latent_dim=8,
                rngs=nnx.Rngs(3))
    jpath = jax_save_model(tmp_path / "jax_vae.npz", jm)
    model = VAE(input_dim=D, encoder_hidden=[24, 16], decoder_hidden=[16, 24], latent_dim=8,
                generator=torch.Generator().manual_seed(0))
    model.load_state_dict(vae_params_from_jax(nnx.to_pure_dict(nnx.state(jm, nnx.Param))))
    # the VAE trainer's checkpoint layout ({"model": ..., "opt": ...})
    return jpath, save_state(tmp_path / "port_vae.npz", {"model": model.state_dict(),
                                                         "opt": {"step": np.zeros(1)}})


@pytest.mark.parametrize("kind", ["alignment", "vae"])
def test_alignment_and_vae_artifacts_match_jax(tmp_path, kind):
    jpath, ppath = (_alignment_pair if kind == "alignment" else _vae_pair)(tmp_path)
    fn, jfn = ((export.export_alignment_fn, jexport.export_alignment_fn) if kind == "alignment"
               else (export.export_vae_fn, jexport.export_vae_fn))
    programs, meta = fn(ppath, platforms=["cpu"])
    blob, jmeta = jfn(jpath, platforms=["cpu"])
    assert meta == jmeta and meta["batch"] == "symbolic"
    art = export.load_serving_artifact(export.write_serving_artifact(tmp_path / "port", programs, meta),
                                       device="cpu")
    jart = jexport.load_serving_artifact(jexport.write_serving_artifact(tmp_path / "jax", blob, jmeta))
    x = np.random.default_rng(1).standard_normal((5, D)).astype(np.float32)
    if kind == "alignment":
        feats = {"cd3": x, "cd8": x[::-1].copy()}
        got, want = art(feats), jart(feats)
        assert set(got) == set(want) == {"cd3", "cd8"}
        for m in got:
            np.testing.assert_allclose(got[m], want[m], **TOL)
    else:
        got, want = art(x), jart(x)
        assert [g.shape for g in got] == [(5, D), (5, 8)]
        for g, w in zip(got, want):
            np.testing.assert_allclose(g, np.asarray(w), **TOL)


def test_cli_exports_every_kind(dirs, tmp_path, capsys):
    jres, pres = dirs["svd_gate_random_clam"]
    _, apath = _alignment_pair(tmp_path)
    _, vpath = _vae_pair(tmp_path)
    # alignment resolves from a results dir whose config names the model
    adir = tmp_path / "aligned"
    shutil.copytree(pres, adir)
    cfg_path = next(adir.glob("configs_*.json"))
    cfg = json.loads(cfg_path.read_text())
    cfg["experiment_config"]["alignment_model_path"] = str(apath)
    cfg_path.write_text(json.dumps(cfg))
    runs = {
        "survival": ["--results_dir", str(pres), "--fold", "1", "--wsi_patches", str(WSI),
                     "--tma_patches", str(TMA)],
        "alignment": ["--results_dir", str(adir)],
        "vae": ["--checkpoint_path", str(vpath), "--fixed_batch"],
    }
    for kind, flags in runs.items():
        capsys.readouterr()
        out = tmp_path / f"{kind}_art"
        assert cli_export.script_main(["--kind", kind, *flags, "--platforms", "cpu",
                                       "--output_path", str(out)]) == 0
        line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        program = export.program_path(out, "cpu")
        assert line == {"artifact": str(out.with_suffix(".json")), "bytes": program.stat().st_size,
                        "batch": 1 if kind == "vae" else "symbolic", "platforms": ["cpu"]}
        art = export.load_serving_artifact(out, device="cpu")
        assert art.meta.get("kind", "survival") == kind
    with pytest.raises(SystemExit):
        cli_export.main(["--kind", "vae", "--output_path", str(tmp_path / "x"), "--platforms", "cpu"])
    with pytest.raises(SystemExit):
        cli_export.main(["--kind", "alignment", "--results_dir", str(pres),
                         "--output_path", str(tmp_path / "x"), "--platforms", "cpu"])

"""The port's parallel layer (``multimodal_fusion_tpu_torch.parallel``) on
the CPU: the mesh helpers, and gangs of 2 and 4 ranks over gloo that build,
extract and train sharded, held against the port's unsharded paths and the
JAX package's mesh paths on the conftest's 8-device CPU mesh.

Each gang runs in subprocesses (``multihost.run_gang``: a file rendezvous
under ``tmp_path``, one thread a rank) with its own timeout, so a hung rank
fails its test and leaves no sibling running.  Most gangs run a list of
calls (``dryrun.run_calls``), each on the mesh of its shape; a call that
raised comes back as {"raised": ..., "message": ...}."""

import csv
import json

import h5py
import jax
import numpy as np
import pytest
import torch

from multimodal_fusion_tpu.config import Configs as JaxConfigs, ExperimentConfig as JaxExperiment
from multimodal_fusion_tpu.config import ModelConfig as JaxModelConfig
from multimodal_fusion_tpu.hypergraph import build as jbuild
from multimodal_fusion_tpu.io.h5io import read_hypergraph_group as jread_group
from multimodal_fusion_tpu.parallel.mesh import make_mesh as jmake_mesh
from multimodal_fusion_tpu_torch.hypergraph import build as tbuild
from multimodal_fusion_tpu_torch.io.fixtures import make_synthetic_dataset
from multimodal_fusion_tpu_torch.io.h5io import read_hypergraph_group
from multimodal_fusion_tpu_torch.parallel import dryrun, multihost
from multimodal_fusion_tpu_torch.parallel import mesh as tmesh

GANG_TIMEOUT = 300
BUILD = dict(num_wsi_super_patches=6, num_groups=2, hypergraph_k=2, num_hyperedges=3)
DRY = "multimodal_fusion_tpu_torch.parallel.dryrun"
# JAX test_parallel.py's odd slide has 300 patches, indivisible by its 8
# devices; 301 is indivisible by the gangs' 2 and 4 ranks (padded)
ODD = 301
TINY_VIT = dict(img_size=32, patch_size=16, embed_dim=64, depth=2, num_heads=4)


def _gang(world, calls, tmp_path, timeout=GANG_TIMEOUT):
    """Each rank's list of call results."""
    results, _ = multihost.run_gang(f"{DRY}:run_calls", world, {"calls": calls, "device": "cpu"},
                                    timeout=timeout, device="cpu", workdir=tmp_path)
    return results


def _ok(result):
    assert not (isinstance(result, dict) and "raised" in result), result
    return result


# ---------------------------------------------------------------------------
# the helpers, in one process (no process group)
# ---------------------------------------------------------------------------

def test_mesh_from_shape_follows_the_jax_rule(capsys):
    """No shape gives None; a world smaller than the shape prints the JAX
    message and runs unsharded; make_mesh refuses as JAX's does."""
    assert tmesh.mesh_from_shape(None) is None and tmesh.mesh_from_shape({}) is None
    assert tmesh.mesh_from_shape({"data": 1}, "cpu") is None
    assert tmesh.mesh_from_shape({"data": 2}, "cpu") is None
    assert tmesh.mesh_from_shape({"replica": 2, "data": 4}, "cpu") is None
    out = capsys.readouterr().out
    assert "mesh_shape {'data': 2} needs 2 devices, have 1; running unsharded" in out
    assert "needs 8 devices, have 1; running unsharded" in out
    with pytest.raises(ValueError, match="requested 2 devices, have 1"):
        tmesh.make_mesh(2, device="cpu")
    with pytest.raises(ValueError, match="requested 4 devices, have 1"):
        tmesh.make_mesh_2d(2, 2, device="cpu")
    assert not torch.distributed.is_initialized()


def test_place_batch_unit():
    """The one placement rule: this rank's rows of axis 0 (axis 1 of a scan
    group), per-leaf fallback where a dim does not divide, whole-tree
    fallback through batch_size, mesh=None a no-op; rank order is
    replica-major on a 2-D mesh."""
    mesh = tmesh.Mesh((4,), ("data",), rank=1, device=torch.device("cpu"))
    x = torch.arange(48.0).view(8, 6)
    y = torch.zeros(5, 6)  # 5 % 4 != 0: stays whole
    out = tmesh.place_batch(mesh, {"x": x, "y": y, "n": np.arange(8), "s": 3})
    assert torch.equal(out["x"], x[2:4]) and out["y"] is y and out["s"] == 3
    np.testing.assert_array_equal(out["n"], [2, 3])
    xs = torch.arange(48.0).view(3, 8, 2)
    assert torch.equal(tmesh.place_batch(mesh, xs, scan=True), xs[:, 2:4])
    assert tmesh.place_batch(mesh, {"x": x}, batch_size=5)["x"] is x
    assert tmesh.place_batch(None, {"x": x})["x"] is x
    assert tmesh.divides(mesh, 8) and not tmesh.divides(mesh, 6) and not tmesh.divides(None, 8)
    mesh2 = tmesh.Mesh((2, 2), ("replica", "data"), rank=3, device=torch.device("cpu"))
    assert mesh2.size == 4 and tmesh.rows_of(mesh2, 8) == slice(6, 8)
    assert tmesh.replicate(mesh2, {"w": x})["w"] is x


# ---------------------------------------------------------------------------
# the sharded single-slide build
# ---------------------------------------------------------------------------

def _slide():
    """JAX test_parallel.py:332's inputs: 400 x 16 features, 8 TMA cores."""
    rng = np.random.default_rng(5)
    feats = (rng.standard_normal((400, 16)) * 0.3).astype(np.float32)
    pos = rng.uniform(0, 3, (400, 2)).astype(np.float32)
    tma = (rng.standard_normal((8, 16)) * 0.3).astype(np.float32)
    return feats, pos, tma


def _write(path, feats, pos, tma):
    with h5py.File(path, "w") as f:
        f["wsi/features"] = feats
        f["wsi/positions"] = pos
        f["tma/features"] = tma


def _jax_draws(feats, pos, tma):
    """The JAX build's three sets of kmeans++ draws for a slide (its key
    split as ``_fused_build`` splits it), as the port's ``init_centers``."""
    import importlib

    import jax.numpy as jnp

    jkm = importlib.import_module("multimodal_fusion_tpu.ops.kmeans")

    key = jax.random.key(42)
    out = jbuild._fused_build(key, jnp.asarray(feats), jnp.asarray(pos), jnp.asarray(tma),
                              jnp.asarray(feats.shape[0], jnp.int32), 1.0, 1.0,
                              *BUILD.values(), full_stats=True, ship_cache=False)
    k1, k2, k3 = jax.random.split(key, 3)

    def draws(k, x, n):
        keys = jax.random.split(k, 10)
        return torch.as_tensor(np.array(jax.vmap(lambda kk: jkm.kmeans_plus_plus_init(kk, x, n))(keys)))

    return {"super": draws(k1, jnp.asarray(feats), 6), "group": draws(k2, out["sim"], 2),
            "hyperedge": draws(k3, jnp.concatenate([out["sp_feats"], jnp.asarray(tma)]), 3)}


def _wsi_stats(stats):
    return stats["wsi_aggregation"]["wsi_similarity_matrix_stats"]


@pytest.mark.parametrize("world", [2, 4])
def test_sharded_build_matches_unsharded_and_jax(tmp_path, world):
    """In a gang of ``world``: each rank's K1 stripe
    (``sharded_combined_similarity``) equals the whole K's rows bit for
    bit; the 400-patch slide and the padded ODD-patch
    slide, in full and in streamed statistics, equal the port's unsharded
    build (median, min, max bit for bit; mean, std, intra mean 1e-5; labels
    and edges); the file the gang writes matches the JAX package's mesh
    build (8 CPU devices) of the same slide, from the JAX draws (statistics
    1e-5 as the port's other build tests hold them, edges and groups
    equal); save_similarity with an indivisible patch count, and mesh with
    file_batch, raise; the build CLI runs with --mesh_data."""
    feats, pos, tma = _slide()
    for name in ("port", "jax", "port_ref", "odd", "d", "cli"):
        _write(tmp_path / f"{name}.h5", *(_slide() if name != "odd" else (feats[:ODD], pos[:ODD], tma)))
    with open(tmp_path / "d.csv", "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=["patient_id", "case_id", "label", "h5_file_path"])
        w.writeheader()
        w.writerow({"patient_id": 0, "case_id": "d", "label": "living", "h5_file_path": "d.h5"})
    init = _jax_draws(feats, pos, tma)
    shape = {"data": world}
    common = dict(BUILD, save_similarity=False, device="cpu")
    calls = [
        (f"{DRY}:check_sharded_similarity", dict(n=8 * world, dim=16), shape),
        (f"{DRY}:check_build", dict(arrays=(feats, pos, tma), **BUILD), shape),
        (f"{DRY}:check_build", dict(arrays=(feats[:ODD], pos[:ODD], tma), **BUILD), shape),
        (f"{DRY}:check_build", dict(arrays=(feats, pos, tma), full_stats=False, **BUILD), shape),
        (f"{DRY}:check_build", dict(arrays=(feats[:ODD], pos[:ODD], tma), full_stats=False,
                                    **BUILD), shape),
        ("multimodal_fusion_tpu_torch.hypergraph.build:process_single_file",
         dict(h5_path=tmp_path / "port.h5", init_centers=init, **common), shape),
        ("multimodal_fusion_tpu_torch.hypergraph.build:process_single_file",
         dict(h5_path=tmp_path / "odd.h5", **dict(common, save_similarity=True)), shape),
        ("multimodal_fusion_tpu_torch.hypergraph.build:process_dataset",
         dict(csv_path=tmp_path / "d.csv", data_root_dir=tmp_path, file_batch=2, **common), shape),
        ("multimodal_fusion_tpu_torch.hypergraph.build:process_dataset",
         dict(csv_path=tmp_path / "d.csv", data_root_dir=tmp_path, **common), shape),
        ("multimodal_fusion_tpu_torch.cli.preprocess_hypergraph:main",
         dict(argv=["--csv_path", str(tmp_path / "d.csv"), "--data_root_dir", str(tmp_path),
                    "--num_wsi_super_patches", "6", "--num_groups", "2", "--hypergraph_k", "2",
                    "--num_hyperedges", "3", "--no_save_similarity", "--device", "cpu",
                    "--mesh_data", str(world),
                    "--output_stats_path", str(tmp_path / "cli_stats.json")]), None),
    ]
    ranks = _gang(world, calls, tmp_path)
    stripe, full, odd, streamed, odd_streamed, sharded, refused, exclusive, dataset, cli = ranks[0]
    assert all(_ok(rank[0])["equal"] and rank[0]["shape"] == [8, 8 * world] for rank in ranks)
    for res in (full, odd, streamed, odd_streamed):
        assert _ok(res)["median_min_max_equal"] and res["labels_equal"] and res["edges_equal"]
        assert res["stats_rel"] <= 1e-5 and res["intra_rel"] <= 1e-5
    assert all(r == ranks[0][1:5] for r in (rank[1:5] for rank in ranks))
    assert all(rank[5] == sharded for rank in ranks)  # every rank returns the stats
    assert refused["raised"] == "ValueError" and "save_similarity" in refused["message"]
    assert exclusive["raised"] == "ValueError" and "mutually exclusive" in exclusive["message"]
    stats, summary = _ok(dataset)
    assert [s.get("error") for s in stats] == [None] and summary["files"] == 1
    assert [s.get("error") for s in _ok(cli)] == [None]
    assert json.loads((tmp_path / "cli_stats.json").read_text())["summary"]["files"] == 1

    # the group rank 0 wrote against the port's unsharded build ...
    ref = tbuild.process_single_file(tmp_path / "port_ref.h5", init_centers=init, **common)
    for k in ("median", "min", "max"):
        assert _wsi_stats(sharded)[k] == _wsi_stats(ref)[k], k
    for k in ("mean", "std"):
        np.testing.assert_allclose(_wsi_stats(sharded)[k], _wsi_stats(ref)[k], rtol=1e-5)
    got, want = read_hypergraph_group(tmp_path / "port.h5"), read_hypergraph_group(tmp_path / "port_ref.h5")
    for key in ("edge_index", "group_labels"):
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    # ... and against the JAX package's mesh build
    jstats = jbuild.process_single_file(tmp_path / "jax.h5", *BUILD.values(), save_similarity=False,
                                        mesh=jmake_mesh(8))
    for k in ("mean", "std", "min", "max", "median"):
        np.testing.assert_allclose(_wsi_stats(sharded)[k], _wsi_stats(jstats)[k], rtol=1e-5,
                                   atol=1e-7, err_msg=k)
    np.testing.assert_allclose(sharded["wsi_aggregation"]["avg_intra_cluster_similarity"],
                               jstats["wsi_aggregation"]["avg_intra_cluster_similarity"], rtol=1e-5)
    jgroup = jread_group(tmp_path / "jax.h5")
    for key in ("edge_index", "group_labels"):
        np.testing.assert_array_equal(got[key], jgroup[key], err_msg=key)


# ---------------------------------------------------------------------------
# the survival trainer
# ---------------------------------------------------------------------------

CHANNELS = ["wsi=features", "tma=cd3=features", "clinical=val", "clinical=mask"]


@pytest.fixture(scope="module")
def survival_data(tmp_path_factory):
    root = tmp_path_factory.mktemp("surv")
    csv_path = make_synthetic_dataset(root, n_patients=13, seed=11, min_wsi_patches=16,
                                      max_wsi_patches=24, feature_dim=32, n_tma_patches=3)
    return root, csv_path


def _survival_configs(model_type="svd_gate_random_clam", **exp):
    mc = JaxModelConfig(model_type=model_type, n_classes=2, input_dim=32, model_size="32*16",
                        dropout=0.0, output_dim=32, channels_used_in_model=list(CHANNELS),
                        channel_input_dims={"clinical=val": 16}, enable_random_loss=False)
    ec = JaxExperiment(exp_name="mesh", seed=0, k_folds=3, max_epochs=2, batch_size=4, lr=1e-3,
                       patience=5, min_epochs=0, **exp)
    ec.extra["verbose"] = False
    return JaxConfigs(experiment_config=ec, model_config=mc)


def _history(summary, key):
    return [h[key] for h in summary["history"]]


def test_survival_trainer_mesh_matches_unsharded_and_jax(survival_data, tmp_path):
    """train_fold under mesh_shape {"data": 2} (host windows and device
    tables with scan_windows 2) and {"replica": 2, "data": 1}, with a
    leftover window that stays whole, equals the unsharded trainer (losses
    and parameters 1e-5); the ranks' parameters are identical; one run from
    the JAX trainer's weights follows the JAX trainer under the same
    mesh_shape on the 8-device CPU mesh (rtol 1e-4); the training CLI with
    --tpu_opts mesh_shape under the gang writes one results directory, as
    the unsharded CLI does."""
    from flax import nnx

    from multimodal_fusion_tpu.data.multimodal import MultimodalDataset as JaxDataset
    from multimodal_fusion_tpu.data.splits import create_k_fold_splits
    from multimodal_fusion_tpu.models.factory import ModelFactory as JaxFactory
    from multimodal_fusion_tpu.train.survival import SurvivalTrainer as JaxTrainer
    from multimodal_fusion_tpu_torch.models.jax_params import survival_params_from_jax
    from multimodal_fusion_tpu_torch import config as tconfig
    from multimodal_fusion_tpu_torch.models.factory import ModelFactory
    from multimodal_fusion_tpu_torch.train.checkpoint import save_model

    root, csv_path = survival_data
    jc = _survival_configs(mesh_shape={"data": 2})
    jmodel = JaxFactory.create_model(jc.model_config, seed=0)  # the fold's seed: seed + fold 0
    model = ModelFactory.create_model(
        tconfig.ModelConfig.from_dict(jc.model_config.to_dict()), device="cpu")
    model.load_state_dict(survival_params_from_jax(nnx.to_pure_dict(nnx.state(jmodel, nnx.Param))))
    init = tmp_path / "jax_init.npz"
    save_model(init, model)
    runs = {
        "host": ({"data": 2}, dict(device_data=False)),
        "tables": ({"data": 2}, dict(device_data=True, scan_windows=2)),
        "replica": ({"replica": 2, "data": 1}, dict(device_data=False)),
    }

    def call(name, shape, exp, init_state=None, log=None):
        cfg = json.loads(json.dumps(_survival_configs(mesh_shape=shape, **exp).to_dict()))
        return (f"{DRY}:train_fold",
                dict(configs=cfg, csv_path=csv_path, data_root_dir=root, channels=CHANNELS,
                     log_dir=tmp_path / (log or name), init_state=init_state, device="cpu"), shape)

    cli = ["--csv_path", str(csv_path), "--data_root_dir", str(root), "--exp_code", "m",
           "--model_type", "svd_gate_random_clam", "--target_channels", *CHANNELS,
           "--channels_used_in_model", *CHANNELS, "--input_dim", "32", "--model_size", "32*16",
           "--output_dim", "32", "--k", "3", "--start_k_fold", "2", "--max_epochs", "2",
           "--batch_size", "4", "--enable_svd", "--dropout", "0", "--seed", "0", "--device", "cpu"]
    calls = [call(n, *r) for n, r in runs.items()] + [call("jax", {"data": 2}, {}, init, "from_jax")]
    calls.append(("multimodal_fusion_tpu_torch.cli.main_survival:main",
                  dict(argv=cli + ["--results_dir", str(tmp_path / "cli_mesh"), "--tpu_opts",
                                   '{"mesh_shape": {"data": 2}}']), None))
    ranks = _gang(2, calls, tmp_path)
    cli_dir = ranks[0].pop()
    assert ranks[1].pop() == cli_dir  # one directory, named from rank 0's clock
    for r0, r1 in zip(*ranks):
        _ok(r0)
        assert r0["params"].keys() == r1["params"].keys()
        assert all(np.array_equal(r0["params"][k], r1["params"][k]) for k in r0["params"])

    for (name, (shape, exp)), got in zip(runs.items(), ranks[0]):
        _, want, _ = call(name, None, exp)
        want = dryrun.train_fold(None, **dict(want, log_dir=tmp_path / f"{name}_ref"))
        for key in ("train_loss", "val_loss"):
            np.testing.assert_allclose(_history(got["summary"], key),
                                       _history(want["summary"], key), rtol=1e-5, atol=1e-6,
                                       err_msg=f"{name} {key}")
        for k, v in want["params"].items():
            np.testing.assert_allclose(got["params"][k], v, rtol=1e-5,
                                       atol=1e-5 * max(np.abs(v).max(), 1e-6), err_msg=f"{name} {k}")
        assert (tmp_path / name / "fold_0_summary.json").exists()

    # the training CLI under the gang wrote what the unsharded CLI writes
    from multimodal_fusion_tpu_torch.cli import main_survival

    ref_dir = main_survival.main(cli + ["--results_dir", str(tmp_path / "cli_ref")])
    for name in ("summary.csv", "detailed_results_for_plotting.json", "configs_m.json",
                 "s_2_checkpoint.npz"):
        assert (cli_dir / name).exists() and (ref_dir / name).exists(), name
    got_cli, want_cli = (json.loads((d / "fold_2_summary.json").read_text()) for d in (cli_dir, ref_dir))
    for key in ("train_loss", "val_loss"):
        np.testing.assert_allclose(_history(got_cli, key), _history(want_cli, key), rtol=1e-5,
                                   atol=1e-6, err_msg=f"cli {key}")

    splits = create_k_fold_splits(JaxDataset(csv_path, root, CHANNELS).labels, 3, 0)
    jds = JaxDataset(csv_path, root, CHANNELS)
    want = JaxTrainer(jc, tmp_path / "jax_run").train_fold(jds, splits[0], 0)
    got = ranks[0][3]["summary"]
    for key in ("train_loss", "val_loss"):
        np.testing.assert_allclose(_history(got, key), _history(want, key), rtol=1e-4, atol=1e-6,
                                   err_msg=key)


# ---------------------------------------------------------------------------
# pretraining, extraction, MFMF
# ---------------------------------------------------------------------------

def test_pretraining_extraction_and_mfmf_steps_sharded(tmp_path):
    """In a gang of 2: VAE steps (a batch that divides, and one that stays
    whole), alignment steps (rank-1 with a negative pool of 5 that stays
    whole on every rank; volume), ViT extraction in float32 and bfloat16,
    and an MFMF training window with remat (each rank calls the attention
    wrappers: their plain versions on the CPU) equal the unsharded ones."""
    mfmf = dryrun.survival_config("mfmf", input_dim=16, model_size="8*4", output_dim=32,
                                  channels=dryrun.MFMF_CHANNELS, attention_num_heads=8)
    shape = {"data": 2}
    calls = [
        (f"{DRY}:check_vae_step", dict(B=16), shape),
        (f"{DRY}:check_vae_step", dict(B=15), shape),
        (f"{DRY}:check_alignment_step", dict(B=16, n_neg=5), shape),
        (f"{DRY}:check_alignment_step", dict(B=8, loss_type="volume", lambda2=0.0), shape),
        (f"{DRY}:check_extraction", dict(vit=TINY_VIT), shape),
        (f"{DRY}:check_extraction", dict(vit=TINY_VIT, compute_dtype="bfloat16"), shape),
        (f"{DRY}:check_survival_step", dict(G=4, config=mfmf, input_dim=16, remat=True,
                                            tol={"loss": 1e-5, "grad": 1e-4, "param": 1e-5}),
         shape),
    ]
    ranks = _gang(2, calls, tmp_path)
    for res in ranks[0]:
        _ok(res)
    assert ranks[0][4]["shape"] == [10, 64] and ranks[0][4]["rel_l2"] <= 1e-5
    assert ranks[0][5]["min_cosine"] >= 0.999


def test_pretraining_clis_with_mesh_data(tmp_path):
    """train_vae and run_alignment with --mesh_data 2 in a gang of 2 write
    the histories of the unsharded CLIs (1e-5)."""
    from multimodal_fusion_tpu_torch.cli import run_alignment, train_vae
    from multimodal_fusion_tpu_torch.io.fixtures import make_alignment_npz_fixtures

    root = tmp_path / "d"
    csv_path = make_synthetic_dataset(root, n_patients=4, seed=3, min_wsi_patches=40,
                                      max_wsi_patches=60, feature_dim=32, n_tma_patches=3)
    make_alignment_npz_fixtures(tmp_path / "npz", markers=["cd3", "cd8"], n_cores=24,
                                patches_per_core=2, feature_dim=32)

    def vae(out):
        return ["--csv_path", str(csv_path), "--data_root_dir", str(root), "--input_dim", "32",
                "--hidden_dims", "16", "--latent_dim", "8", "--epochs", "2", "--batch_size", "16",
                "--checkpoint_dir", str(tmp_path / out), "--device", "cpu"]

    def align(out):
        return ["--base_dir", str(tmp_path / "npz"), "--filename_template", "{marker}.npz",
                "--markers", "cd3", "cd8", "--feature_dim", "32", "--max_steps", "6",
                "--batch_size", "8", "--val_interval", "3", "--save_path", str(tmp_path / out),
                "--device", "cpu"]

    calls = [("multimodal_fusion_tpu_torch.cli.train_vae:main",
              dict(argv=vae("vae_mesh") + ["--mesh_data", "2"]), None),
             ("multimodal_fusion_tpu_torch.cli.run_alignment:main",
              dict(argv=align("align_mesh.npz") + ["--mesh_data", "2"]), None)]
    ranks = _gang(2, calls, tmp_path)
    got_vae, got_align = (_ok(r) for r in ranks[0])
    want_vae = train_vae.main(vae("vae_ref"))
    want_align = run_alignment.main(align("align_ref.npz"))
    for key in ("train_loss", "val_loss", "recon_loss", "kld_loss"):
        np.testing.assert_allclose(got_vae["history"][key], want_vae["history"][key], rtol=1e-5,
                                   err_msg=key)
    np.testing.assert_allclose(got_align["history"]["train_loss"],
                               want_align["history"]["train_loss"], rtol=1e-5)
    np.testing.assert_allclose([v["loss"] for v in got_align["history"]["val_loss"]],
                               [v["loss"] for v in want_align["history"]["val_loss"]], rtol=1e-5)
    assert (tmp_path / "vae_mesh" / "best.npz").exists()
    assert (tmp_path / "align_mesh.npz.history.json").exists()


# ---------------------------------------------------------------------------
# the gang and the dry run
# ---------------------------------------------------------------------------

def test_multihost_two_process_gang(tmp_path):
    out = multihost.launch(2, timeout=GANG_TIMEOUT, device="cpu", workdir=tmp_path)
    assert "multihost OK proc 0/2" in out and "multihost OK proc 1/2" in out


def test_dryrun_multichip_four_ranks(tmp_path):
    out = dryrun.dryrun_multichip(4, timeout=GANG_TIMEOUT, device="cpu", workdir=tmp_path)
    assert "dryrun_multichip(4): OK (mesh {'replica': 2, 'data': 2})" in out
    for line in ("sharded single-slide build OK", "sharded VAE train step OK",
                 "sharded alignment train step OK"):
        assert f"dryrun_multichip(4): {line}" in out

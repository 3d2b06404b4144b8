"""MFMF's second and third fusion orders (experiments/2.related_works/
mfmf_config1.sh and mfmf_config2.sh) in the port against the JAX package
on the CPU: ``train_fold``'s loss trajectory, the training CLI's parsing of
the scripts' flags, and the kernel routes the orders' blocks take at the
scripts' width.

The trainer test runs both trainers on one synthetic HDF5 dataset from the
same initial weights (the JAX fold model's, carried across by
``mfmf_params_from_jax``), as ``test_torch_port_train.py`` does for the
default order: at attention dropout 0 the forward draws no random numbers
and both take the window order from numpy, so the whole loss trajectory is
compared.  Tolerances: per-epoch losses rtol 1e-4, atol 1e-6 (float32 sums
in other orders, compounded over Adam steps); AUCs 1e-6; test
probabilities 1e-4.
"""

import json
import shlex
from pathlib import Path

import numpy as np
import pytest
from flax import nnx

from multimodal_fusion_tpu import config as jconfig
from multimodal_fusion_tpu.cli import main_survival as jcli
from multimodal_fusion_tpu.data.multimodal import MultimodalDataset as JaxDataset
from multimodal_fusion_tpu.io.fixtures import make_synthetic_dataset
from multimodal_fusion_tpu.models.factory import ModelFactory as JaxFactory
from multimodal_fusion_tpu.train.survival import SurvivalTrainer as JaxTrainer
from multimodal_fusion_tpu_torch import channels as tchannels
from multimodal_fusion_tpu_torch import config as tconfig
from multimodal_fusion_tpu_torch.channels import parse_channels
from multimodal_fusion_tpu_torch.cli import main_survival as cli
from multimodal_fusion_tpu_torch.data import splits as tsplits
from multimodal_fusion_tpu_torch.data.multimodal import MultimodalDataset
from multimodal_fusion_tpu_torch.models.factory import ModelFactory
from multimodal_fusion_tpu_torch.models.mfmf import DEFAULT_FUSION_SEQUENCE, mfmf_params_from_jax
from multimodal_fusion_tpu_torch.ops.attention_kernel import _route
from multimodal_fusion_tpu_torch.train.survival import SurvivalTrainer

SCRIPTS = Path(__file__).resolve().parents[1] / "experiments" / "2.related_works"
SHORTHANDS = ["wsi", "cd3", "cd8", "clinical_mask", "blood_mask"]


def _script_argv(name):
    """The training CLI's argv in ``<name>.sh``, its shell variables filled
    with placeholders."""
    text = (SCRIPTS / f"{name}.sh").read_text().replace("\\\n", " ")
    line = next(ln for ln in text.splitlines() if "cli.main_survival" in ln)
    argv = shlex.split(line.split("cli.main_survival", 1)[1])
    fill = {"$CSV_PATH": "d.csv", "$DATA_ROOT_DIR": "d", "$RESULTS_DIR": "r", "$TPU_OPTS": "{}",
            "$SEED": "5678"}
    return [fill.get(a, a) for a in argv]


def _order(name):
    argv = _script_argv(name)
    return json.loads(argv[argv.index("--fusion_blocks_sequence") + 1])


@pytest.fixture(scope="module")
def mfmf_data(tmp_path_factory):
    """12 patients, 16-d features, WSI bags of 16-40 patches with their
    reconstruction, 2 TMA markers, 2 tabular groups with masks."""
    root = tmp_path_factory.mktemp("mfmf_configs")
    csv_path = make_synthetic_dataset(root, n_patients=12, seed=5, min_wsi_patches=16,
                                      max_wsi_patches=40, feature_dim=16, markers=("cd3", "cd8"),
                                      with_reconstructed=True)
    return root, csv_path, tchannels.parse_channels(SHORTHANDS)


def _configs(chans, order):
    mc = jconfig.ModelConfig(model_type="mfmf", n_classes=2, input_dim=16, model_size="8*4",
                             dropout=0.25, output_dim=32, channels_used_in_model=chans,
                             channel_input_dims={"clinical=val": 16, "blood=val": 24},
                             fusion_blocks_sequence=order)
    mc.extra.update(attention_num_heads=8, attention_impl="pallas_interpret")
    ec = jconfig.ExperimentConfig(exp_name="t", seed=11, k_folds=3, max_epochs=2, batch_size=4,
                                  lr=1e-3, optimizer="adam", weight_decay=1e-5, scheduler="plateau",
                                  scheduler_params={"mode": "min", "patience": 15, "factor": 0.5},
                                  min_epochs=0)
    ec.extra["verbose"] = False
    jc = jconfig.Configs(experiment_config=ec, model_config=mc)
    tc = tconfig.Configs.from_dict(json.loads(json.dumps(jc.to_dict())))
    tc.model_config.extra["attention_impl"] = "auto"
    return jc, tc


@pytest.mark.parametrize("name", ["mfmf_config1", "mfmf_config2"])
def test_train_fold_matches_jax_trainer(mfmf_data, tmp_path, name):
    root, csv_path, chans = mfmf_data
    jc, tc = _configs(chans, _order(name))
    ds = MultimodalDataset(csv_path, root, chans)
    split = tsplits.create_k_fold_splits(ds.labels, 3, 11)[0]
    want = JaxTrainer(jc, tmp_path / "jax").train_fold(JaxDataset(csv_path, root, chans), split, 0)

    def port_model(fold_idx):
        jm = JaxFactory.create_model(jc.model_config, seed=jc.experiment_config.seed + fold_idx)
        model = ModelFactory.create_model(tc.model_config, seed=0, device="cpu")
        model.load_state_dict(mfmf_params_from_jax(nnx.to_pure_dict(nnx.state(jm, nnx.Param))),
                              strict=True)
        return model

    tr = SurvivalTrainer(tc, tmp_path / "port", device="cpu")
    tr._build_model = port_model
    got = tr.train_fold(ds, split, 0)
    assert list(tr._build_model(0).attention_blocks) == [f"{b['q']}:{b['kv']}" for b in _order(name)]
    for key in ("train_loss", "val_loss"):
        np.testing.assert_allclose([h[key] for h in got["history"]],
                                   [h[key] for h in want["history"]], rtol=1e-4, atol=1e-6,
                                   err_msg=key)
    for key in ("val_auc", "test_auc"):
        np.testing.assert_allclose(got[key], want[key], atol=1e-6, err_msg=key)
    pj = json.loads((tmp_path / "jax" / "fold_0_summary.json").read_text())["patient_results"]
    pt = json.loads((tmp_path / "port" / "fold_0_summary.json").read_text())["patient_results"]
    assert list(pt) == list(pj)
    for pid in pj:
        np.testing.assert_allclose(pt[pid]["prob"], pj[pid]["prob"], atol=1e-4)


@pytest.mark.parametrize("name", ["mfmf_config0", "mfmf_config1", "mfmf_config2"])
def test_cli_parses_the_scripts_like_jax(name):
    """The script's flags through both CLIs give the same ModelConfig and
    ExperimentConfig, the fusion order among them."""
    argv = _script_argv(name)
    args = cli.parse_args(argv)
    jargs = jcli.build_parser().parse_args(argv)
    # the JAX main's channel handling, replayed on its parsed flags
    jargs.target_channels = parse_channels([c.lower() for c in jargs.target_channels])
    jargs.channels_used_in_model = parse_channels(jargs.channels_used_in_model)
    jargs._aligned_map = {}
    jargs.aligned_channels = []
    dims = {"clinical=val": 16, "pathological=val": 12, "blood=val": 24}
    got, want = cli.args_to_configs(args, dims), jcli.args_to_configs(jargs, dims)
    assert got.to_dict() == want.to_dict()
    order = got.model_config.fusion_blocks_sequence
    assert order == _order(name)
    if name == "mfmf_config0":
        assert order == DEFAULT_FUSION_SEQUENCE
    model = ModelFactory.create_model(
        tconfig.ModelConfig.from_dict(dict(got.model_config.to_dict(), input_dim=16, output_dim=16,
                                           channel_input_dims=dict(dims, **{
                                               "icd=val": 8, "tma_cell_density=val": 8}))),
        seed=0, device="cpu")
    assert list(model.attention_blocks) == [f"{b['q']}:{b['kv']}" for b in order]


# tokens per modality at the scripts' width (chip_smoke.py's MFMF cells):
# 5 tabular groups, 8 markers' 64-row TMA buckets, WSI and reconstructed
# bags in a 4096 bucket; hd = output_dim 128 / 8 heads
TOKENS = {"other": 5, "tma": 8 * 64, "wsi": 4096, "reconstruct": 4096}
ROUTES = {
    "mfmf_config0": ["narrow_q", "narrow_q", "narrow_k"],
    "mfmf_config1": ["narrow_k", "general", "general"],
    "mfmf_config2": ["narrow_q", "narrow_q", "narrow_q"],
}


@pytest.mark.parametrize("name", list(ROUTES))
def test_routes_of_the_fusion_orders(name):
    """K3 and K4's route for each block of the order: the result tokens are
    the previous block's q side, so config1's blocks 2 and 3 are 512 x 4096
    and 4096 x 512 (both sides > NARROW: ``general``) and every block of
    config2 has the 5 tabular tokens on its q side (``narrow_q``)."""
    sizes = dict(TOKENS)
    routes = []
    for blk in _order(name):
        routes.append(_route(sizes[blk["q"]], sizes[blk["kv"]], 128 // 8))
        sizes["result"] = sizes[blk["q"]]
    assert routes == ROUTES[name]

"""The experiment matrix (``experiments/matrix.py``) through the port's
training CLI against the JAX CLI on the CPU.

Every entry's argv parses to the JAX CLI's namespace (``--device`` aside)
and to the same configs; its model type and channels resolve in the port,
and its model builds in the port's factory and runs an eval forward at a
tiny width.  Every checked-in generated ``.sh`` script's flags, with
``--tpu_opts "$TPU_OPTS"`` and ``--seed "$SEED"``, parse in the port's
parser as in the JAX one.  Every alignment sweep argv parses equal in both
``cli/run_alignment.py`` parsers.

The JAX matrix test's seven representatives then train for one epoch at
k 2 through both CLIs on its fixture with its overrides (dropout 0), the
port's fold models starting from the JAX fold models' initial weights
(carried across by ``survival_params_from_jax`` / ``mfmf_params_from_jax``
in a patched ``SurvivalTrainer._build_model``, here only).  Both write the
same files, CSV headers, JSON keys and ``splits_<fold>.csv``.  Where
neither side draws random numbers, the numbers are held: per-epoch losses
rtol 1e-4, atol 1e-6; AUCs and accuracies 1e-6; test probabilities 1e-4
(``test_torch_port_flagship_train.py``'s bars).  The three representatives
with the random partial loss draw from each backend's own generator, so
their numbers are held on a second run with ``--enable_random_loss``
taken out of the argv.
"""

import csv
import importlib.util
import json
import os
import shlex
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from flax import nnx

from multimodal_fusion_tpu import config as jconfig
from multimodal_fusion_tpu.cli import main_survival as jcli
from multimodal_fusion_tpu.cli import run_alignment as jalign
from multimodal_fusion_tpu.io.fixtures import make_synthetic_dataset
from multimodal_fusion_tpu.models.factory import ModelFactory as JaxFactory
from multimodal_fusion_tpu_torch.channels import parse_channels
from multimodal_fusion_tpu_torch.cli import main_survival as cli
from multimodal_fusion_tpu_torch.cli import run_alignment as talign
from multimodal_fusion_tpu_torch.config import ModelConfig
from multimodal_fusion_tpu_torch.io.fixtures import TABULAR_DIMS
from multimodal_fusion_tpu_torch.models.factory import MODEL_REGISTRY, ModelFactory
from multimodal_fusion_tpu_torch.models.jax_params import survival_params_from_jax
from multimodal_fusion_tpu_torch.models.mfmf import mfmf_params_from_jax
from multimodal_fusion_tpu_torch.train.survival import SurvivalTrainer

REPO = Path(__file__).resolve().parents[1]
_spec = importlib.util.spec_from_file_location("exp_matrix", REPO / "experiments" / "matrix.py")
matrix = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(matrix)

DIMS = {f"{g}=val": d for g, d in TABULAR_DIMS.items()}
# the JAX matrix test's representatives and smoke overrides
SMOKE = [
    "0.clam/clam/tma_wsi_clam",
    "0.clam/clam_mlp/all_clam_mlp",
    "0.clam/svd_gate_random_clam/combined_svd_gate_random_clam",
    "0.clam/clip_gate_random_clam_detach/clip_random_clam_detach",
    "1.deep_supervise/random/ds_svd_random",
    "2.related_works/mfmf_config1",
    "3.additional_exp/svd_pool_max",
]
OVERRIDES = {"max_epochs": "1", "k": "2", "batch_size": "4", "input_dim": "16",
             "model_size": "16*8", "output_dim": "16", "inst_number": "2", "dropout": "0.0"}
RANDOM_LOSS = [n for n in SMOKE if "enable_random_loss" in matrix.ENTRIES[n]["switches"]]
RUNS = [(n, True) for n in SMOKE] + [(n, False) for n in RANDOM_LOSS]


def _entry_argv(name):
    e = matrix.ENTRIES[name]
    return [str(a) for a in matrix.build_argv(
        name, "d.csv", "root", "results",
        dataset_split_path="split.json" if e.get("needs_split_path") else None)]


def _jax_configs(argv):
    """The JAX CLI's configs for ``argv``, its main's channel handling
    replayed on its parsed flags."""
    jargs = jcli.build_parser().parse_args(argv)
    jargs.target_channels = parse_channels([c.lower() for c in jargs.target_channels])
    jargs.channels_used_in_model = parse_channels(
        [c.lower() if "=" not in c else c for c in jargs.channels_used_in_model])
    jargs._aligned_map = {}
    jargs.aligned_channels = []
    return jcli.args_to_configs(jargs, DIMS)


def _tiny_window(chans, generator, cases=2, patches=3, dim=16):
    """A window of random cases over ``chans`` at input width ``dim``:
    bags [cases, patches, dim] with a mask, tabular values [cases, 1, d]."""
    channels, masks = {}, {}
    for ch in chans:
        if ch.endswith("=val"):
            channels[ch] = torch.randn(cases, 1, DIMS[ch], generator=generator)
        else:
            channels[ch] = torch.randn(cases, patches, dim, generator=generator)
            masks[ch] = torch.ones(cases, patches, dtype=torch.bool)
    return {"channels": channels, "masks": masks}, torch.arange(cases) % 2


@pytest.mark.parametrize("name", list(matrix.ENTRIES))
def test_entry_parses_like_jax_and_builds(name):
    argv = _entry_argv(name)
    got = vars(cli.build_parser().parse_args(argv))
    want = vars(jcli.build_parser().parse_args(argv))
    assert got.pop("device") is None
    assert got == want
    args = cli.parse_args(argv)
    assert args.model_type in MODEL_REGISTRY
    chans = args.target_channels
    assert chans and set(args.channels_used_in_model) <= set(chans)
    configs = cli.args_to_configs(args, DIMS)
    assert configs.to_dict() == _jax_configs(argv).to_dict()
    mc = ModelConfig.from_dict(dict(configs.model_config.to_dict(), input_dim=16, model_size="8*4"))
    model = ModelFactory.create_model(mc, seed=0, device="cpu")
    case, label = _tiny_window(chans, torch.Generator().manual_seed(0))
    with torch.no_grad():
        res = model(case, label)
    assert res["logits"].shape == (2, 2) and torch.isfinite(res["logits"]).all()


def _script_argv(name, tpu_opts, seed):
    """The training CLI's argv in the checked-in ``<name>.sh``, its shell
    variables filled."""
    text = (REPO / "experiments" / f"{name}.sh").read_text().replace("\\\n", " ")
    line = next(ln for ln in text.splitlines() if "cli.main_survival" in ln)
    fill = {"$CSV_PATH": "d.csv", "$DATA_ROOT_DIR": "root", "$RESULTS_DIR": "results",
            "$DATASET_SPLIT_PATH": "split.json", "$TPU_OPTS": tpu_opts, "$SEED": seed}
    return [fill.get(a, a) for a in shlex.split(line.split("cli.main_survival", 1)[1])]


@pytest.mark.parametrize("name", list(matrix.ENTRIES))
def test_generated_script_parses_in_the_port(name):
    tpu_opts = '{"device_data": true, "remat": true}'
    argv = _script_argv(name, tpu_opts, "1234")
    assert argv[-4:] == ["--tpu_opts", tpu_opts, "--seed", "1234"]
    got = vars(cli.build_parser().parse_args(argv))
    assert got.pop("device") is None
    assert got == vars(jcli.build_parser().parse_args(argv))
    assert got["tpu_opts"] == tpu_opts and got["seed"] == 1234
    # the script runs the entry's configuration, its seed from $SEED
    entry = _entry_argv(name) + ["--tpu_opts", tpu_opts, "--seed", "1234"]
    assert dict(got, device=None) == vars(cli.build_parser().parse_args(entry))
    configs = cli.args_to_configs(cli.parse_args(argv), DIMS)
    assert configs.experiment_config.device_data is True and configs.experiment_config.remat is True
    assert configs.to_dict() == _jax_configs(argv).to_dict()


ALIGNMENT_ARGVS = [(name, v) for name, sweep in matrix.ALIGNMENT_SWEEPS.items()
                   for v in sweep.get("values") or [None]]


@pytest.mark.parametrize("name,value", ALIGNMENT_ARGVS,
                         ids=[f"{n}-{v}" for n, v in ALIGNMENT_ARGVS])
def test_alignment_argv_parses_like_jax(name, value):
    argv = [str(a) for a in matrix.build_alignment_argv(name, value=value)]
    argv += ["--base_dir", "x", "--save_path", "m.npz"]
    got = vars(talign.build_parser().parse_args(argv))
    assert got.pop("device") is None
    assert got == vars(jalign.build_parser().parse_args(argv))


def test_matrix_counts():
    assert len(matrix.ENTRIES) == 66 and len(ALIGNMENT_ARGVS) == 42
    assert len({matrix.ENTRIES[n]["model_type"] for n in matrix.ENTRIES}) == 14
    assert RANDOM_LOSS == [SMOKE[2], SMOKE[3], SMOKE[4]]


# ---------------------------------------------------------------- training


@pytest.fixture(scope="module")
def smoke_dataset(tmp_path_factory):
    """The JAX matrix test's ``smoke_dataset``."""
    root = tmp_path_factory.mktemp("exp_matrix")
    csv_path = make_synthetic_dataset(
        root, n_patients=8, seed=11, min_wsi_patches=8, max_wsi_patches=12,
        feature_dim=16, n_tma_patches=2, with_reconstructed=True,
    )
    return root, csv_path


def _run_argv(name, random_loss, root, csv_path, results_dir):
    argv = [str(a) for a in matrix.build_argv(name, csv_path, root, results_dir,
                                              overrides=OVERRIDES)]
    if not random_loss:
        argv.remove("--enable_random_loss")
    return argv


_JAX_CLI = r"""
import json, sys
from pathlib import Path
from multimodal_fusion_tpu.utils.jaxcache import enable_compilation_cache
enable_compilation_cache(Path(sys.argv[1]))
from multimodal_fusion_tpu.cli.main_survival import main
for argv in json.loads(sys.argv[2]):
    main(argv)
"""


@pytest.fixture(scope="module")
def jax_runs(smoke_dataset, tmp_path_factory):
    """Every run of ``RUNS`` through the JAX CLI: its results directory by
    run.  The JAX CLI spends most of its time tracing and compiling on one
    core, so the runs go to three processes, round robin."""
    root, csv_path = smoke_dataset
    out = tmp_path_factory.mktemp("jax_cli")
    argvs = [_run_argv(n, r, root, csv_path, out / str(i)) for i, (n, r) in enumerate(RUNS)]
    procs = [subprocess.Popen(
        [sys.executable, "-c", _JAX_CLI, str(REPO / ".jax_cache" / "cpu"), json.dumps(argvs[g::3])],
        cwd=REPO, env=dict(os.environ, PYTHONPATH=str(REPO)), stdout=subprocess.DEVNULL,
        stderr=subprocess.PIPE, text=True) for g in range(3)]
    for p in procs:
        _, err = p.communicate(timeout=900)
        assert p.returncode == 0, err[-3000:]
    return {run: next((out / str(i)).iterdir()) for i, run in enumerate(RUNS)}


def _from_jax_weights(self, fold_idx):
    """The port's fold model with the JAX trainer's initial weights of
    that fold (the JAX factory at the same config and seed)."""
    mc = self.configs.model_config
    jm = JaxFactory.create_model(jconfig.ModelConfig.from_dict(mc.to_dict()),
                                 seed=self.exp.seed + fold_idx)
    state = nnx.to_pure_dict(nnx.state(jm, nnx.Param))
    to_port = mfmf_params_from_jax if mc.model_type == "mfmf" else survival_params_from_jax
    model = ModelFactory.create_model(mc, seed=0, device=self.device)
    model.load_state_dict(to_port(state), strict=True)
    return model


def _read_csv(path):
    with open(path, newline="") as f:
        return list(csv.reader(f))


def _json(path):
    return json.loads(path.read_text())


@pytest.mark.parametrize("name,random_loss", RUNS,
                         ids=[n.rsplit("/", 1)[-1] + ("" if r else "-no_random_loss")
                              for n, r in RUNS])
def test_representative_trains_like_the_jax_cli(name, random_loss, smoke_dataset, jax_runs,
                                                tmp_path, monkeypatch):
    root, csv_path = smoke_dataset
    jdir = jax_runs[(name, random_loss)]
    monkeypatch.setattr(SurvivalTrainer, "_build_model", _from_jax_weights)
    tdir = cli.main(_run_argv(name, random_loss, root, csv_path, tmp_path) + ["--device", "cpu"])

    exp_code = name.rsplit("/", 1)[-1]
    assert tdir.name.startswith(f"{exp_code}_") and jdir.name.startswith(f"{exp_code}_")
    names = {p.name for p in jdir.iterdir()}
    assert {p.name for p in tdir.iterdir()} == names
    assert {f"configs_{exp_code}.json", "summary.csv", "s_1_checkpoint.npz"} <= names
    for csv_name in sorted(n for n in names if n.endswith(".csv")):
        got, want = _read_csv(tdir / csv_name), _read_csv(jdir / csv_name)
        assert got[0] == want[0] and len(got) == len(want), csv_name
        if csv_name.startswith("splits_"):
            assert got == want, csv_name
    for json_name in sorted(n for n in names if n.endswith(".json")):
        assert _json(tdir / json_name).keys() == _json(jdir / json_name).keys(), json_name
    for fold in (0, 1):
        hist = _json(tdir / f"fold_{fold}_summary.json")["history"]
        assert len(hist) == 1 and np.isfinite([hist[0]["train_loss"], hist[0]["val_loss"]]).all()
    if random_loss and name in RANDOM_LOSS:
        return

    for fold in (0, 1):
        got, want = (_json(d / f"fold_{fold}_summary.json") for d in (tdir, jdir))
        for key in ("train_loss", "val_loss"):
            np.testing.assert_allclose([h[key] for h in got["history"]],
                                       [h[key] for h in want["history"]],
                                       rtol=1e-4, atol=1e-6, err_msg=f"fold {fold} {key}")
        pt, pj = got["patient_results"], want["patient_results"]
        assert list(pt) == list(pj)
        for pid in pj:
            np.testing.assert_allclose(pt[pid]["prob"], pj[pid]["prob"], atol=1e-4,
                                       err_msg=f"fold {fold} {pid}")
    got, want = (_read_csv(d / "summary.csv") for d in (tdir, jdir))
    np.testing.assert_allclose(np.asarray(got[1:], float), np.asarray(want[1:], float),
                               atol=1e-6, err_msg="summary.csv")

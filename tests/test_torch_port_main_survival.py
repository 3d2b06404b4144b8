"""The port's training CLI (``cli/main_survival.py``) and
``utils/seeding.py`` against the JAX package's on the CPU.

The CLI test runs both CLIs with the same flags on one HDF5 fixture (the
JAX package's ``make_synthetic_dataset``): the port writes the JAX CLI's
files, with the same CSV headers, the same JSON keys and byte-equal
``splits_<fold>.csv``, and the port's ``cli/predict.py`` then scores the
port's results directory.  The two runs start from different random
weights, so their numbers are not compared here
(``tests/test_torch_port_flagship_train.py`` holds the trainer's).
"""

import csv
import json
import random

import numpy as np
import pytest
import torch

from multimodal_fusion_tpu.cli import main_survival as jcli
from multimodal_fusion_tpu.io.fixtures import make_synthetic_dataset
from multimodal_fusion_tpu.utils.seeding import seed_everything as jax_seed_everything
from multimodal_fusion_tpu_torch.channels import parse_channels
from multimodal_fusion_tpu_torch.cli import main_survival as cli
from multimodal_fusion_tpu_torch.cli import predict as cli_predict
from multimodal_fusion_tpu_torch.data.multimodal import MultimodalDataset
from multimodal_fusion_tpu_torch.models.alignment import MultiModalAlignmentModel
from multimodal_fusion_tpu_torch.train.checkpoint import save_model
from multimodal_fusion_tpu_torch.utils.seeding import seed_everything

FLAGS = [
    "--exp_code", "v", "--model_type", "svd_gate_random_clam",
    "--target_channels", "wsi=features", "tma=cd3=features", "clinical=val", "clinical=mask",
    "--channels_used_in_model", "wsi=features", "tma=cd3=features", "clinical=val", "clinical=mask",
    "--input_dim", "16", "--model_size", "8*4", "--output_dim", "8", "--k", "2",
    "--max_epochs", "1", "--batch_size", "4", "--enable_svd", "--enable_dynamic_gate",
    "--tau1", "1.0", "--tau2", "1.0", "--lambda1", "0.1", "--seed", "0",
]


@pytest.fixture(scope="module")
def fixture(tmp_path_factory):
    root = tmp_path_factory.mktemp("cli")
    csv_path = make_synthetic_dataset(root, n_patients=8, seed=2, min_wsi_patches=6,
                                      max_wsi_patches=20, feature_dim=16, markers=("cd3",))
    return root, csv_path


def _read_csv(path):
    with open(path, newline="") as f:
        return list(csv.reader(f))


def test_main_survival_writes_the_jax_cli_files(fixture, tmp_path, capsys):
    root, csv_path = fixture
    data = ["--csv_path", str(csv_path), "--data_root_dir", str(root)]
    jdir = jcli.main(FLAGS + data + ["--results_dir", str(tmp_path / "jax")])
    tdir = cli.main(FLAGS + data + ["--results_dir", str(tmp_path / "port"), "--device", "cpu"])
    assert tdir.name.startswith("v_") and tdir.parent == tmp_path / "port"
    names = {p.name for p in jdir.iterdir()}
    assert {p.name for p in tdir.iterdir()} == names
    for must in ("configs_v.json", "summary.csv", "detailed_results_for_plotting.json",
                 "splits_0.csv", "splits_1.csv", "s_0_checkpoint.npz", "fold_1_epochs.csv"):
        assert must in names, must
    for name in ("summary.csv", "fold_0_epochs.csv", "fold_1_epochs.csv"):
        got, want = _read_csv(tdir / name), _read_csv(jdir / name)
        assert got[0] == want[0] and len(got) == len(want), name
    for fold in (0, 1):
        assert (tdir / f"splits_{fold}.csv").read_text() == (jdir / f"splits_{fold}.csv").read_text()
    for name in ("configs_v.json", "detailed_results_for_plotting.json", "fold_0_summary.json"):
        got, want = json.loads((tdir / name).read_text()), json.loads((jdir / name).read_text())
        assert got.keys() == want.keys(), name
    got, want = (json.loads((d / "configs_v.json").read_text()) for d in (tdir, jdir))
    assert got["experiment_config"].pop("results_dir") == str(tmp_path / "port")
    want["experiment_config"].pop("results_dir")
    assert got == want

    # the port's predict scores the port's results directory
    capsys.readouterr()
    cli_predict.main(["--results_dir", str(tdir), "--csv_path", str(csv_path),
                      "--data_root_dir", str(root), "--device", "cpu"])
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == {
        "n_cases_scored": 8, "folds": [0, 1]}
    rows = _read_csv(tdir / "predictions.csv")
    assert len(rows) == 9 and np.isfinite([float(x) for x in rows[1][3:]]).all()


def test_cli_flags_and_configs_match_jax(fixture, tmp_path):
    """The JAX CLI's flags plus --device, the same parsed channels and
    colon-mapped aligned channels, the same configs; an alignment model
    that exists is loaded (the run trains, its colon mapping persisted), a
    path that does not exist is ignored (the run trains)."""
    jflags = {a.dest for a in jcli.build_parser()._actions}
    assert {a.dest for a in cli.build_parser()._actions} == jflags | {"device"}
    argv = FLAGS + ["--aligned_channels", "cd3:tma", "clinical", "--tpu_opts",
                    '{"remat": true, "device_data": false, "custom": 3}']
    args = cli.parse_args(argv)
    jargs = jcli.build_parser().parse_args(argv)
    assert args.device is None
    dims = {"clinical=val": 16}
    # the JAX main's channel handling, replayed on its parsed flags
    jargs.target_channels = parse_channels([c.lower() for c in jargs.target_channels])
    jargs.channels_used_in_model = parse_channels(jargs.channels_used_in_model)
    jargs._aligned_map = {"tma=cd3=features": "tma", **{c: c for c in parse_channels(["clinical"])}}
    jargs.aligned_channels = list(jargs._aligned_map)
    assert args._aligned_map == jargs._aligned_map
    assert cli.args_to_configs(args, dims).to_dict() == jcli.args_to_configs(jargs, dims).to_dict()
    root, csv_path = fixture
    data = ["--csv_path", str(csv_path), "--data_root_dir", str(root), "--device", "cpu"]
    model = MultiModalAlignmentModel(["tma"], feature_dim=16, num_layers=2,
                                     generator=torch.Generator().manual_seed(0))
    ckpt = save_model(tmp_path / "alignment.npz", model)
    out = cli.main(FLAGS + data + ["--results_dir", str(tmp_path / "a"),
                                   "--alignment_model_path", str(ckpt),
                                   "--aligned_channels", "tma=cd3=features:tma"])
    saved = json.loads((out / "configs_v.json").read_text())["experiment_config"]
    assert saved["aligned_channels_map"] == {"tma=cd3=features": "tma"}
    out = cli.main(FLAGS + data + ["--results_dir", str(tmp_path / "r"),
                                   "--alignment_model_path", str(tmp_path / "absent.npz")])
    assert (out / "summary.csv").exists()


class _InMemory:
    """The dataset interface ``cli.run`` reads (``case_ids``, ``labels``,
    ``case_to_patient``, ``get_case``, ``has_survival_time``) over cases
    held in memory, as a driver without h5py holds them."""

    has_survival_time = False

    def __init__(self, ds):
        self.case_ids = list(ds.case_ids)
        self.labels = np.asarray(ds.labels)
        self.case_to_patient = dict(ds.case_to_patient)
        self._cases = {c: ds.get_case(c) for c in self.case_ids}

    def __len__(self):
        return len(self.case_ids)

    def get_case(self, case_id):
        return self._cases[case_id]


def test_run_trains_any_object_with_the_dataset_interface(fixture, tmp_path):
    """``cli.run`` (everything after the dataset is built) over the cases
    held in memory writes what ``main`` writes from the HDF5 files: the
    same splits, per-epoch histories and summary."""
    root, csv_path = fixture
    data = ["--csv_path", str(csv_path), "--data_root_dir", str(root), "--device", "cpu"]
    args = cli.parse_args(FLAGS + data + ["--results_dir", str(tmp_path / "mem")])
    table = _InMemory(MultimodalDataset(csv_path, root, args.target_channels))
    seed_everything(args.seed)
    mem = cli.run(args, table)
    files = cli.main(FLAGS + data + ["--results_dir", str(tmp_path / "h5")])
    for name in ("splits_0.csv", "splits_1.csv", "summary.csv"):
        assert (mem / name).read_text() == (files / name).read_text(), name
    for fold in (0, 1):  # the histories but their wall-clock column
        got, want = (_read_csv(d / f"fold_{fold}_epochs.csv") for d in (mem, files))
        assert got[0] == want[0] and len(got) == len(want) == 2
        timed = [i for i, h in enumerate(got[0]) if "time" in h]
        assert len(timed) == 1
        assert [r[: timed[0]] + r[timed[0] + 1:] for r in got] == \
            [r[: timed[0]] + r[timed[0] + 1:] for r in want]


def test_seed_everything_seeds_like_jax():
    jax_seed_everything(5)
    want = (random.random(), np.random.random())
    assert seed_everything(5) is None
    assert (random.random(), np.random.random()) == want
    a = torch.rand(3)
    seed_everything(5)
    assert torch.equal(torch.rand(3), a)

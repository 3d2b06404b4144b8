"""The port's serving path (``utils/results_io``, ``utils/predict``,
``cli/predict``, ``utils/serve``, ``cli/serve``) against the JAX package's
on the CPU.

One fixture serves both packages: an HDF5 dataset with ``time`` / ``event``
columns (the JAX package's ``make_synthetic_dataset``), one
``configs_flag.json`` written by the JAX package and read by both, and two
fold checkpoints of the flagship ``svd_gate_random_clam``, saved by the
JAX package and converted for the port by ``survival_params_from_jax``.
Tolerances: probabilities and risk within 1e-5 of the JAX package's; the
C-index within 1e-6 (BASELINE's bar is 0.005).
"""

import csv
import http.client
import json
import shutil
import threading

import numpy as np
import pytest
import torch
from flax import nnx

from multimodal_fusion_tpu import config as jconfig
from multimodal_fusion_tpu.data.multimodal import MultimodalDataset as JaxDataset
from multimodal_fusion_tpu.data.splits import FoldSplit as JaxFoldSplit
from multimodal_fusion_tpu.io.fixtures import make_synthetic_dataset
from multimodal_fusion_tpu.train import metrics as jmetrics
from multimodal_fusion_tpu.train.checkpoint import save_state as jax_save_state
from multimodal_fusion_tpu.train.survival import SurvivalTrainer as JaxTrainer
from multimodal_fusion_tpu.utils.predict import predict as jax_predict
from multimodal_fusion_tpu.utils.serve import make_server as jax_make_server
from multimodal_fusion_tpu_torch.cli import predict as cli_predict
from multimodal_fusion_tpu_torch.cli import serve as cli_serve
from multimodal_fusion_tpu_torch.config import Configs
from multimodal_fusion_tpu_torch.data.multimodal import MultimodalDataset
from multimodal_fusion_tpu_torch.data.splits import FoldSplit
from multimodal_fusion_tpu_torch.models.alignment import MultiModalAlignmentModel
from multimodal_fusion_tpu_torch.models.factory import ModelFactory
from multimodal_fusion_tpu_torch.models.jax_params import survival_params_from_jax
from multimodal_fusion_tpu_torch.train import metrics as tmetrics
from multimodal_fusion_tpu_torch.train.checkpoint import save_model
from multimodal_fusion_tpu_torch.train.survival import SurvivalTrainer
from multimodal_fusion_tpu_torch.utils import results_io
from multimodal_fusion_tpu_torch.utils.predict import predict
from multimodal_fusion_tpu_torch.utils.serve import make_server

CHANNELS = ["wsi=features", "tma=cd3=features", "tma=cd8=features", "clinical=val", "clinical=mask"]
FOLDS = (0, 1)
FLOAT_COLS = ("risk", "prob_0", "prob_1", "fold_0_prob_1", "fold_1_prob_1")


def _read_csv(path):
    with open(path, newline="") as f:
        return list(csv.DictReader(f))


def _write_csv(path, rows, fields):
    with open(path, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=fields)
        w.writeheader()
        w.writerows(rows)


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """(data root, labelled CSV, no-label CSV, JAX results dir, port
    results dir)."""
    root = tmp_path_factory.mktemp("serve")
    csv_path = make_synthetic_dataset(root, n_patients=10, seed=4, min_wsi_patches=4,
                                      max_wsi_patches=40, feature_dim=32, markers=("cd3", "cd8"))
    rng = np.random.default_rng(0)
    rows = _read_csv(csv_path)
    for r in rows:
        r["time"] = f"{rng.uniform(1, 60):.3f}"
        r["event"] = str(int(rng.random() < 0.6))
    _write_csv(csv_path, rows, list(rows[0]))
    nolabel = root / "nolabel.csv"
    _write_csv(nolabel, [{k: r[k] for k in ("patient_id", "case_id", "h5_file_path")} for r in rows],
               ["patient_id", "case_id", "h5_file_path"])

    mc = jconfig.ModelConfig(model_type="svd_gate_random_clam", n_classes=2, input_dim=32,
                             model_size="8*4", dropout=0.25, output_dim=16, inst_number=8,
                             base_weight=0.9, subtyping=True, channels_used_in_model=CHANNELS,
                             channel_input_dims={"clinical=val": 16})
    ec = jconfig.ExperimentConfig(exp_name="flag", seed=3, k_folds=2, batch_size=4,
                                  target_channels=CHANNELS)
    jres, pres = root / "jax_results", root / "port_results"
    jres.mkdir()
    pres.mkdir()
    jconfig.Configs(experiment_config=ec, model_config=mc).save(jres / "configs_flag.json")
    shutil.copy(jres / "configs_flag.json", pres / "configs_flag.json")
    jtr = JaxTrainer(jconfig.Configs.load(jres / "configs_flag.json"), jres)
    port_cfg = Configs.load(pres / "configs_flag.json")
    for fold in FOLDS:
        _, _, params, rest = jtr._build_model(fold)
        jax_save_state(jres / f"s_{fold}_checkpoint.npz", {"params": params, "rest": rest})
        model = ModelFactory.create_model(port_cfg.model_config, device="cpu")
        model.load_state_dict(survival_params_from_jax(nnx.to_pure_dict(params)))
        save_model(pres / f"s_{fold}_checkpoint.npz", model)
    return root, csv_path, nolabel, jres, pres


def _assert_rows_match(got, want):
    assert [list(r) for r in got] == [list(r) for r in want]  # columns, in order
    for g, w in zip(got, want):
        assert g["case_id"] == w["case_id"]
        assert str(g["patient_id"]) == str(w["patient_id"])
        assert int(g["prediction"]) == int(w["prediction"])
        for col in FLOAT_COLS:
            np.testing.assert_allclose(float(g[col]), float(w[col]), rtol=0, atol=1e-5, err_msg=col)


@pytest.mark.parametrize("labelled", [True, False])
def test_predict_matches_jax(served, tmp_path, labelled):
    root, csv_path, nolabel, jres, pres = served
    path = csv_path if labelled else nolabel
    want = jax_predict(jres, path, root, output_path=tmp_path / "jax" / "predictions")
    got = predict(pres, path, root, output_path=tmp_path / "port" / "predictions", device="cpu")
    assert got["n_cases_scored"] == want["n_cases_scored"] == 10
    assert got["n_cases_input"] == want["n_cases_input"] == 10
    assert got["folds"] == want["folds"] == list(FOLDS)
    _assert_rows_match(got["cases"], want["cases"])
    # the files: same schema, same rows
    _assert_rows_match(_read_csv(tmp_path / "port" / "predictions.csv"),
                       _read_csv(tmp_path / "jax" / "predictions.csv"))
    saved = json.loads((tmp_path / "port" / "predictions.json").read_text())
    assert set(saved) == set(json.loads((tmp_path / "jax" / "predictions.json").read_text()))
    if not labelled:  # the placeholder label changes no score
        labelled_rows = predict(pres, csv_path, root, output_path=tmp_path / "l", device="cpu")
        _assert_rows_match(got["cases"], labelled_rows["cases"])


def test_c_index_matches_jax(served, tmp_path):
    """Each fold's evaluate_fold (AUC, loss, C-index) and the C-index of
    the ensembled risk."""
    root, csv_path, _, jres, pres = served
    jds = JaxDataset(csv_path, root, CHANNELS)
    ds = MultimodalDataset(csv_path, root, CHANNELS)
    assert ds.has_survival_time and ds.case_ids == jds.case_ids
    jtr = JaxTrainer(jconfig.Configs.load(jres / "configs_flag.json"), jres)
    tr = SurvivalTrainer(Configs.load(pres / "configs_flag.json"), pres, device="cpu")
    idx = np.arange(len(ds))
    risks = []
    for fold in FOLDS:
        want = jtr.evaluate_fold(jds, JaxFoldSplit(idx[:0], idx[:0], idx), fold)
        got = tr.evaluate_fold(ds, FoldSplit(idx[:0], idx[:0], idx), fold)
        assert got["patient_ids"] == want["patient_ids"]
        np.testing.assert_allclose(got["risk"], want["risk"], rtol=0, atol=1e-5)
        assert abs(got["c_index"] - want["c_index"]) <= 1e-6
        assert abs(got["auc"] - want["auc"]) <= 1e-6
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
        risks.append(got["risk"])
    risk = np.mean(risks, axis=0)
    time = np.asarray([ds.case_to_time[c] for c in ds.case_ids])
    event = np.asarray([ds.case_to_event[c] for c in ds.case_ids])
    assert tmetrics.concordance_index(risk, time, event) == pytest.approx(
        jmetrics.concordance_index(risk, time, event), abs=1e-12)


class _Running:
    """An HTTP server on a thread, shut down on exit."""

    def __init__(self, httpd):
        self.httpd = httpd
        self.port = httpd.server_address[1]
        self.thread = threading.Thread(target=httpd.serve_forever, daemon=True)

    def __enter__(self):
        self.thread.start()
        return self

    def __exit__(self, *exc):
        self.httpd.shutdown()
        self.httpd.server_close()
        self.thread.join(timeout=30)
        assert not self.thread.is_alive()

    def request(self, method, path, body=None, headers=None):
        conn = http.client.HTTPConnection("127.0.0.1", self.port, timeout=300)
        try:
            conn.request(method, path, body=body, headers=headers or {})
            resp = conn.getresponse()
            return resp.status, json.loads(resp.read() or b"{}")
        finally:
            conn.close()


def test_scoring_server_matches_jax(served):
    root, csv_path, nolabel, jres, pres = served
    labelled = [dict(r) for r in _read_csv(csv_path)]
    unlabelled = [dict(r) for r in _read_csv(nolabel)]
    with _Running(make_server(pres, root, device="cpu")) as port, \
            _Running(jax_make_server(jres, root)) as jax_srv:
        status, health = port.request("GET", "/health")
        assert status == 200 and health["status"] == "ok"
        assert health["folds"] == list(FOLDS) and health["model_type"] == "svd_gate_random_clam"
        for rows in (labelled, unlabelled[:3]):
            body = json.dumps({"cases": rows})
            status, got = port.request("POST", "/predict", body)
            assert status == 200, got
            _, want = jax_srv.request("POST", "/predict", body)
            assert got["n_cases_scored"] == want["n_cases_scored"] == len(rows)
            _assert_rows_match(got["cases"], want["cases"])
        # malformed requests get a 400 and the server stays up
        for bad in (b"{not json", b"[1, 2]", json.dumps({"cases": [{"case_id": "x"}]}).encode(),
                    json.dumps({"cases": labelled, "drop_prob": 0.5}).encode()):
            status, err = port.request("POST", "/predict", bad)
            assert status == 400 and "error" in err
        status, _ = port.request("POST", "/predict", b"",
                                 headers={"Content-Length": str(65 * 1024 * 1024)})
        assert status == 413
        assert port.request("GET", "/nope")[0] == 404
        status, health = port.request("GET", "/health")
        assert status == 200 and health["requests"] == 2 and health["cases_scored"] == 13


def test_eval_steps_lru_is_bounded(served):
    root, _, _, _, pres = served
    scorer = make_server(pres, root, device="cpu")
    try:
        s = scorer.scorer
        steps = [s._eval_step(0, None), s._eval_step(1, None)]
        assert s._eval_step(0, None) is steps[0]
        with pytest.raises(ValueError, match="drop_prob"):
            s._eval_step(0, 0.25)  # not a *_detach model
        assert len(s._eval_steps) <= s._eval_steps_max == 8
    finally:
        scorer.server_close()


def test_clis_parse_and_predict(served, tmp_path, capsys):
    root, csv_path, _, _, pres = served
    res = cli_predict.main(["--results_dir", str(pres), "--csv_path", str(csv_path),
                            "--data_root_dir", str(root), "--folds", "1",
                            "--output_path", str(tmp_path / "p"), "--device", "cpu"])
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == {
        "n_cases_scored": 10, "folds": [1]}
    assert res["folds"] == [1] and (tmp_path / "p.csv").exists()
    args = cli_serve.build_parser().parse_args(
        ["--results_dir", "r", "--data_root_dir", "d", "--port", "0", "--device", "cpu"])
    assert (args.port, args.device, args.host) == (0, "cpu", "127.0.0.1")


def test_results_io(served, tmp_path):
    root, csv_path, _, _, pres = served
    assert results_io.discover_folds(pres) == list(FOLDS)
    configs = results_io.load_configs(pres)
    assert results_io.load_alignment(configs) == (None, None)
    assert len(results_io.build_dataset(configs, csv_path, root)) == 10
    with pytest.raises(FileNotFoundError):
        results_io.load_configs(tmp_path)
    ckpt = tmp_path / "align.npz"
    configs.experiment_config.alignment_model_path = str(ckpt)
    with pytest.raises(FileNotFoundError, match="alignment_model_path"):
        results_io.load_alignment(configs)
    model = MultiModalAlignmentModel(["tma=cd3=features"], feature_dim=32, num_layers=2,
                                     generator=torch.Generator().manual_seed(0))
    save_model(ckpt, model)
    configs.experiment_config.aligned_channels = ["tma=cd3=features"]
    fn, align = results_io.load_alignment(configs, "cpu")
    assert align == {"tma=cd3=features": "tma=cd3=features"}
    x = np.ones((3, 32), np.float32)
    want = model({"tma=cd3=features": torch.as_tensor(x)})["tma=cd3=features"].detach().numpy()
    np.testing.assert_array_equal(fn({"tma=cd3=features": x})["tma=cd3=features"], want)
    raw, _ = results_io.build_dataset(configs, csv_path, root, align=(fn, align)).get_case("patient_000")
    assert raw["aligned_tma=cd3=features"].shape == raw["tma=cd3=features"].shape

"""Long-lived HTTP scoring server over a trained survival results dir
(counterpart of ``multimodal_fusion_tpu.utils.serve``).

Where the one-shot ``utils.predict.predict`` bootstraps per invocation,
this server loads once and stays warm:

- the fold checkpoints load once at startup, into fold models that are
  built once and kept (in the compute dtype: a bfloat16 copy under
  ``compute_dtype="bfloat16"``);
- the alignment checkpoint, when the config names one, loads once at
  startup (``utils.results_io.load_alignment``);
- eval steps are kept per (fold, drop_prob) in an LRU bounded at four per
  fold, since ``drop_prob`` is client-supplied;
- requests serialize on a lock (one device, one queue); the HTTP layer is
  threaded, so health checks never wait behind scoring.

The JAX server also guards XLA:CPU's persistent compile cache
(``guard_cpu_compile_cache``); there is no compile cache here, so nothing
corresponds to it.

Protocol (JSON over HTTP, stdlib only):

    GET  /health    -> {"status": "ok", "folds": [...], "model_type": ...}
    POST /predict   {"cases": [{"patient_id", "case_id", "h5_file_path",
                                ("label")}, ...],
                     "drop_prob": optional float, "seed": optional int}
                    -> the row schema of ``predictions.csv``

The h5 paths resolve against the server's ``data_root_dir``, as in
training.
"""

from __future__ import annotations

import functools
import json
import tempfile
import threading
import time
from collections import OrderedDict
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np


class ScoringServer:
    """Trained-results-dir scorer with fold state kept across requests."""

    def __init__(self, results_dir: str | Path, data_root_dir: str | Path,
                 folds: Optional[Sequence[int]] = None, device=None):
        from multimodal_fusion_tpu_torch.train.checkpoint import load_model
        from multimodal_fusion_tpu_torch.train.survival import SurvivalTrainer
        from multimodal_fusion_tpu_torch.utils.results_io import (
            discover_folds,
            load_alignment,
            load_configs,
        )

        self.results_dir = Path(results_dir)
        self.data_root_dir = data_root_dir
        self.configs = load_configs(self.results_dir)
        self.trainer = SurvivalTrainer(self.configs, self.results_dir, device=device)
        self.folds = list(folds) if folds else discover_folds(self.results_dir)
        if not self.folds:
            raise FileNotFoundError(f"no s_<fold>_checkpoint.npz in {self.results_dir}")
        self.align = load_alignment(self.configs, device)
        self._lock = threading.Lock()
        self._models = {}
        for fold in self.folds:
            model = self.trainer._build_model(fold)
            load_model(self.results_dir / f"s_{fold}_checkpoint.npz", model)
            self._models[fold] = self.trainer._compute_model(model)
        self._eval_steps: "OrderedDict[tuple, Callable]" = OrderedDict()
        self._eval_steps_max = 4 * len(self.folds)
        self.stats = {"requests": 0, "cases_scored": 0, "busy_seconds": 0.0}

    def _eval_step(self, fold: int, drop_prob: Optional[float]) -> Callable:
        """The (fold, drop_prob) eval step: ``step(dataset, indices, seed)``.
        Like ``evaluate_fold`` it refuses ``drop_prob`` for a model that
        does not implement it."""
        key = (fold, drop_prob)
        if key not in self._eval_steps:
            model = self._models[fold]
            if drop_prob is not None and not getattr(model, "supports_drop_prob", False):
                raise ValueError(f"{type(model).__name__} does not support inference-time "
                                 "modality dropout (drop_prob); use a *_detach variant")
            self._eval_steps[key] = functools.partial(self._run_eval, model, drop_prob)
            while len(self._eval_steps) > self._eval_steps_max:
                self._eval_steps.popitem(last=False)
        else:
            self._eval_steps.move_to_end(key)
        return self._eval_steps[key]

    def _run_eval(self, model, drop_prob, dataset, indices, seed):
        return self.trainer._evaluate(dataset, indices, model, drop_prob=drop_prob, seed=seed)

    def score_rows(self, rows: List[Dict], drop_prob: Optional[float] = None,
                   seed: int = 0) -> Dict:
        """Score request rows ([{patient_id, case_id, h5_file_path, ...}])
        through every fold; mean-probability ensemble."""
        from multimodal_fusion_tpu_torch.utils import results_io
        from multimodal_fusion_tpu_torch.utils.predict import ensemble_rows, write_csv

        if not rows:
            raise ValueError("request contains no cases")
        if not all(isinstance(r, dict) for r in rows):
            raise ValueError("'cases' must be a list of objects")
        for col in ("patient_id", "case_id", "h5_file_path"):
            if any(col not in r for r in rows):
                raise ValueError(f"every case row needs a {col!r} field")
        rows_in = [{**r, "label": "unknown" if r.get("label") is None else r["label"]}
                   for r in rows]
        tmp = tempfile.NamedTemporaryFile("w", suffix=".csv", delete=False)
        tmp.close()
        try:
            write_csv(tmp.name, rows_in)
            dataset = results_io.build_dataset(self.configs, tmp.name, self.data_root_dir,
                                               align=self.align)
        finally:
            Path(tmp.name).unlink(missing_ok=True)
        if len(dataset) == 0:
            raise ValueError("no scoreable cases: every row was filtered by the dataset layer "
                             f"(missing h5 files or channels?); input rows={len(rows)}")
        idx = np.arange(len(dataset))
        per_fold: Dict[int, Dict] = {}
        with self._lock:
            t0 = time.perf_counter()
            for fold in self.folds:
                res = self._eval_step(fold, drop_prob)(dataset, idx, seed)
                per_fold[fold] = {"patient_ids": res["patient_ids"], "probs": res["probs"].tolist(),
                                  "risk": res["risk"].tolist()}
            self.stats["requests"] += 1
            self.stats["cases_scored"] += len(idx)
            self.stats["busy_seconds"] += time.perf_counter() - t0
        out = ensemble_rows(per_fold, self.folds, dataset.case_to_patient)
        return {
            "cases": out,
            "folds": list(self.folds),
            "n_cases_scored": len(out),
            "n_cases_input": len(rows),
            "drop_prob": drop_prob,
        }


class _Handler(BaseHTTPRequestHandler):
    server_version = "mmf-torch-serve/1.0"

    def _json(self, code: int, payload: Dict):
        body = json.dumps(payload).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def log_message(self, fmt, *args):  # quiet unless asked
        if getattr(self.server, "verbose", False):
            super().log_message(fmt, *args)

    def do_GET(self):
        if self.path == "/health":
            scorer: ScoringServer = self.server.scorer
            self._json(200, {
                "status": "ok",
                "folds": list(scorer.folds),
                "model_type": scorer.configs.model_config.get("model_type"),
                **scorer.stats,
            })
        else:
            self._json(404, {"error": f"unknown path {self.path}"})

    # requests carry row metadata (ids and h5 paths), not features: 64 MB
    # of JSON rows is already about 100k cases
    MAX_BODY_BYTES = 64 * 1024 * 1024

    def do_POST(self):
        if self.path != "/predict":
            self._json(404, {"error": f"unknown path {self.path}"})
            return
        try:
            n = int(self.headers.get("Content-Length", 0))
            if n > self.MAX_BODY_BYTES:
                self._json(413, {"error": f"request body {n} bytes exceeds {self.MAX_BODY_BYTES} "
                                          "(send case metadata, not features)"})
                return
            body = json.loads(self.rfile.read(n) or b"{}")
            if not isinstance(body, dict):
                raise ValueError("request body must be a JSON object")
            cases = body.get("cases") or []
            if not isinstance(cases, list):
                raise ValueError("'cases' must be a list of objects")
            drop = body.get("drop_prob")
            res = self.server.scorer.score_rows(
                cases, drop_prob=None if drop is None else float(drop),
                seed=int(body.get("seed", 0)))
            self._json(200, res)
        except (ValueError, TypeError, KeyError, FileNotFoundError, json.JSONDecodeError) as e:
            self._json(400, {"error": str(e)})
        except Exception as e:  # noqa: BLE001 — scoring must never kill the server
            self._json(500, {"error": f"{type(e).__name__}: {e}"})


def make_server(results_dir: str | Path, data_root_dir: str | Path, host: str = "127.0.0.1",
                port: int = 0, folds: Optional[Sequence[int]] = None, verbose: bool = False,
                device=None) -> ThreadingHTTPServer:
    """Bound but not yet serving HTTP server (call ``serve_forever()``);
    loads all fold state eagerly, so a bad results dir fails at startup.
    ``port=0`` binds an ephemeral port (``server.server_address[1]``);
    scoring runs on ``device`` (default: the CUDA card)."""
    scorer = ScoringServer(results_dir, data_root_dir, folds=folds, device=device)
    httpd = ThreadingHTTPServer((host, port), _Handler)
    httpd.scorer = scorer
    httpd.verbose = verbose
    return httpd

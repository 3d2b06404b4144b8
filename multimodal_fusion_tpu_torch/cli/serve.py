"""Serving CLI of the PyTorch port: a long-lived HTTP scoring endpoint over
a trained results dir.

Same flags as ``multimodal_fusion_tpu.cli.serve`` plus ``--device``
(default: the CUDA card)::

    python -m multimodal_fusion_tpu_torch.cli.serve \\
        --results_dir runs/exp1 --data_root_dir /data/slides --port 8860
    curl -s localhost:8860/health
    curl -s -X POST localhost:8860/predict -d \\
        '{"cases": [{"patient_id": "p1", "case_id": "c1", "h5_file_path": "c1.h5"}]}'

See ``utils/serve.py`` for the protocol.
"""

from __future__ import annotations

import argparse
import json

from multimodal_fusion_tpu_torch.cli import console_script
from multimodal_fusion_tpu_torch.utils.serve import make_server


def build_parser():
    p = argparse.ArgumentParser(
        description="HTTP scoring server for a trained survival results dir "
        "(GET /health, POST /predict)"
    )
    p.add_argument("--results_dir", type=str, required=True)
    p.add_argument("--data_root_dir", type=str, required=True,
                   help="root that request h5_file_path entries resolve against")
    p.add_argument("--host", type=str, default="127.0.0.1")
    p.add_argument("--port", type=int, default=8860,
                   help="0 binds an ephemeral port (printed on startup)")
    p.add_argument("--folds", type=int, nargs="*", default=None)
    p.add_argument("--verbose", action="store_true", help="log one line per HTTP request")
    p.add_argument("--device", type=str, default=None,
                   help="torch device; default: the CUDA card (cpu runs on the host)")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    httpd = make_server(args.results_dir, args.data_root_dir, host=args.host, port=args.port,
                        folds=args.folds or None, verbose=args.verbose, device=args.device)
    host, port = httpd.server_address[:2]
    print(json.dumps({
        "serving": f"http://{host}:{port}",
        "folds": list(httpd.scorer.folds),
        "endpoints": ["GET /health", "POST /predict"],
    }), flush=True)
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        httpd.server_close()


script_main = console_script(__name__)


if __name__ == "__main__":
    main()

"""Run one cell of ``BENCHMARK.json`` once, from the root of a checkout:

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer ones), ``device``, with ``--trace 1``
``breakdown``, and last ``checks``, each number compared with its limit,
which also end standard error.

Exit codes: 0 with a result; 2 without a CUDA card or with fewer than the
cell asks for; 3 where JAX or the JAX package was loaded; 1 on any other
failure.  None of them but 0 prints a result.

Caches stay inside the checkout at fixed paths, so only a checkout's first
run builds: the port's kernels build into ``multimodal_fusion_tpu_torch/_build/``
and any Triton or Inductor cache goes under ``.portbench_cache/``.
"""

import time

T0 = time.perf_counter()  # set-up is timed from the process's first line

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402
from pathlib import Path  # noqa: E402

CACHE = Path(__file__).resolve().parents[1] / ".portbench_cache"


def set_cache_dirs() -> None:
    """Every compiler cache the process may write, inside the checkout."""
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCHINDUCTOR_CACHE_DIR", "inductor"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
        os.environ[var] = str(CACHE / sub)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    set_cache_dirs()

    from portbench.harness.runner import ForbiddenModules, NoCard, print_result, run_cell

    try:
        result = run_cell(args.workload, args.seed, args.seconds, bool(args.trace), T0)
    except NoCard as exc:
        print(f"no result: {exc}", file=sys.stderr)
        return 2
    except ForbiddenModules as exc:
        print(f"no result: {exc}", file=sys.stderr)
        return 3
    except Exception:  # noqa: BLE001 - the run's boundary: report and fail
        traceback.print_exc()
        print("no result: the run failed", file=sys.stderr)
        return 1
    print_result(result)
    return 0


if __name__ == "__main__":
    sys.exit(main())

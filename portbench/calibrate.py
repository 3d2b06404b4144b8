"""Readings for a cell's limits, on the card, in one process:

    python3 -m portbench.calibrate --workload <cell> --seconds <s> \\
        --seeds <n> ... [--control-seeds <n> ...] [--faults <name> ...] [--fault-seeds <n> ...]

For each of ``--seeds`` a whole run of the cell (a short window) and its
compared numbers: the program's readings, whose largest is a limit's lower
reading.  For each of ``--control-seeds`` the entry's ``control``: the
reference in the precision below the configuration's, put in the program's
place, whose smallest reading is the upper one.  For each fault of the
entry's ``FAULTS`` named in ``--faults`` and each of ``--fault-seeds`` a
run with the fault planted in the program.  One JSON line a reading goes to
standard output, and a summary last.  Benchmark runs never run this.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from collections import defaultdict  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--seeds", type=int, nargs="*", default=[])
    p.add_argument("--control-seeds", type=int, nargs="*", default=[])
    p.add_argument("--faults", nargs="*", default=[])
    p.add_argument("--fault-seeds", type=int, nargs="*", default=[])
    args = p.parse_args(argv)

    from portbench.run import set_cache_dirs

    set_cache_dirs()
    import torch

    from portbench.harness import manifest
    from portbench.harness.runner import check_card, run_cell

    cell = manifest.load_cell(args.workload)
    dev = check_card(cell.chips)
    entry = manifest.entry(cell.entry)
    summary = defaultdict(list)

    def emit(kind, seed, readings, extra=None):
        line = {"kind": kind, "seed": seed, "readings": readings, **(extra or {})}
        print(json.dumps(line), flush=True)
        for name, value in readings.items():
            summary[f"{kind}.{name}"].append(value)

    def checks(result):
        return {k: c["value"] for k, c in result["checks"].items()}

    def settle():
        gc.collect()
        torch.cuda.empty_cache()

    for seed in args.seeds:
        t0 = T0 if seed == args.seeds[0] else time.perf_counter()
        result = run_cell(args.workload, seed, args.seconds, False, t0)
        emit("program", seed, checks(result), {"correct": result["correct"],
                                               "metrics": result["metrics"]})
        settle()
    for seed in args.control_seeds:
        emit("control", seed, entry.control(cell, seed, dev))
        settle()
    for fault in args.faults:
        for seed in args.fault_seeds:
            with entry.FAULTS[fault]():
                result = run_cell(args.workload, seed, args.seconds, False, time.perf_counter())
            emit(f"fault.{fault}", seed, checks(result), {"correct": result["correct"]})
            settle()
    print(json.dumps({"summary": {k: {"min": min(v, key=_num), "max": max(v, key=_num)}
                                  for k, v in summary.items()}}), flush=True)
    return 0


def _num(v):
    return float("inf") if v is None else v


if __name__ == "__main__":
    sys.exit(main())

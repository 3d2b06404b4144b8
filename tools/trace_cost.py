#!/usr/bin/env python3
"""The cost of the program's tracer (``utils/profiling.py``): each
benchmark cell's measured window run with the tracer off and on, in turns,
on one CUDA card, with no profiler.

    python3 tools/trace_cost.py --seed N [--seconds 10] [--pairs 3] [--cells CELL ...]

For each cell one entry of ``portbench`` is set up (as a benchmark run sets
it up from the cell and the seed), then driven through ``2 x pairs``
windows of ``seconds`` each, whole steps, a synchronize closing each:
off, on, on, off, off, on, ...  Each window prints one JSON line (its
rate in the entry's units per second and, on, the spans it recorded); each
cell ends in a line with the median rate of each side and their ratio,
on over off.  Run from the repo root.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import json
import statistics
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from multimodal_fusion_tpu_torch.utils import profiling  # noqa: E402
from portbench.harness import manifest  # noqa: E402
from portbench.harness.runner import Spans  # noqa: E402


def window(entry, seconds: float, traced: bool) -> dict:
    profiling.reset()
    gc.collect()
    units, steps = 0, 0
    torch.cuda.synchronize()
    with profiling.tracing() if traced else contextlib.nullcontext():
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            units += entry.step()[0]
            steps += 1
        torch.cuda.synchronize()
        elapsed = time.perf_counter() - t0
    return {"traced": traced, "steps": steps, "units": units, "seconds": elapsed,
            "rate": units / elapsed, "spans": len(profiling.records())}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, default=10.0)
    p.add_argument("--pairs", type=int, default=3)
    p.add_argument("--cells", nargs="*", default=None)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    cells = args.cells or [w["name"] for w in manifest.manifest()["workloads"]]
    for name in cells:
        cell = manifest.load_cell(name)
        entry = manifest.entry(cell.entry).Entry(cell, args.seed, device, Spans())
        runs = []
        for k in range(2 * args.pairs):
            traced = k % 4 in (1, 2)  # off, on, on, off, ...
            runs.append(window(entry, args.seconds, traced))
            print(json.dumps({"cell": name, **runs[-1]}), flush=True)
        entry.release()
        del entry
        gc.collect()
        torch.cuda.empty_cache()
        off = statistics.median(r["rate"] for r in runs if not r["traced"])
        on = statistics.median(r["rate"] for r in runs if r["traced"])
        print(json.dumps({"cell": name, "card": torch.cuda.get_device_name(device),
                          "rate_off": off, "rate_on": on, "on_over_off": on / off}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

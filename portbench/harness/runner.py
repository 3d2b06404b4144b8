"""One run of one cell: set-up, the measured window, the traced window, the
check against the plain reference, and the result line.

The order is the contract's: the set-up (the process's start, imports,
inputs and weights drawn on the device, the entry's warm-up) is timed as
``setup_s``; the measured window runs whole steps until ``seconds`` have
passed and ends in a synchronize; with ``trace`` a second, profiled window
follows; the peak memory is read; the program's state is freed; then the
reference checks what the timed path produced; and the process must not
hold JAX when the result is printed.
"""

from __future__ import annotations

import contextlib
import gc
import json
import math
import sys
import time
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import torch

from portbench.harness import counters, guard, manifest
from portbench.harness.peaks import Peaks, peaks, power_line
from portbench.harness.readers import KERNELS
from portbench.harness.trace import Trace, breakdown, cuda_sync, no_sync, traced_window

TRACE_SECONDS = 4.0  # the profiled window's length (at most the run's)


class NoCard(RuntimeError):
    """No CUDA card, or fewer than the cell asks for."""


class ForbiddenModules(RuntimeError):
    """JAX or the JAX package was loaded in the process."""


class Spans:
    """Host-clock spans the entries record around their calls into the
    program, by name; each is also a ``record_function`` range, so the
    traced window's idle gaps can name it."""

    def __init__(self):
        self.seconds: Dict[str, List[float]] = defaultdict(list)

    @contextlib.contextmanager
    def __call__(self, name: str):
        with torch.profiler.record_function(name):
            t0 = time.perf_counter()
            try:
                yield
            finally:
                self.seconds[name].append(time.perf_counter() - t0)

    def clear(self) -> None:
        self.seconds.clear()


def add_work(total: Dict[str, Any], work: Dict[str, Any]) -> None:
    """Add one step's counts (numbers, and lists of per-launch (ops, bytes)
    under ``kernels``) into ``total``."""
    for key, value in work.items():
        if key == "kernels":
            kernels = total.setdefault("kernels", {})
            for name, launches in value.items():
                kernels.setdefault(name, []).extend(launches)
        else:
            total[key] = total.get(key, 0) + value


@dataclass
class Run:
    """What the metric readers read."""

    cell: manifest.Cell
    peaks: Optional[Peaks]  # None off the card
    dtype: str  # the configuration's compute dtype
    setup_s: float
    window_s: float
    units: int  # cases or patches completed in the measured window
    spans: Dict[str, List[float]]
    work: Dict[str, Any]  # the reference's counts over the measured window
    calls: Dict[str, int]  # the program's kernel calls over the measured window (counters)
    trace: Optional[Trace] = None
    trace_work: Dict[str, Any] = field(default_factory=dict)  # ... over the traced window


def check_card(chips: int) -> torch.device:
    if not torch.cuda.is_available():
        raise NoCard("torch.cuda.is_available() is False: this benchmark runs on a CUDA card")
    if torch.cuda.device_count() < chips:
        raise NoCard(f"the cell asks for {chips} cards, torch.cuda.device_count() is "
                     f"{torch.cuda.device_count()}")
    return torch.device("cuda", 0)


def compare(readings: Dict[str, float], limits: Dict[str, float]) -> Dict[str, Dict[str, Any]]:
    """Each reading beside its limit, in the limits' order; a limit without
    a reading, or a reading that is not finite, has the value None and
    fails."""
    out = {}
    for name, limit in limits.items():
        value = float(readings.get(name, math.nan))
        out[name] = {"value": value if math.isfinite(value) else None, "limit": float(limit)}
    return out


def passes(check: Dict[str, Any]) -> bool:
    return check["value"] is not None and check["value"] <= check["limit"]


def run_cell(workload: str, seed: int, seconds: float, trace: bool, t0: float,
             device: Optional[str] = None, override: Optional[Dict] = None) -> Dict[str, Any]:
    """The result line's object of one run.  ``device`` None means the CUDA
    card, looked for first (``NoCard``); the CPU tests pass "cpu" and an
    ``override`` that shrinks the cell."""
    cell = manifest.load_cell(workload, override=override)
    dev = check_card(cell.chips) if device is None else torch.device(device)
    on_card = dev.type == "cuda"
    sync = cuda_sync if on_card else no_sync
    kind = torch.cuda.get_device_name(dev) if on_card else dev.type
    row = peaks(kind) if on_card else None
    if on_card:
        print(f"card: {power_line()}", file=sys.stderr, flush=True)

    spans = Spans()
    reference = manifest.reference(cell.config["reference"])
    entry_module = manifest.entry(cell.entry)
    t_entry = time.perf_counter()
    entry = entry_module.Entry(cell, seed, dev, spans)
    sync()
    setup_s = time.perf_counter() - t0
    print(f"set-up: {setup_s:.3f} s, {time.perf_counter() - t_entry:.3f} s of it the entry's "
          f"(inputs, weights, warm-up)", file=sys.stderr)

    # the measured window, from a collected heap
    gc.collect()
    spans.clear()
    records = []
    units = 0
    calls_before = counters.calls()
    start = time.perf_counter()
    while time.perf_counter() - start < seconds:
        done, record = entry.step()
        units += done
        records.append(record)
    sync()
    window_s = time.perf_counter() - start
    calls = {k: n - calls_before[k] for k, n in counters.calls().items()}
    work: Dict[str, Any] = {}
    for record in records:  # counted after the window, outside its time
        add_work(work, reference.count(cell.config, record))
    run = Run(cell=cell, peaks=row, dtype=cell.config.get("compute_dtype", "float32"),
              setup_s=setup_s, window_s=window_s, units=units,
              spans={k: list(v) for k, v in spans.seconds.items()}, work=work, calls=calls)

    print(f"measured window: {len(records)} steps, {units} {entry.unit}, {window_s:.3f} s",
          file=sys.stderr)
    if trace:
        run.trace = traced_window(entry.step, min(TRACE_SECONDS, seconds), sync, counters.calls)
        if run.trace is not None:
            for record in run.trace.records:
                add_work(run.trace_work, reference.count(cell.config, record))
            launches = {k: sum(n for name, n in run.trace.op_n.items() if pattern.search(name))
                        for k, pattern in KERNELS.items()}
            print(f"traced window: {len(run.trace.records)} steps, {run.trace.window_s:.3f} s, "
                  f"busy {run.trace.busy_s:.3f} s, kernel launches {launches}, program calls "
                  f"{run.trace.calls}, counted "
                  f"{ {k: len(v) for k, v in run.trace_work.get('kernels', {}).items()} }",
                  file=sys.stderr)
    memory_peak = torch.cuda.max_memory_allocated(dev) if on_card else 0

    entry.release()
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    checks = compare(entry.check(), cell.limits)
    failed = int(entry.failed)
    correct = failed == 0 and all(passes(c) for c in checks.values())

    found = guard.loaded()
    if found:
        raise ForbiddenModules(f"modules loaded in the process: {', '.join(found)}")

    metrics = {}
    for metric in (cell.per_layer if trace else cell.end_to_end):
        value = manifest.reader(metric["name"])(run)
        if value is not None:
            metrics[metric["name"]] = {"value": float(value), "unit": metric["unit"]}
    device_info: Dict[str, Any] = {"platform": "gpu" if on_card else dev.type, "kind": kind,
                                   "count": cell.chips if on_card else 0,
                                   "memory_peak_bytes": int(memory_peak)}
    result: Dict[str, Any] = {"correct": correct, "attempted": units + failed, "failed": failed,
                              "metrics": metrics, "device": device_info}
    if run.trace is not None:
        device_info["busy_s"] = run.trace.busy_s
        device_info["window_s"] = run.trace.window_s
        result["breakdown"] = breakdown(run.trace)
    result["checks"] = checks
    return result


def print_result(result: Dict[str, Any]) -> None:
    """The result as the last line of standard output, then each compared
    number beside its limit as the last lines of standard error."""
    print(json.dumps(result), flush=True)
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(f"correct {result['correct']}", file=sys.stderr, flush=True)

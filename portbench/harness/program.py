"""The program's own spans and counters (``multimodal_fusion_tpu_torch.utils.profiling``),
read in a window of their own.

The run's two windows stay as they are: the measured one untraced, the
profiled one with the program's tracer off.  The metrics that read the
program's spans and counters get a third, the program window, run once per
run by the first of them the harness reads (after the run's check): a
fresh entry of the run's cell and seed, set up as the run's was, steps for
``PROGRAM_SECONDS`` (whole steps, at least one; no longer than the measured
window) with the tracer on, and on the card under ``torch.profiler``.

Each device op of the profile goes to the innermost program span open when
its launch was issued: the launch's host time is the midpoint of the
runtime call with the op's CUPTI correlation id, or else that of the host
op the profiler links to it (``linked_correlation_id``); an op with neither
goes to the innermost program span whose ``gpu_user_annotation`` range
holds it on the device.  Device seconds are summed by span, each span's
sum holding its children's, and what falls outside every span is logged.

A program without the tracer (before ``utils.profiling.span`` existed)
gives no window, and every reader None.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import sys
import time
import traceback
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Tuple

import torch

from portbench.harness import manifest
from portbench.harness.trace import _attribute, _is_device_op, _union

PROGRAM_SECONDS = 2.0
LAUNCHES = ("cuda_runtime", "cuda_driver")  # kineto's activity types of host launch calls


@dataclass
class Window:
    steps: int
    seconds: float
    records: List[Tuple[str, int, int, Optional[int]]]  # the tracer's spans
    counts: Dict[str, int]  # the program's counters over the window
    device_s: Optional[Dict[str, float]] = None  # device seconds by span, children included
    outside_s: float = 0.0  # device seconds of ops launched outside every span
    busy_s: float = 0.0  # union of the device ops' intervals
    notes: Dict = field(default_factory=dict)  # ops placed by method, the clock check


def tracer():
    """The program's tracer module; None where the program has none."""
    try:
        from multimodal_fusion_tpu_torch.utils import profiling
    except ImportError:
        return None
    return profiling if hasattr(profiling, "tracing") else None


def process_seed(default: int = 0) -> int:
    """The ``--seed`` the process was started with (``portbench.run``)."""
    p = argparse.ArgumentParser(add_help=False, allow_abbrev=False)
    p.add_argument("--seed", type=int, default=default)
    return p.parse_known_args(sys.argv[1:])[0].seed


def ancestors(records) -> Dict[str, set]:
    """Each span name -> the names of the spans ever open around it."""
    out: Dict[str, set] = defaultdict(set)
    for name, _, _, parent in records:
        while parent is not None:
            out[name].add(records[parent][0])
            parent = records[parent][3]
    return out


def innermost(records, times: Iterable[Tuple[int, int]]) -> Dict[int, Optional[int]]:
    """For each (key, host ns) the index of the innermost record open at
    that time, or None: a sweep over the times in order, with the records
    open at the time on a stack (one thread's records nest, so the stack
    is a chain, innermost on top)."""
    order = sorted(range(len(records)), key=lambda i: records[i][1])
    out: Dict[int, Optional[int]] = {}
    stack: List[int] = []
    j = 0
    for key, t in sorted(times, key=lambda kt: kt[1]):
        while j < len(order) and records[order[j]][1] <= t:
            start = records[order[j]][1]
            while stack and records[stack[-1]][2] < start:
                stack.pop()
            stack.append(order[j])
            j += 1
        while stack and records[stack[-1]][2] < t:
            stack.pop()
        out[key] = stack[-1] if stack else None
    return out


def _is_launch(e) -> bool:
    """A CUDA runtime or driver call on the host (``cudaLaunchKernel``,
    ``cuLaunchKernel``, ``cudaMemcpyAsync``, ...); by name where kineto's
    events carry no activity type (as torch 2.11's do)."""
    kind = getattr(e, "activity_type", None)
    if kind is not None:
        return kind() in LAUNCHES
    return e.name().startswith("cu")


def clock_gap_us(ranges, records) -> Optional[Tuple[float, float]]:
    """The least and the largest distance, µs, from an end of a record to
    the same end of the profiler's range of its span (the k-th range of a
    name against the k-th record of it), measured inward: the least is
    negative where a record sticks out of its range.  None where the
    counts differ."""
    by_name: Dict[str, List] = defaultdict(list)
    for a, b, name in sorted(ranges):
        by_name[name].append((a, b))
    seen: Dict[str, int] = defaultdict(int)
    gaps = []
    for name, start, end, _ in records:
        k = seen[name]
        seen[name] += 1
        if k >= len(by_name[name]):
            return None
        a, b = by_name[name][k]
        gaps += [start - a, b - end]
    if not gaps or any(len(v) != seen[k] for k, v in by_name.items()):
        return None
    return min(gaps) / 1e3, max(gaps) / 1e3


def attribute(events, records) -> Optional[Tuple[Dict[str, float], float, float, Dict]]:
    """(device seconds by span name, children included; seconds outside
    every span; busy seconds; notes: device ops placed by method, the
    clock check ``clock_gap_us``, and ``idle_s``, the device's idle gaps
    by the innermost span open at their midpoint) of a profile's events;
    None where it holds no device op."""
    from torch.autograd import DeviceType

    ops, launch_ns, frontend_ns, annotations, ranges = [], {}, {}, [], []
    names = {r[0] for r in records}
    for e in events:
        a, d = e.start_ns(), e.duration_ns()
        if _is_device_op(e, DeviceType.CUDA):
            ops.append(e)
        elif e.device_type() == DeviceType.CPU:  # a host op's midpoint lies inside its spans
            (launch_ns if _is_launch(e) else frontend_ns)[e.correlation_id()] = a + d // 2
            if e.name() in names:
                ranges.append((a, a + d, e.name()))
        elif e.is_user_annotation() and e.name() in names:
            annotations.append((a, a + d, e.name()))
    if not ops:
        return None
    host, placed = [], defaultdict(int)
    for k, e in enumerate(ops):
        t = launch_ns.get(e.correlation_id())
        if t is None:
            t = frontend_ns.get(e.linked_correlation_id())
        if t is not None:
            host.append((k, t))
    owner_of = innermost(records, host)
    up = ancestors(records)
    device_s: Dict[str, float] = defaultdict(float)
    outside = 0.0
    for k, e in enumerate(ops):
        s = e.duration_ns() / 1e9
        if k in owner_of:
            owner = owner_of[k]
            name = None if owner is None else records[owner][0]
            placed["launch"] += 1
        else:
            a, b = e.start_ns(), e.start_ns() + e.duration_ns()
            inside = [x for x in annotations if x[0] <= a and b <= x[1]]
            name = min(inside, key=lambda x: x[1] - x[0])[2] if inside else None
            placed["annotation" if inside else "unplaced"] += 1
        if name is None:
            outside += s
            continue
        for n in {name} | up[name]:
            device_s[n] += s
    busy, gaps = _union([(e.start_ns(), e.start_ns() + e.duration_ns()) for e in ops])
    idle = _attribute([(a, b, name) for name, a, b, _ in records], gaps)
    notes = dict(placed, clock_gap_us=clock_gap_us(ranges, records),
                 idle_s=dict(sorted(idle.items(), key=lambda kv: -kv[1])))
    return dict(device_s), outside, busy / 1e9, notes


_LAST: List = [None, None]  # (the run, its window)


def window(run) -> Optional[Window]:
    """The program window of ``run``, run on the first call and kept."""
    if _LAST[0] is run:
        return _LAST[1]
    _LAST[:] = [run, None]
    profiling = tracer()
    if profiling is None:
        return None
    try:
        _LAST[1] = _run_window(run, profiling)
    except Exception:  # noqa: BLE001 - the readers' boundary: log, read nothing
        traceback.print_exc()
        print("program window failed: its metrics are not read", file=sys.stderr)
    return _LAST[1]


def _run_window(run, profiling) -> Window:
    from portbench.harness.runner import Spans

    on_card = torch.cuda.is_available()
    device = torch.device("cuda", 0) if on_card else torch.device("cpu")
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    t_entry = time.perf_counter()
    entry = manifest.entry(run.cell.entry).Entry(run.cell, process_seed(), device, Spans())
    seconds = min(PROGRAM_SECONDS, run.window_s)
    for attempt in range(2 if on_card else 1):  # CUPTI now and then misses a whole profile
        profiling.reset()
        steps = 0
        prof = _profile() if on_card else None
        with prof if prof is not None else contextlib.nullcontext(), profiling.tracing():
            sync()
            t0 = time.perf_counter()
            while steps == 0 or time.perf_counter() - t0 < seconds:
                entry.step()
                steps += 1
            sync()
            elapsed = time.perf_counter() - t0
        w = Window(steps=steps, seconds=elapsed, records=profiling.records(),
                   counts=profiling.counters())
        if prof is not None:
            reduced = attribute(prof.profiler.kineto_results.events(), w.records)
            if reduced is None:
                print(f"program window {attempt + 1}: the profile saw no device time",
                      file=sys.stderr)
                continue
            w.device_s, w.outside_s, w.busy_s, w.notes = reduced
        break
    profiling.reset()
    entry.release()
    del entry
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    _log(run, w, profiling, time.perf_counter() - t_entry)
    return w


def _profile():
    from torch.profiler import ProfilerActivity, profile

    return profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])


def _log(run, w: Window, profiling, wall_s: float) -> None:
    host = {k: round(v["self_s"], 6) for k, v in profiling.summary(w.records).items()}
    print(f"program window: {w.steps} steps, {w.seconds:.3f} s ({wall_s:.3f} s with its set-up); "
          f"host self seconds by span {host}; counters {w.counts}", file=sys.stderr)
    if w.device_s is not None:
        notes = dict(w.notes, idle_s={k: round(v, 6) for k, v in w.notes["idle_s"].items()})
        print(f"program window: device seconds by span (children included) "
              f"{ {k: round(v, 6) for k, v in sorted(w.device_s.items())} }, outside every span "
              f"{w.outside_s:.6f} s, busy {w.busy_s:.6f} s; {notes}",
              file=sys.stderr)
    rows, patches = w.counts.get("extract.rows", 0), w.counts.get("extract.patches", 0)
    if rows:
        from portbench.harness.readers import pad_share

        config = run.cell.config
        share = pad_share(run, int(config["model"]["depth"]),
                          int(config["extraction"]["batch_size"]))
        beside = "not read" if share is None else f"{share:.4f}%"
        print(f"program window: (extract.rows - extract.patches) / extract.rows = "
              f"{100.0 * (rows - patches) / rows:.4f}% ({rows} rows, {patches} patches); "
              f"pad_share.extract {beside}", file=sys.stderr)


def device_ms_per_window(run, name: str) -> Optional[float]:
    """Device ms of the ops launched inside the span ``name`` per
    ``train.window``."""
    w = window(run)
    if w is None or w.device_s is None:
        return None
    windows = sum(1 for r in w.records if r[0] == "train.window")
    if not windows or name not in w.device_s:
        return None
    return 1e3 * w.device_s[name] / windows


def host_ms_per(run, names: Tuple[str, ...], per: str) -> Optional[float]:
    """Host ms of the spans ``names`` per span ``per``."""
    w = window(run)
    if w is None:
        return None
    n = sum(1 for r in w.records if r[0] == per)
    if not n:
        return None
    return sum(r[2] - r[1] for r in w.records if r[0] in names) / 1e6 / n


def ratio(run, num: str, den: str) -> Optional[float]:
    """Counter ``num`` over counter ``den`` over the window."""
    w = window(run)
    if w is None or not w.counts.get(den):
        return None
    return w.counts.get(num, 0) / w.counts[den]

"""The traced window: ``torch.profiler`` over whole steps, reduced to the
device's busy time, the time of each device op by name, and the idle gaps
of the device timeline by what the host was doing meanwhile."""

from __future__ import annotations

import heapq
import re
import sys
import time
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

import torch

STEP = "bench.step"  # the span around each step of the traced window
DEVICE_OPS = ("kernel", "gpu_memcpy", "gpu_memset")  # kineto's activity types of device work


@dataclass
class Trace:
    window_s: float  # host clock over the traced steps, the closing sync included
    busy_s: float  # union of the device ops' intervals
    op_s: Dict[str, float]  # device seconds by op name (kernels, copies, sets)
    op_n: Dict[str, int]  # launches by op name
    gaps_s: Dict[str, float]  # idle seconds by the innermost host op open in the gap
    records: List = field(default_factory=list)  # the entries' per-step records
    calls: Dict[str, int] = field(default_factory=dict)  # the program's counted calls, by kernel


def short(name: str) -> str:
    """An op name as the ledger keeps it: letters, digits and ``_:.-``, at
    most 64 characters."""
    return re.sub(r"[^A-Za-z0-9_:.-]", "_", name)[:64]


def _union(intervals: List[Tuple[int, int]]):
    """(busy ns, the gaps between merged intervals as (start, end))."""
    intervals.sort()
    busy, gaps = 0, []
    start, end = intervals[0]
    for a, b in intervals[1:]:
        if a > end:
            busy += end - start
            gaps.append((end, a))
            start, end = a, b
        else:
            end = max(end, b)
    busy += end - start
    return busy, gaps


def _attribute(host: List[Tuple[int, int, str]], gaps: List[Tuple[int, int]]) -> Dict[str, float]:
    """Idle seconds by the shortest host op open at each gap's midpoint (a
    sweep over the midpoints in order, with the open ops in a heap by
    length; an op that has closed leaves the heap when it reaches the top)."""
    out: Dict[str, float] = defaultdict(float)
    host = sorted(host)
    heap: List[Tuple[int, int, str]] = []
    i = 0
    for a, b in sorted(gaps, key=lambda g: g[0] + g[1]):
        mid = (a + b) // 2
        while i < len(host) and host[i][0] <= mid:
            s, e, name = host[i]
            heapq.heappush(heap, (e - s, e, name))
            i += 1
        while heap and heap[0][1] < mid:
            heapq.heappop(heap)
        out[heap[0][2] if heap else "host: outside any operator"] += (b - a) / 1e9
    return out


def _is_device_op(e, cuda) -> bool:
    """A kernel, copy or set on the device; not the device-side span that
    the profiler draws for a host annotation."""
    kind = getattr(e, "activity_type", None)
    if kind is not None:
        return kind() in DEVICE_OPS
    return e.device_type() == cuda and not e.is_user_annotation()


def reduce(prof) -> Optional[Tuple[int, Dict[str, float], Dict[str, int], Dict[str, float]]]:
    """(busy ns, device seconds by op, launches by op, idle seconds by host
    op) of a profile; None where it holds no device op."""
    from torch.autograd import DeviceType

    device, host = [], []
    op_s: Dict[str, float] = defaultdict(float)
    op_n: Dict[str, int] = defaultdict(int)
    for e in prof.profiler.kineto_results.events():
        a, d = e.start_ns(), e.duration_ns()
        if _is_device_op(e, DeviceType.CUDA):
            device.append((a, a + d))
            op_s[e.name()] += d / 1e9
            op_n[e.name()] += 1
        elif e.device_type() == DeviceType.CPU and d > 0:
            host.append((a, a + d, e.name()))
    if not device:
        return None
    busy, gaps = _union(device)
    steps = [(a, b) for a, b, n in host if n == STEP]
    if steps:  # the stretch of the window before the first device op
        first = min(a for a, _ in device)
        if first > steps[0][0]:
            gaps.append((steps[0][0], first))
    gaps_s = _attribute(host, gaps)
    return busy, dict(op_s), dict(op_n), dict(gaps_s)


def traced_window(step: Callable[[], Tuple[int, object]], seconds: float,
                  sync: Callable[[], None], calls: Callable[[], Dict[str, int]] = dict,
                  attempts: int = 3) -> Optional[Trace]:
    """Run ``step`` for ``seconds`` under the profiler, whole steps only, and
    reduce the profile; ``calls`` reads the program's counters, before and
    after.  A profile that sees no device time (CUPTI on the card has been
    seen to miss a whole profile) is taken again, up to ``attempts`` times;
    then None: the device metrics are not measured."""
    from torch.profiler import ProfilerActivity, profile, record_function

    for attempt in range(attempts):
        records = []
        before = calls()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            sync()
            t0 = time.perf_counter()
            while time.perf_counter() - t0 < seconds:
                with record_function(STEP):
                    records.append(step()[1])
            sync()
            window = time.perf_counter() - t0
        made = {k: n - before[k] for k, n in calls().items()}
        reduced = reduce(prof)
        if reduced is not None:
            busy, op_s, op_n, gaps_s = reduced
            return Trace(window_s=window, busy_s=busy / 1e9, op_s=op_s, op_n=op_n, gaps_s=gaps_s,
                         records=records, calls=made)
        print(f"profile {attempt + 1} saw no device time", file=sys.stderr)
    return None


def breakdown(trace: Trace, top: int = 10) -> Dict[str, List]:
    """The device ops that took most time and the longest idle stretches by
    host op, ``top`` of each, as the result line carries them."""
    def rank(d: Dict[str, float]) -> List:
        merged: Dict[str, float] = defaultdict(float)
        for k, v in d.items():
            merged[short(k)] += v
        return [[k, v] for k, v in sorted(merged.items(), key=lambda kv: kv[1], reverse=True)[:top]]

    return {"device_ops": rank(trace.op_s), "idle_gaps": rank(trace.gaps_s)}


def no_sync() -> None:
    pass


def cuda_sync() -> None:
    torch.cuda.synchronize()

"""Profiling utilities (counterpart of ``multimodal_fusion_tpu.utils.profiling``).

The program's tracer: :func:`span` marks a stretch of host work by name,
:func:`count` adds to a named counter.  Spans record only inside a
:func:`tracing` block; outside it ``span`` returns one shared no-op
context, which reads no clock and opens no profiler range.  Inside it a
span appends ``(name, start_ns, end_ns, parent)`` to an in-memory list
(``parent`` the index of the span open around it on the same thread, or
None) and opens a ``torch.profiler.record_function`` range of its name, so
a running profiler draws it on the timeline of the device's ops.  The
timestamps are ``time.time_ns()``, the clock kineto's events are given in
(nanoseconds since the Unix epoch), so a record can be laid over a
profile.  Counters are always on: plain integer adds.

The spans and counters the port records:

- ``train/survival.py:window_step``: ``train.window``, tiled by
  ``train.forward`` (the model, its losses and any group loss),
  ``train.backward`` (``zero_grad``, ``backward``, the gradients'
  all-reduce) and ``train.optimizer`` (``optimizer.step``);
- ``data/tma_extraction.py``: ``extract.core`` around each core of
  ``extract_marker_features``, with ``extract.cut`` (the patches cut),
  ``extract.stage`` (the pinned buffer filled) and ``extract.wait`` (the
  one wait for the device) inside it; counters ``extract.cores``,
  ``extract.waits``, ``extract.rows`` (rows the encoder ran, padding
  included) and ``extract.patches`` (the real rows among them);
- ``models/vit.py``: ``vit.attention`` and ``vit.mlp`` tiling each block
  of the encoder; counters ``vit.batches`` (one a forward) and
  ``vit.tokens`` (the forward's rows times its tokens);
- :class:`StageTimer`'s stages, under their own names.

The reference's opt-in wall-clock stage profiler
(``alignment/trainer.py:88-102,442-507``) is :class:`StageTimer`;
:func:`device_trace` is a ``torch.profiler`` context that writes a Chrome
trace with the tracer on, so the trace holds the spans above beside the
card's kernels when CUDA is available.
"""

from __future__ import annotations

import contextlib
import threading
import time
from collections import defaultdict
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import torch

Record = Tuple[str, int, int, Optional[int]]  # (name, start_ns, end_ns, parent index)


class _NoSpan:
    """The span of a tracer that is off: nothing at all."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NO_SPAN = _NoSpan()


class _Span:
    __slots__ = ("tracer", "name", "index", "range")

    def __init__(self, tracer: "Tracer", name: str):
        self.tracer, self.name = tracer, name

    def __enter__(self):
        self.range = torch.profiler.record_function(self.name)
        self.range.__enter__()
        stack = self.tracer._stack()
        self.index = len(self.tracer._records)
        # the clock is read inside the profiler's range at both ends
        self.tracer._records.append([self.name, time.time_ns(), 0, stack[-1] if stack else None])
        stack.append(self.index)
        return None

    def __exit__(self, *exc):
        self.tracer._records[self.index][2] = time.time_ns()
        self.tracer._stack().pop()
        self.range.__exit__(*exc)
        return False


class Tracer:
    """Spans and counters of one process (the module's functions use one
    instance, ``TRACER``)."""

    def __init__(self):
        self.on = False
        self._records: List[list] = []
        self._counters: Dict[str, int] = defaultdict(int)
        self._local = threading.local()

    def _stack(self) -> List[int]:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def span(self, name: str):
        return _Span(self, name) if self.on else _NO_SPAN

    def count(self, name: str, n: int = 1) -> None:
        self._counters[name] += n

    @contextlib.contextmanager
    def tracing(self):
        was, self.on = self.on, True
        try:
            yield self
        finally:
            self.on = was

    def records(self) -> List[Record]:
        return [tuple(r) for r in self._records]

    def counters(self) -> Dict[str, int]:
        return dict(self._counters)

    def reset(self) -> None:
        """Drop the records and zero the counters (outside any open span)."""
        self._records.clear()
        self._counters.clear()


TRACER = Tracer()


def span(name: str):
    """A context that records the with-block as a span ``name`` while
    tracing is on, and does nothing otherwise."""
    return TRACER.span(name)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name``."""
    TRACER.count(name, n)


def tracing():
    """Spans record inside the with-block."""
    return TRACER.tracing()


def records() -> List[Record]:
    """The spans recorded so far, in the order they opened."""
    return TRACER.records()


def counters() -> Dict[str, int]:
    return TRACER.counters()


def reset() -> None:
    TRACER.reset()


def summary(recs: List[Record]) -> Dict[str, Dict[str, float]]:
    """Per span name: ``count``, ``total_s`` and ``self_s`` (each span's
    duration less what its child spans cover)."""
    child_ns = defaultdict(int)
    for _, start, end, parent in recs:
        if parent is not None:
            child_ns[parent] += end - start
    out: Dict[str, Dict[str, float]] = {}
    for i, (name, start, end, _) in enumerate(recs):
        s = out.setdefault(name, {"count": 0, "total_s": 0.0, "self_s": 0.0})
        s["count"] += 1
        s["total_s"] += (end - start) / 1e9
        s["self_s"] += (end - start - child_ns[i]) / 1e9
    return out


class StageTimer:
    """Per-stage wall-clock aggregation with bottleneck ranking.  Each stage
    is also a :func:`span` of its name."""

    def __init__(self):
        self.stats: Dict[str, list] = defaultdict(list)

    @contextlib.contextmanager
    def stage(self, name: str):
        """Wall-clock a with-block.  To include the device time of CUDA work
        launched inside the block, call ``torch.cuda.synchronize()`` before
        it exits."""
        with span(name):
            t0 = time.perf_counter()
            yield
            self.stats[name].append(time.perf_counter() - t0)

    def record(self, name: str, seconds: float) -> None:
        self.stats[name].append(seconds)

    def summary(self) -> Dict[str, Dict[str, float]]:
        out = {}
        for name, vals in self.stats.items():
            out[name] = {
                "mean_s": sum(vals) / len(vals),
                "total_s": sum(vals),
                "count": len(vals),
            }
        return out

    def bottleneck_ranking(self) -> list:
        return sorted(
            self.summary().items(), key=lambda kv: kv[1]["total_s"], reverse=True
        )

    def print_report(self) -> None:
        print(f"{'stage':30s} {'total_s':>10s} {'mean_s':>10s} {'count':>7s}")
        for name, s in self.bottleneck_ranking():
            print(f"{name:30s} {s['total_s']:10.3f} {s['mean_s']:10.4f} {s['count']:7d}")


@contextlib.contextmanager
def device_trace(log_dir: str, enabled: bool = True):
    """``torch.profiler`` over the with-block with the tracer on, written as
    a Chrome trace ``<log_dir>/trace.json`` (open in Perfetto or
    chrome://tracing): the program's spans beside the host's ops and, when
    a card is present, its kernels and copies.  Yields the profiler."""
    if not enabled:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof, tracing():
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    Path(log_dir).mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(Path(log_dir) / "trace.json"))

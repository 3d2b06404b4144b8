"""Profiling utilities (counterpart of ``multimodal_fusion_tpu.utils.profiling``).

The reference's opt-in wall-clock stage profiler
(``alignment/trainer.py:88-102,442-507``) is :class:`StageTimer`, copied;
:func:`device_trace` is a ``torch.profiler`` context that writes a Chrome
trace, with the card's kernels when CUDA is available.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from pathlib import Path
from typing import Dict


class StageTimer:
    """Per-stage wall-clock aggregation with bottleneck ranking."""

    def __init__(self):
        self.stats: Dict[str, list] = defaultdict(list)

    @contextlib.contextmanager
    def stage(self, name: str):
        """Wall-clock a with-block.  To include the device time of CUDA work
        launched inside the block, call ``torch.cuda.synchronize()`` before
        it exits."""
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
    """``torch.profiler`` over the with-block, written as a Chrome trace
    ``<log_dir>/trace.json`` (open in Perfetto or chrome://tracing); the
    CUDA activity is traced when a card is present.  Yields the profiler."""
    if not enabled:
        yield None
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    Path(log_dir).mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(Path(log_dir) / "trace.json"))

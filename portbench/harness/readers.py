"""What the metric readers (``metrics/<metric>.py``) share.

Each returns None where its run has nothing to read (off the card, no
traced window, no launch of the kernel), and the harness then leaves the
metric out of the line.  A share of a peak or a roofline is never made up
as 0 or clipped at 100.
"""

from __future__ import annotations

import re
import statistics
import sys
from typing import Optional

from portbench.harness.peaks import bound_s

# the port's kernels by name (multimodal_fusion_tpu_torch/csrc): K3 the
# attention forward (attention.cu: attn_f32_kernel, attn_bf16_kernel, the
# narrow routes and attn_combine_kernel), K4 its backward (attention_bwd.cu)
KERNELS = {
    "k3": re.compile(r"\battn_(?!bwd)\w*kernel"),
    "k4": re.compile(r"\battn_bwd_\w*kernel"),
}


def rate(run) -> Optional[float]:
    """Units completed over the measured window's host-clock length."""
    return run.units / run.window_s if run.window_s > 0 else None


def mfu(run) -> Optional[float]:
    """The useful FLOPs of the measured window (the reference's count from
    the configuration and the shapes, padding left out) over the window's
    length at the card's peak for the configuration's dtype, in %."""
    if run.peaks is None or not run.work.get("flops"):
        return None
    return 100.0 * run.work["flops"] / (run.window_s * run.peaks.flops[run.dtype])


def roofline(run, kernel: str) -> Optional[float]:
    """The least time the traced window's calls of ``kernel`` could take
    (each call's operations or bytes, as the shapes and masks need them, at
    the card's peak) over the profiler's device time of that kernel's
    launches, in %.  None where the calls the reference counted are not the
    calls the program's counter made, or the trace does not hold a whole
    number of launches a call: the count would not be of the timed work."""
    if run.trace is None or run.peaks is None:
        return None
    counted = run.trace_work.get("kernels", {}).get(kernel, [])
    made = run.trace.calls.get(kernel, 0)
    pattern = KERNELS[kernel]
    traced = sum(n for name, n in run.trace.op_n.items() if pattern.search(name))
    device = sum(s for name, s in run.trace.op_s.items() if pattern.search(name))
    if not counted or device <= 0:
        return None
    if len(counted) != made or traced < made or traced % made:
        print(f"{kernel}_roofline not read: {len(counted)} calls counted, {made} made by the "
              f"program, {traced} kernel launches traced", file=sys.stderr)
        return None
    least = sum(bound_s(ops, nbytes, run.peaks, run.dtype) for ops, nbytes in counted)
    return 100.0 * least / device


def idle(run) -> Optional[float]:
    """The share of the traced window in which no op ran on the device, %."""
    if run.trace is None or run.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)


def span_mean_ms(run, name: str) -> Optional[float]:
    """The mean host time of the span ``name`` over the measured window, ms."""
    spans = run.spans.get(name)
    return 1e3 * statistics.fmean(spans) if spans else None


def pad_share(run, calls_per_batch: int, batch: int) -> Optional[float]:
    """Padded rows over all rows the encoder ran in the measured window, %:
    its batches from the program's K3 calls (``calls_per_batch`` a batch of
    ``batch`` rows), its real rows the patches completed.  None where the
    calls are no whole number of batches or the batches cannot hold the
    patches."""
    batches, rest = divmod(run.calls.get("k3", 0), calls_per_batch)
    rows = batches * batch
    if rest or rows < run.units or not rows:
        return None
    return 100.0 * (rows - run.units) / rows

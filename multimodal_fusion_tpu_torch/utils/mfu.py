"""Device performance accounting: MFU and roofline position (counterpart
of ``multimodal_fusion_tpu.utils.mfu``).

``measure_device`` times a function on inputs already on the device and
reports

    achieved FLOP/s, MFU = achieved / peak(card, dtype),
    arithmetic intensity I = flops / bytes,
    roofline bound = min(peak_flops, I * peak_hbm_bw),
    fraction_of_roofline = achieved / bound.

An operation of low intensity is bound by memory and can sit at a small
MFU while running at its roofline, so ``fraction_of_roofline`` is the
number that says how close to the card's limit a call runs.

Timing on a CUDA card uses ``torch.cuda.Event``s: a warm-up, then the best
of 3 runs of ``iters`` back-to-back calls, each run closed by a
synchronize (on the CPU, the host clock around the same runs).  The
FLOPs come from ``torch.utils.flop_counter.FlopCounterMode`` over one call
unless the caller passes ``flops_override``: like XLA's cost analysis,
which cannot see Pallas calls, the counter cannot see the port's kernels,
which launch through ctypes (``ops/_cuda.py``), so their FLOPs need the
override.  The bytes come only from ``bytes_override`` (an analytic
count, e.g. ``analytic_step_bytes``); without it the bound is the compute
peak.  The JAX module guards its timing loop against XLA hoisting the
work out of the loop and eliminating it as dead code (``_perturb_floats``,
``_digest``); eager PyTorch runs every call it is given, so neither guard
is ported.

Peaks of one card, dense, from NVIDIA's data sheets (keyed on
``torch.cuda.get_device_name``):

| card                 | bf16 FLOP/s (tensor cores) | float32 FLOP/s (no tensor cores) | HBM B/s |
| NVIDIA H100 SXM/HBM3 | 989e12                     | 67e12                            | 3.35e12 |
| NVIDIA H100 PCIe     | 756e12                     | 51e12                            | 2.0e12  |

The float32 column is the peak outside the tensor cores because
``device.resolve_device`` switches TF32 off: the port's float32 matmuls
run in true float32.  The rates assume the card's full power limit; a
card set below it (``nvidia-smi --query-gpu=power.limit``) runs slower.
The CPU row is nominal and keeps the report defined on the host.
"""

from __future__ import annotations

import time
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from multimodal_fusion_tpu_torch.device import resolve_device

_PEAKS = {
    # substring of the lowercased device name -> (bf16 FLOP/s, float32
    # FLOP/s, HBM bytes/s); the first match wins
    "h100 pcie": (756e12, 51e12, 2.0e12),
    "h100": (989e12, 67e12, 3.35e12),
    "cpu": (1e12, 5e11, 1e11),  # nominal
}


def chip_peaks(device=None) -> Tuple[str, float, float, float]:
    """(device kind, peak_bf16, peak_f32, peak_hbm_bw) of one card
    (``device`` default: the CUDA card); an unlisted CUDA card gets the
    H100 SXM row."""
    dev = resolve_device(device)
    kind = (torch.cuda.get_device_name(dev) if dev.type == "cuda" else dev.type).lower()
    for sub, peaks in _PEAKS.items():
        if sub in kind:
            return kind, *peaks
    return kind, *_PEAKS["h100"]


def tree_bytes(tree) -> float:
    """Total bytes of the tensors and arrays in a nested dict / list /
    tuple (parameters, optimizer state, batches); ``None`` is skipped."""
    if tree is None:
        return 0.0
    if isinstance(tree, dict):
        return sum(tree_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(tree_bytes(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return float(tree.numel() * tree.element_size())
    if hasattr(tree, "nbytes"):
        return float(tree.nbytes)
    return 0.0


def analytic_step_bytes(
    *,
    input_bytes: float,
    weight_bytes: float,
    trainable_bytes: float = 0.0,
    hbm_activation_bytes: float = 0.0,
    mode: str = "train",
) -> float:
    """Analytic memory traffic of one train or eval step, the JAX package's
    model term for term:

    - ``input_bytes``: the batch, read once.
    - ``weight_bytes``: every parameter the forward touches, read once in
      eval and twice in training (the forward and the backward's
      transposed products).
    - ``trainable_bytes``: the parameters the optimizer updates, 6x for an
      Adam step (gradient write, both moments read and written, parameter
      write; the parameter read is in ``weight_bytes``).
    - ``hbm_activation_bytes``: intermediates that go through device
      memory, 2x (the forward's write, the backward's read).

    An engineering estimate of documented terms, not a measurement."""
    if mode == "eval":
        return input_bytes + weight_bytes + 2.0 * hbm_activation_bytes
    return input_bytes + 2.0 * weight_bytes + 6.0 * trainable_bytes + 2.0 * hbm_activation_bytes


def _device_of(args) -> torch.device:
    """The device of the first non-CPU tensor in ``args`` (nested dicts,
    lists and tuples), else the CPU."""
    if isinstance(args, torch.Tensor):
        return args.device
    items = args.values() if isinstance(args, dict) else args if isinstance(args, (list, tuple)) else ()
    for a in items:
        dev = _device_of(a)
        if dev.type != "cpu":
            return dev
    return torch.device("cpu")


def _seconds(dev: torch.device, body: Callable[[], Any]) -> float:
    """Seconds ``body`` takes on ``dev``: CUDA events around it, then a
    synchronize; the host clock on the CPU."""
    if dev.type == "cuda":
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        body()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / 1e3
    t0 = time.perf_counter()
    body()
    return time.perf_counter() - t0


def _count_flops(fn: Callable, args: Tuple) -> float:
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as counter:
        fn(*args)
    return float(counter.get_total_flops())


def measure_device(
    fn: Callable,
    args: Tuple,
    iters: int = 10,
    dtype: str = "float32",
    work_items: Optional[float] = None,
    flops_override: Optional[float] = None,
    bytes_override: Optional[float] = None,
    mxu_dtype: Optional[str] = None,
) -> Dict[str, Any]:
    """Time ``fn(*args)`` on the device its tensors lie on and report its
    MFU and roofline position (module docstring).  ``dtype`` is the input
    dtype; ``mxu_dtype`` the precision of the dominant products where it
    differs, which picks the peak (``"bfloat16"``: the tensor-core peak).
    ``work_items`` (e.g. slides, patches) adds an items/s field."""
    dev = _device_of(args)
    fn(*args)  # warm-up
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    overhead = min(_seconds(dev, lambda: None) for _ in range(3))

    def run():
        for _ in range(iters):
            fn(*args)

    best, signal = float("inf"), 0.0
    for _ in range(3):
        elapsed = _seconds(dev, run)
        signal = max(signal, elapsed - overhead)
        best = min(best, max(elapsed - overhead, 1e-9) / iters)
    # the timed runs must stand well above the cost of the timing itself
    low_snr = signal < 5 * overhead

    flops = flops_override if flops_override is not None else _count_flops(fn, args)
    bytes_accessed = bytes_override or 0.0
    kind, peak_bf16, peak_f32, peak_bw = chip_peaks(dev)
    eff = mxu_dtype or dtype
    peak = peak_bf16 if eff == "bfloat16" else peak_f32
    rep = {
        "device_kind": kind,
        "compute_dtype": dtype,
        "mxu_dtype": eff,
        "sec_per_call": best,
        "timing_iters": iters,
        "fetch_overhead_sec": overhead,
        "low_snr": low_snr,
    }
    if work_items:
        rep["items_per_sec"] = work_items / best
    if not flops:
        # nothing the counter can see (the port's kernels launch through
        # ctypes): timing only, and the caller passes flops_override
        rep["flops_per_call"] = None
        return rep
    achieved = flops / best
    intensity = flops / bytes_accessed if bytes_accessed else float("inf")
    ridge = peak / peak_bw
    bound = min(peak, intensity * peak_bw) if bytes_accessed else peak
    rep.update(
        {
            "flops_per_call": flops,
            "bytes_per_call": bytes_accessed,
            # an override is the caller's analytic count; without one no
            # bytes are counted and the bound is the compute peak
            "bytes_model": "analytic" if bytes_override is not None else "none",
            "achieved_tflops": achieved / 1e12,
            "peak_tflops": peak / 1e12,
            "mfu": achieved / peak,
            "arithmetic_intensity_flop_per_byte": intensity,
            "ridge_intensity": ridge,
            "bound": "compute" if intensity >= ridge else "memory",
            "roofline_tflops": bound / 1e12,
            "fraction_of_roofline": achieved / bound,
        }
    )
    if rep["fraction_of_roofline"] > 1.05:
        # faster than the card can run: the peak or the bytes model for
        # this entry is wrong (a mis-set mxu_dtype, a stale bytes_override)
        rep["suspect_roofline"] = True
    return rep

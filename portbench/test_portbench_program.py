"""The program window (``harness/program.py``): device ops placed in the
program's spans on a made-up profile, in kineto's event forms with and
without activity types; the clock check; tiny traced runs of every cell on
the CPU, where the program's spans and counters read and the device-placed
metrics do not; and a program without the tracer, where none read."""

import json
import time
from pathlib import Path

import pytest
import torch

from portbench.harness import manifest, program
from portbench.harness.runner import Run, run_cell
from portbench.test_portbench_runs import SEED, tiny

ROOT = Path(__file__).resolve().parents[1]
CELLS = [w["name"] for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]
NEW = ("forward_ms.train", "backward_ms.train", "optimizer_ms.train", "host_prep_ms.extract",
       "waits_per_core.extract")


class _Event:
    """A kineto event: ``kind`` as kineto's activity types name them."""

    def __init__(self, name, start, dur, kind, corr=0, linked=0):
        self._n, self._s, self._d, self._k = name, start, dur, kind
        self._c, self._l = corr, linked

    def name(self):
        return self._n

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._d

    def activity_type(self):
        return self._k

    def correlation_id(self):
        return self._c

    def linked_correlation_id(self):
        return self._l

    def is_user_annotation(self):
        return self._k in ("user_annotation", "gpu_user_annotation")

    def device_type(self):
        from torch.autograd import DeviceType
        host = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")
        return DeviceType.CPU if self._k in host else DeviceType.CUDA


class _Untyped(_Event):
    """The same event as torch 2.11 gives it: no activity type."""

    activity_type = None


# one window: train.window 100..400 holding forward 110..200, backward
# 200..300, optimizer 300..390; a gather launched at 50, before it
RECORDS = [("train.window", 100, 400, None), ("train.forward", 110, 200, 0),
           ("train.backward", 200, 300, 0), ("train.optimizer", 300, 390, 0)]


def _events(cls):
    return [
        cls("cudaLaunchKernel", 48, 4, "cuda_runtime", corr=1),
        cls("gather_kernel", 500, 10, "kernel", corr=1),  # launched at 50: outside
        cls("aten::mm", 120, 20, "cpu_op", corr=900),
        cls("cudaLaunchKernel", 125, 4, "cuda_runtime", corr=2),
        cls("gemm", 510, 30, "kernel", corr=2, linked=900),  # by its runtime call: forward
        cls("cudaLaunchKernel", 250, 4, "cuda_runtime", corr=3),
        cls("attn_bwd_dq_f32_kernel", 540, 40, "kernel", corr=3),  # backward
        cls("aten::_foreach_add_", 320, 40, "cpu_op", corr=901),
        cls("multi_tensor_apply_kernel", 580, 5, "kernel", corr=77, linked=901),  # linked: optimizer
        cls("train.optimizer", 299, 92, "user_annotation", corr=902),
        cls("train.optimizer", 584, 20, "gpu_user_annotation"),
        cls("Memcpy DtoD", 590, 6, "gpu_memcpy", corr=78),  # neither: by its annotation
        cls("train.window", 98, 303, "user_annotation", corr=903),  # the profiler's ranges
        cls("train.forward", 109, 92, "user_annotation", corr=904),
        cls("train.backward", 199, 102, "user_annotation", corr=905),
    ]


@pytest.mark.parametrize("cls", [_Event, _Untyped], ids=["typed", "untyped"])
def test_device_ops_go_to_the_innermost_span_open_at_their_launch(cls):
    device_s, outside, busy, notes = program.attribute(_events(cls), RECORDS)
    assert device_s == pytest.approx({"train.forward": 30e-9, "train.backward": 40e-9,
                                      "train.optimizer": 11e-9, "train.window": 81e-9})
    assert outside == pytest.approx(10e-9)
    assert busy == pytest.approx(91e-9)  # 500..585 and 590..596
    assert (notes["launch"], notes["annotation"]) == (4, 1) and "unplaced" not in notes
    assert notes["clock_gap_us"] == pytest.approx((1e-3, 2e-3))
    # the device's one gap, 585..590, by the span open at 587 on the host: none
    assert notes["idle_s"] == pytest.approx({"host: outside any operator": 5e-9})


def test_no_device_op_reads_nothing():
    events = [e for e in _events(_Event) if e.device_type() == torch.autograd.DeviceType.CPU]
    assert program.attribute(events, RECORDS) is None


def test_innermost_over_nested_and_sibling_records():
    records = [("a", 0, 100, None), ("b", 10, 20, 0), ("c", 30, 60, 0), ("d", 40, 50, 2),
               ("a", 200, 300, None)]
    times = [(0, 5), (1, 15), (2, 25), (3, 45), (4, 55), (5, 150), (6, 250), (7, 400)]
    assert program.innermost(records, times) == {0: 0, 1: 1, 2: 0, 3: 3, 4: 2, 5: None, 6: 4,
                                                 7: None}


def test_the_clock_check():
    records = [("a", 10, 90, None), ("a", 110, 190, None)]
    assert program.clock_gap_us([(5, 95, "a"), (100, 200, "a")], records) == (5e-3, 10e-3)
    assert program.clock_gap_us([(12, 95, "a"), (100, 200, "a")], records)[0] < 0
    assert program.clock_gap_us([(5, 95, "a")], records) is None


def _readings(result):
    return {k: v["value"] for k, v in result["metrics"].items()}


@pytest.mark.parametrize("cell", CELLS)
def test_a_traced_cpu_run_reads_the_programs_spans_and_counters(cell, capsys):
    result = run_cell(cell, SEED, 0.3, True, time.perf_counter(), device="cpu",
                      override=tiny(cell))
    assert result["correct"], result["checks"]
    read = _readings(result)
    err = capsys.readouterr().err
    assert "program window:" in err
    if cell.startswith("uni_vit"):
        assert read["waits_per_core.extract"] == 1.0
        assert read["host_prep_ms.extract"] > 0
        assert "(extract.rows - extract.patches) / extract.rows" in err
        assert "pad_share.extract" in err
    # the device-placed metrics need the card's profile
    assert not {"forward_ms.train", "backward_ms.train", "optimizer_ms.train"} & set(read)
    listed = {m["name"] for m in manifest.load_cell(cell).per_layer} & set(NEW)
    assert {"host_prep_ms.extract", "waits_per_core.extract"} & listed <= set(read)


@pytest.mark.parametrize("cell", CELLS)
def test_without_the_programs_tracer_the_new_metrics_read_nothing(cell, monkeypatch):
    monkeypatch.setattr(program, "tracer", lambda: None)
    result = run_cell(cell, SEED, 0.3, True, time.perf_counter(), device="cpu",
                      override=tiny(cell))
    assert result["correct"] and not set(NEW) & set(result["metrics"])


def test_the_window_counts_what_the_program_did():
    """The small cores' counters over the program window: every core one
    wait; rows whole batches of the tiny cell's 4; padding the reader's."""
    cell = manifest.load_cell(CELLS[-1], override=tiny(CELLS[-1]))
    run = Run(cell=cell, peaks=None, dtype="float32", setup_s=0.0, window_s=0.2, units=0,
              spans={}, work={}, calls={})
    w = program.window(run)
    c = w.counts
    assert c["extract.cores"] == c["extract.waits"] == sum(1 for r in w.records
                                                           if r[0] == "extract.core")
    assert c["extract.rows"] % 4 == 0 and c["extract.patches"] <= c["extract.rows"]
    assert program.window(run) is w  # run once a run


@pytest.mark.parametrize("metric,want", [
    ("forward_ms.train", 1e3 * 0.6 / 2), ("backward_ms.train", 1e3 * 1.2 / 2),
    ("optimizer_ms.train", 1e3 * 0.008 / 2), ("host_prep_ms.extract", (3 + 4 + 5) / 1e6 / 2),
    ("waits_per_core.extract", 1.5),
])
def test_each_reader_reads_its_spans_and_counters(metric, want, monkeypatch):
    """Each new metric's reader over a made-up program window: two
    windows, two cores."""
    records = [("train.window", 0, 10, None), ("train.window", 20, 30, None),
               ("extract.core", 40, 60, None), ("extract.cut", 41, 44, 2),
               ("extract.stage", 44, 48, 2), ("extract.core", 60, 80, None),
               ("extract.stage", 61, 66, 5)]
    w = program.Window(steps=2, seconds=1.0, records=records,
                       counts={"extract.cores": 2, "extract.waits": 3},
                       device_s={"train.forward": 0.6, "train.backward": 1.2,
                                 "train.optimizer": 0.008, "train.window": 1.808})
    run = object()
    monkeypatch.setattr(program, "_LAST", [run, w])
    assert manifest.reader(metric)(run) == pytest.approx(want)

"""The port's tracer (``multimodal_fusion_tpu_torch.utils.profiling``):
off it records nothing and opens no profiler range; on it nests spans by
their parents, reports self time, lies inside the profiler's ranges on
the profiler's clock, and counts; the training step and the extraction
loop give the same numbers with it on and off and open their spans in
order; ``StageTimer`` and ``device_trace`` go through it."""

import contextlib
import json
import threading
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from multimodal_fusion_tpu_torch import channels as tchannels
from multimodal_fusion_tpu_torch import config as tconfig
from multimodal_fusion_tpu_torch.data import tma_extraction
from multimodal_fusion_tpu_torch.data.multimodal import MultimodalDataset
from multimodal_fusion_tpu_torch.io.fixtures import make_synthetic_dataset
from multimodal_fusion_tpu_torch.models import vit as tvit
from multimodal_fusion_tpu_torch.models.factory import ModelFactory
from multimodal_fusion_tpu_torch.train.optim import make_optimizer
from multimodal_fusion_tpu_torch.train.survival import SurvivalTrainer, window_step
from multimodal_fusion_tpu_torch.utils import profiling

TRAIN = ["train.window", "train.forward", "train.backward", "train.optimizer"]
CORE = ["extract.core", "extract.cut", "extract.stage", "extract.wait"]


@pytest.fixture(autouse=True)
def _clean():
    profiling.reset()
    yield
    profiling.reset()


def _profiled_names(prof):
    return [e.name() for e in prof.profiler.kineto_results.events()]


def test_off_records_nothing_and_opens_no_range_under_a_profiler():
    assert profiling.span("a") is profiling.span("b")  # one shared no-op
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with profiling.span("off.outer"):
            with profiling.span("off.inner"):
                torch.ones(3).sum()
    assert profiling.records() == []
    assert not {"off.outer", "off.inner"} & set(_profiled_names(prof))


def test_on_nests_by_parent_and_reports_self_time():
    with profiling.tracing():
        with profiling.span("w"):
            with profiling.span("x"):
                time.sleep(0.004)
            with profiling.span("y"):
                with profiling.span("z"):
                    time.sleep(0.002)
        with profiling.span("w"):
            pass
    assert not profiling.TRACER.on
    recs = profiling.records()
    assert [(r[0], r[3]) for r in recs] == [("w", None), ("x", 0), ("y", 0), ("z", 2), ("w", None)]
    for name, start, end, parent in recs:
        assert start <= end
        if parent is not None:
            assert recs[parent][1] <= start and end <= recs[parent][2]
    s = profiling.summary(recs)
    assert s["w"]["count"] == 2 and s["z"]["count"] == 1
    w0 = (recs[0][2] - recs[0][1]) / 1e9
    x, y, z = ((r[2] - r[1]) / 1e9 for r in recs[1:4])
    assert s["x"]["self_s"] == pytest.approx(x) and s["y"]["self_s"] == pytest.approx(y - z)
    assert s["w"]["self_s"] == pytest.approx(w0 - x - y + (recs[4][2] - recs[4][1]) / 1e9)
    assert s["x"]["self_s"] >= 0.004 and 0 <= s["w"]["self_s"] < x


def test_each_thread_nests_its_own_spans():
    with profiling.tracing():
        with profiling.span("main"):
            t = threading.Thread(target=_open_on_thread)
            t.start()
            t.join(timeout=10)
            assert not t.is_alive()
    by_name = {r[0]: r for r in profiling.records()}
    assert by_name["other"][3] is None and by_name["inside other"][3] is not None
    assert profiling.records()[by_name["inside other"][3]][0] == "other"


def _open_on_thread():
    with profiling.span("other"):
        with profiling.span("inside other"):
            pass


def test_counters_are_always_on_and_reset():
    profiling.count("c")
    profiling.count("c", 4)
    with profiling.tracing():
        profiling.count("d", 2)
    assert profiling.counters() == {"c": 5, "d": 2}
    profiling.reset()
    assert profiling.counters() == {} and profiling.records() == []


def test_records_lie_inside_the_profilers_ranges_on_its_clock():
    with profile(activities=[ProfilerActivity.CPU]) as prof, profiling.tracing():
        with profiling.span("clock.warm"):  # the profiler's first range costs more
            pass
        for i in range(5):
            with profiling.span(f"clock.{i}"):
                torch.randn(64, 64) @ torch.randn(64, 64)
                with profiling.span(f"clock.{i}.inner"):
                    time.sleep(0.001)
    ranges = {e.name(): (e.start_ns(), e.start_ns() + e.duration_ns())
              for e in prof.profiler.kineto_results.events() if e.name().startswith("clock.")}
    recs = profiling.records()
    assert len(recs) == 11 and {r[0] for r in recs} == set(ranges)
    for name, start, end, _ in recs:
        a, b = ranges[name]
        assert a <= start and end <= b, name
        assert start - a < 1_000_000 and b - end < 1_000_000, name


def test_stage_timer_records_through_span():
    timer = profiling.StageTimer()
    with timer.stage("s1"):
        pass
    assert profiling.records() == [] and timer.summary()["s1"]["count"] == 1
    with profiling.tracing():
        with timer.stage("s1"):
            with timer.stage("s2"):
                pass
    assert [(r[0], r[3]) for r in profiling.records()] == [("s1", None), ("s2", 0)]
    assert timer.summary()["s1"]["count"] == 2 and timer.summary()["s2"]["count"] == 1


def test_device_trace_holds_the_programs_spans(tmp_path):
    with profiling.device_trace(str(tmp_path)):
        with profiling.span("trace.me"):
            torch.ones(4).sum()
    assert not profiling.TRACER.on
    assert [r[0] for r in profiling.records()] == ["trace.me"]
    events = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    assert any(e.get("name") == "trace.me" for e in events)


# the training step ---------------------------------------------------------

SHORTHANDS = ["wsi", "cd3", "cd8", "clinical_mask", "blood_mask"]


@pytest.fixture(scope="module")
def mfmf_window(tmp_path_factory):
    root = tmp_path_factory.mktemp("profiling_mfmf")
    csv_path = make_synthetic_dataset(root, n_patients=6, seed=3, min_wsi_patches=8,
                                      max_wsi_patches=20, feature_dim=16, markers=("cd3", "cd8"),
                                      with_reconstructed=True)
    chans = tchannels.parse_channels(SHORTHANDS)
    configs = tconfig.Configs.from_dict({
        "model_config": {"model_type": "mfmf", "n_classes": 2, "input_dim": 16,
                         "model_size": "8*4", "dropout": 0.25, "output_dim": 32,
                         "channels_used_in_model": chans, "attention_num_heads": 8,
                         "channel_input_dims": {"clinical=val": 16, "blood=val": 24}},
        "experiment_config": {"exp_name": "t", "seed": 7, "batch_size": 4, "lr": 1e-3,
                              "optimizer": "adam", "weight_decay": 1e-5}})
    trainer = SurvivalTrainer(configs, root / "logs", device="cpu")
    dataset = MultimodalDataset(csv_path, root, chans)
    windows = [trainer._to_device(w) for _, w in trainer._windows(dataset, list(range(6)), 3)]
    return configs, windows


def _train(configs, windows, traced: bool):
    exp = configs.experiment_config
    model = ModelFactory.create_model(configs.model_config, seed=5, device="cpu")
    optimizer = make_optimizer(exp.optimizer, exp.weight_decay, model.parameters(), exp.lr)
    generator = torch.Generator().manual_seed(11)
    with profiling.tracing() if traced else contextlib.nullcontext():
        losses = [window_step(model, optimizer, w, generator) for w in windows]
    return losses, {n: p.detach().clone() for n, p in model.named_parameters()}


def test_window_step_is_the_same_traced_and_opens_its_spans_in_order(mfmf_window):
    configs, windows = mfmf_window
    losses_off, params_off = _train(configs, windows, traced=False)
    assert profiling.records() == []
    losses_on, params_on = _train(configs, windows, traced=True)
    assert all(torch.equal(a, b) for a, b in zip(losses_off, losses_on))
    assert params_off.keys() == params_on.keys()
    assert all(torch.equal(params_off[n], params_on[n]) for n in params_off)
    recs = profiling.records()
    assert [r[0] for r in recs] == TRAIN * len(windows)
    for i in range(0, len(recs), 4):  # three children that tile the window, in order
        window, children = recs[i], recs[i + 1 : i + 4]
        assert all(c[3] == i for c in children) and window[3] is None
        assert window[1] <= children[0][1] and children[-1][2] <= window[2]
        assert all(a[2] <= b[1] for a, b in zip(children, children[1:]))


# the extraction loop -------------------------------------------------------

TINY_VIT = dict(img_size=32, patch_size=16, embed_dim=32, depth=2, num_heads=2)


def _cores():
    """Five cores of a known stream: 64 px (9 patches of 32 at stride 16),
    48 px (4), 20 px (smaller than a patch: 1, resized), 80 px (16), 32 px (1)."""
    rng = np.random.default_rng(0)
    return [(f"core{i}", rng.integers(0, 256, (e, e, 3), dtype=np.uint8))
            for i, e in enumerate((64, 48, 20, 80, 32))]


def _extract(traced: bool):
    model = tvit.ViT(**TINY_VIT, generator=torch.Generator().manual_seed(2))
    extractor = tma_extraction.make_feature_extractor(model, batch_size=4, device="cpu")
    with profiling.tracing() if traced else contextlib.nullcontext():
        return tma_extraction.extract_marker_features(iter(_cores()), extractor, patch_size=32,
                                                      stride=16)


def test_extraction_is_the_same_traced_and_counts_exactly():
    off = _extract(traced=False)
    assert profiling.records() == []
    counted_off = profiling.counters()
    profiling.reset()
    on = _extract(traced=True)
    assert off.keys() == on.keys() and all(np.array_equal(off[k], on[k]) for k in off)
    patches = [9, 4, 1, 16, 1]
    rows = [4 * -(-n // 4) for n in patches]  # batches of 4, the last one padded
    # the encoder's counters: a batch a forward, 4 patch tokens and the
    # class token a row
    want = {"extract.cores": 5, "extract.waits": 5, "extract.rows": sum(rows),
            "extract.patches": sum(patches), "vit.batches": sum(rows) // 4,
            "vit.tokens": 5 * sum(rows)}
    assert profiling.counters() == want == counted_off
    recs = profiling.records()
    # each core: cut, stage, the encoder's blocks (vit.attention, vit.mlp)
    # for each of its batches, then the one wait
    blocks = ["vit.attention", "vit.mlp"] * TINY_VIT["depth"]
    assert [r[0] for r in recs] == [name for r in rows
                                    for name in CORE[:3] + blocks * (r // 4) + CORE[3:]]
    core = None
    for i, rec in enumerate(recs):
        if rec[0] == "extract.core":
            core = i
            assert rec[3] is None
        else:
            assert rec[3] == core

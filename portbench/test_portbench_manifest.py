"""BENCHMARK.json keeps to the contract's shape, and every configuration,
traffic mix, entry, limit file and metric reader it names is found by
name.  Run from the repo root: ``python -m pytest portbench -q``."""

import json
import re
from pathlib import Path

import pytest

from portbench.harness import manifest

ROOT = Path(__file__).resolve().parents[1]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
LINE = re.compile(r"^[^\t\n]{1,200}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]


def test_top_level_keys_and_sizes():
    assert list(BENCH) == ["command", "paths", "run_seconds", "configs", "workloads",
                           "end_to_end", "per_layer"]
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert 1 <= len(BENCH["paths"]) <= 16 and all(PATH.match(p) and ".." not in p
                                                   and not p.startswith("/") for p in BENCH["paths"])
    assert 1 <= len(BENCH["command"]) <= 32 and all(LINE.match(w) for w in BENCH["command"])
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51


def test_run_seconds_fit_a_full_check_of_24_cells():
    runs = 2 + 14 * 24
    assert runs * (BENCH["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200


@pytest.mark.parametrize("entry", BENCH["configs"], ids=lambda c: c["name"])
def test_config_entries(entry):
    assert set(entry) == {"name", "source", "file", "reduced", "why"}
    assert manifest.NAME.match(entry["name"]) and LINE.match(entry["source"]) and LINE.match(entry["why"])
    assert entry["file"].startswith(BENCH["paths"][0] + "/")
    config = json.loads((ROOT / entry["file"]).read_text())
    assert config["name"] == entry["name"] and config["source"] == entry["source"]
    assert config["reduced"] == entry["reduced"] and len(entry["reduced"]) <= 16
    assert manifest.reference(config["reference"]).weight_spec(config)
    assert any(w["config"] == entry["name"] for w in BENCH["workloads"])


def test_config_files_are_distinct():
    files = [c["file"] for c in BENCH["configs"]]
    assert len(files) == len(set(files))


@pytest.mark.parametrize("entry", BENCH["workloads"], ids=lambda w: w["name"])
def test_workload_entries_find_their_files(entry):
    assert set(entry) == {"name", "config", "traffic", "chips", "why"}
    assert manifest.NAME.match(entry["name"]) and manifest.NAME.match(entry["traffic"])
    assert entry["chips"] in (1, 4) and LINE.match(entry["why"])
    cell = manifest.load_cell(entry["name"])
    module = manifest.entry(cell.entry)
    assert hasattr(module, "Entry") and hasattr(module, "control") and module.FAULTS
    assert cell.limits and all(v > 0 for v in cell.limits.values())
    e2e = [m["name"] for m in cell.end_to_end]
    assert "setup_s" in e2e and len(e2e) >= 2 and cell.per_layer
    for metric in cell.per_layer:
        assert metric["moves"] in e2e


def test_names_are_unique():
    for key in ("configs", "workloads"):
        names = [e["name"] for e in BENCH[key]]
        assert len(names) == len(set(names))
    names = [m["name"] for m in METRICS]
    assert len(names) == len(set(names))
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))


@pytest.mark.parametrize("metric", METRICS, ids=lambda m: m["name"])
def test_metric_entries_and_readers(metric):
    keys = {"name", "unit", "better", "source"}
    if metric in BENCH["end_to_end"]:
        assert set(metric) - {"workloads"} == keys | {"bound"}
        assert metric["source"] in ("host_clock", "device_trace")
        assert 0.01 <= metric["bound"] <= 0.25
    else:
        assert set(metric) == keys | {"layer", "moves", "workloads"}
        assert LINE.match(metric["layer"])
        assert metric["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
    assert manifest.NAME.match(metric["name"]) and manifest.UNIT.match(metric["unit"])
    assert metric["better"] in ("lower", "higher")
    cells = {w["name"] for w in BENCH["workloads"]}
    assert set(metric.get("workloads", [])) <= cells
    assert callable(manifest.reader(metric["name"]))


def test_roofline_and_mfu_names():
    for m in BENCH["per_layer"]:
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"
    assert any("mfu" in m["name"] for m in BENCH["per_layer"])


def test_at_most_a_quarter_of_cells_take_four_chips():
    four = sum(w["chips"] == 4 for w in BENCH["workloads"])
    assert four <= max(1, len(BENCH["workloads"]) // 4)

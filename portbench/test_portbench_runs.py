"""Whole runs of every cell at a tiny size on the CPU, past the harness's
look for a card: the port agrees with the plain reference (``correct``),
each fault a cell can have, planted in the program, makes ``correct`` come
out false, and so does the control, the reference in TF32 (emulated on the
CPU) put in the program's place.  A card-marked test reads the control at
the cells' own sizes on the card."""

import json
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

from portbench.harness import manifest
from portbench.harness.runner import passes, run_cell

ROOT = Path(__file__).resolve().parents[1]
CELLS = [w["name"] for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]

TINY_MFMF = {
    "config": {"model": {"input_dim": 32, "output_dim": 16, "attention_num_heads": 2,
                         "channel_input_dims": {"clinical=val": 3, "pathological=val": 2,
                                                "blood=val": 4, "icd=val": 2,
                                                "tma_cell_density=val": 2}},
               "experiment": {"batch_size": 4}},
    "traffic": {"cases": 12, "wsi_patches": [40, 64], "tma_patches": [3, 6]},
}
TINY_VIT = {
    "config": {"model": {"img_size": 32, "patch_size": 16, "embed_dim": 32, "depth": 2,
                         "num_heads": 2},
               "extraction": {"patch_size": 48, "stride": 16, "batch_size": 4}},
    "traffic": {"edges": [64, 80], "pool": 1, "check_patches": 8, "block": 8},
}
SEED = 3_000_000_019  # beyond 32 bits, as the check's seeds are


def tiny(cell: str):
    return TINY_VIT if cell.startswith("uni_vit") else TINY_MFMF


def run(cell: str, seed: int = SEED, seconds: float = 0.3):
    return run_cell(cell, seed, seconds, False, time.perf_counter(), device="cpu",
                    override=tiny(cell))


@pytest.mark.parametrize("cell", CELLS)
def test_the_port_agrees_with_the_reference(cell):
    result = run(cell)
    assert result["correct"], result["checks"]
    assert result["failed"] == 0 and result["attempted"] > 0
    assert set(result["metrics"]) == {m["name"] for m in manifest.load_cell(cell).end_to_end}
    assert list(result)[-1] == "checks"


def _faults():
    out = []
    for cell in CELLS:
        entry = manifest.entry(manifest.load_cell(cell).entry)
        out += [(cell, name) for name in entry.FAULTS]
    return out


@pytest.mark.parametrize("cell,fault", _faults())
def test_a_planted_fault_is_not_correct(cell, fault):
    entry = manifest.entry(manifest.load_cell(cell).entry)
    with entry.FAULTS[fault]():
        result = run(cell)
    assert not result["correct"], result["checks"]


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_is_not_correct(cell):
    c = manifest.load_cell(cell, override=tiny(cell))
    readings = manifest.entry(c.entry).control(c, SEED, torch.device("cpu"))
    checks = [{"value": readings.get(k), "limit": v} for k, v in c.limits.items()]
    assert not all(passes(x) for x in checks), readings


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_the_control_is_not_correct_on_the_card_at_full_size(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: TF32 is the card's")
    c = manifest.load_cell(cell)
    entry = manifest.entry(c.entry)
    for seed in (SEED, SEED + 1, SEED + 2):
        readings = entry.control(c, seed, torch.device("cuda", 0))
        checks = [{"value": readings.get(k), "limit": v} for k, v in c.limits.items()]
        assert not all(passes(x) for x in checks), (seed, readings)


def test_without_a_card_the_run_exits_nonzero_and_prints_no_result():
    if torch.cuda.is_available():
        pytest.skip("the machine has a card")
    p = subprocess.run([sys.executable, "-m", "portbench.run", "--workload", CELLS[0], "--seed",
                        str(SEED), "--seconds", "1", "--trace", "0"], cwd=ROOT,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode == 2 and p.stdout.strip() == ""


def test_a_seed_gives_the_same_inputs_and_a_run_the_same_answers():
    a, b = run(CELLS[0]), run(CELLS[0])
    assert a["checks"] == b["checks"]

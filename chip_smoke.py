#!/usr/bin/env python3
"""Chip smoke test of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``multimodal_fusion_tpu_torch/csrc``,
holds each against its plain PyTorch version on the card, and drives the
port's paths through their entry points:

- the per-slide hypergraph build at the benchmark's shape (8 slides x 4096
  patches x 1024-d features + 32 TMA cores, 100/10/5/10,
  ``save_similarity=False``, ``pipeline_depth=4``), checked against a CPU
  rebuild, then one 32768-patch slide and one slide with 4096 graph nodes;
- ViT-L/16 TMA feature extraction at full width (seeded random weights,
  ``make_feature_extractor(batch_size=32)`` + ``extract_marker_features`` on
  synthetic uint8 cores), checked against a CPU run of the port, against the
  einsum attention on the card, and bf16 against float32; its throughput in
  float32 and bf16 and a profile of one batch;
- MFMF survival training at ``mfmf_config0`` width (1024-d inputs,
  output_dim 128, 8 heads, windows of 64 cases) through
  ``SurvivalTrainer.train_fold`` on 160 in-memory cases, with the device
  tables and with host windows, checked against a CPU run of the port's
  window step; remat's peak device memory of one window; its throughput
  and a profile of one window.  K4 (the
  attention backward) is held against its plain version at MFMF's three
  block shapes first, and K3 and K4 at mfmf_config1's two general blocks
  ([64 x 8, 512 x 4096, 16] with the WSI bag's mask, [64 x 8, 4096 x 512,
  16] with the markers' bucket mask), float32 and bf16; at the end (phase
  44) mfmf_config1's fusion order is trained the same way (K3 and K4 on
  their general routes), one 16-case window checked card vs CPU and one
  window profiled, then one ``train_fold`` of mfmf_config2;
- the flagship ``svd_gate_random_clam`` family's serving path, on which no
  TPU kernel lies: its eval forward at the width of
  ``combined_svd_gate_random_clam.sh`` on 16 of those cases, checked
  against a CPU run of the port, bf16 against float32, and the detach
  variant's ``drop_prob``; inference slides/s at bench.py's cell (8 cases
  x 4096 WSI x 32 TMA patches x 1024, float32 and bf16) and
  ``evaluate_fold`` cases/s; the HTTP scoring server (``make_server``) over
  a results dir of 5 fold checkpoints, checked against ``evaluate_fold``
  run directly and against a CPU server; a profile of one inference
  window;
- the flagship's training, on which no TPU kernel lies either: one
  16-case training window of ``combined_svd_gate_random_clam.sh``'s config
  on the card against a CPU run of the port from the same weights, window
  and draws (cuSOLVER may choose other signs of the dominant singular
  vector than the CPU's LAPACK: the flipped cases are counted, and the
  CPU run takes the card's signs, so the gradient is held at the config's
  lambda1 = 0.1); ``rank1_svd_loss`` at [64, 128, 7] with its singular
  values, flip count, and value and gradient at the card's signs, its
  "gram" impl, the Jacobi eigensolver, the CLIP, AUCM, Cox and volume
  losses card vs CPU; remat on against off, and its peak device memory;
  training cases/s over 64-case windows on the device tables, bench.py's
  training cell in slides/s, the training CLI over one fold of phase 12's
  cases and ``predict`` over the directory it wrote; a profile of one
  training window and of its SVD group loss;
- the two pretraining stages, on which no TPU kernel lies: alignment
  pretraining at the width of ``exp_volume_256_tma.sh`` /
  ``exp_svd_256_tma.sh`` (8 markers x 1024, 2 layers, batches of 512) on
  NPZs of 1024 cores x 8 patches, one batch card vs CPU for the volume,
  rank-1 "gram" and "svd" losses and ``validate()``; ``cli/run_alignment.py``
  with the script's flags, its step rates, and its checkpoint aligning
  the 8 markers at load time through the survival CLI, ``predict`` and
  the scoring server; the VAE at ``run_vae_train.sh``'s width, one step
  card vs CPU, ``cli/train_vae.py`` over the living cases and
  ``cli/generate_reconstructed_wsi.py`` over every case; a profile of one
  step of each;
- the rest of the build: one 65536-patch slide whose statistics stream
  over K1 stripes of 1024 rows (the median by bit-pattern refine sweeps),
  held against K1's whole [65536, 65536] K, with its time by pass and by
  kernel; K1 at the stripe shape against its plain version; bf16 upload
  and the sampled statistics at 36864 patches; the streamed build card vs
  CPU at 6000 patches; ``process_dataset`` with ``file_batch=8`` against
  ``file_batch=1`` (bench shape, and bucketed 2048-4096-patch slides);
  the build CLI's ``--cache_similarity`` and ``--rebuild
  --threshold_median_ratio`` against a CPU rebuild of the same cache; the
  dense graph card vs CPU.  The HDF5 entry points run on files held in
  host memory where h5py is missing (``_mem_h5py``);
- export and the utilities, on which no TPU kernel lies: the flagship's
  ``torch.export`` serving artifact from the serving results dir at
  bench.py's inference cell, for the CPU and the card, against
  ``evaluate_fold`` and the live model, its throughput beside the live
  eval forward's; MFMF's artifact (the plain attention) against the live
  model's kernels; the alignment and VAE artifacts from the pretraining
  checkpoints; the fold checkpoints saved as reference ``.pt`` files and
  converted back by ``import_results_dir``, ``predict`` over both; the
  robustness sweep; and ``utils/mfu.measure_device`` on the flagship's
  eval forward, ViT-L/16 and K1, whose bounds the kernels line also
  takes from ``utils/mfu.chip_peaks``;
- the experiment matrix (``experiments/matrix.py``): six of its smoke
  representatives (clam, clam_mlp, the CLIP detach variant, deep
  supervision, mfmf_config1 and svd_pool; phase 19 runs the seventh)
  through the training CLI's ``run`` at the matrix's own widths over one
  fold of the 160 cases, each fold checkpoint evaluated on the CPU against
  the card; and the demo's models (``multimodal_fusion_tpu_torch/demo``)
  on the card against the CPU.

Every phase must pass: the script exits non-zero otherwise, and also when
no CUDA device is present (it never falls back to the CPU).

Each line a phase prints ends with the seconds since the phase began, and
each phase ends with its wall; after the last phase a line gives the sum of
the walls and its share of the driver's 1200 s limit.  Then come a JSON
object with one entry per kernel (launches on the main path, error against
the plain version, times, bound), the card's name and power limit, and as
the last line ``{"ok": true, "device": {...}}``.  Times come from CUDA
events and stand beside the card's name and power limit.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import hashlib
import json
import shutil
import subprocess
import sys
import tempfile
import time
import traceback
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
TIME_LIMIT_S = 1200  # the whole run, the kernels' build included, must end within it

# the benchmark's build configuration (bench.py)
N_FILES, N_PATCHES, N_TMA, DIM = 8, 4096, 32, 1024
NUM_SUPER, NUM_GROUPS, K, NUM_HYPEREDGES = 100, 10, 5, 10
SEED = 42
MAIN_PATH_WINDOWS = 5  # timed windows of N_FILES slides; the median is reported
LARGE_NODES = 4096  # graph nodes at which the build's node KNN switches to K2

# ViT-L/16 extraction (bench.py:674-737: 32 crops of 256 x 256 per batch)
VIT_BATCH, VIT_DEPTH, VIT_HEADS, VIT_TOKENS, VIT_HEAD_DIM = 32, 24, 16, 257, 64
VIT_WINDOW = 96  # patches per timed window (3 batches)
VIT_WINDOWS = 5

# MFMF survival training (experiments/2.related_works/mfmf_config0.sh):
# 1024-d inputs, output_dim 128, 8 heads of 16, the default three blocks,
# Adam lr 1e-4 with coupled L2 1e-5, the plateau scheduler, windows of 64
# cases.  160 in-memory cases, 5 folds: 128 train, 16 val, 16 test.
MFMF_CASES, MFMF_FOLDS, MFMF_EPOCHS, MFMF_BATCH = 160, 5, 2, 64
MFMF_DIM, MFMF_HEADS = 128, 8
MFMF_WSI = (2048, 4096)  # patches per WSI bag: one bucket of 4096
MFMF_TMA = (9, 16)  # patches per TMA marker: one bucket of 64
MFMF_TIMED_WINDOWS = 5
# mfmf_config1.sh:39 and mfmf_config2.sh's fusion orders: in config1 the
# "result" tokens of blocks 2 and 3 are the 8 markers' TMA tokens (512 rows
# of 64-row buckets), so both sides of those blocks pass NARROW and K3 and
# K4 take their general routes; config2 runs narrow_q blocks only
MFMF_CONFIG1 = [{"q": "tma", "kv": "other"}, {"q": "result", "kv": "wsi"},
                {"q": "reconstruct", "kv": "result"}]
MFMF_CONFIG2 = [{"q": "other", "kv": "tma"}, {"q": "result", "kv": "reconstruct"},
                {"q": "result", "kv": "wsi"}]

# flagship svd_gate_random_clam (experiments/0.clam/svd_gate_random_clam/
# combined_svd_gate_random_clam.sh): 1024-d inputs, model_size 64*32,
# output_dim 128, base_weight 0.9, subtyping, inst_number 8, two alignment
# layers, the SVD, gate and random losses on; wsi, the 8 markers and the 5
# tabular groups with masks (7 modalities)
FLAG_DIM, FLAG_WINDOW = 128, 16
# bench.py's inference cell (bench.py:231-251): windows of 8 cases x 4096
# WSI x 32 TMA (cd3) patches x 1024 and clinical values, held on the card
INF_BATCH, INF_WSI, INF_TMA, INF_BATCHES, INF_WINDOWS = 8, 4096, 32, 32, 5
SERVE_FOLDS, SERVE_REQUESTS = 5, (16, 64, 160)
# bench.py's training cell (run_training_ours, bench.py:344-412): 16 steps
# of 8 cases at the inference cell's shape
BENCH_TRAIN_STEPS = 16

# alignment pretraining (experiments/alignment/exp_volume_256_tma.sh and
# exp_svd_256_tma.sh, which differ only in --loss_type) on NPZs of 8 markers x
# 1024 cores x 8 patches x 1024; the VAE at run_vae_train.sh's width (1024 ->
# [512, 256] -> 128, batches of 1024) over phase 12's living cases
ALIGN_CORES, ALIGN_PATCHES, ALIGN_BATCH = 1024, 8, 512
ALIGN_FLAGS = ["--mismatch_ratio", "1.0", "--seed", "42", "--lambda1", "1.0", "--lambda2", "0.1",
               "--tau1", "0.1", "--tau2", "0.05", "--num_layers", "2", "--max_steps", "400",
               "--batch_size", str(ALIGN_BATCH), "--lr", "1e-4", "--weight_decay", "1e-5",
               "--loss2_chunk_size", "8", "--align_mode", "intersection"]
VAE_BATCH = 1024

# the build above FULL_STATS_MAX_N: one 65536-patch slide streamed in stripes
# of 1024 rows, bf16 upload and sampled statistics at 36864 patches, card vs
# CPU at 6000; the batched build's bucketed slides; the dense graph
BIG_N, STRIPE, MID_N, CPU_N, BUCKET_FILES, DENSE_N = 65536, 1024, 36864, 6000, 16, 2048

# the experiment matrix (experiments/matrix.py): six of
# tests/test_experiment_matrix.py's SMOKE representatives through the training
# CLI at the matrix's widths (phase 19 runs the seventh,
# combined_svd_gate_random_clam)
MATRIX_RUNS = ["0.clam/clam/tma_wsi_clam", "0.clam/clam_mlp/all_clam_mlp",
               "0.clam/clip_gate_random_clam_detach/clip_random_clam_detach",
               "1.deep_supervise/random/ds_svd_random", "2.related_works/mfmf_config1",
               "3.additional_exp/svd_pool_max"]

# the parallel layer: gangs of ranks on this one card (gloo) beside an NCCL
# world of 1 in this process; one training window of 16 cases with WSI bags
# of up to 1024 patches at each trainer's width
GANG_TIMEOUT = 300
MESH_WINDOW, MESH_WSI = 16, 1024
DRY = "multimodal_fusion_tpu_torch.parallel.dryrun"


def _card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if out.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


class Smoke:
    def __init__(self, torch):
        self.torch = torch
        self.card = _card_line()
        self.failures: list = []
        self.kernels: dict = {}
        self.walls: dict = {}  # phase name -> wall in s
        self.t_phase = None  # start of the running phase

    def log(self, msg: str) -> None:
        """Print ``msg``; inside a phase, with the seconds since it began."""
        if self.t_phase is not None:
            msg = f"{msg}  [+{time.perf_counter() - self.t_phase:.1f} s]"
        print(msg, flush=True)

    def timed(self, msg: str) -> None:
        self.log(f"  [{self.card}] {msg}")

    def check(self, ok: bool, what: str) -> None:
        self.log(f"  {'PASS' if ok else 'FAIL'}: {what}")
        if not ok:
            self.failures.append(what)

    def cuda_ms(self, fn, iters: int = 20, warmup: int = 3) -> float:
        torch = self.torch
        for _ in range(warmup):
            fn()
        torch.cuda.synchronize()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(iters):
            fn()
        e1.record()
        e1.synchronize()
        return e0.elapsed_time(e1) / iters

    def host_us(self, fn, iters: int = 300, warmup: int = 20) -> float:
        """Host time per call of ``fn`` in microseconds: no synchronisation
        inside the timed loop, so kernels shorter than the call hide
        behind it."""
        for _ in range(warmup):
            fn()
        self.torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        t1 = time.perf_counter()
        self.torch.cuda.synchronize()
        return (t1 - t0) / iters * 1e6

    def device_ms(self, fn, reps: int = 5) -> dict:
        """Device time per call of ``fn`` by kernel (short name -> ms), from
        torch.profiler over ``reps`` calls after a warm-up: without the
        host's launch overhead, which the event-timed loop of ``cuda_ms``
        includes whenever it exceeds the kernels' time.

        The profiler is a measurement, not a check: a profile that sees no
        device time, or raises, is taken again up to twice, and after that
        the call returns {} and the caller reports the time as not
        measured."""
        from torch.profiler import ProfilerActivity, profile

        fn()
        self.torch.cuda.synchronize()
        for attempt in range(3):
            try:
                with profile(activities=[ProfilerActivity.CUDA]) as prof:
                    for _ in range(reps):
                        fn()
                    self.torch.cuda.synchronize()
                events = _device_events(prof)
            except Exception as exc:  # noqa: BLE001 - reported, then retried
                self.log(f"  profiler attempt {attempt + 1} raised {type(exc).__name__}: {exc}")
                continue
            if events:
                out: dict = {}
                for e, us in events:
                    name = e.key.replace("void ", "").replace("(anonymous namespace)::", "").split("(")[0]
                    out[name] = out.get(name, 0.0) + us / 1e3 / reps
                return out
            self.log(f"  profiler attempt {attempt + 1} saw no device time")
        self.log("  device time not measured")
        return {}

    def phase(self, name: str, fn) -> None:
        self.log(f"== {name}")
        t0 = self.t_phase = time.perf_counter()
        try:
            fn()
        except Exception:  # a failed phase fails the run; later phases still report
            tb = traceback.format_exc()
            self.log(tb)
            print(f"{name}:\n{tb}", file=sys.stderr, flush=True)
            self.failures.append(f"{name}: exception")
        self.t_phase = None
        self.walls[name] = time.perf_counter() - t0
        self.log(f"   ({name}: {self.walls[name]:.1f} s wall)")

    def walls_line(self) -> str:
        total = sum(self.walls.values())
        top = sorted(self.walls.items(), key=lambda x: x[1], reverse=True)[:6]
        return (f"phase walls: {total:.1f} s over {len(self.walls)} phases = "
                f"{100 * total / TIME_LIMIT_S:.1f}% of the {TIME_LIMIT_S} s limit; longest: "
                + ", ".join(f"{n.split('.')[0]} {w:.1f} s" for n, w in top))


def _ptxas_summary(log):
    """One entry per kernel of nvcc's ``-Xptxas -v`` report: the kernel and
    its template arguments, registers and spill bytes."""
    import re

    out, name, spill = [], None, ""
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", ln)
        if m:
            k = re.search(r"((?:attn|sim|knn)\w*?_kernel)(I\w*?EE)?", m.group(1))
            args = [] if not k else [
                {"13__nv_bfloat16": "bf16", "f": "f32"}.get(t, t[2:-1])
                for t in re.findall(r"13__nv_bfloat16|Li\d+E|f", k.group(2) or "")]
            name = (k.group(1) if k else m.group(1)[-40:]) + (f"<{','.join(args)}>" if args else "")
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)
        if m:
            spill = f"{m.group(1)}/{m.group(2)} B spill st/ld"
        m = re.search(r"Used (\d+) registers", ln)
        if m and name:
            out.append(f"{name} {m.group(1)} regs {spill}")
            name = None
    return out


def _similarity_work(m, n, d, p, feat_bytes):
    """(operations, bytes) of K1 on an [m, n] tile of d-wide features and
    p-wide positions."""
    ops = (2 * d + 3 * p + 5) * m * n + 2 * (m + n) * d
    nbytes = (m + n) * d * feat_bytes + (m + n) * p * 4 + m * n * 4
    return ops, nbytes


def _similarity_bound_ms(m, n, d, p, feat_bytes):
    return _bound_ms(*_similarity_work(m, n, d, p, feat_bytes), 4)


def _knn_bound_ms(n, d, k):
    ops = 2 * n * n * d + 4 * n * n + 2 * n * d
    nbytes = n * d * 4 + n * k * 8
    return _bound_ms(ops, nbytes, 4)


def _knn_two_calls(torch, x, k):
    """A yardstick for K2 from PyTorch calls: the norm expansion in one
    addmm, then torch.topk (no self pin, no tie order)."""
    sq = (x * x).sum(dim=1)
    return torch.topk(torch.addmm(sq[:, None] + sq[None, :], x, x.T, alpha=-2.0), k, dim=1,
                      largest=False)


def _knn_digest(d, i) -> str:
    """SHA-256 of K2's (distances, int64 indices), first 16 hex digits."""
    return hashlib.sha256(d.cpu().numpy().tobytes() + i.long().cpu().numpy().tobytes()).hexdigest()[:16]


def _attention_bound_ms(b, h, t_q, t_k, hd, itemsize):
    """Operations 4*B*H*Tq*Tk*hd (q k^T and P.V) at the f32 non-tensor or
    the bf16 tensor peak; bytes of q, k, v and o at the HBM rate."""
    ops = 4 * b * h * t_q * t_k * hd
    nbytes = b * h * (2 * t_q + 2 * t_k) * hd * itemsize
    return _bound_ms(ops, nbytes, itemsize)


def _attention_bwd_work(b, h, t_q, t_k, hd, itemsize, valid_keys=None):
    """(operations, bytes) of the recompute backward: 10 * H * hd * Tq
    FLOPs per key a case keeps (the five products s, dp, dq, dk, dv), and
    q, k, v, do read and dq, dk, dv written at the input width, m, l and
    dsum read in float32."""
    keys = b * t_k if valid_keys is None else valid_keys
    ops = 10 * h * hd * t_q * keys
    nbytes = b * h * hd * (3 * t_q + 4 * t_k) * itemsize + 3 * b * h * t_q * 4
    return ops, nbytes


def _bound_ms(ops, nbytes, itemsize):
    """The larger of the operations at the card's f32 non-tensor (or bf16
    tensor) peak and the bytes at its HBM rate, in ms, and which one it
    is; the peaks are ``utils/mfu.chip_peaks``'s table."""
    from multimodal_fusion_tpu_torch.utils.mfu import chip_peaks

    _, peak_bf16, peak_f32, peak_bytes = chip_peaks()
    t_ops = ops / (peak_f32 if itemsize == 4 else peak_bf16)
    t_bytes = nbytes / peak_bytes
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def _device_gaps(trace_path):
    """Device timeline of a profiler chrome trace: (span from the first
    device op's start to the last one's end, busy time as the union of the
    ops' intervals, the gaps between them as (us, op before, op after)
    sorted largest first), all in microseconds."""
    with open(trace_path) as f:
        events = [e for e in json.load(f).get("traceEvents", [])
                  if e.get("ph") == "X" and e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    if not events:
        return 0.0, 0.0, []
    events.sort(key=lambda e: float(e["ts"]))
    busy, gaps = 0.0, []
    start, end, last = float(events[0]["ts"]), float(events[0]["ts"]), events[0]
    for e in events:
        t0, t1 = float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0))
        if t0 > end:
            gaps.append((t0 - end, last["name"], e["name"]))
            busy += end - start
            start = t0
        if t1 >= end:
            end, last = t1, e
    busy += end - start
    span = end - float(events[0]["ts"])
    return span, busy, sorted(gaps, key=lambda g: g[0], reverse=True)


class _CsvCases:
    """The dataset interface the serving path reads (``case_ids``,
    ``case_to_patient``, ``labels``, ``get_case``) over a request's CSV,
    whose rows' ``h5_file_path`` name cases held in host memory: it stands
    in for ``utils.results_io.build_dataset``'s HDF5 reader, since the
    card's machine has no h5py.  Labels map as the HDF5 dataset maps them
    (sorted unique labels)."""

    has_survival_time = False

    def __init__(self, csv_path, by_path):
        import csv

        with open(csv_path, newline="") as f:
            rows = list(csv.DictReader(f))
        self._rows = {r["case_id"]: r for r in rows if r["h5_file_path"] in by_path}
        self._by_path = by_path
        self.case_ids = sorted(self._rows)
        self.case_to_patient = {c: r["patient_id"] for c, r in self._rows.items()}
        uniq = sorted({r["label"] for r in self._rows.values()})
        self.label_to_int = {label: i for i, label in enumerate(uniq)}
        self.labels = np.asarray([self.label_to_int[self._rows[c]["label"]] for c in self.case_ids])

    def __len__(self):
        return len(self.case_ids)

    def get_case(self, case_id):
        r = self._rows[case_id]
        return self._by_path[r["h5_file_path"]], self.label_to_int[r["label"]]


class _CaseTable:
    """The dataset interface ``SurvivalTrainer.train_fold`` and the training
    CLI's ``run`` read (``case_ids``, ``labels``, ``case_to_patient``,
    ``get_case``) over cases held in host memory: the card's machine has no
    h5py or pandas to read the HDF5 layout that
    ``data.multimodal.MultimodalDataset`` reads.  Patient ids are phase
    16's (1000 + the case's index)."""

    has_survival_time = False

    def __init__(self, raws, labels):
        self.case_ids = [f"case_{i:03d}" for i in range(len(raws))]
        self.case_to_patient = {c: str(1000 + i) for i, c in enumerate(self.case_ids)}
        self._cases = dict(zip(self.case_ids, zip(raws, (int(x) for x in labels))))
        self.labels = np.asarray(labels, np.int64)

    def __len__(self):
        return len(self.case_ids)

    def get_case(self, case_id):
        return self._cases[case_id]


class _MemDataset:
    """One dataset of the in-memory HDF5 stand-in (``_mem_h5py``)."""

    def __init__(self, data):
        self._data = np.asarray(data)

    @property
    def shape(self):
        return self._data.shape

    @property
    def dtype(self):
        return self._data.dtype

    def __array__(self, dtype=None, copy=None):
        return self._data if dtype is None else self._data.astype(dtype)

    def __getitem__(self, idx):
        return self._data[idx]


class _MemGroup:
    """One group of the in-memory HDF5 stand-in: slash paths, datasets,
    subgroups and ``attrs``, as far as the port's HDF5 code uses h5py."""

    def __init__(self):
        self._items, self.attrs = {}, {}

    def _parent(self, key, create=False):
        parts = [q for q in key.split("/") if q]
        node = self
        for part in parts[:-1]:
            if part not in node._items:
                if not create:
                    raise KeyError(key)
                node._items[part] = _MemGroup()
            node = node._items[part]
            if not isinstance(node, _MemGroup):
                raise KeyError(key)
        return node, parts[-1]

    def __contains__(self, key):
        try:
            node, last = self._parent(key)
        except KeyError:
            return False
        return last in node._items

    def __getitem__(self, key):
        node, last = self._parent(key)
        return node._items[last]

    def __setitem__(self, key, value):
        node, last = self._parent(key, create=True)
        node._items[last] = _MemDataset(value)

    def __delitem__(self, key):
        node, last = self._parent(key)
        del node._items[last]

    def get(self, key, default=None):
        return self[key] if key in self else default

    def keys(self):
        return list(self._items)

    def create_group(self, key):
        node, last = self._parent(key, create=True)
        node._items[last] = _MemGroup()
        return node._items[last]

    def require_group(self, key):
        return self[key] if key in self else self.create_group(key)

    def create_dataset(self, key, data=None, **_):
        self[key] = data
        return self[key]

    def visititems(self, fn):
        def walk(prefix, group):
            for name, obj in group._items.items():
                fn(prefix + name, obj)
                if isinstance(obj, _MemGroup):
                    walk(prefix + name + "/", obj)
        walk("", self)


def _mem_h5py(store):
    """A module standing in for ``h5py`` over ``store`` (path -> root
    group): the card's machine has no h5py, and with this in
    ``sys.modules`` the port's HDF5 entry points (``process_dataset``, the
    build CLI, the caches and the rebuild) run unchanged on files held in
    host memory.  A file it creates is also touched on disk, for the CSV
    loops' ``os.path.exists``."""
    import types

    class File(_MemGroup):
        def __init__(self, path, mode="r"):
            key = str(path)
            if mode == "r" and key not in store:
                raise FileNotFoundError(key)
            if mode == "w" or key not in store:
                store[key] = _MemGroup()
                Path(key).touch()  # for os.path.exists
            self._items, self.attrs = store[key]._items, store[key].attrs

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

        def close(self):
            pass

    mod = types.ModuleType("h5py")
    mod.File, mod.Group, mod.Dataset = File, _MemGroup, _MemDataset
    return mod


@contextlib.contextmanager
def _hdf5_files():
    """(directory, how) for HDF5 files: h5py's own files where h5py is
    installed, else the in-memory stand-in installed as ``h5py`` for the
    block's duration."""
    td = Path(tempfile.mkdtemp(prefix="h5_"))
    try:
        import h5py  # noqa: F401
        stand_in = False
    except ImportError:
        stand_in = True
        sys.modules["h5py"] = _mem_h5py({})
    try:
        yield td, ("HDF5 files held in host memory (an in-memory h5py stand-in: no h5py here)"
                   if stand_in else "h5py files")
    finally:
        if stand_in:
            del sys.modules["h5py"]
        shutil.rmtree(td, ignore_errors=True)


def _mfmf_cases(rng, markers, tabular_dims, gen):
    """``MFMF_CASES`` raw cases as ``MultimodalDataset.get_case`` returns
    them: a WSI bag of 2048-4096 patches x 1024 and its reconstruction
    (the bag plus small noise), each marker's 9-16 TMA patches, and each
    tabular group's [1, D] values with a 0/1 mask; balanced labels.  The
    bags (4 GB in all) are drawn on the card from the CUDA generator
    ``gen`` and copied to host memory; the rest from ``rng``."""
    import torch

    raws = []
    for _ in range(MFMF_CASES):
        n = int(rng.integers(MFMF_WSI[0], MFMF_WSI[1] + 1))
        wsi = torch.randn((n, DIM), generator=gen, device=gen.device)
        recon = wsi + 0.05 * torch.randn((n, DIM), generator=gen, device=gen.device)
        raw = {"wsi=features": wsi.cpu().numpy(), "wsi=reconstructed_features": recon.cpu().numpy()}
        for mk in markers:
            n_tma = int(rng.integers(MFMF_TMA[0], MFMF_TMA[1] + 1))
            raw[f"tma={mk}=features"] = rng.standard_normal((n_tma, DIM), dtype=np.float32)
        for group, dim in tabular_dims.items():
            raw[f"{group}=val"] = rng.standard_normal((1, dim), dtype=np.float32)
            raw[f"{group}=mask"] = (rng.random((1, dim)) > 0.2).astype(np.float32)
        raws.append(raw)
    return raws, rng.permutation(np.arange(MFMF_CASES) % 2)


def _clustered_slides_on_card(sizes, gen, n_tma=N_TMA, dim=DIM, n_blobs=12):
    """``io.fixtures.clustered_slide``'s slides (its blob scales), one of
    each size in ``sizes``, drawn on the card from the CUDA generator
    ``gen`` and copied to host memory: (features [N, D], positions [N, 2],
    tma [T, D]) float32."""
    import torch

    def normal(*shape):
        return torch.randn(shape, generator=gen, device=gen.device)

    slides = []
    for n in sizes:
        centers = normal(n_blobs, dim) * np.sqrt(1.75 / dim)
        pos_centers = 4.0 * torch.rand((n_blobs, 2), generator=gen, device=gen.device)
        assign = torch.randint(0, n_blobs, (n,), generator=gen, device=gen.device)
        feats = centers[assign] + normal(n, dim) * np.sqrt(0.25 / dim)
        pos = pos_centers[assign] + 0.3 * normal(n, 2)
        tma_assign = torch.randint(0, n_blobs, (n_tma,), generator=gen, device=gen.device)
        tma = centers[tma_assign] + normal(n_tma, dim) * np.sqrt(0.25 / dim)
        slides.append(tuple(t.cpu().numpy() for t in (feats, pos, tma)))
    return slides


def _vit_dense_flops(n_images, dim=1024, depth=VIT_DEPTH, tokens=VIT_TOKENS, patch=16):
    """FLOPs of ViT-L/16's Linear layers for ``n_images`` (qkv, proj, fc1,
    fc2 per token and block, plus the patch embedding); attention is K3's."""
    per_token = 2 * dim * (3 * dim + dim + 4 * dim + 4 * dim)
    embed = 2 * (patch * patch * 3) * dim * (tokens - 1)
    return n_images * (depth * tokens * per_token + embed)


def _device_events(prof):
    """Device-side entries of a profile (kernels and copies; the operator
    entries above them carry the same device time again), with their
    device time in microseconds."""
    from torch.autograd import DeviceType

    def dev_us(e):
        return getattr(e, "device_time_total", None) or getattr(e, "cuda_time_total", 0)

    return [(e, dev_us(e)) for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and dev_us(e) > 0]


def _synthetic_core(rng, h, w):
    """uint8 [h, w, 3] tissue-like core: blocky colour field plus noise."""
    base = rng.integers(60, 200, (h // 32 + 1, w // 32 + 1, 3))
    img = np.repeat(np.repeat(base, 32, axis=0), 32, axis=1)[:h, :w]
    return np.clip(img + rng.normal(0, 20, (h, w, 3)), 0, 255).astype(np.uint8)


def _bf16_units(got, want, scale) -> float:
    """Largest |got - want| of bf16 attention outputs in units of
    2^-8 * ``scale``, where ``scale`` is the plain version's output on |v|
    (elementwise sum_j p_j |v_j| / l, the size of the terms o sums; o
    itself may cancel to near zero).  Each side rounds every p_j to bf16
    (a flip moves p_j by at most 2^-7 of itself) and o to bf16 (at most
    2^-7 of |o| <= scale), so the two agree within 4 units, up to float32
    rounding."""
    err = (got.float() - want.float()).abs()
    return float((err / (scale.float().clamp_min(1e-30) * 2 ** -8)).max())


def _rel_l2(a, b) -> float:
    """Largest per-row relative L2 distance of ``a`` from ``b``."""
    return float((np.linalg.norm(a - b, axis=1) / np.linalg.norm(b, axis=1)).max())


def _rel_l2_all(a, b) -> float:
    """Relative L2 distance of tensor ``a`` from ``b`` over all elements."""
    return float((a.float() - b.float()).norm() / b.float().norm().clamp_min(1e-30))


def _exact_sq_dists(x64, idx, chunk: int = 512):
    """[N, k] float64 squared distances from each row of ``x64`` to the rows
    ``idx`` lists for it."""
    out = idx.new_empty(idx.shape, dtype=x64.dtype)
    for r0 in range(0, idx.shape[0], chunk):
        rows = x64[r0:r0 + chunk, None, :]
        out[r0:r0 + chunk] = ((x64[idx[r0:r0 + chunk]] - rows) ** 2).sum(-1)
    return out


def _ari(a, b) -> float:
    """Adjusted Rand index of two labelings (numpy only)."""
    _, ai = np.unique(a, return_inverse=True)
    _, bi = np.unique(b, return_inverse=True)
    table = np.zeros((ai.max() + 1, bi.max() + 1), np.int64)
    np.add.at(table, (ai, bi), 1)

    def comb2(x):
        return (x * (x - 1) / 2.0).sum()

    sum_ij = comb2(table)
    sum_a = comb2(table.sum(1))
    sum_b = comb2(table.sum(0))
    expected = sum_a * sum_b / comb2(np.array([len(a)]))
    max_index = (sum_a + sum_b) / 2.0
    return float((sum_ij - expected) / (max_index - expected)) if max_index != expected else 1.0


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script needs a CUDA card",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    from multimodal_fusion_tpu_torch.channels import TMA_MARKERS, h5_path_for_channel, parse_channels
    from multimodal_fusion_tpu_torch.cli import main_survival as cli_main
    from multimodal_fusion_tpu_torch.config import Configs, ExperimentConfig, ModelConfig
    from multimodal_fusion_tpu_torch.data.splits import create_k_fold_splits
    from multimodal_fusion_tpu_torch.data.tma_extraction import (
        extract_marker_features,
        make_feature_extractor,
        save_marker_npz,
    )
    from multimodal_fusion_tpu_torch.device import resolve_device
    from multimodal_fusion_tpu_torch.hypergraph import build
    from multimodal_fusion_tpu_torch.io.h5io import open_h5_retrying, read_hypergraph_group
    from multimodal_fusion_tpu_torch.data.alignment import TMANpzAlignedWithNegDataset
    from multimodal_fusion_tpu_torch.data.vae_patches import WSIVAEDataset, split_train_val
    from multimodal_fusion_tpu_torch.io.fixtures import (
        TABULAR_DIMS,
        clustered_slide,
        make_alignment_npz_fixtures,
        make_clustered_dataset,
    )
    from multimodal_fusion_tpu_torch.models.alignment import MultiModalAlignmentModel
    from multimodal_fusion_tpu_torch.models.vae import VAE, vae_loss
    from multimodal_fusion_tpu_torch.train.alignment import MultiModalAlignmentTrainer
    from multimodal_fusion_tpu_torch.train.vae import VAETrainer
    from multimodal_fusion_tpu_torch.models.base import checkpoint_replaying
    from multimodal_fusion_tpu_torch.models.factory import ModelFactory
    from multimodal_fusion_tpu_torch.models.mfmf import DEFAULT_FUSION_SEQUENCE
    from multimodal_fusion_tpu_torch.models.vit import vit_large_16
    from multimodal_fusion_tpu_torch.ops import _cuda
    from multimodal_fusion_tpu_torch.ops.attention import (
        plain_fused_attention,
        plain_fused_attention_bwd,
    )
    from multimodal_fusion_tpu_torch.ops.attention_kernel import (
        ROUTES,
        _route,
        attention_bwd,
        attention_fwd,
    )
    from multimodal_fusion_tpu_torch.ops.kmeans import kmeans_plus_plus_init
    from multimodal_fusion_tpu_torch.ops.knn import knn_indices, knn_indices_blockwise
    from multimodal_fusion_tpu_torch.ops import losses as losses_mod
    from multimodal_fusion_tpu_torch.ops.knn_kernel import knn
    from multimodal_fusion_tpu_torch.ops.losses import (
        _jacobi_eigh_desc,
        aucm_loss,
        clip_alignment_loss,
        cox_ph_loss,
        rank1_svd_loss,
        volume_loss,
    )
    from multimodal_fusion_tpu_torch.ops.similarity_kernel import (
        similarity_rect,
        similarity_rect_plain,
    )
    from multimodal_fusion_tpu_torch.data.batching import make_window
    from multimodal_fusion_tpu_torch.data.splits import FoldSplit
    from multimodal_fusion_tpu_torch.train.checkpoint import load_model, load_state, save_model
    from multimodal_fusion_tpu_torch.train.optim import make_optimizer
    from multimodal_fusion_tpu_torch.train.survival import SurvivalTrainer
    from multimodal_fusion_tpu_torch.utils import results_io
    from multimodal_fusion_tpu_torch.utils.predict import ensemble_rows, predict, write_csv
    from multimodal_fusion_tpu_torch.utils.serve import make_server

    dev = resolve_device("cuda")
    s = Smoke(torch)
    counters = {"similarity": similarity_rect, "knn": knn, "attention": attention_fwd,
                "attention_bwd": attention_bwd}
    main_path_launches = {name: 0 for name in counters}
    routed = {"attention": attention_fwd, "attention_bwd": attention_bwd}  # K3, K4: counts per route
    main_path_routes = {name: dict.fromkeys(ROUTES, 0) for name in routed}
    route_ms = {name: {r: {} for r in ROUTES} for name in routed}  # shape label -> ms
    main_path_ms_per_slide: list = []  # phase 4's median window, read by phase 7

    def reset_counts():
        for fn in counters.values():
            fn.launches = 0
        for fn in routed.values():
            fn.route_launches = dict.fromkeys(ROUTES, 0)

    def add_main_path_counts():
        for name, fn in counters.items():
            main_path_launches[name] += fn.launches
        for name, fn in routed.items():
            for r in ROUTES:
                main_path_routes[name][r] += fn.route_launches[r]

    def mfmf_masks(rng):
        """MFMF's key masks for a 64-case window: the 8 markers' 64-row
        buckets with 9-16 valid rows each [64, 512], and the WSI bag's
        4096-row bucket with 2048-4096 valid [64, 4096]."""
        markers = torch.as_tensor(np.concatenate(
            [np.arange(64)[None] < rng.integers(MFMF_TMA[0], MFMF_TMA[1] + 1, (MFMF_BATCH, 1))
             for _ in range(8)], axis=1), device=dev)
        wsi = torch.as_tensor(
            np.arange(4096)[None] < rng.integers(MFMF_WSI[0], MFMF_WSI[1] + 1, (MFMF_BATCH, 1)), device=dev)
        return markers, wsi

    def config1_blocks(markers, wsi):
        """(label, Tq, Tk, key mask) of mfmf_config1's two general blocks."""
        return [("config1 block 2 result->wsi [64x8, 512x4096, 16]", 512, 4096, wsi),
                ("config1 block 3 reconstruct->result [64x8, 4096x512, 16]", 4096, 512, markers)]

    def check_k1(label, rf, rp, cf, cp, bf16=False, stripe=4096, digest=False):
        """K1 against its plain version on the same inputs: max abs err <= 1e-5
        and two launches bit-identical.  The plain version runs in row
        stripes (whole, its float64 temporaries at 32768 patches would take
        tens of GiB beside the kernel's two 4 GiB outputs); returns (err,
        the plain K assembled in float32).  ``digest`` prints a SHA-256 of
        the output's bytes, by which two versions of the kernel can be
        compared bit for bit across runs."""
        out = similarity_rect(rf, rp, cf, cp, 1.0, 1.0, bf16)
        again = similarity_rect(rf, rp, cf, cp, 1.0, 1.0, bf16)
        s.check(bool(torch.equal(out, again)), f"K1 {label}: two launches bit-identical")
        if digest:
            s.log(f"  K1 {label}: output sha256 "
                  f"{hashlib.sha256(out.cpu().numpy().tobytes()).hexdigest()[:16]}")
        del again
        plain = torch.empty_like(out)
        err = 0.0
        for r0 in range(0, out.shape[0], stripe):
            r1 = r0 + stripe
            plain[r0:r1] = similarity_rect_plain(rf[r0:r1], rp[r0:r1], cf, cp, 1.0, 1.0, bf16)
            err = max(err, float((out[r0:r1] - plain[r0:r1]).abs().max()))
        # 1e-5 abs on K in [0, 1]: the kernel sums f32 products in 16-wide
        # chunks, the plain version evaluates the feature term in float64
        s.check(err <= 1e-5, f"K1 {label}: max abs err {err:.3e} <= 1e-5")
        return err, plain

    def check_build_k1(label, feats, pos, k_stats):
        """K1 at a build's own shape and inputs (the slide as the build
        uploads it), and the build's K statistics against the statistics of
        the plain version's K."""
        f = torch.as_tensor(feats, device=dev)
        p = torch.as_tensor(pos, device=dev)
        _, plain = check_k1(label, f, p, f, p)
        want = build._matrix_stats_dev(plain).cpu().numpy()
        del plain
        serr = float(np.abs(want - k_stats).max())
        # K within 1e-5 elementwise moves mean, std, min, max and median by
        # at most about that much
        s.check(serr <= 1e-5, f"{label}: build's K_stats vs the plain K's, max abs diff "
                              f"{serr:.2e} <= 1e-5")

    def check_k2(label, x, k, exact, digest=False):
        """K2 against its plain version on ``x``; returns (max abs distance
        difference, the kernel's indices).  ``exact`` (integer-valued
        features: every distance exact in f32, ties many) demands identical
        indices.  ``digest`` prints a SHA-256 of the (distances, indices)
        bytes, by which two versions of the kernel can be compared bit for
        bit across runs.

        On float data, errors are held relative to the scale at which f32
        rounds the norm expansion, ||x_i||^2 + ||x_j||^2: a squared distance
        far below that scale (near-duplicate super-patch means) cancels, so
        an error relative to the distance itself says nothing about the
        arithmetic.  The kernel's squared distances must lie within 1e-5 of
        that scale of the float64 ones at the neighbours it returned: the
        worst case of 16-wide chunked f32 sums over D = 1024, and 50x below
        TF32's rounding.  At most 1% of rows may differ from the plain
        version, and only between near-ties: slot by slot, float64 squared
        distances within 2e-5 of the scale (each side may be off by 1e-5)."""
        d_k, i_k = knn(x, k)
        d_p, i_p = knn_indices_blockwise(x, k)
        torch.cuda.synchronize()
        if digest:
            s.log(f"  K2 {label}: (distances, indices) sha256 {_knn_digest(d_k, i_k)}")
        x64 = x.double()
        sq = (x64 * x64).sum(dim=1)
        e_k = _exact_sq_dists(x64, i_k)
        if exact:
            s.check(bool(torch.equal(i_k, i_p)), f"K2 {label}: indices identical to the plain version")
        else:
            differ = (i_k != i_p).any(dim=1)
            share = float(differ.float().mean())
            s.check(share <= 0.01, f"K2 {label}: {int(differ.sum())} rows differ from the plain "
                                   f"version ({100 * share:.3f}% <= 1%)")
            e_p = _exact_sq_dists(x64, i_p)
            scale = (sq[:, None] + torch.maximum(sq[i_k], sq[i_p])).clamp_min(1e-12)
            tie = float(((e_k - e_p).abs() / scale).max())
            s.check(tie <= 2e-5, f"K2 {label}: differing neighbours are near-ties (float64 "
                                 f"squared distances within {tie:.2e} <= 2e-5 of the scale)")
        err = float(((d_k.double() ** 2 - e_k).abs() / (sq[:, None] + sq[i_k]).clamp_min(1e-12)).max())
        rel = float(((d_k.double() - e_k.sqrt()).abs() / e_k.sqrt().clamp_min(1e-6)).max())
        s.check(err <= 1e-5, f"K2 {label}: squared distances within {err:.2e} <= 1e-5 of the "
                             f"scale of float64 (relative to the distance: {rel:.2e})")
        return float((d_k - d_p).abs().max()), i_k

    # ---------------------------------------------------------------- 1
    def device_phase():
        s.log(f"  nvidia-smi: {s.card}")
        s.log(f"  torch {torch.__version__}, CUDA {torch.version.cuda}, "
              f"device {torch.cuda.get_device_name(0)}, count {torch.cuda.device_count()}")
        t0 = time.perf_counter()
        report = _cuda.build_all()
        s.log(f"  kernel build: {time.perf_counter() - t0:.2f} s wall (nvcc in parallel)")
        for name, info in report.items():
            s.log(f"    {name}: {info['seconds']:.2f} s")
            for line in _ptxas_summary(info["log"]):
                s.log(f"      {line}")

    # ---------------------------------------------------------------- 2
    def similarity_phase():
        rng = np.random.default_rng(0)
        feats, pos, _ = clustered_slide(rng, N_PATCHES, N_TMA, DIM)
        f = torch.as_tensor(feats, device=dev)
        p = torch.as_tensor(pos, device=dev)
        rag_f = torch.as_tensor(
            (rng.standard_normal((4001, 1000)) * np.sqrt(1.0 / 1000)).astype(np.float32), device=dev
        )
        rag_p = torch.as_tensor(rng.uniform(0, 4, (4001, 2)).astype(np.float32), device=dev)
        f_bf = f.to(torch.bfloat16).float()  # bf16_exact's precondition
        cases = [
            ("f32 [4096,4096,1024]", f, p, f, p, False),
            ("ragged [1000x3001, D=1000]", rag_f[:1000], rag_p[:1000], rag_f[1000:], rag_p[1000:], False),
            ("bf16_exact [4096,4096,1024]", f_bf, p, f_bf, p, True),
        ]
        for label, rf, rp, cf, cp, bf in cases:
            err, _ = check_k1(label, rf, rp, cf, cp, bf, digest=True)
            ms = s.cuda_ms(lambda: similarity_rect(rf, rp, cf, cp, 1.0, 1.0, bf))
            plain_ms = s.cuda_ms(lambda: similarity_rect_plain(rf, rp, cf, cp, 1.0, 1.0, bf))
            lib_ms = s.cuda_ms(lambda: torch.matmul(rf, cf.T))
            m, d = rf.shape
            bound, bound_by = _similarity_bound_ms(m, cf.shape[0], d, rp.shape[1], 2 if bf else 4)
            s.timed(f"K1 {label}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
                    f"torch.matmul feature dot {lib_ms:.4f} ms, bound {bound:.4f} ms ({bound_by})")
            if label.startswith("f32"):  # the main path's call
                s.kernels["similarity"] = {
                    "name": "similarity", "route": "cuda",
                    "source": "multimodal_fusion_tpu_torch/csrc/similarity.cu",
                    "replaces": "multimodal_fusion_tpu/ops/pallas_similarity.py:56",
                    "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                    "bound_ms": bound, "bound_by": bound_by, "library_ms": lib_ms,
                }

    # ---------------------------------------------------------------- 3
    def knn_phase():
        rng = np.random.default_rng(1)
        # integer-valued features: every distance is exact in f32 whatever
        # the summation order, so indices must be identical, ties included
        # (they rank by (distance, smallest index) on both sides).  Float
        # clustered-blob features at the large-node build's shape (4096
        # nodes, k + 1 = 6), where the distances are rounded.
        cases = [
            ("integer N=5000 k=6", rng.integers(-2, 3, (5000, DIM)), 6, True),
            ("integer N=5000 k=128", rng.integers(-2, 3, (5000, DIM)), 128, True),
            ("float N=4096 k=6", clustered_slide(rng, 4096, N_TMA, DIM)[0], 6, False),
        ]
        for label, data, k, exact in cases:
            x = torch.as_tensor(data.astype(np.float32), device=dev)
            n = x.shape[0]
            err, _ = check_k2(label, x, k, exact, digest=True)
            ms = s.cuda_ms(lambda: knn(x, k), iters=20)
            plain_ms = s.cuda_ms(lambda: knn_indices_blockwise(x, k), iters=20)
            dot_ms = s.cuda_ms(lambda: torch.matmul(x, x.T), iters=20)
            two_ms = s.cuda_ms(lambda: _knn_two_calls(torch, x, k), iters=20)
            bound, bound_by = _knn_bound_ms(n, DIM, k)
            s.timed(f"K2 {label} D={DIM}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
                    f"bound {bound:.4f} ms ({bound_by}); yardsticks: torch.matmul(x, x.T) "
                    f"(the dot alone) {dot_ms:.4f} ms, two calls (addmm norm expansion, "
                    f"torch.topk) {two_ms:.4f} ms; no single PyTorch call computes it")
            if not exact:  # the large-node build's call
                s.kernels["knn"] = {
                    "name": "knn", "route": "cuda",
                    "source": "multimodal_fusion_tpu_torch/csrc/knn.cu",
                    "replaces": "multimodal_fusion_tpu/ops/pallas_knn.py:35",
                    "max_abs_err": err, "ms": ms,
                    "plain_ms": plain_ms, "bound_ms": bound, "bound_by": bound_by,
                    "library_ms": None,
                }
        # the build's node-KNN dispatch (knn_indices_auto) keeps the JAX
        # package's threshold of 4096 nodes; where would the card put it?
        for n in (1024, 2048, 4096):
            x = torch.as_tensor(clustered_slide(rng, n, N_TMA, DIM)[0], device=dev)
            dense_ms = s.cuda_ms(lambda: knn_indices(x, 6), iters=10)
            k2_ms = s.cuda_ms(lambda: knn(x, 6), iters=10)
            s.timed(f"dispatch N={n} D={DIM} k=6: dense knn_indices ([N, N] distances + "
                    f"stable sort) {dense_ms:.4f} ms, K2 {k2_ms:.4f} ms")

    # ---------------------------------------------------------------- 4
    params = dict(num_wsi_super_patches=NUM_SUPER, num_groups=NUM_GROUPS,
                  hypergraph_k=K, num_hyperedges=NUM_HYPEREDGES, seed=SEED)

    def main_path_phase():
        rng = np.random.default_rng(0)
        slides = [clustered_slide(rng, N_PATCHES, N_TMA, DIM) for _ in range(N_FILES)]
        try:
            import h5py  # noqa: F401
            have_h5 = True
        except ImportError:
            have_h5 = False
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        warm = build.process_arrays(*slides[0], **params, save_similarity=False, device=dev)
        s.timed(f"warm-up slide (first CUDA use of the build): {time.perf_counter() - t0:.3f} s")
        built = 1
        if have_h5:
            with tempfile.TemporaryDirectory() as td:
                csv_path = make_clustered_dataset(td, N_FILES, N_PATCHES, N_TMA, DIM, seed=0)
                t0 = time.perf_counter()
                stats, summary = build.process_dataset(
                    csv_path, td, **params, save_similarity=False, pipeline_depth=4, device=dev,
                )
                wall = time.perf_counter() - t0
                s.check(not any("error" in st for st in stats), "process_dataset: no per-file errors")
                s.check(len(stats) == N_FILES, f"process_dataset built {len(stats)} files")
                built += len(stats)
            s.log("  HDF5 layer exercised: process_dataset on clustered-blob fixtures")
        else:
            # the same window of slides, several times: one window's reading
            # varies with the host's load
            walls, finite = [], True
            for _ in range(MAIN_PATH_WINDOWS):
                t0 = time.perf_counter()
                for sl in slides:
                    res = build.process_arrays(*sl, **params, save_similarity=False, device=dev)
                    finite &= bool(np.isfinite(res["host"]["K_stats"]).all())
                walls.append(time.perf_counter() - t0)
                built += len(slides)
            s.check(finite, f"K_stats finite on all {MAIN_PATH_WINDOWS * N_FILES} slides")
            s.log("  h5py is not installed: the HDF5 layer was NOT exercised; "
                  f"slides ran through process_arrays, one after another, {MAIN_PATH_WINDOWS} "
                  f"windows of {N_FILES} slides")
            s.log("  window walls (s): " + ", ".join(f"{w:.4f}" for w in walls))
            wall = float(np.median(walls))
            pps_all = sorted(N_FILES * N_PATCHES / w for w in walls)
            s.timed(f"main path windows: patches/s min {pps_all[0]:.1f}, "
                    f"max {pps_all[-1]:.1f}, spread {100 * (pps_all[-1] / pps_all[0] - 1):.1f}%")
        pps = N_FILES * N_PATCHES / wall
        main_path_ms_per_slide.append(wall / N_FILES * 1e3)
        s.timed(f"main path: {N_FILES} slides x {N_PATCHES} patches in {wall:.4f} s (median "
                f"window) = {pps:.1f} patches/s (after one warm-up slide)")
        add_main_path_counts()
        s.log(f"  launches: similarity {similarity_rect.launches}, knn {knn.launches}")
        s.check(similarity_rect.launches == built,
                f"K1 launched once per slide built ({similarity_rect.launches} == {built})")

        # check the output: shapes, finiteness, and a CPU rebuild of slide 0
        # from the same kmeans++ draws (generators are per device, so the
        # card's draws are repeated here and handed to the CPU build)
        h = warm["host"]
        ei = warm["arrays"]["edge_index"]
        s.check(h["sp_feats"].shape == (NUM_SUPER, DIM) and ei.shape[0] == 2 and ei.shape[1] > 0,
                f"slide 0 shapes: sp_feats {h['sp_feats'].shape}, edge_index {ei.shape}")
        s.check(all(np.isfinite(h[k]).all() for k in ("K_stats", "sim", "normed", "sp_feats")),
                "slide 0 outputs finite")
        g1, g2, g3 = build._generators(SEED, dev)
        feats0, pos0, tma0 = slides[0]
        sim = torch.as_tensor(h["sim"], device=dev)
        all_feats = torch.cat([torch.as_tensor(h["sp_feats"], device=dev),
                               torch.as_tensor(tma0, device=dev)])
        init = {
            "super": kmeans_plus_plus_init(torch.as_tensor(feats0, device=dev), NUM_SUPER, g1, 10).cpu(),
            "group": kmeans_plus_plus_init(sim, NUM_GROUPS, g2, 10).cpu(),
            "hyperedge": kmeans_plus_plus_init(all_feats, NUM_HYPEREDGES, g3, 10).cpu(),
        }
        t0 = time.perf_counter()
        cpu = build.process_arrays(*slides[0], **params, save_similarity=False, device="cpu",
                                   init_centers=init)
        s.log(f"  CPU rebuild of slide 0: {time.perf_counter() - t0:.1f} s (host)")
        ari = _ari(cpu["host"]["labels"], h["labels"])
        kerr = float(np.abs(cpu["host"]["K_stats"] - h["K_stats"]).max())
        ierr = float(abs(cpu["host"]["intra_mean"] - h["intra_mean"]))
        s.check(ari >= 0.99, f"super-patch labels vs CPU rebuild: ARI {ari:.4f} >= 0.99")
        s.check(kerr <= 1e-4, f"K_stats vs CPU rebuild: max abs diff {kerr:.2e} <= 1e-4")
        s.check(ierr <= 1e-4, f"intra_mean vs CPU rebuild: abs diff {ierr:.2e} <= 1e-4")

    # ---------------------------------------------------------------- 5
    def large_slide_phase():
        rng = np.random.default_rng(5)
        n = build.FULL_STATS_MAX_N
        slide = clustered_slide(rng, n, N_TMA, DIM)
        reset_counts()
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = build.process_arrays(*slide, **params, save_similarity=False, device=dev)
        wall = time.perf_counter() - t0
        add_main_path_counts()
        peak = torch.cuda.max_memory_allocated() / 2**30
        s.timed(f"{n}-patch slide: {wall:.3f} s ({n / wall:.1f} patches/s), "
                f"peak device memory {peak:.2f} GiB")
        s.check(similarity_rect.launches == 1, f"K1 launched for the {n}-patch slide")
        s.check(np.isfinite(res["host"]["K_stats"]).all(), f"{n}-patch K_stats finite")
        check_build_k1(f"[{n},{n},{DIM}] (the {n}-patch slide)", slide[0], slide[1],
                       res["host"]["K_stats"])
        held_builds["p5"] = res["host"]  # phase 36 holds the 2-rank build to it
        # K1 alone at this shape (the plain version's float64 temporaries
        # would take tens of GiB here: not timed)
        f, p = torch.as_tensor(slide[0], device=dev), torch.as_tensor(slide[1], device=dev)
        ms = s.cuda_ms(lambda: similarity_rect(f, p, f, p), iters=3, warmup=1)
        lib_ms = s.cuda_ms(lambda: torch.matmul(f, f.T), iters=3, warmup=1)
        bound, bound_by = _similarity_bound_ms(n, n, DIM, p.shape[1], 4)
        s.timed(f"K1 [{n},{n},{DIM}] f32 alone: kernel {ms:.4f} ms, torch.matmul feature dot "
                f"{lib_ms:.4f} ms, bound {bound:.4f} ms ({bound_by})")

    # ---------------------------------------------------------------- 6
    def large_node_phase():
        rng = np.random.default_rng(6)
        n_nodes, n_patches = LARGE_NODES, 2 * LARGE_NODES
        n_super = n_nodes - N_TMA
        slide = clustered_slide(rng, n_patches, N_TMA, DIM)
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = build.process_arrays(*slide, **dict(params, num_wsi_super_patches=n_super),
                                   save_similarity=False, device=dev)
        wall = time.perf_counter() - t0
        add_main_path_counts()
        s.timed(f"{n_patches}-patch slide with {n_super} super-patches + {N_TMA} TMA = "
                f"{n_nodes} nodes: {wall:.3f} s; knn launches {knn.launches}")
        s.check(knn.launches >= 1, f"K2 launched inside the build ({n_nodes} nodes)")
        s.check(res["stats"]["hypergraph"]["num_nodes"] == n_nodes, f"{n_nodes} graph nodes")
        check_build_k1(f"[{n_patches},{n_patches},{DIM}] (the {n_nodes}-node slide)",
                       slide[0], slide[1], res["host"]["K_stats"])
        # K2 on the build's own node features (super-patch means + TMA cores)
        nodes = torch.cat([torch.as_tensor(res["host"]["sp_feats"], device=dev),
                           torch.as_tensor(slide[2], device=dev)])
        _, i_k = check_k2(f"the {n_nodes}-node slide's nodes, k={K + 1}", nodes, K + 1,
                          exact=False, digest=True)
        s.check(np.array_equal(i_k.cpu().numpy(), res["host"]["knn_idx"]),
                "K2 relaunched on the build's nodes gives the build's neighbour lists")
        built = hashlib.sha256(np.ascontiguousarray(res["host"]["knn_idx"], np.int64).tobytes())
        again = hashlib.sha256(i_k.cpu().numpy().astype(np.int64).tobytes())
        s.check(built.hexdigest() == again.hexdigest(),
                f"K2 indices sha256 on the build's nodes {again.hexdigest()[:16]} == the build's "
                f"knn_idx {built.hexdigest()[:16]}")
        k2_ms = s.cuda_ms(lambda: knn(nodes, K + 1), iters=20)
        s.timed(f"K2 alone on the build's {n_nodes} nodes (k={K + 1}): {k2_ms:.4f} ms, "
                f"{100 * k2_ms / (wall * 1e3):.2f}% of the slide's {wall * 1e3:.1f} ms wall")

    # ---------------------------------------------------------------- 7
    def profile_phase():
        from torch.profiler import ProfilerActivity, profile

        slide = clustered_slide(np.random.default_rng(7), N_PATCHES, N_TMA, DIM)
        build.process_arrays(*slide, **params, save_similarity=False, device=dev)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            build.process_arrays(*slide, **params, save_similarity=False, device=dev)
            wall_ms = (time.perf_counter() - t0) * 1e3

        events = _device_events(prof)
        busy_ms = sum(us for _, us in events) / 1e3
        if not events:
            s.log("  profiler saw no device time: device busy share not measured")
            return
        s.timed(f"one {N_PATCHES}-patch slide under torch.profiler: wall {wall_ms:.2f} ms, "
                f"device busy {busy_ms:.2f} ms ({100 * busy_ms / wall_ms:.1f}% of the "
                f"profiled wall), {sum(e.count for e, _ in events)} device ops")
        if main_path_ms_per_slide:
            # an estimate: the profiler inflates host time, so the profiled
            # device time is set against phase 4's unprofiled wall per slide
            per_slide = main_path_ms_per_slide[0]
            s.timed(f"estimate: profiled device time over phase 4's median {per_slide:.2f} ms "
                    f"per slide = {100 * busy_ms / per_slide:.1f}% device busy (two runs)")
        for e, us in sorted(events, key=lambda x: x[1], reverse=True)[:10]:
            s.timed(f"  {us / 1e3:8.3f} ms  x{e.count:<5d} {e.key[:90]}")

    # ---------------------------------------------------------------- 8
    def attention_phase():
        """K3 against its plain version on the same inputs.  Tolerances: o
        within 2e-5 absolute in float32; in bf16, elementwise within 4
        units of 2^-8 times the plain output on |v| (``_bf16_units``: p
        rounds to bf16 before P.V on both sides, a last-bit difference in
        f32 p can flip a rounding, and o rounds to bf16); m exact where every
        score is exact in f32 (inputs on a 1/8 grid), else within 1e-6 of
        max(|m|, 1) (the f32 rounding of the dots, summed in another
        order); l within 1e-5 relative; two launches bit-identical.  Every
        route: the general one at the ViT and bag shapes, the narrow ones
        (and the general one on the same inputs) at MFMF's block shapes in
        bf16 here and in float32 in phase 11."""
        import torch.nn.functional as F

        rng = np.random.default_rng(8)

        def draw(shape, dtype, grid=False):
            x = rng.standard_normal(shape)
            if grid:
                x = np.round(np.clip(x, -1, 1) * 8) / 8
            return torch.as_tensor(x.astype(np.float32), device=dev).to(dtype)

        def qkv_views(dtype, grid=False):  # as the ViT block slices its projection
            qkv = draw((VIT_BATCH, VIT_TOKENS, 3, VIT_HEADS, VIT_HEAD_DIM), dtype, grid)
            return qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]

        def check(label, q, k, v, mask=None, rate=0.0, seed=None, m_exact=False, route=None):
            before = dict(attention_fwd.route_launches)
            got = attention_fwd(q, k, v, mask, dropout_rate=rate, seed=seed, route=route)
            again = attention_fwd(q, k, v, mask, dropout_rate=rate, seed=seed, route=route)
            ran = [r for r in ROUTES if attention_fwd.route_launches[r] != before[r]]
            label = f"{label} ({'/'.join(ran)} route)"
            want = plain_fused_attention(q, k, v, mask, dropout_rate=rate, seed=seed)
            torch.cuda.synchronize()
            s.check(all(torch.equal(a, b) for a, b in zip(got, again)),
                    f"K3 {label}: two launches bit-identical")
            o_err = float((got[0].float() - want[0].float()).abs().max())
            if q.dtype == torch.bfloat16:
                scale = plain_fused_attention(q, k, v.abs(), mask, dropout_rate=rate, seed=seed)[0]
                units = _bf16_units(got[0], want[0], scale)
                s.check(units <= 4, f"K3 {label}: o within {units:.3f} <= 4 units of 2^-8 x "
                                    f"the plain output on |v| (max abs err {o_err:.3e})")
            else:
                s.check(o_err <= 2e-5, f"K3 {label}: o max abs err {o_err:.3e} <= 2e-05")
            if m_exact:
                s.check(bool(torch.equal(got[1], want[1])), f"K3 {label}: m exact")
            else:
                m_err = float(((got[1] - want[1]).abs() / want[1].abs().clamp_min(1.0)).max())
                s.check(m_err <= 1e-6, f"K3 {label}: m within {m_err:.2e} <= 1e-6 of max(|m|, 1)")
            l_err = float(((got[2] - want[2]).abs() / want[2]).max())
            s.check(l_err <= 1e-5, f"K3 {label}: l max rel err {l_err:.2e} <= 1e-5")
            return got, o_err

        def timed(label, q, k, v, valid_k=None, mask=None):
            """Kernel, plain and SDPA (yardstick, with the same key mask)
            times, and the bound over the keys this call needs (``valid_k``
            a case)."""
            b, t_q, h, hd = q.shape
            ms = s.cuda_ms(lambda: attention_fwd(q, k, v, mask))
            dev_ms = s.device_ms(lambda: attention_fwd(q, k, v, mask))
            route_ms["attention"]["general"][label] = {"ms": ms, "device_ms": sum(dev_ms.values())}
            plain_ms = s.cuda_ms(lambda: plain_fused_attention(q, k, v, mask), iters=5)
            qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
            am = None if mask is None else mask[:, None, None, :]
            lib_ms = s.cuda_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=am))
            bound, by = _attention_bound_ms(b, h, t_q, valid_k or k.shape[1], hd, q.element_size())
            s.timed(f"K3 {label}: kernel {ms:.4f} ms (device {sum(dev_ms.values()):.4f} ms: "
                    + ", ".join(f"{n} {t:.4f}" for n, t in dev_ms.items())
                    + f"), plain {plain_ms:.4f} ms, scaled_dot_product_attention {lib_ms:.4f} ms, "
                    f"bound {bound:.4f} ms ({by})")
            return ms, plain_ms, lib_ms, bound, by

        # (a) the ViT-L shape, f32 and bf16, q/k/v strided views of one projection
        for dtype, name in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
            shape = f"[{VIT_BATCH}x{VIT_HEADS}, {VIT_TOKENS}, {VIT_HEAD_DIM}] {name}"
            check(f"ViT {shape}, 1/8-grid inputs", *qkv_views(dtype, grid=True), m_exact=True)
            q, k, v = qkv_views(dtype)
            _, err = check(f"ViT {shape}", q, k, v)
            ms, plain_ms, lib_ms, bound, by = timed(f"ViT {shape}", q, k, v)
            if dtype == torch.bfloat16:
                # the 257-token edge: a fifth q tile of one row and a fifth
                # key tile of one key, which 256 tokens do without
                q2, k2, v2 = (x[:, :VIT_TOKENS - 1] for x in (q, k, v))
                edge = sum(s.device_ms(lambda: attention_fwd(q2, k2, v2)).values())
                full = route_ms["attention"]["general"][f"ViT {shape}"]["device_ms"]
                if edge > 0 and full > 0:
                    s.timed(f"K3 ViT bf16 at {VIT_TOKENS - 1} tokens: device {edge:.4f} ms against "
                            f"{full:.4f} ms at {VIT_TOKENS}: the edge takes "
                            f"{100 * (1 - edge / full):.1f}% of the kernel's time")
                else:
                    s.log("  K3 ViT bf16 257-token edge: device time not measured")
            if dtype == torch.float32:  # the extraction's default path
                s.kernels["attention"] = {
                    "name": "attention", "route": "cuda",
                    "source": "multimodal_fusion_tpu_torch/csrc/attention.cu",
                    "replaces": "multimodal_fusion_tpu/ops/pallas_attention.py:130",
                    "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                    "bound_ms": bound, "bound_by": by, "library_ms": lib_ms,
                }
        # (b) the MFMF bag shape (bench.py:739-756): batch 0 keeps a ragged
        # 3001 of 4096 keys, batch 1 is all masked
        bag = (2, 4096, 8, 64)
        mask = torch.zeros((2, 4096), dtype=torch.bool, device=dev)
        mask[0, :3001] = True
        for dtype, name in ((torch.bfloat16, "bf16"), (torch.float32, "f32")):
            q, k, v = (draw(bag, dtype) for _ in range(3))
            got, _ = check(f"bag [8, 4096, 64] {name}, ragged + all-masked kv_mask", q, k, v, mask)
            uniform = v[1].float().mean(0)[None].expand_as(got[0][1])  # [Tq, H, hd]
            if dtype == torch.bfloat16:
                scale = v[1].float().abs().mean(0)[None].expand_as(uniform)
                u_err, u_tol, unit = _bf16_units(got[0][1], uniform, scale), 4, " units"
            else:
                u_err, u_tol, unit = float((got[0][1] - uniform).abs().max()), 2e-5, " abs"
            s.check(bool(torch.all(got[1][1] == -1e9)) and u_err <= u_tol,
                    f"K3 bag {name}: all-masked bag gives m = -1e9 and the uniform average of v "
                    f"(err {u_err:.3g} <= {u_tol:g}{unit})")
            timed(f"bag [1x8, 4096, 64] {name}, no mask", q[:1], k[:1], v[:1])
        # (c) dropout, against the hash-mask plain version
        for dtype, name in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
            q, k, v = draw((2, 40, 4, 64), dtype), draw((2, 300, 4, 64), dtype), draw((2, 300, 4, 64), dtype)
            check(f"[2x4, 40x300, 64] {name}, dropout 0.1", q, k, v, rate=0.1, seed=-1399772917)
        # (d) the narrow routes in bf16 at MFMF's block shapes (64 cases x 8
        # heads, hd 16), each against the plain version, and the general
        # route on the same inputs; ragged masks, one case all masked
        for t_q, t_k in ((5, 512), (5, 4096), (4096, 5)):
            q = draw((MFMF_BATCH, t_q, MFMF_HEADS, 16), torch.bfloat16)
            k, v = (draw((MFMF_BATCH, t_k, MFMF_HEADS, 16), torch.bfloat16) for _ in range(2))
            mask = torch.as_tensor(np.arange(t_k)[None] < rng.integers(1, t_k + 1, (MFMF_BATCH, 1)),
                                   device=dev)
            mask[0] = False
            for route in (None, "general"):
                check(f"[64x8, {t_q}x{t_k}, 16] bf16, ragged + all-masked kv_mask", q, k, v, mask,
                      route=route)
        # (e) mfmf_config1's general blocks at full width (hd 16 unpadded),
        # f32 and bf16, with MFMF's key masks, timed beside SDPA
        for label, t_q, t_k, mask in config1_blocks(*mfmf_masks(rng)):
            for dtype, name in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
                q = draw((MFMF_BATCH, t_q, MFMF_HEADS, 16), dtype)
                k, v = (draw((MFMF_BATCH, t_k, MFMF_HEADS, 16), dtype) for _ in range(2))
                check(f"{label} {name}", q, k, v, mask)
                timed(f"{label} {name}", q, k, v, float(mask.sum()) / MFMF_BATCH, mask)

    # ---------------------------------------------------------------- 9
    vit = {}  # extractors and the timed window, read by phase 10

    def vit_phase():
        """The slice's main path: ViT-L/16 extraction at full width."""
        from multimodal_fusion_tpu_torch.data.tma_extraction import extract_patches_from_image

        t0 = time.perf_counter()
        model = vit_large_16(torch.Generator(device=dev).manual_seed(SEED))
        torch.cuda.synchronize()
        n_params = sum(p.numel() for p in model.parameters())
        s.log(f"  ViT-L/16 seeded init on the card: {n_params / 1e6:.1f} M parameters, "
              f"{time.perf_counter() - t0:.2f} s")
        rng = np.random.default_rng(9)
        cores = {f"core_block1_x{i}_y{i}_patient{i:03d}": _synthetic_core(rng, 512, 512)
                 for i in range(11)}
        cores["core_block2_x1_y1_patient100"] = _synthetic_core(rng, 200, 180)  # Lanczos
        white = _synthetic_core(rng, 512, 512)
        white[:300, :300] = 255
        cores["core_block2_x2_y2_patient101"] = white
        filt = dict(white_threshold=0.9, min_content_ratio=0.5)
        n_patches = {key: len(extract_patches_from_image(img, 256, 128, **filt))
                     for key, img in cores.items()}
        n_batches = sum(-(-n // VIT_BATCH) for n in n_patches.values())
        s.log(f"  {len(cores)} cores, {sum(n_patches.values())} patches after the white "
              f"filter ({n_patches['core_block2_x2_y2_patient101']} of 9 kept on the white "
              f"core), {n_batches} batches of {VIT_BATCH}")

        f32 = make_feature_extractor(model, batch_size=VIT_BATCH)
        bf16 = make_feature_extractor(model, batch_size=VIT_BATCH, compute_dtype="bfloat16")
        xla = make_feature_extractor(model, batch_size=VIT_BATCH, attn_impl="xla")
        window = [p for key in list(cores)[:11] for p in
                  extract_patches_from_image(cores[key], 256, 128)][:VIT_WINDOW]
        vit.update(float32=f32, bfloat16=bf16, window=window)

        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        feats = extract_marker_features(cores, f32, 256, 128, **filt)
        s.timed(f"extract_marker_features ({len(cores)} cores, first CUDA use of the "
                f"extractor): {time.perf_counter() - t0:.3f} s")
        s.check(attention_fwd.launches == VIT_DEPTH * n_batches,
                f"K3 launched {VIT_DEPTH} times per batch ({attention_fwd.launches} == "
                f"{VIT_DEPTH} x {n_batches})")
        s.check(attention_fwd.route_launches["general"] == attention_fwd.launches,
                f"K3 ran the general route ({attention_fwd.route_launches})")
        add_main_path_counts()  # the checks below launch K3 outside the main path
        s.check(set(feats) == set(cores) and all(
            feats[key].shape == (n, 1024) and feats[key].dtype == np.float32
            for key, n in n_patches.items()), "features: one [N_patches, 1024] f32 entry per core")
        s.check(all(np.isfinite(f).all() for f in feats.values()), "features finite")
        with tempfile.TemporaryDirectory() as td:
            save_marker_npz(Path(td) / "tma_uni_tile_1024_cd3.npz", feats)
            with np.load(Path(td) / "tma_uni_tile_1024_cd3.npz") as z:
                s.check(sorted(z.files) == sorted(feats), "NPZ keys are the core keys")

        # check 1: a CPU run of the port from the same weights
        first = list(cores)[0]
        patches2 = extract_patches_from_image(cores[first], 256, 128, **filt)[:2]
        t0 = time.perf_counter()
        cpu = make_feature_extractor(model, batch_size=2, device="cpu")(patches2)
        err = _rel_l2(feats[first][:2], cpu)
        s.log(f"  CPU run of 2 patches: {time.perf_counter() - t0:.1f} s (host)")
        s.check(err <= 1e-4, f"first two patches vs a CPU run of the port: relative L2 "
                             f"{err:.2e} <= 1e-4")
        # check 2: one full batch against the einsum attention on the card
        batch = window[:VIT_BATCH]
        a = f32(batch)
        err = _rel_l2(a, xla(batch))
        s.check(err <= 1e-4, f"one batch, K3 vs attn_impl='xla' on the card: relative L2 "
                             f"{err:.2e} <= 1e-4")
        # check 3: bf16 against float32
        b = bf16(batch)
        cos = float((np.sum(a * b, axis=1) / (np.linalg.norm(a, axis=1) *
                                               np.linalg.norm(b, axis=1))).min())
        s.check(cos >= 0.999, f"bf16 vs f32 CLS cosine min {cos:.6f} >= 0.999")
        # UNI's LayerScale 1e-5 keeps every block's output near 1e-5 of the
        # residual stream, so checks 1 and 2 barely see attention: repeat
        # them on a ViT-L/16 with LayerScale 1
        strong = vit_large_16(torch.Generator(device=dev).manual_seed(SEED + 1), init_values=1.0)
        a1 = make_feature_extractor(strong, batch_size=VIT_BATCH)(batch)
        err = _rel_l2(a1, make_feature_extractor(strong, batch_size=VIT_BATCH,
                                                 attn_impl="xla")(batch))
        s.check(err <= 1e-4, f"LayerScale 1: one batch, K3 vs attn_impl='xla': relative L2 "
                             f"{err:.2e} <= 1e-4")
        err = _rel_l2(a1[:2], make_feature_extractor(strong, batch_size=2, device="cpu")(batch[:2]))
        s.check(err <= 1e-4, f"LayerScale 1: first two patches vs a CPU run of the port: "
                             f"relative L2 {err:.2e} <= 1e-4")
        b1 = make_feature_extractor(strong, batch_size=VIT_BATCH, compute_dtype="bfloat16")(batch)
        cos1 = float((np.sum(a1 * b1, axis=1) / (np.linalg.norm(a1, axis=1) *
                                                  np.linalg.norm(b1, axis=1))).min())
        s.log(f"  LayerScale 1: bf16 vs f32 CLS cosine min {cos1:.6f} (measured, no bar)")
        del strong

        window_batches = VIT_WINDOWS * -(-VIT_WINDOW // VIT_BATCH)
        for label in ("float32", "bfloat16"):
            ex = vit[label]
            ex(window)  # warm-up
            reset_counts()
            walls, finite = [], True
            for _ in range(VIT_WINDOWS):
                t0 = time.perf_counter()
                out = ex(window)
                walls.append(time.perf_counter() - t0)
                finite &= bool(np.isfinite(out).all())
            add_main_path_counts()
            s.check(finite, f"{label} windows: features finite")
            s.check(attention_fwd.launches == VIT_DEPTH * window_batches,
                    f"{label} windows: K3 launched {VIT_DEPTH} times per batch "
                    f"({attention_fwd.launches} == {VIT_DEPTH} x {window_batches})")
            s.check(attention_fwd.route_launches["general"] == attention_fwd.launches,
                    f"{label} windows: K3 ran the general route ({attention_fwd.route_launches})")
            rates = sorted(VIT_WINDOW / w for w in walls)
            med = VIT_WINDOW / float(np.median(walls))
            vit[f"{label}_ms_per_batch"] = float(np.median(walls)) / (VIT_WINDOW / VIT_BATCH) * 1e3
            s.log("  window walls (s): " + ", ".join(f"{w:.4f}" for w in walls))
            s.timed(f"ViT-L/16 extraction {label}: median {med:.1f} patches/s over "
                    f"{VIT_WINDOWS} windows of {VIT_WINDOW} (min {rates[0]:.1f}, max "
                    f"{rates[-1]:.1f}, spread {100 * (rates[-1] / rates[0] - 1):.1f}%)")
            flops = _vit_dense_flops(VIT_BATCH)
            s.timed(f"  {label}: dense layers {flops / 1e12:.3f} TFLOP per {VIT_BATCH}-patch "
                    f"batch, {flops / vit[f'{label}_ms_per_batch'] / 1e9:.1f} TFLOP/s at the "
                    f"median window")
        s.log(f"  K3 launches on the main path (the marker run and the timed windows): "
              f"{main_path_launches['attention']}")

    # ---------------------------------------------------------------- 10
    def vit_profile_phase():
        from torch.profiler import ProfilerActivity, profile

        batch = vit["window"][:VIT_BATCH]
        for label in ("float32", "bfloat16"):
            ex = vit[label]
            ex(batch)
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                ex(batch)
                wall_ms = (time.perf_counter() - t0) * 1e3
            events = _device_events(prof)
            if not events:
                s.log(f"  {label}: profiler saw no device time: device busy share not measured")
                continue
            busy_ms = sum(us for _, us in events) / 1e3
            k3_ms = sum(us for e, us in events if "attn_" in e.key) / 1e3
            s.timed(f"one {VIT_BATCH}-patch batch ({label}) under torch.profiler: wall "
                    f"{wall_ms:.2f} ms, device busy {busy_ms:.2f} ms ({100 * busy_ms / wall_ms:.1f}% "
                    f"of the profiled wall), K3 {k3_ms:.2f} ms ({100 * k3_ms / busy_ms:.1f}% of "
                    f"device time), {sum(e.count for e, _ in events)} device ops")
            per_batch = vit.get(f"{label}_ms_per_batch")
            if per_batch:
                s.timed(f"estimate: profiled device time over phase 9's median {per_batch:.2f} ms "
                        f"per batch = {100 * busy_ms / per_batch:.1f}% device busy (two runs)")
            for e, us in sorted(events, key=lambda x: x[1], reverse=True)[:8]:
                s.timed(f"  {us / 1e3:8.3f} ms  x{e.count:<5d} {e.key[:90]}")

    # ---------------------------------------------------------------- 11
    def attention_bwd_phase():
        """K4 against its plain version, both fed the plain forward's m, l
        and dsum: relative L2 <= 1e-5 per output in float32 (sums in other
        orders), <= 1e-2 in bf16 (ds and p round to bf16 before the second
        products on both sides, where a last-bit difference in float32 can
        flip a rounding); two launches bit-identical.  K3 against its plain
        version at MFMF's three shapes as in phase 8."""
        import torch.nn.functional as F

        rng = np.random.default_rng(11)
        b, h, hd = MFMF_BATCH, MFMF_HEADS, MFMF_DIM // MFMF_HEADS

        def randn(shape, dtype=torch.float32):
            return torch.as_tensor(rng.standard_normal(shape, dtype=np.float32), device=dev).to(dtype)

        def check_k4(label, q, k, v, mask, args=None, route=None, **drop):
            """K4 on ``route`` (None: the shape's) against its plain version;
            ``args`` (q, k, v, do, m, l, dsum, mask) are reused when given."""
            if args is None:
                o, m, l = plain_fused_attention(q, k, v, mask, **drop)
                do = randn(tuple(q.shape), q.dtype)
                dsum = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
                args = (q, k, v, do, m, l, dsum, mask)
            before = dict(attention_bwd.route_launches)
            got = attention_bwd(*args, route=route, **drop)
            again = attention_bwd(*args, route=route, **drop)
            ran = [r for r in ROUTES if attention_bwd.route_launches[r] != before[r]]
            label = f"{label} ({'/'.join(ran)} route)"
            want = plain_fused_attention_bwd(*args, **drop)
            torch.cuda.synchronize()
            s.check(all(torch.equal(x, y) for x, y in zip(got, again)),
                    f"K4 {label}: two launches bit-identical")
            errs = [_rel_l2_all(g, w) for g, w in zip(got, want)]
            bar = 1e-5 if q.dtype == torch.float32 else 1e-2
            s.check(max(errs) <= bar, f"K4 {label}: relative L2 dq {errs[0]:.2e}, dk {errs[1]:.2e}, "
                                      f"dv {errs[2]:.2e} <= {bar:g}")
            abs_err = max(float((g.float() - w.float()).abs().max()) for g, w in zip(got, want))
            return got, args, abs_err

        def check_k4_chunked(label, q, k, v, mask):
            """K4 on its shape's route against the plain version, which runs
            8 cases at a time (m, l from the plain forward, chunked alike):
            relative L2 over all 64 cases at check_k4's bars, two launches
            bit-identical.  Returns (args, max abs err)."""
            m, l = (torch.empty((b, h, q.shape[1]), device=dev) for _ in range(2))
            do = randn(tuple(q.shape), q.dtype)
            dsum = torch.empty_like(m)
            for c0 in range(0, b, 8):
                o, m[c0:c0 + 8], l[c0:c0 + 8] = plain_fused_attention(
                    q[c0:c0 + 8], k[c0:c0 + 8], v[c0:c0 + 8], mask[c0:c0 + 8])
                dsum[c0:c0 + 8] = (do[c0:c0 + 8].float() * o.float()).sum(-1).transpose(1, 2)
            args = (q, k, v, do, m, l, dsum, mask)
            before = dict(attention_bwd.route_launches)
            got = attention_bwd(*args)
            again = attention_bwd(*args)
            ran = [r for r in ROUTES if attention_bwd.route_launches[r] != before[r]]
            label = f"{label} ({'/'.join(ran)} route)"
            torch.cuda.synchronize()
            s.check(all(torch.equal(x, y) for x, y in zip(got, again)),
                    f"K4 {label}: two launches bit-identical")
            del again
            diff2, ref2, abs_err = [0.0] * 3, [0.0] * 3, 0.0
            for c0 in range(0, b, 8):
                want = plain_fused_attention_bwd(*(a[c0:c0 + 8] for a in args))
                for i, (g_, w) in enumerate(zip(got, want)):
                    g8, w8 = g_[c0:c0 + 8].float(), w.float()
                    diff2[i] += float(((g8 - w8) ** 2).sum())
                    ref2[i] += float((w8 ** 2).sum())
                    abs_err = max(abs_err, float((g8 - w8).abs().max()))
                del want
            errs = [(d / max(r, 1e-300)) ** 0.5 for d, r in zip(diff2, ref2)]
            bar = 1e-5 if q.dtype == torch.float32 else 1e-2
            s.check(max(errs) <= bar, f"K4 {label}: relative L2 over 64 cases (plain in chunks of 8) dq "
                                      f"{errs[0]:.2e}, dk {errs[1]:.2e}, dv {errs[2]:.2e} <= {bar:g}")
            return args, abs_err

        def check_k3(label, q, k, v, mask, route=None):
            before = dict(attention_fwd.route_launches)
            got = attention_fwd(q, k, v, mask, route=route)
            again = attention_fwd(q, k, v, mask, route=route)
            ran = [r for r in ROUTES if attention_fwd.route_launches[r] != before[r]]
            label = f"{label} ({'/'.join(ran)} route)"
            want = plain_fused_attention(q, k, v, mask)
            torch.cuda.synchronize()
            s.check(all(torch.equal(x, y) for x, y in zip(got, again)),
                    f"K3 {label}: two launches bit-identical")
            o_err = float((got[0] - want[0]).abs().max())
            m_err = float(((got[1] - want[1]).abs() / want[1].abs().clamp_min(1.0)).max())
            l_err = float(((got[2] - want[2]).abs() / want[2]).max())
            s.check(o_err <= 2e-5 and m_err <= 1e-6 and l_err <= 1e-5,
                    f"K3 {label}: o max abs err {o_err:.2e} <= 2e-05, m within {m_err:.2e} <= "
                    f"1e-6 of max(|m|, 1), l rel err {l_err:.2e} <= 1e-5")

        def sdpa_ms(q, k, v, do, mask):
            """(forward ms, backward ms: autograd through SDPA less its
            forward) of ``scaled_dot_product_attention`` on the same inputs,
            or (None, None) when no SDPA backend takes them."""
            qt, kt, vt = (x.detach().transpose(1, 2).contiguous().requires_grad_(True) for x in (q, k, v))
            go = do.transpose(1, 2).contiguous()
            am = None if mask is None else mask[:, None, None, :]

            def fwd():
                return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=am)

            try:
                fwd_ms = s.cuda_ms(fwd)
                both_ms = s.cuda_ms(lambda: torch.autograd.grad(fwd(), (qt, kt, vt), go))
            except RuntimeError as e:
                s.log(f"  scaled_dot_product_attention refused these inputs: {e}")
                return None, None
            return fwd_ms, both_ms - fwd_ms

        def timed(label, args, valid_keys=None, k3=False, route=None, yardsticks=True):
            """K4's (and with ``k3`` K3's) time on ``route`` (None: the
            shape's), with the plain versions' and SDPA's beside it when
            ``yardsticks``, and the bounds."""
            q, k, v, do, m, l, dsum, mask = args
            bq, t_q, heads, d = q.shape
            t_k = k.shape[1]
            taken = route or _route(t_q, t_k, d)
            out = {"ms": s.cuda_ms(lambda: attention_bwd(*args, route=route)),
                   "plain_ms": None, "library_ms": None, "k3_ms": None}
            dev_ms = s.device_ms(lambda: attention_bwd(*args, route=route))
            out["device_ms"] = sum(dev_ms.values())
            route_ms["attention_bwd"][taken][label] = {"ms": out["ms"], "device_ms": out["device_ms"]}
            fwd_lib = None
            if yardsticks:
                out["plain_ms"] = s.cuda_ms(lambda: plain_fused_attention_bwd(*args), iters=5)
                fwd_lib, out["library_ms"] = sdpa_ms(q, k, v, do, mask)
            out["ops"], out["bytes"] = _attention_bwd_work(bq, heads, t_q, t_k, d, q.element_size(),
                                                           valid_keys)
            bound, by = _bound_ms(out["ops"], out["bytes"], q.element_size())
            extra = "" if not yardsticks else (
                f", plain {out['plain_ms']:.4f} ms, SDPA backward "
                + ("not measured" if out["library_ms"] is None else f"{out['library_ms']:.4f} ms"))
            s.timed(f"K4 {label} ({taken} route): kernel {out['ms']:.4f} ms (device "
                    f"{out['device_ms']:.4f} ms: " + ", ".join(f"{n} {t:.4f}" for n, t in dev_ms.items())
                    + f"){extra}, bound "
                    f"{bound:.4f} ms ({by}; {out['ops'] / 1e9:.3f} GFLOP, {out['bytes'] / 1e6:.1f} MB)")
            if k3:
                out["k3_ms"] = s.cuda_ms(lambda: attention_fwd(q, k, v, mask, route=route))
                dev3 = s.device_ms(lambda: attention_fwd(q, k, v, mask, route=route))
                out["k3_device_ms"] = sum(dev3.values())
                route_ms["attention"][taken][label] = {"ms": out["k3_ms"], "device_ms": out["k3_device_ms"]}
                kv = t_k if valid_keys is None else valid_keys / bq
                out["k3_bound"], k3_by = _attention_bound_ms(bq, heads, t_q, kv, d, q.element_size())
                extra = ""
                if yardsticks:
                    k3_plain = s.cuda_ms(lambda: plain_fused_attention(q, k, v, mask), iters=5)
                    extra = f", plain {k3_plain:.4f} ms, SDPA " + (
                        "not measured" if fwd_lib is None else f"{fwd_lib:.4f} ms")
                s.timed(f"K3 {label} ({taken} route): kernel {out['k3_ms']:.4f} ms (device "
                        f"{out['k3_device_ms']:.4f} ms: " + ", ".join(f"{n} {t:.4f}" for n, t in dev3.items())
                        + f"){extra}, bound "
                        f"{out['k3_bound']:.4f} ms ({k3_by})")
            return out

        # (a) MFMF's three blocks at mfmf_config0 width, 64 cases: 5 tabular
        # tokens against 8 markers' 64-row buckets (9-16 valid each), against
        # the 4096-bucket WSI bag (2048-4096 valid), and the reconstructed
        # bag's 4096 tokens against the 5 result tokens (no key mask).  Each
        # on its own (narrow) route and on the general route, same inputs.
        markers, wsi = mfmf_masks(rng)
        blocks = [("block 1 other->tma [64x8, 5x512, 16]", 5, 512, markers),
                  ("block 2 result->wsi [64x8, 5x4096, 16]", 5, 4096, wsi),
                  ("block 3 reconstruct->result [64x8, 4096x5, 16]", 4096, 5, None)]
        window = {"ms": 0.0, "device_ms": 0.0, "k3_device_ms": 0.0, "general_ms": 0.0, "k3_ms": 0.0,
                  "k3_general_ms": 0.0, "k3_bound": 0.0,
                  "plain_ms": 0.0, "library_ms": 0.0, "ops": 0, "bytes": 0, "err": 0.0}
        for label, t_q, t_k, mask in blocks:
            q, k, v = randn((b, t_q, h, hd)), randn((b, t_k, h, hd)), randn((b, t_k, h, hd))
            for route in (None, "general"):
                check_k3(label, q, k, v, mask, route=route)
            _, args, err = check_k4(label, q, k, v, mask)
            check_k4(label, q, k, v, mask, args=args, route="general")
            valid = None if mask is None else int(mask.sum())
            own = timed(label, args, valid, k3=True)
            general = timed(label, args, valid, k3=True, route="general", yardsticks=False)
            window["ms"] += own["ms"]
            window["device_ms"] += own["device_ms"]
            window["k3_device_ms"] += own["k3_device_ms"]
            window["general_ms"] += general["ms"]
            window["k3_ms"] += own["k3_ms"]
            window["k3_general_ms"] += general["k3_ms"]
            window["k3_bound"] += own["k3_bound"]
            window["plain_ms"] += own["plain_ms"]
            window["library_ms"] = None if own["library_ms"] is None or window["library_ms"] is None \
                else window["library_ms"] + own["library_ms"]
            window["ops"] += own["ops"]
            window["bytes"] += own["bytes"]
            window["err"] = max(window["err"], err)
        bound, by = _bound_ms(window["ops"], window["bytes"], 4)
        s.timed(f"K4, one MFMF train window (the three blocks): narrow routes {window['ms']:.4f} ms "
                f"(device {window['device_ms']:.4f} ms), general route {window['general_ms']:.4f} ms, "
                f"plain {window['plain_ms']:.4f} ms, bound {bound:.4f} ms ({by})")
        s.timed(f"K3, one MFMF window (the three blocks): narrow routes {window['k3_ms']:.4f} ms "
                f"(device {window['k3_device_ms']:.4f} ms), general route {window['k3_general_ms']:.4f} "
                f"ms, bound {window['k3_bound']:.4f} ms")
        s.kernels["attention_bwd"] = {
            "name": "attention_bwd", "route": "cuda",
            "source": "multimodal_fusion_tpu_torch/csrc/attention_bwd.cu",
            "replaces": "multimodal_fusion_tpu/ops/pallas_attention.py:373",
            "max_abs_err": window["err"], "ms": window["ms"], "device_ms": window["device_ms"],
            "plain_ms": window["plain_ms"], "bound_ms": bound, "bound_by": by,
            "library_ms": window["library_ms"],
        }
        # (a2) mfmf_config1's blocks 2 and 3 on the general route (hd 16
        # unpadded), f32 and bf16, with the WSI and bucket key masks; the
        # plain version runs 8 cases at a time (its float32 scores of all 64
        # would take GiBs); the bound counts the keys each case keeps
        c1 = {}
        for label, t_q, t_k, mask in config1_blocks(markers, wsi):
            for dtype, name in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
                q, k, v = randn((b, t_q, h, hd), dtype), randn((b, t_k, h, hd), dtype), randn((b, t_k, h, hd), dtype)
                args, err = check_k4_chunked(f"{label} {name}", q, k, v, mask)
                c1[(label, name)] = timed(f"{label} {name}", args, int(mask.sum()), k3=True)
                c1[(label, name)]["err"] = err
                del q, k, v, args
        for name in ("f32", "bf16"):
            tot = {key: sum(c1[(lb, name)][key] for lb, *_ in config1_blocks(markers, wsi))
                   for key in ("ms", "device_ms", "k3_ms", "k3_device_ms", "ops", "bytes")}
            bound, by = _bound_ms(tot["ops"], tot["bytes"], 4 if name == "f32" else 2)
            s.timed(f"K4 + K3, mfmf_config1's general blocks 2 and 3 ({name}), one 64-case window: K4 "
                    f"{tot['ms']:.4f} ms (device {tot['device_ms']:.4f} ms), K3 {tot['k3_ms']:.4f} ms "
                    f"(device {tot['k3_device_ms']:.4f} ms); K4 bound {bound:.4f} ms ({by}, valid keys)")
        s.kernels["attention_bwd"]["config1"] = {
            f"{lb} {nm}": {"ms": r["ms"], "device_ms": r["device_ms"],
                           "plain_ms": r["plain_ms"], "library_ms": r["library_ms"], "max_abs_err": r["err"],
                           "bound_ms": _bound_ms(r["ops"], r["bytes"], 4 if nm == "f32" else 2)[0]}
            for (lb, nm), r in c1.items()}
        if "attention" in s.kernels:
            s.kernels["attention"]["config1"] = {
                f"{lb} {nm}": {"ms": r["k3_ms"], "device_ms": r["k3_device_ms"], "bound_ms": r["k3_bound"]}
                for (lb, nm), r in c1.items()}
        # the wrappers' own host time, which event-timed calls at MFMF's
        # small shapes include
        q1, st = randn((1, 8, 1, 16)), torch.zeros((1, 1, 8), device=dev)
        x1, p1 = randn((16, 16)), randn((16, 2))
        sim_us = s.host_us(lambda: similarity_rect(x1, p1, x1, p1))
        s.timed(f"host time per wrapper call at [1, 8, 1, 16]: attention_fwd "
                f"{s.host_us(lambda: attention_fwd(q1, q1, q1)):.1f} us, attention_bwd "
                f"{s.host_us(lambda: attention_bwd(q1, q1, q1, q1, st, st + 1, st)):.1f} us; "
                f"at [16, 16]: similarity_rect {sim_us:.1f} us, knn (k 4) "
                f"{s.host_us(lambda: knn(x1, 4)):.1f} us")
        # (b) the bench's gradient shape (bench.py:765-785), f32 and bf16
        for dtype, name in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
            q, k, v = (randn((1, 4096, 8, 64), dtype) for _ in range(3))
            _, args, _ = check_k4(f"bag [1x8, 4096, 64] {name}", q, k, v, None)
            timed(f"bag [1x8, 4096, 64] {name}", args)
        # (c) dropout 0.1 with one seed per case, at block 2's shape, on
        # both routes
        seeds = torch.as_tensor(rng.integers(-2 ** 31, 2 ** 31, b), dtype=torch.int32, device=dev)
        drop = dict(dropout_rate=0.1, seed=seeds)
        q, k, v = randn((b, 5, h, hd)), randn((b, 4096, h, hd)), randn((b, 4096, h, hd))
        want_f = plain_fused_attention(q, k, v, wsi, **drop)
        args = None
        for route in (None, "general"):
            got_f = attention_fwd(q, k, v, wsi, route=route, **drop)
            o_err = float((got_f[0] - want_f[0]).abs().max())
            s.check(o_err <= 2e-5, f"K3 block 2, dropout 0.1, per-case seeds ({route or 'narrow_q'} "
                                   f"route): o max abs err {o_err:.2e} <= 2e-05")
            _, args, _ = check_k4("block 2, dropout 0.1, per-case seeds", q, k, v, wsi, args=args,
                                  route=route, **drop)
        # (d) an all-masked bag: zero dq and dk, dv through the uniform p
        mask = torch.ones((2, 4096), dtype=torch.bool, device=dev)
        mask[1] = False
        q, k, v = randn((2, 5, h, hd)), randn((2, 4096, h, hd)), randn((2, 4096, h, hd))
        args = None
        for route in (None, "general"):
            got, args, _ = check_k4("[2x8, 5x4096, 16], bag 1 all masked", q, k, v, mask, args=args,
                                    route=route)
            uniform = args[3][1].sum(0, keepdim=True).expand(4096, -1, -1) / 4096  # sum_q do / Tk
            u_err = float((got[2][1] - uniform).abs().max())
            s.check(not got[0][1].any() and not got[1][1].any() and u_err <= 1e-6,
                    f"K4 all-masked bag ({route or 'narrow_q'} route): dq = dk = 0, dv = sum_q do / Tk "
                    f"within {u_err:.2e} <= 1e-6")

    def remat_peaks(label, mc, ec, state, window, gen_device):
        """Peak device memory of one training window (forward, group loss,
        backward) above what was allocated before it, in MiB: remat off,
        the whole forward as one checkpoint, and remat on (each segment of
        the model checkpointed on its own, as the trainer runs it).  The
        same weights, window and draws each time; a zero learning rate."""
        peaks = {}
        for mode in ("off", "whole forward", "segments"):
            m = ModelFactory.create_model(mc, device=dev)
            m.load_state_dict(state)
            tr_r = SurvivalTrainer(Configs(dataclasses.replace(ec, remat=mode == "segments"), mc),
                                   tempfile.mkdtemp(prefix="remat_"), device=dev)
            gen = torch.Generator(device=gen_device).manual_seed(0)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            if mode == "whole forward":
                labels = window["label"]
                case = {"channels": window["channels"], "masks": window["masks"]}
                res = checkpoint_replaying(m, (case, labels), {"train": True}, gen)
                total = m.loss_fn(res["logits"], labels, res).sum()
                if m.has_group_loss():
                    total = total + m.group_loss_fn(dict(res, label=labels))
                (total / labels.shape[0]).backward()
                del res, total
            else:
                tr_r._train_step(m, torch.optim.SGD(m.parameters(), lr=0.0), window, gen)
            torch.cuda.synchronize()
            peaks[mode] = (torch.cuda.max_memory_allocated() - base) / 2 ** 20
            del m
        s.timed(f"{label}: peak device memory of one training window above its inputs and "
                "weights: " + ", ".join(f"{k} {v:.1f} MiB" for k, v in peaks.items())
                + f"; remat's segments {100 * (1 - peaks['segments'] / peaks['off']):.1f}% below off")
        return peaks

    # ---------------------------------------------------------------- 12
    mfmf = {}  # trainer, model, tables and timing window, read by phases 13 and 40
    drawn = {}  # phase 12's in-memory cases, read by phases 14-16

    def mfmf_raw_cases():
        if not drawn:
            t0 = time.perf_counter()
            drawn["cases"] = _mfmf_cases(np.random.default_rng(12), TMA_MARKERS, TABULAR_DIMS,
                                         torch.Generator(device=dev).manual_seed(12))
            s.log(f"  {MFMF_CASES} in-memory cases drawn in {time.perf_counter() - t0:.1f} s (bags on the card, "
                  "copied to host memory)")
        return drawn["cases"]

    def mfmf_configs(order, name):
        """(ModelConfig, ExperimentConfig) of the mfmf_config scripts: 1024-d
        inputs, output_dim 128, 8 heads, model_size 64*32, inst_number 8,
        dropout 0.25, the 7 channel groups, Adam lr 1e-4 with coupled L2
        1e-5, the plateau scheduler, windows of 64; ``order`` the script's
        fusion order."""
        chans = parse_channels(["wsi", "tma"] + [f"{g}_mask" for g in TABULAR_DIMS])
        mc = ModelConfig(model_type="mfmf", n_classes=2, input_dim=DIM, model_size="64*32",
                         dropout=0.25, inst_number=8, base_weight=0.9, subtyping=True,
                         output_dim=MFMF_DIM, channels_used_in_model=chans,
                         channel_input_dims={f"{g}=val": d for g, d in TABULAR_DIMS.items()},
                         fusion_blocks_sequence=order)
        mc.extra["attention_num_heads"] = MFMF_HEADS
        ec = ExperimentConfig(exp_name=name, seed=5678, k_folds=MFMF_FOLDS,
                              max_epochs=MFMF_EPOCHS, batch_size=MFMF_BATCH, lr=1e-4,
                              optimizer="adam", weight_decay=1e-5, scheduler="plateau",
                              scheduler_params={"mode": "min", "patience": 15, "factor": 0.5},
                              device_data=True)
        return mc, ec

    def mfmf_phase():
        """The slice's main path: MFMF survival training at mfmf_config0
        width through ``SurvivalTrainer.train_fold``."""
        raws, labels = mfmf_raw_cases()
        ds = _CaseTable(raws, labels)
        mc, ec = mfmf_configs(DEFAULT_FUSION_SEQUENCE, "mfmf_config0")
        s.log(f"  {MFMF_CASES} in-memory cases, {len(mc.channels_used_in_model)} channels")
        split = create_k_fold_splits(ds.labels, MFMF_FOLDS, ec.seed)[0]
        sizes = (len(split.train_idx), len(split.val_idx), len(split.test_idx))
        s.check(sizes == (128, 16, 16), f"fold 0: {sizes} train/val/test cases")
        n_train = MFMF_EPOCHS * -(-sizes[0] // MFMF_BATCH)
        n_eval = (MFMF_EPOCHS + 1) * -(-sizes[1] // 16) + -(-sizes[2] // 16)

        td = Path(tempfile.mkdtemp(prefix="mfmf_"))
        mfmf.update(dir=td, mc=mc, ec=ec)  # phase 40 exports the fold this phase trains
        summaries = {}
        for device_data in (True, False):
            ec.device_data = device_data
            tr = SurvivalTrainer(Configs(ec, mc), td / f"device_data_{device_data}", device=dev)
            reset_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            summaries[device_data] = tr.train_fold(ds, split, 0)
            wall = time.perf_counter() - t0
            add_main_path_counts()
            s.timed(f"train_fold, device_data={device_data}: {MFMF_EPOCHS} epochs of "
                    f"{sizes[0]} cases + evaluation in {wall:.2f} s, "
                    f"{MFMF_EPOCHS * sizes[0] / wall:.1f} training cases/s end to end"
                    + (" (the model's first CUDA use included)" if device_data else
                       " (each window read, padded and uploaded on the host)"))
            s.check(attention_bwd.launches == 3 * n_train,
                    f"device_data={device_data}: K4 launched 3 times per train window "
                    f"({attention_bwd.launches} == 3 x {n_train})")
            s.check(attention_fwd.launches == 3 * (n_train + n_eval),
                    f"device_data={device_data}: K3 launched 3 times per train and eval window "
                    f"({attention_fwd.launches} == 3 x ({n_train} + {n_eval}))")
            # blocks 1 and 2 (5 rows against 512 and 4096 keys) take narrow_q,
            # block 3 (4096 rows against 5 keys) narrow_k
            want_fwd = {"general": 0, "narrow_q": 2 * (n_train + n_eval), "narrow_k": n_train + n_eval}
            want_bwd = {"general": 0, "narrow_q": 2 * n_train, "narrow_k": n_train}
            s.check(attention_fwd.route_launches == want_fwd and attention_bwd.route_launches == want_bwd,
                    f"device_data={device_data}: routes K3 {attention_fwd.route_launches}, K4 "
                    f"{attention_bwd.route_launches} (want {want_fwd}, {want_bwd})")
            out = td / f"device_data_{device_data}"
            s.check(all((out / n).exists() for n in ("splits_0.csv", "fold_0_epochs.csv",
                                                     "fold_0_summary.json")),
                    f"device_data={device_data}: splits_0.csv, fold_0_epochs.csv and "
                    "fold_0_summary.json written")
            hist = summaries[device_data]["history"]
            probs = [p["prob"] for p in json.loads((out / "fold_0_summary.json").read_text())
                     ["patient_results"].values()]
            s.check(all(np.isfinite([h_["train_loss"], h_["val_loss"]]).all() for h_ in hist)
                    and np.isfinite(probs).all() and np.asarray(probs).shape == (sizes[2], 2),
                    f"device_data={device_data}: losses finite, {len(probs)} test probabilities "
                    "finite")
            s.log("  history: " + "; ".join(
                f"epoch {h_['epoch']}: train {h_['train_loss']:.6f} val {h_['val_loss']:.6f} "
                f"auc {h_['val_auc']:.4f}" for h_ in hist))
        a = summaries[True]["history"][0]["train_loss"]
        b_ = summaries[False]["history"][0]["train_loss"]
        s.check(abs(a - b_) <= 1e-6 * abs(a), f"first-epoch train loss, device_data True vs False: "
                                              f"{a!r} vs {b_!r} (within 1e-6 relative)")

        # one window's gradients on the card against a CPU run of the port
        # from the same weights and window: the trainer's own step with a
        # zero learning rate, which leaves the gradients on the parameters
        ec.device_data = True
        tr = SurvivalTrainer(Configs(ec, mc), td / "timing", device=dev)
        all_idx = np.concatenate([split.train_idx, split.val_idx, split.test_idx]).astype(np.int64)
        tables, row_of = tr._device_tables(ds, all_idx)
        rows = torch.as_tensor([row_of[int(i)] for i in split.train_idx], dtype=torch.int64)
        window = tr._gather_window(tables, rows[:MFMF_BATCH].to(dev))
        card = tr._build_model(0)
        host = ModelFactory.create_model(mc, device="cpu")
        host.load_state_dict({k: t.cpu() for k, t in card.state_dict().items()})
        cpu_tr = SurvivalTrainer(Configs(ec, mc), td / "cpu", device="cpu")
        cpu_window = {"channels": {k: t.cpu() for k, t in window["channels"].items()},
                      "masks": {k: t.cpu() for k, t in window["masks"].items()},
                      "label": window["label"].cpu()}
        loss_card = float(tr._train_step(card, torch.optim.SGD(card.parameters(), lr=0.0), window,
                                         torch.Generator(device=dev)))
        t0 = time.perf_counter()
        loss_cpu = float(cpu_tr._train_step(host, torch.optim.SGD(host.parameters(), lr=0.0),
                                            cpu_window, torch.Generator()))
        s.log(f"  CPU run of one {MFMF_BATCH}-case window: {time.perf_counter() - t0:.1f} s (host)")
        cpu_grads = {n: p.grad for n, p in host.named_parameters()}
        card_grads = {n: p.grad.cpu() for n, p in card.named_parameters()}
        # a k_proj bias shifts each query's scores by one constant, which
        # the softmax removes: its gradient is 0 in exact arithmetic and
        # rounding noise on both sides, so it is held against the norm of
        # its block's k_proj weight gradient instead of its own
        errs = {}
        for n, g in card_grads.items():
            scale = cpu_grads[n.replace("k_proj.bias", "k_proj.weight")].norm()
            errs[n] = float((g - cpu_grads[n]).norm() / scale.clamp_min(1e-30))
        worst = max(errs, key=errs.get)
        s.log("  largest gradient errors: " + ", ".join(
            f"{n} {errs[n]:.2e}" for n in sorted(errs, key=errs.get, reverse=True)[:4]))
        s.check(errs[worst] <= 1e-4, f"one window's gradients, card vs CPU: worst relative L2 "
                                     f"{errs[worst]:.2e} <= 1e-4 over {len(errs)} tensors ({worst}; "
                                     f"the k_proj biases against their weights' gradient norm)")
        rel = abs(loss_card - loss_cpu) / abs(loss_cpu)
        s.check(rel <= 1e-5, f"one window's loss, card {loss_card!r} vs CPU {loss_cpu!r}: relative "
                             f"{rel:.2e} <= 1e-5")
        del host, cpu_window, cpu_grads
        peaks = remat_peaks(f"MFMF, a {MFMF_BATCH}-case window", mc, ec, card.state_dict(), window, dev)
        s.check(peaks["segments"] < peaks["off"],
                f"MFMF remat (each attention block a segment) lowers one window's peak: "
                f"{peaks['segments']:.1f} < {peaks['off']:.1f} MiB")

        # throughput on the device path: the median of timed 64-case windows
        # (row gather + the trainer's step) after a warm-up
        model = tr._build_model(0)
        opt = make_optimizer(ec.optimizer, ec.weight_decay, model.parameters(), ec.lr)
        gen = torch.Generator(device=dev).manual_seed(0)

        def device_window(i):
            idx = rows[(i % 2) * MFMF_BATCH:(i % 2 + 1) * MFMF_BATCH].to(dev)
            return tr._train_step(model, opt, tr._gather_window(tables, idx), gen)

        device_window(0)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        walls = []
        for i in range(MFMF_TIMED_WINDOWS):
            t0 = time.perf_counter()
            device_window(i + 1)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        rates = sorted(MFMF_BATCH / w for w in walls)
        mfmf.update(tr=tr, device_window=device_window, median_ms=float(np.median(walls)) * 1e3)
        s.log("  window walls (s): " + ", ".join(f"{w:.4f}" for w in walls))
        s.timed(f"MFMF training, device path: median {MFMF_BATCH / float(np.median(walls)):.1f} "
                f"cases/s over {MFMF_TIMED_WINDOWS} windows of {MFMF_BATCH} (min {rates[0]:.1f}, "
                f"max {rates[-1]:.1f}); peak device memory "
                f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB with the tables")
        # evaluation on the device path: all 160 cases in windows of 16
        walls = []
        for _ in range(3):
            t0 = time.perf_counter()
            res = tr._evaluate(ds, all_idx, model, tables, row_of)
            walls.append(time.perf_counter() - t0)
        s.check(np.isfinite(res["probs"]).all(), "evaluation probabilities finite")
        s.timed(f"MFMF evaluation, device path: {MFMF_CASES / float(np.median(walls[1:])):.1f} "
                f"cases/s (median of 2 runs after a warm-up, windows of 16)")

    # ---------------------------------------------------------------- 13
    def mfmf_profile_phase():
        from torch.profiler import ProfilerActivity, profile

        step = mfmf["device_window"]
        step(0)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            step(1)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        events = _device_events(prof)
        if not events:
            s.log("  profiler saw no device time: device busy share not measured")
            return
        busy_ms = sum(us for _, us in events) / 1e3
        k3_ms = sum(us for e, us in events if "attn_" in e.key and "attn_bwd" not in e.key) / 1e3
        k4_ms = sum(us for e, us in events if "attn_bwd" in e.key) / 1e3
        s.timed(f"one {MFMF_BATCH}-case training window under torch.profiler: wall {wall_ms:.2f} ms, "
                f"device busy {busy_ms:.2f} ms ({100 * busy_ms / wall_ms:.1f}% of the profiled "
                f"wall), K3 {k3_ms:.3f} ms, K4 {k4_ms:.3f} ms, "
                f"{sum(e.count for e, _ in events)} device ops")
        s.timed(f"estimate: profiled device time over phase 12's median {mfmf['median_ms']:.2f} ms "
                f"per window = {100 * busy_ms / mfmf['median_ms']:.1f}% device busy (two runs)")
        for e, us in sorted(events, key=lambda x: x[1], reverse=True)[:10]:
            s.timed(f"  {us / 1e3:8.3f} ms  x{e.count:<5d} {e.key[:90]}")
        trace = mfmf["dir"] / "window_trace.json"
        prof.export_chrome_trace(str(trace))
        span, busy, gaps = _device_gaps(trace)
        if span > 0:
            s.timed(f"device timeline: {span / 1e3:.3f} ms from the first device op to the last, "
                    f"busy {busy / 1e3:.3f} ms, idle {100 * (1 - busy / span):.1f}% of it in "
                    f"{sum(1 for g in gaps if g[0] >= 5)} gaps of >= 5 us")
            for us, before, after in gaps[:5]:
                s.timed(f"  gap {us:9.1f} us after {before[:45]} before {after[:45]}")

    # ---------------------------------------------------------------- 14
    flag = {}  # directory, configs, trainers, models and windows, read by phases 15-17
    empty_idx = np.array([], np.int64)

    def flag_config(model_type="svd_gate_random_clam"):
        """combined_svd_gate_random_clam.sh's model config."""
        return ModelConfig(
            model_type=model_type, n_classes=2, input_dim=DIM, model_size="64*32", dropout=0.25,
            output_dim=FLAG_DIM, base_weight=0.9, subtyping=True, inst_number=8,
            alignment_layer_num=2, lambda1=0.1, lambda2=0.1, tau1=1.0, tau2=1.0,
            weight_random_loss=0.1, enable_svd=True, enable_dynamic_gate=True,
            enable_random_loss=True,
            channels_used_in_model=parse_channels(["wsi", "tma"] + [f"{g}_mask" for g in TABULAR_DIMS]),
            channel_input_dims={f"{g}=val": d for g, d in TABULAR_DIMS.items()})

    def bf16_config(mc):
        mc16 = ModelConfig.from_dict(mc.to_dict())
        mc16.extra["compute_dtype"] = "bfloat16"
        return mc16

    def no_kernel_launches(what):
        torch.cuda.synchronize()
        counts = {name: fn.launches for name, fn in counters.items()}
        s.check(not any(counts.values()), f"{what}: K1-K4 launched 0 times ({counts})")

    def flagship_phase():
        """The flagship eval forward on the card against a CPU run of the
        port from the same weights and window; bf16 against float32; the
        detach variant's drop_prob."""
        reset_counts()
        raws, labels = mfmf_raw_cases()
        mc = flag_config()
        td = Path(tempfile.mkdtemp(prefix="flagship_"))
        ec = ExperimentConfig(exp_name="combined_svd_gate_random_clam", seed=5678,
                              k_folds=SERVE_FOLDS, batch_size=64,
                              target_channels=list(mc.channels_used_in_model))
        flag.update(dir=td, ec=ec)
        tr = SurvivalTrainer(Configs(ec, mc), td / "f32", device=dev)
        window = tr._to_device(make_window(raws[:FLAG_WINDOW], labels[:FLAG_WINDOW]))
        case, label = {"channels": window["channels"], "masks": window["masks"]}, window["label"]
        n_wsi = window["masks"]["wsi=features"].sum(1)
        s.log(f"  window: {FLAG_WINDOW} cases, WSI bags of {int(n_wsi.min())}-{int(n_wsi.max())} "
              f"patches in a bucket of {window['channels']['wsi=features'].shape[1]}, "
              f"{len(window['channels'])} channels")
        card = ModelFactory.create_model(mc, seed=0, device=dev)
        host = ModelFactory.create_model(mc, device="cpu")
        host.load_state_dict({k: t.cpu() for k, t in card.state_dict().items()})
        s.check(len(card.used_modality) == 7, f"{len(card.used_modality)} modalities: {card.used_modality}")
        with torch.no_grad():
            got = card(case, label)
            got_loss = card.loss_fn(got["logits"], label, got)
            t0 = time.perf_counter()
            want = host({k: {c: t.cpu() for c, t in case[k].items()} for k in case}, label.cpu())
            want_loss = host.loss_fn(want["logits"], label.cpu(), want)
        s.log(f"  CPU forward of the window: {time.perf_counter() - t0:.1f} s (host)")
        l_err = float((got["logits"].cpu() - want["logits"]).abs().max())
        p_err = float((got["probabilities"].cpu() - want["probabilities"]).abs().max())
        loss_err = float(((got_loss.cpu() - want_loss).abs() / want_loss.abs()).max())
        a_err = _rel_l2_all(got["aligned_features_stack"].cpu(), want["aligned_features_stack"])
        # true float32 on both sides, summed in other orders over 1024-d rows
        s.check(l_err <= 1e-4 and p_err <= 1e-5,
                f"flagship forward, card vs CPU (float32, TF32 off): logits max abs err "
                f"{l_err:.2e} <= 1e-4, probabilities {p_err:.2e} <= 1e-5")
        s.check(loss_err <= 1e-4 and a_err <= 1e-5,
                f"per-case eval losses within {loss_err:.2e} <= 1e-4 relative, "
                f"aligned_features_stack {tuple(got['aligned_features_stack'].shape)} within "
                f"{a_err:.2e} <= 1e-5 relative L2")

        tr16 = SurvivalTrainer(Configs(ec, bf16_config(mc)), td / "bf16", device=dev)
        p16 = tr16._eval_window(tr16._compute_model(card), window)[1]
        d16 = float((p16 - got["probabilities"]).abs().max())
        s.check(p16.dtype == torch.float32 and d16 <= 4e-2,
                f"compute_dtype bfloat16 vs float32: probabilities within {d16:.2e} <= 4e-2 "
                "(the JAX package's bar, tests/test_trainers.py:test_bf16_eval_matches_f32)")

        det = ModelFactory.create_model(flag_config("svd_gate_random_clam_detach"), seed=0, device=dev)
        gen = torch.Generator(device=dev)
        with torch.no_grad():
            plain = det(case, label)["logits"]
            zero = det(case, label, generator=gen.manual_seed(0), drop_prob=0.0)["logits"]
            ones = det(case, label, generator=gen.manual_seed(0), drop_prob=1.0)["logits"]
            head = det.fusion_prediction(
                torch.zeros(FLAG_WINDOW, det.fusion_prediction[0].in_features, device=dev))
        s.check(torch.equal(plain, zero), "svd_gate_random_clam_detach at drop_prob 0.0 equals "
                                          "its forward without drop_prob")
        s.check(torch.equal(ones, head), "svd_gate_random_clam_detach at drop_prob 1.0: the logits "
                                         "are the fusion head's on an all-zero input")
        no_kernel_launches("phase 14")

    # ---------------------------------------------------------------- 15
    def flagship_inference_phase():
        """Main path: flagship inference slides/s at bench.py's cell, and
        evaluate_fold cases/s over phase 12's cases on host windows."""
        reset_counts()
        chans = ["wsi=features", "tma=cd3=features", "clinical=val", "clinical=mask"]
        mc = ModelConfig(model_type="svd_gate_random_clam", n_classes=2, input_dim=DIM,
                         model_size="64*32", dropout=0.25, output_dim=128,
                         channels_used_in_model=chans, channel_input_dims={"clinical=val": 16})
        rng = np.random.default_rng(0)
        shapes = {"wsi=features": (INF_BATCH, INF_WSI, DIM), "tma=cd3=features": (INF_BATCH, INF_TMA, DIM),
                  "clinical=val": (INF_BATCH, 1, 16)}
        channels = {k: torch.as_tensor(rng.standard_normal(v, dtype=np.float32), device=dev)
                    for k, v in shapes.items()}
        channels["clinical=mask"] = torch.ones((INF_BATCH, 1, 16), device=dev)
        masks = {"wsi=features": torch.ones((INF_BATCH, INF_WSI), dtype=torch.bool, device=dev),
                 "tma=cd3=features": torch.ones((INF_BATCH, INF_TMA), dtype=torch.bool, device=dev)}
        label = torch.zeros(INF_BATCH, dtype=torch.int64, device=dev)
        model = ModelFactory.create_model(mc, seed=0, device=dev)
        torch.cuda.reset_peak_memory_stats()
        for name, cfg in (("float32", mc), ("bf16", bf16_config(mc))):
            tr = SurvivalTrainer(Configs(flag["ec"], cfg), flag["dir"] / f"inference_{name}", device=dev)
            m = tr._compute_model(model)
            dtype = tr.compute_dtype or torch.float32
            # the window is held in the compute dtype, as bench.py holds it
            win = {"channels": {k: v.to(dtype) for k, v in channels.items()}, "masks": masks,
                   "label": label}

            def window_run(tr=tr, m=m, win=win):
                for _ in range(INF_BATCHES):
                    out = tr._eval_window(m, win)
                torch.cuda.synchronize()
                return out

            window_run()
            walls = []
            for _ in range(INF_WINDOWS):
                t0 = time.perf_counter()
                out = window_run()
                walls.append(time.perf_counter() - t0)
            rates = sorted(INF_BATCH * INF_BATCHES / w for w in walls)
            median = float(np.median(walls))
            flag[f"inference_{name}"] = (window_run, median * 1e3)
            s.check(out[1].shape == (INF_BATCH, 2) and bool(torch.isfinite(out[1]).all())
                    and bool(torch.isfinite(out[3]).all()),
                    f"{name}: probabilities [{INF_BATCH}, 2] and losses finite")
            s.log(f"  {name} window walls (s): " + ", ".join(f"{w:.4f}" for w in walls))
            s.timed(f"flagship inference, {name}: median {INF_BATCH * INF_BATCHES / median:.1f} "
                    f"slides/s over {INF_WINDOWS} windows of {INF_BATCHES} batches of {INF_BATCH} "
                    f"(min {rates[0]:.1f}, max {rates[-1]:.1f}); {1e3 * median / INF_BATCHES:.3f} ms "
                    "per batch (the trainer's eval step: forward, loss, risk)")
        s.timed(f"peak device memory {torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")

        raws, labels = mfmf_raw_cases()
        mcf = flag_config()
        tr = SurvivalTrainer(Configs(flag["ec"], mcf), flag["dir"] / "evaluate", device=dev)
        save_model(tr.log_dir / "s_0_checkpoint.npz", ModelFactory.create_model(mcf, seed=1, device=dev))
        ds = _CaseTable(raws, labels)
        split = FoldSplit(empty_idx, empty_idx, np.arange(MFMF_CASES))
        walls = []
        for _ in range(3):
            t0 = time.perf_counter()
            res = tr.evaluate_fold(ds, split, 0)
            walls.append(time.perf_counter() - t0)
        s.check(np.asarray(res["probs"]).shape == (MFMF_CASES, 2) and np.isfinite(res["probs"]).all(),
                f"evaluate_fold: {MFMF_CASES} finite probabilities")
        s.timed(f"evaluate_fold over {MFMF_CASES} cases in host windows of 16 (read, padded, "
                f"uploaded): {MFMF_CASES / float(np.median(walls[1:])):.1f} cases/s (median of 2 "
                "runs after a warm-up)")
        no_kernel_launches("phase 15")

    # ---------------------------------------------------------------- 16
    def serving_phase():
        """Main path: the HTTP scoring server over a results dir of 5 fold
        checkpoints, against evaluate_fold run directly and a CPU server."""
        import http.client
        import threading

        reset_counts()
        raws, labels = mfmf_raw_cases()
        mc, ec = flag_config(), flag["ec"]
        rd = flag["dir"] / "serve"
        rd.mkdir()
        Configs(ec, mc).save(rd / f"configs_{ec.exp_name}.json")
        for fold in range(SERVE_FOLDS):
            save_model(rd / f"s_{fold}_checkpoint.npz",
                       ModelFactory.create_model(mc, seed=100 + fold, device=dev))
        folds = list(range(SERVE_FOLDS))
        by_path = {f"h5/case_{i:03d}.h5": raw for i, raw in enumerate(raws)}
        names = ("deceased", "living")
        rows = [{"patient_id": str(1000 + i), "case_id": f"case_{i:03d}", "label": names[int(lab)],
                 "h5_file_path": f"h5/case_{i:03d}.h5"} for i, lab in enumerate(labels)]
        float_cols = ["risk", "prob_0", "prob_1"] + [f"fold_{f}_prob_1" for f in folds]

        def max_diff(got, want):
            same = ([r["case_id"] for r in got] == [r["case_id"] for r in want]
                    and [r["prediction"] for r in got] == [r["prediction"] for r in want])
            err = max(abs(float(g[c]) - float(w[c])) for g, w in zip(got, want) for c in float_cols)
            return same, err

        original = results_io.build_dataset
        results_io.build_dataset = lambda configs, csv_path, data_root_dir, align=None, **_: _CsvCases(
            csv_path, by_path)
        s.log("  utils.results_io.build_dataset is replaced by an in-memory reader keyed by "
              "h5_file_path (this machine has no h5py); everything downstream is the port's own")
        httpd = thread = None
        try:
            t0 = time.perf_counter()
            httpd = make_server(rd, rd, port=0, device=dev)
            s.timed(f"make_server: {SERVE_FOLDS} fold models built and loaded in "
                    f"{time.perf_counter() - t0:.2f} s")
            thread = threading.Thread(target=httpd.serve_forever, daemon=True)
            thread.start()

            def request(method, path, body=None):
                conn = http.client.HTTPConnection("127.0.0.1", httpd.server_address[1], timeout=600)
                try:
                    conn.request(method, path, body=body)
                    resp = conn.getresponse()
                    return resp.status, json.loads(resp.read() or b"{}")
                finally:
                    conn.close()

            status, health = request("GET", "/health")
            s.check(status == 200 and health.get("folds") == folds,
                    f"GET /health: {status}, folds {health.get('folds')}")
            responses = {}
            for n in SERVE_REQUESTS:
                t0 = time.perf_counter()
                status, res = request("POST", "/predict", json.dumps({"cases": rows[:n]}))
                wall = time.perf_counter() - t0
                s.check(status == 200 and res.get("n_cases_scored") == n,
                        f"POST /predict of {n} cases: {status}, {res.get('n_cases_scored')} scored")
                s.timed(f"POST /predict, {n} cases x {SERVE_FOLDS} folds: {wall:.3f} s, "
                        f"{n / wall:.1f} cases/s")
                responses[n] = res["cases"]
            # the ensemble of evaluate_fold run directly, once over the largest
            # request's cases: evaluate_fold scores windows of 16 cases in
            # order, so a smaller request's cases are the same windows, and
            # each request is held against its own cases' rows
            tr = SurvivalTrainer(Configs(ec, mc), rd, device=dev)
            csv_path = flag["dir"] / "request_all.csv"
            write_csv(csv_path, rows[:max(SERVE_REQUESTS)])
            ds = results_io.build_dataset(tr.configs, csv_path, rd)
            split = FoldSplit(empty_idx, empty_idx, np.arange(len(ds)))
            per_fold = {f: tr.evaluate_fold(ds, split, f) for f in folds}
            flag["fold_0_eval"] = per_fold[0]  # phase 40 holds the artifact to it
            ensemble = ensemble_rows(per_fold, folds, ds.case_to_patient)
            for n, got in responses.items():
                same, err = max_diff(got, ensemble[:n])
                s.check(same and err <= 1e-6, f"{n}-case response vs the ensemble of evaluate_fold "
                                              f"run directly on the card: max abs diff {err:.2e} <= 1e-6")
            status, err = request("POST", "/predict", b"{not json")
            s.check(status == 400 and "error" in err, f"malformed body: {status}")
            status, health = request("GET", "/health")
            s.check(status == 200 and health.get("requests") == len(SERVE_REQUESTS),
                    f"server up after the 400: {status}, {health.get('requests')} requests scored")
            cpu = make_server(rd, rd, port=0, device="cpu")
            try:
                for n in SERVE_REQUESTS[:2]:
                    t0 = time.perf_counter()
                    got = cpu.scorer.score_rows(rows[:n])["cases"]
                    s.log(f"  CPU ScoringServer, {n} cases: {time.perf_counter() - t0:.1f} s (host)")
                    same, err = max_diff(got, responses[n])
                    s.check(same and err <= 1e-4, f"{n} cases, CPU ScoringServer vs the card's "
                                                  f"responses: max abs diff {err:.2e} <= 1e-4 "
                                                  "(phase 14's logit bound; risk is a logit)")
            finally:
                cpu.server_close()
        finally:
            results_io.build_dataset = original
            if httpd is not None:
                httpd.shutdown()
                httpd.server_close()
            if thread is not None:
                thread.join(timeout=60)
        no_kernel_launches("phase 16")

    # ---------------------------------------------------------------- 17
    def flagship_profile_phase():
        """One phase-15 window in float32 and in bf16 under the profiler:
        device busy share, device ops, the longest device ops, the longest
        host ops (self time) and the longest idle gaps."""
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile

        reset_counts()
        for name in ("float32", "bf16"):
            window_run, median_ms = flag[f"inference_{name}"]
            window_run()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                window_run()
                wall_ms = (time.perf_counter() - t0) * 1e3
            events = _device_events(prof)
            if not events:
                s.log(f"  {name}: profiler saw no device time: device busy share not measured")
                continue
            busy_ms = sum(us for _, us in events) / 1e3
            n_ops = sum(e.count for e, _ in events)
            s.timed(f"one {name} inference window ({INF_BATCHES} batches of {INF_BATCH}) under "
                    f"torch.profiler: wall {wall_ms:.2f} ms, device busy {busy_ms:.2f} ms "
                    f"({100 * busy_ms / wall_ms:.1f}% of the profiled wall), {n_ops} device ops "
                    f"({n_ops / INF_BATCHES:.0f} per batch)")
            s.timed(f"estimate: profiled device time over phase 15's median {median_ms:.2f} ms per "
                    f"window = {100 * busy_ms / median_ms:.1f}% device busy (two runs)")
            for e, us in sorted(events, key=lambda x: x[1], reverse=True)[:8]:
                s.timed(f"  device {us / 1e3:8.3f} ms  x{e.count:<5d} {e.key[:90]}")
            host = [e for e in prof.key_averages() if e.device_type == DeviceType.CPU]
            for e in sorted(host, key=lambda e: e.self_cpu_time_total, reverse=True)[:6]:
                s.timed(f"  host self {e.self_cpu_time_total / 1e3:8.3f} ms  x{e.count:<5d} {e.key[:60]}")
            trace = flag["dir"] / f"inference_trace_{name}.json"
            prof.export_chrome_trace(str(trace))
            span, busy, gaps = _device_gaps(trace)
            if span > 0:
                s.timed(f"device timeline: {span / 1e3:.3f} ms from the first device op to the "
                        f"last, busy {busy / 1e3:.3f} ms, idle {100 * (1 - busy / span):.1f}% of it "
                        f"in {sum(1 for g in gaps if g[0] >= 5)} gaps of >= 5 us")
                for us, before, after in gaps[:3]:
                    s.timed(f"  gap {us:9.1f} us after {before[:45]} before {after[:45]}")
        no_kernel_launches("phase 17")

    # ---------------------------------------------------------------- 18
    flag_train = {}  # directory, trainer, model and timed window step, read by phases 19-20

    def flag_train_configs(**model):
        """combined_svd_gate_random_clam.sh's model and experiment configs
        (Adam lr 1e-4 with coupled L2 1e-5, the plateau scheduler, windows
        of 64 cases, 10 folds; epochs cut to 2)."""
        mc = flag_config()
        for k, v in model.items():
            setattr(mc, k, v)
        ec = ExperimentConfig(exp_name="combined_svd_gate_random_clam", seed=5678, k_folds=10,
                              max_epochs=2, batch_size=64, lr=1e-4, optimizer="adam",
                              weight_decay=1e-5, scheduler="plateau",
                              scheduler_params={"mode": "min", "patience": 15, "factor": 0.5},
                              device_data=True, target_channels=list(mc.channels_used_in_model))
        return mc, ec

    def host_copy(model, mc):
        host = ModelFactory.create_model(mc, device="cpu")
        host.load_state_dict({k: t.cpu() for k, t in model.state_dict().items()})
        return host

    # biases whose gradient is 0 in exact arithmetic: a binary CLAM's
    # ``attention_c`` and CustOmics' attention-pool gate shift every score of
    # a bag by one constant, which the softmax (and the top-k selection)
    # removes; the Linear before CustOmics' masked batch norm adds one
    # constant per feature over the nodes, which the normalisation removes
    exact_zero_biases = ("attention_c", "gate_nn.2", "hypergraph_net.first")

    def grad_errors(card, host, zero_biases=()):
        """Relative L2 error of each parameter's gradient on the card against
        the CPU's; a tensor with a gradient on one side only counts inf.  A
        bias of ``exact_zero_biases`` (or ``zero_biases``) has rounding noise
        for a gradient on both sides, so it is held against the norm of its
        layer's weight gradient instead of its own."""
        cpu = dict(host.named_parameters())
        errs = {}
        for n, p in card.named_parameters():
            g, want = p.grad, cpu[n].grad
            if g is None and want is None:
                continue
            if g is None or want is None:
                errs[n] = float("inf")
                continue
            ref = n
            for layer in exact_zero_biases + tuple(zero_biases):
                ref = ref.replace(f"{layer}.bias", f"{layer}.weight")
            errs[n] = float((g.cpu() - want).norm() / cpu[ref].grad.norm().clamp_min(1e-30))
        return errs

    def card_vs_cpu(label, fn, arrays, grad_idx, bar_value=1e-5, bar_grad=1e-4):
        """``fn`` (a scalar loss) on the card and on the CPU from the same
        float32 arrays: the value within ``bar_value`` relative, each
        gradient within ``bar_grad`` relative L2."""
        out = {}
        for d in (dev, "cpu"):
            ts = [torch.tensor(a, device=d, requires_grad=i in grad_idx) for i, a in enumerate(arrays)]
            v = fn(*ts)
            v.backward()
            out[d] = (v.detach().cpu(), [ts[i].grad.cpu() for i in grad_idx])
        (vc, gc), (vh, gh) = out[dev], out["cpu"]
        v_err = float((vc - vh).abs() / vh.abs().clamp_min(1e-30))
        g_err = max(_rel_l2_all(a, b) for a, b in zip(gc, gh))
        s.check(v_err <= bar_value and g_err <= bar_grad,
                f"{label}, card vs CPU: value {float(vc):.6f} within {v_err:.2e} <= {bar_value:g} "
                f"relative, gradients within {g_err:.2e} <= {bar_grad:g} relative L2")
        return gc

    def svd_factors(features):
        """rank1_svd_loss's normalisation and SVD: (S, U1) of [G, D, M]."""
        feats = features / (torch.linalg.norm(features, dim=1, keepdim=True) + 1e-8)
        U, S, _ = torch.linalg.svd(feats, full_matrices=False)
        return S, U[:, :, 0]

    @contextlib.contextmanager
    def card_signs_on_cpu(reference=lambda feats: feats.is_cuda, keep=None):
        """``rank1_svd_loss``'s SVD (``ops.losses._svd_rank1``) wrapped for a
        card run followed by a CPU run of the same loss: the card's call
        records its U1, and the CPU's call negates each case whose U1
        points against the card's.  The sign is a constant factor per
        case, so the CPU computes the value and the gradient of the loss
        at the card's signs.  Yields the CPU calls' flip counts.
        ``reference`` picks the recording run's calls by their input;
        ``keep`` (a list), if given, receives the recorded U1s in order.
        Inside, every other call re-signs to the next recorded U1: with
        ``reference`` never true and ``keep`` recorded before, runs take
        that earlier run's signs."""
        plain = losses_mod._svd_rank1
        card_u, flips = list(keep or []), []

        def svd(feats):
            S, U1 = plain(feats)
            if reference(feats):
                card_u.append(U1.detach().cpu().double())
                if keep is not None:
                    keep.append(card_u[-1])
                return S, U1
            ref = card_u.pop(0).to(U1.device)
            sign = torch.where((U1.detach().double() * ref).sum(1) < 0, -1.0, 1.0).to(U1.dtype)
            flips.append(int((sign < 0).sum()))
            return S, U1 * sign[:, None]

        losses_mod._svd_rank1 = svd
        try:
            yield flips
        finally:
            losses_mod._svd_rank1 = plain

    def flagship_train_check_phase():
        """One flagship training window on the card against a CPU run of the
        port from the same weights, window and draws; the group losses and
        the Jacobi eigensolver card vs CPU; remat on and off on the card."""
        reset_counts()
        raws, labels = mfmf_raw_cases()
        mc, ec = flag_train_configs()
        td = flag_train.setdefault("dir", Path(tempfile.mkdtemp(prefix="flagtrain_")))
        tr = SurvivalTrainer(Configs(ec, mc), td / "card", device=dev)
        cpu_tr = SurvivalTrainer(Configs(ec, mc), td / "cpu", device="cpu")
        window = tr._to_device(make_window(raws[:FLAG_WINDOW], labels[:FLAG_WINDOW]))
        cpu_window = {k: {c: t.cpu() for c, t in v.items()} if isinstance(v, dict) else v.cpu()
                      for k, v in window.items()}
        label = window["label"]
        card = ModelFactory.create_model(mc, seed=0, device=dev)
        host = host_copy(card, mc)
        # the draws (dropout masks, the random partial loss) come from one
        # CPU generator on both sides; the wrappers move them to the card
        with torch.no_grad():
            res = card({"channels": window["channels"], "masks": window["masks"]}, label,
                       generator=torch.Generator().manual_seed(0), train=True)
        stack = res["aligned_features_stack"]  # [G, M, output_dim]
        feats = stack.transpose(1, 2)
        s_card, u_card = svd_factors(feats)
        s_cpu, u_cpu = svd_factors(feats.cpu())
        flips = int(((u_card.cpu() * u_cpu).sum(1) < 0).sum())
        s.log(f"  window of {FLAG_WINDOW}: aligned_features_stack {tuple(stack.shape)}; U1 sign flips, "
              f"cuSOLVER vs the CPU's LAPACK on the same features: {flips} of {FLAG_WINDOW}")
        s.check(float((s_card.cpu() - s_cpu).abs().max()) <= 1e-5,
                f"window singular values, card vs CPU within "
                f"{float((s_card.cpu() - s_cpu).abs().max()):.2e} <= 1e-5")
        # loss2 reads U1's signs: the CPU run takes the card's (see
        # card_signs_on_cpu), so the gradient is held at lambda1 = 0.1
        with card_signs_on_cpu() as step_flips:
            loss_card = float(tr._train_step(card, torch.optim.SGD(card.parameters(), lr=0.0),
                                             window, torch.Generator().manual_seed(0)))
            t0 = time.perf_counter()
            loss_cpu = float(cpu_tr._train_step(host, torch.optim.SGD(host.parameters(), lr=0.0),
                                                cpu_window, torch.Generator().manual_seed(0)))
        s.log(f"  CPU run of one {FLAG_WINDOW}-case training window: {time.perf_counter() - t0:.1f} s "
              f"(host); its U1 re-signed to the card's in {step_flips[0]} of {FLAG_WINDOW} cases")
        errs = grad_errors(card, host)
        worst = max(errs, key=errs.get)
        s.log("  largest gradient errors: " + ", ".join(
            f"{n} {errs[n]:.2e}" for n in sorted(errs, key=errs.get, reverse=True)[:4]))
        s.check(errs[worst] <= 1e-4, f"one training window's gradients (lambda1 = "
                                     f"{card.lambda1}, the CPU at the card's U1 signs), card vs "
                                     f"CPU: worst relative L2 "
                                     f"{errs[worst]:.2e} <= 1e-4 over {len(errs)} tensors ({worst}; "
                                     "the attention_c biases against their weights' gradient norm)")
        rel = abs(loss_card - loss_cpu) / abs(loss_cpu)
        s.check(rel <= 1e-5, f"the window's mean case loss, card {loss_card!r} vs CPU {loss_cpu!r}: "
                             f"relative {rel:.2e} <= 1e-5")

        # rank1_svd_loss at the main path's window, [64, 128, 7]
        rng = np.random.default_rng(18)
        f = rng.standard_normal((MFMF_BATCH, FLAG_DIM, 7), dtype=np.float32)
        fc, fh = torch.as_tensor(f, device=dev), torch.as_tensor(f)
        sc, uc = svd_factors(fc)
        sh, uh = svd_factors(fh)
        flipped = (uc.cpu() * uh).sum(1) < 0
        s_err = float((sc.cpu() - sh).abs().max())
        want = rank1_svd_loss(fh, 1.0, 1.0, 0.1)[0]
        raw = rank1_svd_loss(fc, 1.0, 1.0, 0.1)[0]
        s.log(f"  rank1_svd_loss [64, 128, 7]: {int(flipped.sum())} of 64 U1 signs flipped against "
              f"the CPU; card {float(raw):.6f}, CPU at its own signs {float(want):.6f}")
        s.check(s_err <= 1e-5, f"rank1_svd_loss [64, 128, 7]: S within {s_err:.2e} <= 1e-5")
        if not bool(flipped.any()):
            r_err = float((raw.cpu() - want).abs() / want.abs())
            s.check(r_err <= 1e-5, f"rank1_svd_loss [64, 128, 7], no flips: card within {r_err:.2e} "
                                   "<= 1e-5 relative")
        with card_signs_on_cpu() as loss_flips:
            card_vs_cpu("rank1_svd_loss [64, 128, 7], lambda1 = 0.1, the CPU at the card's U1 signs",
                        lambda x: rank1_svd_loss(x, 1.0, 1.0, 0.1)[0], [f], [0])
        s.check(loss_flips == [int(flipped.sum())],
                f"the same {loss_flips} cases re-signed as counted above")
        card_vs_cpu('rank1_svd_loss [64, 128, 7], impl="gram"',
                    lambda x: rank1_svd_loss(x, 1.0, 1.0, 0.1, impl="gram")[0], [f], [0])
        unit = f / np.linalg.norm(f, axis=1, keepdims=True)
        gram = np.einsum("bdm,bdn->bmn", unit, unit).astype(np.float32)
        w_lam = rng.standard_normal((MFMF_BATCH, 7), dtype=np.float32)
        w_vec = rng.standard_normal((MFMF_BATCH, 7, 7), dtype=np.float32)

        def jacobi_probe(g):
            lam, vec = _jacobi_eigh_desc.apply(g, 8)
            return (lam * torch.as_tensor(w_lam, device=g.device)).sum() + (
                vec * torch.as_tensor(w_vec, device=g.device)).sum()

        card_vs_cpu("_jacobi_eigh_desc [64, 7, 7] forward and closed-form backward",
                    jacobi_probe, [gram], [0])
        g_dev = torch.as_tensor(gram, device=dev).requires_grad_()

        def jacobi_step():
            jacobi_probe(g_dev).backward()

        ms = s.cuda_ms(jacobi_step, iters=5, warmup=1)
        s.timed(f"_jacobi_eigh_desc [64, 7, 7] forward + backward on the card: {ms:.2f} ms "
                "(8 sweeps x 21 planes of small launches; off the flagship's path)")

        # the CLIP group loss of clip_gate_random_clam at this window's width,
        # and the other group and alignment losses
        clip_cfg = flag_config("clip_gate_random_clam")
        clip = ModelFactory.create_model(clip_cfg, seed=0, device=dev)
        clip_host = host_copy(clip, clip_cfg)
        lab = np.arange(MFMF_BATCH) % 2
        stack64 = rng.standard_normal((MFMF_BATCH, 7, FLAG_DIM), dtype=np.float32)
        card_vs_cpu("ClipGateRandomClam.group_loss_fn [64, 7, 128]",
                    lambda x: (clip if x.is_cuda else clip_host).group_loss_fn(
                        {"aligned_features_stack": x,
                         "label": torch.as_tensor(lab, device=x.device)}), [stack64], [0])
        a_, o1, o2 = (rng.standard_normal((MFMF_BATCH, FLAG_DIM), dtype=np.float32) / 8 for _ in range(3))
        card_vs_cpu("clip_alignment_loss [64, 128]", clip_alignment_loss,
                    [a_, o1, np.float32(np.log(1 / 0.07))], [0, 1, 2])
        card_vs_cpu("volume_loss, 3 x [64, 128]", lambda x, y, z: volume_loss([x, y, z], 1.0)[0],
                    [a_, o1, o2], [0, 1, 2])
        risk = rng.standard_normal(MFMF_BATCH, dtype=np.float32)
        time_ = rng.uniform(1, 60, MFMF_BATCH).astype(np.float32)
        event = (rng.random(MFMF_BATCH) < 0.6).astype(np.float32)
        card_vs_cpu("cox_ph_loss [64]", cox_ph_loss, [risk, time_, event], [0])
        margins = rng.standard_normal(MFMF_BATCH, dtype=np.float32)
        params = [np.float32(0.3), np.float32(-0.2), np.float32(0.7)]
        g = card_vs_cpu("aucm_loss [64]", lambda m, a, b, al: aucm_loss(
            m, torch.as_tensor(lab, device=m.device), a, b, al), [margins] + params, [0, 1, 2, 3])
        pos = lab == 1
        p = pos.mean()
        dalpha = 2 * (p * (1 - p) + np.mean(p * margins * ~pos - (1 - p) * margins * pos)) \
            - 2 * p * (1 - p) * params[2]
        s.check(abs(float(g[3]) + dalpha) <= 1e-5 * max(1.0, abs(dalpha)),
                f"aucm_loss: alpha's gradient on the card {float(g[3]):.6f} is the negated "
                f"derivative {-dalpha:.6f} (gradient reversal)")

        # remat on and off on the card: the same window, weights and draws
        grads = {}
        for remat in (False, True, False):
            ec_r = dataclasses.replace(ec, remat=remat)
            tr_r = SurvivalTrainer(Configs(ec_r, mc), td / f"remat_{remat}", device=dev)
            m = ModelFactory.create_model(mc, device=dev)
            m.load_state_dict(card.state_dict())
            tr_r._train_step(m, torch.optim.SGD(m.parameters(), lr=0.0), window,
                             torch.Generator().manual_seed(0))
            grads.setdefault(remat, []).append({n: q.grad for n, q in m.named_parameters()
                                                if q.grad is not None})
        off, on, again = grads[False][0], grads[True][0], grads[False][1]
        r_err = max(_rel_l2_all(on[n], off[n]) for n in off)
        n_err = max(_rel_l2_all(again[n], off[n]) for n in off)
        equal = sum(bool(torch.equal(on[n], off[n])) for n in off)
        s.check(on.keys() == off.keys() and r_err <= 1e-6,
                f"remat on vs off on the card: worst relative L2 {r_err:.2e} <= 1e-6 over {len(off)} "
                f"gradients ({equal} bit-equal; two runs without remat differ by {n_err:.2e})")
        peaks = remat_peaks(f"flagship, a {FLAG_WINDOW}-case window", mc, ec, card.state_dict(),
                            window, "cpu")
        s.check(peaks["segments"] <= peaks["whole forward"] and peaks["segments"] <= peaks["off"],
                f"flagship remat (each CLAM branch a segment): peak {peaks['segments']:.1f} MiB, "
                f"not above the whole forward's {peaks['whole forward']:.1f} or off's "
                f"{peaks['off']:.1f}")
        del card, host, res, stack, grads
        no_kernel_launches("phase 18")

    # ---------------------------------------------------------------- 19
    def flagship_training_phase():
        """Main path: flagship training cases/s on the device tables,
        bench.py's training cell in slides/s, then the training CLI's run
        over one fold and the port's predict over its results directory."""
        reset_counts()
        raws, labels = mfmf_raw_cases()
        ds = _CaseTable(raws, labels)
        mc, ec = flag_train_configs()
        td = flag_train.setdefault("dir", Path(tempfile.mkdtemp(prefix="flagtrain_")))
        split = create_k_fold_splits(ds.labels, ec.k_folds, ec.seed)[0]
        tr = SurvivalTrainer(Configs(ec, mc), td / "timing", device=dev)
        all_idx = np.concatenate([split.train_idx, split.val_idx, split.test_idx]).astype(np.int64)
        tables, row_of = tr._device_tables(ds, all_idx)
        rows = torch.as_tensor([row_of[int(i)] for i in split.train_idx], dtype=torch.int64)
        model = tr._build_model(0)
        opt = make_optimizer(ec.optimizer, ec.weight_decay, model.parameters(), ec.lr)
        gen = torch.Generator(device=dev).manual_seed(0)

        def device_window(i):
            idx = rows[(i % 2) * MFMF_BATCH:(i % 2 + 1) * MFMF_BATCH].to(dev)
            return tr._train_step(model, opt, tr._gather_window(tables, idx), gen)

        device_window(0)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        walls, losses = [], []
        for i in range(MFMF_TIMED_WINDOWS):
            t0 = time.perf_counter()
            losses.append(device_window(i + 1))
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        rates = sorted(MFMF_BATCH / w for w in walls)
        median = float(np.median(walls))
        flag_train.update(model=model, tables=tables, rows=rows, tr=tr, device_window=device_window,
                          median_ms=median * 1e3)
        s.check(bool(torch.isfinite(torch.stack(losses)).all()), "timed windows' losses finite")
        s.log("  window walls (s): " + ", ".join(f"{w:.4f}" for w in walls))
        s.log(f"  fold 0 of {ec.k_folds}: {len(split.train_idx)} train, {len(split.val_idx)} val, "
              f"{len(split.test_idx)} test cases; the timed windows alternate its first two")
        s.timed(f"flagship training, device path: median {MFMF_BATCH / median:.1f} cases/s over "
                f"{MFMF_TIMED_WINDOWS} windows of {MFMF_BATCH} (min {rates[0]:.1f}, max "
                f"{rates[-1]:.1f}): gather, forward, backward with the SVD group loss, Adam; peak "
                f"device memory {torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB with the tables")

        # bench.py's training cell (run_training_ours): 8 cases x 4096 WSI x
        # 32 TMA (cd3) x 1024 + clinical values, held on the card, f32, SVD
        # and gate on, random loss off, Adam lr 1e-4 with L2 1e-4
        chans = ["wsi=features", "tma=cd3=features", "clinical=val", "clinical=mask"]
        mcb = ModelConfig(model_type="svd_gate_random_clam", n_classes=2, input_dim=DIM,
                          model_size="64*32", dropout=0.25, output_dim=128,
                          channels_used_in_model=chans, channel_input_dims={"clinical=val": 16})
        mcb.extra.update(enable_svd=True, enable_dynamic_gate=True, enable_random_loss=False)
        trb = SurvivalTrainer(Configs(ExperimentConfig(batch_size=INF_BATCH), mcb),
                              td / "bench", device=dev)
        rng = np.random.default_rng(0)
        shapes = {"wsi=features": (INF_BATCH, INF_WSI, DIM), "tma=cd3=features": (INF_BATCH, INF_TMA, DIM),
                  "clinical=val": (INF_BATCH, 1, 16)}
        channels = {k: torch.as_tensor(rng.standard_normal(v, dtype=np.float32), device=dev)
                    for k, v in shapes.items()}
        channels["clinical=mask"] = torch.ones((INF_BATCH, 1, 16), device=dev)
        win = {"channels": channels,
               "masks": {"wsi=features": torch.ones((INF_BATCH, INF_WSI), dtype=torch.bool, device=dev),
                         "tma=cd3=features": torch.ones((INF_BATCH, INF_TMA), dtype=torch.bool, device=dev)},
               "label": torch.as_tensor(np.tile([0, 1], INF_BATCH // 2), device=dev)}
        mb = trb._build_model(0)
        optb = make_optimizer("adam", 1e-4, mb.parameters(), 1e-4)
        genb = torch.Generator(device=dev).manual_seed(0)

        def bench_run():
            for _ in range(BENCH_TRAIN_STEPS):
                out = trb._train_step(mb, optb, win, genb)
            torch.cuda.synchronize()
            return out

        bench_run()
        walls = []
        for _ in range(MFMF_TIMED_WINDOWS):
            t0 = time.perf_counter()
            out = bench_run()
            walls.append(time.perf_counter() - t0)
        rates = sorted(INF_BATCH * BENCH_TRAIN_STEPS / w for w in walls)
        median = float(np.median(walls))
        s.check(bool(torch.isfinite(out)), "bench training cell: loss finite")
        s.timed(f"bench.py's training cell: median {INF_BATCH * BENCH_TRAIN_STEPS / median:.1f} "
                f"slides/s over {MFMF_TIMED_WINDOWS} runs of {BENCH_TRAIN_STEPS} steps of "
                f"{INF_BATCH} (min {rates[0]:.1f}, max {rates[-1]:.1f}); "
                f"{1e3 * median / BENCH_TRAIN_STEPS:.2f} ms a step")
        del win, channels, mb, optb

        # the training CLI over the in-memory cases: the script's flags, 2
        # epochs of its last fold (--start_k_fold 9 of --k 10)
        shorthands = ["wsi", "tma"] + list(TABULAR_DIMS)
        results = td / "cli"
        args = cli_main.parse_args(
            ["--results_dir", str(results), "--exp_code", "combined_svd_gate_random_clam",
             "--model_type", "svd_gate_random_clam", "--target_channels", *shorthands,
             "--channels_used_in_model", *shorthands, "--k", "10", "--start_k_fold", "9",
             "--max_epochs", "2", "--lr", "1e-4", "--lr_scheduler", "plateau",
             "--lr_scheduler_params", '{"mode": "min", "patience": 15, "factor": 0.5}',
             "--reg", "1e-5", "--opt", "adam", "--batch_size", "64", "--input_dim", str(DIM),
             "--dropout", "0.25", "--base_weight", "0.9", "--inst_loss_fn", "ce",
             "--model_size", "64*32", "--inst_number", "8", "--output_dim", str(FLAG_DIM),
             "--alignment_layer_num", "2", "--lambda1", "0.1", "--lambda2", "0.1", "--tau1", "1.0",
             "--tau2", "1.0", "--weight_random_loss", "0.1", "--early_stopping", "--gate",
             "--subtyping", "--enable_svd", "--enable_dynamic_gate", "--enable_random_loss",
             "--tpu_opts", '{"device_data": true}', "--seed", "5678", "--device", "cuda"])
        t0 = time.perf_counter()
        out_dir = cli_main.run(args, ds)
        wall = time.perf_counter() - t0
        names = {p.name for p in out_dir.iterdir()}
        want_files = {"configs_combined_svd_gate_random_clam.json", "splits_9.csv", "s_9_checkpoint.npz",
                      "fold_9_epochs.csv", "fold_9_summary.json", "summary.csv",
                      "detailed_results_for_plotting.json"}
        s.check(want_files <= names, f"cli.main_survival.run: {sorted(want_files - names) or 'all'} "
                                     f"result files written ({len(names)} files)")
        fold = json.loads((out_dir / "fold_9_summary.json").read_text())
        s.check(all(np.isfinite([h["train_loss"], h["val_loss"]]).all() for h in fold["history"]),
                f"CLI fold 9: losses finite ({len(fold['history'])} epochs)")
        fold9 = create_k_fold_splits(ds.labels, 10, 5678)[9]
        s.timed(f"cli.main_survival.run, fold 9 of 10 ({len(fold9.train_idx)} train, "
                f"{len(fold9.val_idx)} val, {len(fold9.test_idx)} test cases), 2 epochs and "
                f"evaluation, its device tables included: {wall:.2f} s")

        # the port scores the directory it trained (phase 16's in-memory reader)
        by_path = {f"h5/case_{i:03d}.h5": raw for i, raw in enumerate(raws)}
        names_ = ("deceased", "living")
        csv_rows = [{"patient_id": str(1000 + i), "case_id": f"case_{i:03d}",
                     "label": names_[int(lab)], "h5_file_path": f"h5/case_{i:03d}.h5"}
                    for i, lab in enumerate(labels)]
        csv_path = td / "cases.csv"
        write_csv(csv_path, csv_rows)
        original = results_io.build_dataset
        results_io.build_dataset = lambda configs, csv_path, data_root_dir, align=None, **_: _CsvCases(
            csv_path, by_path)
        try:
            res = predict(out_dir, csv_path, out_dir, device=dev)
            tr_cli = SurvivalTrainer(Configs.load(out_dir / "configs_combined_svd_gate_random_clam.json"),
                                     out_dir, device=dev)
            ds_csv = results_io.build_dataset(tr_cli.configs, csv_path, out_dir)
            direct = tr_cli.evaluate_fold(ds_csv, FoldSplit(empty_idx, empty_idx,
                                                            np.arange(len(ds_csv))), 9)
        finally:
            results_io.build_dataset = original
        got = {r["case_id"]: float(r["prob_1"]) for r in res["cases"]}
        err = max(abs(got[c] - p[1]) for c, p in zip(direct["patient_ids"], direct["probs"]))
        s.check(res["n_cases_scored"] == MFMF_CASES and res["folds"] == [9] and err <= 1e-6,
                f"predict over the CLI's results dir: {res['n_cases_scored']} cases, folds "
                f"{res['folds']}, prob_1 within {err:.2e} <= 1e-6 of evaluate_fold run directly")
        no_kernel_launches("phase 19")

    # ---------------------------------------------------------------- 20
    def flagship_train_profile_phase():
        """One phase-19 training window under the profiler: device busy
        share, device ops, the longest device and host ops, idle gaps; then
        the SVD group loss alone, forward and backward, host and device."""
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile

        reset_counts()
        step = flag_train["device_window"]
        step(0)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            step(1)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        events = _device_events(prof)
        if not events:
            s.log("  profiler saw no device time: device busy share not measured")
        else:
            busy_ms = sum(us for _, us in events) / 1e3
            s.timed(f"one {MFMF_BATCH}-case flagship training window under torch.profiler: wall "
                    f"{wall_ms:.2f} ms, device busy {busy_ms:.2f} ms ({100 * busy_ms / wall_ms:.1f}% of "
                    f"the profiled wall), {sum(e.count for e, _ in events)} device ops")
            s.timed(f"estimate: profiled device time over phase 19's median {flag_train['median_ms']:.2f} "
                    f"ms per window = {100 * busy_ms / flag_train['median_ms']:.1f}% device busy (two runs)")
            for e, us in sorted(events, key=lambda x: x[1], reverse=True)[:8]:
                s.timed(f"  device {us / 1e3:8.3f} ms  x{e.count:<5d} {e.key[:90]}")
            host = [e for e in prof.key_averages() if e.device_type == DeviceType.CPU]
            for e in sorted(host, key=lambda e: e.self_cpu_time_total, reverse=True)[:6]:
                s.timed(f"  host self {e.self_cpu_time_total / 1e3:8.3f} ms  x{e.count:<5d} {e.key[:60]}")
            trace = flag_train["dir"] / "train_trace.json"
            prof.export_chrome_trace(str(trace))
            span, busy, gaps = _device_gaps(trace)
            if span > 0:
                s.timed(f"device timeline: {span / 1e3:.3f} ms from the first device op to the last, "
                        f"busy {busy / 1e3:.3f} ms, idle {100 * (1 - busy / span):.1f}% of it in "
                        f"{sum(1 for g in gaps if g[0] >= 5)} gaps of >= 5 us")
                for us, before, after in gaps[:5]:
                    s.timed(f"  gap {us:9.1f} us after {before[:45]} before {after[:45]}")

        # the SVD group loss of one window alone: forward + backward
        model, tr, rows = flag_train["model"], flag_train["tr"], flag_train["rows"]
        idx = rows[:MFMF_BATCH].to(dev)
        win = tr._gather_window(flag_train["tables"], idx)
        with torch.no_grad():
            res = model({"channels": win["channels"], "masks": win["masks"]}, win["label"],
                        generator=torch.Generator(device=dev).manual_seed(0), train=True)
        x = res["aligned_features_stack"].detach().requires_grad_()
        group = {"label": win["label"]}
        del win, res

        def group_loss():
            x.grad = None
            model.group_loss_fn(dict(group, aligned_features_stack=x)).backward()

        group_loss()
        torch.cuda.synchronize()
        host_ms = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            group_loss()
            host_ms.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            group_loss()
            torch.cuda.synchronize()
        dev_ms = sum(us for _, us in _device_events(prof)) / 1e3
        waits = sum(e.count for e in prof.key_averages() if e.device_type == DeviceType.CPU
                    and ("Synchronize" in e.key or "Memcpy" in e.key))
        s.timed(f"SVD group loss of one window ([{MFMF_BATCH}, {FLAG_DIM}, 7], forward + backward): "
                f"host {float(np.median(host_ms)):.2f} ms a call (median of 5, the call returns after "
                f"its host waits), device {dev_ms:.2f} ms, {waits} synchronising host calls "
                "(cudaStreamSynchronize / cudaMemcpy) a call")
        for e, us in sorted(_device_events(prof), key=lambda x: x[1], reverse=True)[:4]:
            s.timed(f"  device {us / 1e3:8.3f} ms  x{e.count:<5d} {e.key[:90]}")
        no_kernel_launches("phase 20")

    # ---------------------------------------------------------------- 21
    zoo = {}  # directory, read by phases 22-23
    # ps3.sh's seven channels, each tabular group with its mask
    zoo_chans = parse_channels(["wsi", "tma"] + [f"{g}_mask" for g in TABULAR_DIMS])
    tabular_chans = parse_channels([f"{g}_mask" for g in TABULAR_DIMS])
    hg_model_chans = ["hypergraph=wsi_super_features", "hypergraph=tma_features"] + tabular_chans
    hg_targets = hg_model_chans[:2] + ["hypergraph=edge_index", "hypergraph=edge_weights"] + tabular_chans

    def zoo_config(key, chans):
        """ps3.sh's width (1024-d inputs, model_size 64*32, output_dim 128,
        dropout 0.25, base_weight 0.9, subtyping, inst_number 8) with the
        flagship script's SVD settings; cust_omics at the JAX default
        hypergraph_hidden_dims [256, 256] over 1024-d nodes."""
        mc = ModelConfig(model_type=key, n_classes=2, input_dim=DIM, model_size="64*32",
                         dropout=0.25, output_dim=FLAG_DIM, base_weight=0.9, subtyping=True,
                         inst_number=8, alignment_layer_num=2, lambda1=0.1, lambda2=0.1,
                         tau1=1.0, tau2=1.0, channels_used_in_model=list(chans),
                         channel_input_dims={f"{g}=val": d for g, d in TABULAR_DIMS.items()})
        if key == "cust_omics":
            mc.extra.update(hypergraph_hidden_dims=[256, 256], hypergraph_node_dim=DIM)
        return mc

    def cpu_copy(window):
        return {k: {c: t.cpu() for c, t in v.items()} if isinstance(v, dict) else v.cpu()
                for k, v in window.items()}

    def synthetic_hypergraph(rng, raw):
        """A build's hypergraph arrays for one of phase 12's cases, drawn
        (phase 21 launches no kernel): 100 super-patches from the WSI bag,
        the case's TMA rows as the TMA nodes, 5 (node, hyperedge) pairs a
        node with weights in [0, 1]."""
        tma = np.concatenate([raw[f"tma={mk}=features"] for mk in TMA_MARKERS])
        n = NUM_SUPER + tma.shape[0]
        src = np.repeat(np.arange(n), 5)
        return {"hypergraph=wsi_super_features": raw["wsi=features"][:NUM_SUPER],
                "hypergraph=tma_features": tma,
                "hypergraph=edge_index": np.stack([src, rng.integers(0, n, src.size)]).astype(np.int64),
                "hypergraph=edge_weights": rng.uniform(0, 1, src.size).astype(np.float32)}

    def zoo_check(label, mc, raws_w, labels_w, svd=False, zero_biases=(), f64_eval=False,
                  f64_train=False):
        """One window of ``mc``'s model on the card against a CPU run of the
        port from the same weights and window: eval logits within 1e-4 and
        probabilities within 1e-5; one training window (the trainer's step
        with a zero learning rate, the draws from one CPU generator on both
        sides) with every gradient within 1e-4 relative L2 and the mean
        case loss within 1e-5.  ``svd``: the CPU run takes the card's U1
        signs (``card_signs_on_cpu``), so loss2's gradient is held at
        lambda1 = 0.1.  ``zero_biases``: more biases whose gradient is 0 in
        exact arithmetic (see ``exact_zero_biases``).

        ``f64_eval`` / ``f64_train``: where float32 rounding alone exceeds
        the bar, the float32 comparison is printed as a reading beside the
        card's own float32 error against its float64 run, and both sides
        run again in float64, which is held to the same bars."""
        ec = ExperimentConfig(batch_size=len(labels_w), target_channels=list(mc.channels_used_in_model))
        tr = SurvivalTrainer(Configs(ec, mc), zoo["dir"] / label, device=dev)
        cpu_tr = SurvivalTrainer(Configs(ec, mc), zoo["dir"] / f"{label}_cpu", device="cpu")
        window32 = tr._to_device(make_window(raws_w, labels_w))
        card = ModelFactory.create_model(mc, seed=0, device=dev)
        host = host_copy(card, mc)

        def cast(window, dtype):
            return dict(window, channels={k: v.to(dtype) for k, v in window["channels"].items()})

        def evaluate(dtype):
            window = cast(window32, dtype)
            cpu_window = cpu_copy(window)
            with torch.no_grad():
                got = card.to(dtype)({"channels": window["channels"], "masks": window["masks"]},
                                     window["label"])
                want = host.to(dtype)({"channels": cpu_window["channels"], "masks": cpu_window["masks"]},
                                      cpu_window["label"])
            return got["logits"].cpu(), got["probabilities"].cpu(), want["logits"], want["probabilities"]

        def train(dtype, signs):
            window = cast(window32, dtype)
            with signs as flips:
                loss_card = float(tr._train_step(card.to(dtype), torch.optim.SGD(card.parameters(), lr=0.0),
                                                 window, torch.Generator().manual_seed(0)))
                t0 = time.perf_counter()
                loss_cpu = float(cpu_tr._train_step(host.to(dtype), torch.optim.SGD(host.parameters(), lr=0.0),
                                                    cpu_copy(window), torch.Generator().manual_seed(0)))
            errs = grad_errors(card, host, zero_biases)
            worst = max(errs, key=errs.get)
            return errs[worst], worst, len(errs), loss_card, abs(loss_card - loss_cpu) / abs(loss_cpu), \
                sum(flips), time.perf_counter() - t0

        gl, gp, wl, wp = evaluate(torch.float32)
        l_err, p_err = float((gl - wl).abs().max()), float((gp - wp).abs().max())
        line = (f"{label}: eval forward of {len(labels_w)} cases, card vs CPU: logits (max |logit| "
                f"{float(wl.abs().max()):.2f}) max abs err {l_err:.2e} <= 1e-4, probabilities {p_err:.2e} "
                "<= 1e-5")
        if f64_eval:
            gl64, gp64, wl64, wp64 = evaluate(torch.float64)
            s.log(f"  reading, float32: {line}; float32 against float64, card "
                  f"{float((gl - gl64).abs().max()):.2e}, CPU {float((wl - wl64).abs().max()):.2e}")
            l_err, p_err = float((gl64 - wl64).abs().max()), float((gp64 - wp64).abs().max())
            line = (f"{label}: eval forward in float64, card vs CPU: logits max abs err {l_err:.2e} "
                    f"<= 1e-4, probabilities {p_err:.2e} <= 1e-5")
        s.check(l_err <= 1e-4 and p_err <= 1e-5, line)

        def no_signs():
            return contextlib.nullcontext([])

        kept = []  # the float32 card run's U1s
        g_err, worst, n, loss, rel, flips, cpu_s = train(
            torch.float32, card_signs_on_cpu(keep=kept) if svd else no_signs())
        line = (f"{label}: training window, card vs CPU: worst gradient relative L2 {g_err:.2e} <= 1e-4 "
                f"over {n} tensors ({worst}), mean case loss {loss:.6f} within {rel:.2e} <= 1e-5"
                + (f"; the CPU re-signed to the card's U1 in {flips} SVD rows" if svd else "")
                + f" (CPU step {cpu_s:.1f} s)")
        if f64_train:
            grads32 = {k: p.grad.detach().double() for k, p in card.named_parameters() if p.grad is not None}
            # both float64 runs at the float32 card run's signs
            g64, worst64, n64, loss64, rel64, flips64, _ = train(
                torch.float64, card_signs_on_cpu(lambda feats: False, kept + kept) if svd
                else no_signs())
            own = {k: float((grads32[k] - p.grad).norm() / p.grad.norm().clamp_min(1e-30))
                   for k, p in card.named_parameters() if k in grads32 and p.grad is not None
                   and not any(f"{b}.bias" in k for b in exact_zero_biases + tuple(zero_biases))}
            s.log(f"  reading, float32: {line}")
            s.log(f"  reading: the card's float32 gradients against its float64 run"
                  + (" at the same U1 signs" if svd else "")
                  + f": worst relative L2 {max(own.values()):.2e} ({max(own, key=own.get)})")
            g_err, rel = g64, rel64
            line = (f"{label}: training window in float64, card vs CPU: worst gradient relative L2 "
                    f"{g64:.2e} <= 1e-4 over {n64} tensors ({worst64}), mean case loss {loss64:.6f} within "
                    f"{rel64:.2e} <= 1e-5" + (f"; both at the float32 card run's U1 signs ({flips64} rows "
                                                        "re-signed)" if svd else ""))
        s.check(g_err <= 1e-4 and rel <= 1e-5, line)
        del card, host, window32

    def zoo_phase():
        """The rest of the zoo, card vs CPU: the 10 classifier keys on one
        16-case window of phase 12's cases at ps3.sh's width (the gate MIL
        family on its bag channels: its Linear(D, D) weightor takes no
        16-d tabular group), cust_omics on the hypergraph channels and on
        the raw-bag fallback, auto_connections' token matrix."""
        reset_counts()
        raws, labels = mfmf_raw_cases()
        zoo["dir"] = Path(tempfile.mkdtemp(prefix="zoo_"))
        raws_w, labels_w = raws[:FLAG_WINDOW], labels[:FLAG_WINDOW]
        gate_chans = parse_channels(["wsi", "tma"])
        svd_clam_chans = ["wsi=features"] + [f"tma={mk}=features" for mk in TMA_MARKERS]
        rng = np.random.default_rng(21)
        hg_raws = [{**synthetic_hypergraph(rng, r), **{c: r[c] for c in tabular_chans}} for r in raws_w]
        # float32 rounding alone exceeds the bars here (the readings print
        # each side against its float64 run), so these comparisons are held
        # in float64 on both sides: GateMIL's slots (h * conf * conf over a
        # masked SUM of up to 4096 rows) give logits of |x| ~ 100;
        # svd_clam's SVD backward divides by the gap between the top two
        # squared singular values of 8 near-orthogonal aligned markers; the
        # raw-bag fallback's incidence joins every node to every hyperedge,
        # so the convolution is a mean over ~4000 nodes and the first
        # layer's gradient a difference of near-equal sums through the
        # batch norm
        runs = [(k, zoo_config(k, gate_chans), raws_w, {}) for k in ("gate_shared_mil", "gate_mil_detach")]
        runs += [(k, zoo_config(k, gate_chans), raws_w, {"f64_eval": True})
                 for k in ("gate_mil", "gate_auc_mil")]
        runs += [("svd_pool", zoo_config("svd_pool", zoo_chans), raws_w, {"svd": True})]
        runs += [(k, zoo_config(k, zoo_chans), raws_w, {}) for k in ("mdlm", "ps3", "fbp")]
        runs += [("cust_omics (hypergraph channels)", zoo_config("cust_omics", hg_model_chans),
                  hg_raws, {}),
                 # one transfer for all nodes: its bias is one constant per
                 # feature, which the batch norm removes
                 ("cust_omics (raw-bag fallback, 4 cases)",
                  zoo_config("cust_omics", ["wsi=features"] + svd_clam_chans[1:] + tabular_chans),
                  raws_w[:4], {"zero_biases": ("hypergraph_transfer",), "f64_train": True}),
                 ("svd_clam", zoo_config("svd_clam", svd_clam_chans), raws_w,
                  {"svd": True, "f64_train": True})]
        for label, mc, rw, opts in runs:
            try:
                zoo_check(label, mc, rw, labels_w[:len(rw)], **opts)
            except Exception:  # every key reports; one failing fails the phase
                s.log(traceback.format_exc())
                s.failures.append(f"phase 21, {label}: exception")
        n_nodes = [r["hypergraph=edge_index"].max() + 1 for r in hg_raws]
        s.log(f"  hypergraph window: {min(n_nodes)}-{max(n_nodes)} nodes a case; raw fallback: WSI "
              f"bags of {min(len(r['wsi=features']) for r in raws_w[:4])}-"
              f"{max(len(r['wsi=features']) for r in raws_w[:4])} patches + the TMA rows")

        mc = zoo_config("auto_connections", zoo_chans)
        tr = SurvivalTrainer(Configs(ExperimentConfig(batch_size=FLAG_WINDOW), mc), zoo["dir"] / "uc",
                             device=dev)
        window = tr._to_device(make_window(raws_w, labels_w))
        cpu_window = cpu_copy(window)
        card = ModelFactory.create_model(mc, seed=0, device=dev)
        with torch.no_grad():
            got = card({"channels": window["channels"], "masks": window["masks"]}, window["label"])
            want = host_copy(card, mc)({"channels": cpu_window["channels"],
                                        "masks": cpu_window["masks"]}, cpu_window["label"])
        err = float((got.cpu() - want).abs().max())
        s.check(tuple(got.shape) == (FLAG_WINDOW, 7 + 2 * 4, FLAG_DIM) and err <= 1e-4,
                f"auto_connections: token matrix {tuple(got.shape)} (7 modality tokens + 2 x 4 views), "
                f"card vs CPU max abs err {err:.2e} <= 1e-4")
        no_kernel_launches("phase 21")

    # ---------------------------------------------------------------- 22
    hg_run = {}  # trainer, model, tables and timed window step, read by phase 23

    class _H5Arrays:
        """An in-memory stand-in for one HDF5 file of the dataset layout:
        dataset paths (``hypergraph/edge_index``, ``clinical/val``) to numpy
        arrays, answering ``in`` and ``[]`` as ``h5py.File`` does for the
        paths ``data.multimodal.MultimodalDataset`` reads (the card's
        machine has no h5py)."""

        def __init__(self, arrays):
            self._arrays = arrays

        def __contains__(self, path):
            return path in self._arrays

        def __getitem__(self, path):
            return self._arrays[path]

    def cust_omics_phase():
        """Main path: the build of each slide on the card (K1 once a slide),
        its hypergraph arrays read by the port's MultimodalDataset, then
        cust_omics trained by train_fold and scored by evaluate_fold and
        predict."""
        from multimodal_fusion_tpu_torch.data import multimodal as multimodal_mod
        from multimodal_fusion_tpu_torch.data.batching import pad_case, window_bag_sizes

        raws, labels = mfmf_raw_cases()  # labels and tabular groups
        rng = np.random.default_rng(22)
        sizes = [int(rng.integers(MFMF_WSI[0], MFMF_WSI[1] + 1)) for _ in range(MFMF_CASES)]
        t0 = time.perf_counter()
        slides = _clustered_slides_on_card(sizes, torch.Generator(device=dev).manual_seed(22))
        s.log(f"  {MFMF_CASES} clustered-blob slides drawn in {time.perf_counter() - t0:.1f} s (on the "
              "card, copied to host memory)")
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        built = [build.process_arrays(*sl, **params, save_similarity=False, device=dev)["arrays"]
                 for sl in slides]
        wall = time.perf_counter() - t0
        add_main_path_counts()
        n_patches = sum(len(sl[0]) for sl in slides)
        s.timed(f"build: {MFMF_CASES} slides, {n_patches} patches ({MFMF_WSI[0]}-{MFMF_WSI[1]} a slide "
                f"x {DIM}, {N_TMA} TMA rows) in {wall:.3f} s = {n_patches / wall:.1f} patches/s "
                "(process_arrays one slide after another)")
        s.check(similarity_rect.launches == MFMF_CASES and knn.launches == 0
                and attention_fwd.launches == 0 and attention_bwd.launches == 0,
                f"build -> cust_omics path: K1 launched once per slide built ({similarity_rect.launches}"
                f" == {MFMF_CASES}), K2-K4 0 times")

        # the dataset layout in memory: the build's hypergraph/ group beside
        # the case's tabular groups, read through MultimodalDataset itself
        td = Path(tempfile.mkdtemp(prefix="hg_"))
        hg_run["dir"] = td
        store, rows = {}, []
        for i, (arrays, raw) in enumerate(zip(built, raws)):
            path = td / f"case_{i:03d}.h5"
            path.touch()  # the dataset keeps the cases whose file exists
            store[str(path)] = _H5Arrays(
                {f"hypergraph/{k}": v for k, v in arrays.items()}
                | {c.replace("=", "/"): raw[c] for c in tabular_chans})
            rows.append({"patient_id": str(1000 + i), "case_id": f"case_{i:03d}",
                         "label": ("deceased", "living")[int(labels[i])],
                         "h5_file_path": path.name})
        csv_path = td / "dataset.csv"
        write_csv(csv_path, rows)
        original = multimodal_mod.read_h5_retrying
        multimodal_mod.read_h5_retrying = lambda path, fn, *a, **k: fn(store[str(path)])
        try:
            cust_omics_main_path(csv_path, td, pad_case, window_bag_sizes)
        finally:
            multimodal_mod.read_h5_retrying = original
        s.log("  the HDF5 files were NOT read: MultimodalDataset read the build's arrays through an "
              "in-memory stand-in for h5py.File (the card's machine has no h5py)")

    def cust_omics_main_path(csv_path, td, pad_case, window_bag_sizes):
        from multimodal_fusion_tpu_torch.data.multimodal import MultimodalDataset

        ds = MultimodalDataset(csv_path, td, hg_targets)
        s.check(len(ds) == MFMF_CASES, f"MultimodalDataset over the built arrays: {len(ds)} cases")
        mc = zoo_config("cust_omics", hg_model_chans)
        ec = ExperimentConfig(exp_name="cust_omics", seed=5678, k_folds=10, max_epochs=2,
                              batch_size=MFMF_BATCH, lr=1e-4, optimizer="adam", weight_decay=1e-5,
                              scheduler="plateau",
                              scheduler_params={"mode": "min", "patience": 15, "factor": 0.5},
                              device_data=True, target_channels=list(hg_targets))
        run_dir = td / "run"
        tr = SurvivalTrainer(Configs(ec, mc), run_dir, device=dev)
        Configs(ec, mc).save(run_dir / "configs_cust_omics.json")
        split = create_k_fold_splits(ds.labels, ec.k_folds, ec.seed)[0]
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        summary = tr.train_fold(ds, split, 0)
        wall = time.perf_counter() - t0
        hist = summary["history"]
        s.check(len(hist) == 2 and all(np.isfinite([h["train_loss"], h["val_loss"]]).all() for h in hist),
                "train_fold: 2 epochs, losses finite")
        s.log("  history: " + "; ".join(f"epoch {h['epoch']}: train {h['train_loss']:.6f} val "
                                        f"{h['val_loss']:.6f} auc {h['val_auc']:.4f}" for h in hist))
        s.timed(f"train_fold, fold 0 of 10 ({len(split.train_idx)} train, {len(split.val_idx)} val, "
                f"{len(split.test_idx)} test cases), 2 epochs and evaluation, its device tables "
                f"included: {wall:.2f} s")

        # the device tables' incidence and edge weights against data/batching.py on the CPU
        all_idx = np.concatenate([split.train_idx, split.val_idx, split.test_idx]).astype(np.int64)
        tables, row_of = tr._device_tables(ds, all_idx)
        cases = [ds.get_case(ds.case_ids[int(i)]) for i in all_idx]
        sizes = window_bag_sizes([c for c, _ in cases])
        bad = 0
        for i, (raw, lab) in zip(all_idx, cases):
            want = pad_case(raw, lab, sizes)["channels"]
            r = row_of[int(i)]
            for k in ("hypergraph=incidence", "hypergraph=edge_weights"):
                bad += not np.array_equal(tables["channels"][k][r].cpu().numpy(), want[k])
        inc = tables["channels"]["hypergraph=incidence"]
        s.check(bad == 0 and float(inc.sum()) > 0,
                f"every case's incidence {tuple(inc.shape[1:])} and edge weights on the card equal "
                f"data/batching.py's on the CPU ({bad} differ); {int(inc.sum())} incidences in all")

        # one 64-case window card vs CPU, the same weights, window and draws
        rows_t = torch.as_tensor([row_of[int(i)] for i in split.train_idx], dtype=torch.int64)
        window = tr._gather_window(tables, rows_t[:MFMF_BATCH].to(dev))
        card = ModelFactory.create_model(mc, seed=0, device=dev)
        host = host_copy(card, mc)
        cpu_tr = SurvivalTrainer(Configs(ec, mc), td / "cpu", device="cpu")
        loss_card = float(tr._train_step(card, torch.optim.SGD(card.parameters(), lr=0.0), window,
                                         torch.Generator().manual_seed(0)))
        loss_cpu = float(cpu_tr._train_step(host, torch.optim.SGD(host.parameters(), lr=0.0),
                                            cpu_copy(window), torch.Generator().manual_seed(0)))
        errs = grad_errors(card, host)
        worst = max(errs, key=errs.get)
        rel = abs(loss_card - loss_cpu) / abs(loss_cpu)
        s.check(rel <= 1e-5, f"one {MFMF_BATCH}-case window's mean case loss, card {loss_card!r} vs CPU "
                             f"{loss_cpu!r}: relative {rel:.2e} <= 1e-5")
        s.check(errs[worst] <= 1e-4, f"its gradients, card vs CPU: worst relative L2 {errs[worst]:.2e} "
                                     f"<= 1e-4 over {len(errs)} tensors ({worst})")
        del card, host

        # training cases/s: timed 64-case windows on the device tables
        model = tr._build_model(0)
        opt = make_optimizer(ec.optimizer, ec.weight_decay, model.parameters(), ec.lr)
        gen = torch.Generator(device=dev).manual_seed(0)

        def device_window(i):
            idx = rows_t[(i % 2) * MFMF_BATCH:(i % 2 + 1) * MFMF_BATCH].to(dev)
            return tr._train_step(model, opt, tr._gather_window(tables, idx), gen)

        device_window(0)
        torch.cuda.synchronize()
        walls, losses = [], []
        for i in range(MFMF_TIMED_WINDOWS):
            t0 = time.perf_counter()
            losses.append(device_window(i + 1))
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        rates = sorted(MFMF_BATCH / w for w in walls)
        median = float(np.median(walls))
        hg_run.update(device_window=device_window, median_ms=median * 1e3)
        s.check(bool(torch.isfinite(torch.stack(losses)).all()), "timed windows' losses finite")
        s.log("  window walls (s): " + ", ".join(f"{w:.4f}" for w in walls))
        s.timed(f"cust_omics training, device path: median {MFMF_BATCH / median:.1f} cases/s over "
                f"{MFMF_TIMED_WINDOWS} windows of {MFMF_BATCH} (min {rates[0]:.1f}, max {rates[-1]:.1f}): "
                "gather, forward, backward, Adam")

        # evaluate_fold over every case, then predict over the run's directory
        everything = FoldSplit(empty_idx, empty_idx, np.arange(len(ds)))
        walls = []
        for _ in range(3):
            t0 = time.perf_counter()
            direct = tr.evaluate_fold(ds, everything, 0)
            walls.append(time.perf_counter() - t0)
        s.timed(f"evaluate_fold over {len(ds)} cases in host windows of 16: "
                f"{len(ds) / float(np.median(walls[1:])):.1f} cases/s (median of 2 runs after a warm-up)")
        res = predict(run_dir, csv_path, td, folds=[0], device=dev)
        got = {r["case_id"]: float(r["prob_1"]) for r in res["cases"]}
        err = max(abs(got[c] - p[1]) for c, p in zip(direct["patient_ids"], direct["probs"]))
        s.check(res["n_cases_scored"] == MFMF_CASES and err <= 1e-6 and np.isfinite(direct["probs"]).all(),
                f"predict over the run's directory: {res['n_cases_scored']} cases, prob_1 within "
                f"{err:.2e} <= 1e-6 of evaluate_fold")
        no_kernel_launches("phase 22 after the build")

    # ---------------------------------------------------------------- 23
    def cust_omics_profile_phase():
        """One phase-22 training window under the profiler: device busy
        share, device ops, the longest device and host ops, idle gaps."""
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile

        reset_counts()
        step = hg_run["device_window"]
        step(0)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            step(1)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        events = _device_events(prof)
        if not events:
            s.log("  profiler saw no device time: device busy share not measured")
            return
        busy_ms = sum(us for _, us in events) / 1e3
        s.timed(f"one {MFMF_BATCH}-case cust_omics training window under torch.profiler: wall "
                f"{wall_ms:.2f} ms, device busy {busy_ms:.2f} ms ({100 * busy_ms / wall_ms:.1f}% of the "
                f"profiled wall), {sum(e.count for e, _ in events)} device ops")
        s.timed(f"estimate: profiled device time over phase 22's median {hg_run['median_ms']:.2f} ms "
                f"per window = {100 * busy_ms / hg_run['median_ms']:.1f}% device busy (two runs)")
        for e, us in sorted(events, key=lambda x: x[1], reverse=True)[:8]:
            s.timed(f"  device {us / 1e3:8.3f} ms  x{e.count:<5d} {e.key[:90]}")
        host = [e for e in prof.key_averages() if e.device_type == DeviceType.CPU]
        for e in sorted(host, key=lambda e: e.self_cpu_time_total, reverse=True)[:6]:
            s.timed(f"  host self {e.self_cpu_time_total / 1e3:8.3f} ms  x{e.count:<5d} {e.key[:60]}")
        trace = hg_run["dir"] / "train_trace.json"
        prof.export_chrome_trace(str(trace))
        span, busy, gaps = _device_gaps(trace)
        if span > 0:
            s.timed(f"device timeline: {span / 1e3:.3f} ms from the first device op to the last, "
                    f"busy {busy / 1e3:.3f} ms, idle {100 * (1 - busy / span):.1f}% of it in "
                    f"{sum(1 for g in gaps if g[0] >= 5)} gaps of >= 5 us")
            for us, before, after in gaps[:5]:
                s.timed(f"  gap {us:9.1f} us after {before[:45]} before {after[:45]}")
        no_kernel_launches("phase 23")

    # ---------------------------------------------------------------- 24
    pre = {}  # NPZ dir, views, checkpoints and one step of each path, read by phases 25-27

    def alignment_data():
        """The NPZs (8 markers x ALIGN_CORES cores x ALIGN_PATCHES patches x
        1024, ``make_alignment_npz_fixtures``) and run_alignment's 8:1:1
        views of them, built once."""
        if "views" not in pre:
            td = Path(tempfile.mkdtemp(prefix="pretrain_"))
            t0 = time.perf_counter()
            make_alignment_npz_fixtures(td / "npz", n_cores=ALIGN_CORES, patches_per_core=ALIGN_PATCHES,
                                        feature_dim=DIM, markers=TMA_MARKERS, seed=24)
            s.log(f"  NPZs written: {len(TMA_MARKERS)} markers x {ALIGN_CORES} cores x {ALIGN_PATCHES} "
                  f"patches x {DIM} in {time.perf_counter() - t0:.1f} s (host, compressed)")
            ds = TMANpzAlignedWithNegDataset(td / "npz", list(TMA_MARKERS), filename_template="{marker}.npz",
                                             mismatch_ratio=1.0, seed=42)
            # run_alignment.py's split: RandomState(seed).shuffle, 8:1:1
            keys = list(ds.normalized_keys)
            idx = np.arange(len(keys))
            np.random.RandomState(42).shuffle(idx)
            keys = [keys[i] for i in idx]
            n_train, n_val = int(len(keys) * 0.8), int(len(keys) * 0.1)
            pre.update(dir=td, npz=td / "npz", views=ds.split_by_ids_with_neg(
                {"train": keys[:n_train], "val": keys[n_train:n_train + n_val]}, id_type="tuple", seed=42))
        return pre["views"]

    def alignment_trainer(device, loss_type, svd_impl="gram", state=None, dtype=torch.float32):
        """exp_{volume,svd}_256_tma.sh's model and trainer (8 markers,
        1024-d, 2 layers, tau1 0.1, tau2 0.05, lambda2 0.1, chunks of 8, lr
        1e-4, weight decay 1e-5), from ``state`` when given."""
        model = MultiModalAlignmentModel(list(TMA_MARKERS), feature_dim=DIM, num_layers=2,
                                         generator=torch.Generator(device=device).manual_seed(42))
        if state is not None:
            model.load_state_dict(state)
        model.to(dtype=dtype)
        return MultiModalAlignmentTrainer(model, learning_rate=1e-4, weight_decay=1e-5,
                                          loss_type=loss_type, svd_impl=svd_impl, tau1=0.1, tau2=0.05,
                                          lambda1=1.0, lambda2=0.1, loss2_chunk_size=8)

    def held(label, pair, bars):
        """``pair(dtype)`` -> ({name: value} on the card, the same on the
        CPU), each name held within its bar (a function of the two values).
        Where float32 rounding alone exceeds a bar, the comparison is held
        in float64 on both sides at the same bar, with the float32 readings
        and each side's float32 distance from its own float64 run printed
        beside it."""
        c32, h32 = pair(torch.float32)
        errs = {k: bars[k][0](c32[k], h32[k]) for k in bars}
        if all(errs[k] <= bars[k][1] for k in bars):
            s.check(True, f"{label}, card vs CPU in float32: " + ", ".join(
                f"{k} {errs[k]:.2e} <= {bars[k][1]:.0e}" for k in bars))
            return
        c64, h64 = pair(torch.float64)
        errs64 = {k: bars[k][0](c64[k], h64[k]) for k in bars}
        s.log(f"  {label}: float32 readings " + ", ".join(f"{k} {errs[k]:.2e}" for k in bars)
              + "; float32 against its own float64 run: card " + ", ".join(
                  f"{k} {bars[k][0](c32[k], c64[k]):.2e}" for k in bars) + ", CPU " + ", ".join(
                  f"{k} {bars[k][0](h32[k], h64[k]):.2e}" for k in bars))
        s.check(all(errs64[k] <= bars[k][1] for k in bars),
                f"{label}, card vs CPU held in float64 (float32 rounding exceeds a bar): " + ", ".join(
                    f"{k} {errs64[k]:.2e} <= {bars[k][1]:.0e}" for k in bars))

    def on_both(run):
        return lambda dtype: (run(dev, dtype), run("cpu", dtype))

    def rel(a, b):
        return abs(a - b) / abs(b)

    def rel_max(a, b):
        return float((a - b).abs().max() / b.abs().max())

    def worst_rel_l2(a, b):
        return max(float((x - y).norm() / y.norm().clamp_min(1e-30)) for x, y in zip(a, b))

    step_bars = {"loss": (rel, 1e-5), "grads": (worst_rel_l2, 1e-4), "svd_values": (rel_max, 1e-4)}

    def alignment_step_phase():
        """One batch of 512 of run_alignment's training view, card vs CPU
        from the same weights, batch and predictor dropout masks (one CPU
        generator): volume, rank1 "gram" and rank1 "svd" (the CPU at the
        card's signs of U1); validate() card vs CPU."""
        reset_counts()
        views = alignment_data()
        t0 = time.perf_counter()
        pos, neg = views["train"].collate(np.arange(ALIGN_BATCH), 0)
        s.log(f"  one batch of {ALIGN_BATCH} collated in {time.perf_counter() - t0:.2f} s (host); "
              f"views: {len(views['train'])} train, {len(views['val'])} val samples")
        state = {k: t.cpu() for k, t in alignment_trainer(dev, "volume").model.state_dict().items()}

        def one_step(loss_type, svd_impl):
            def run(device, dtype):
                tr = alignment_trainer(device, loss_type, svd_impl, state, dtype)
                batch = [{m: torch.as_tensor(v, device=device, dtype=dtype) for m, v in b.items()}
                         for b in (pos, neg)]
                loss, svd = tr._loss(*batch, torch.Generator().manual_seed(7), True)
                grads = torch.autograd.grad(loss, tr.params)
                return {"loss": float(loss.detach()), "svd_values": svd.detach().cpu().double(),
                        "grads": [g.cpu().double() for g in grads]}
            return run

        held("volume step (exp_volume_256_tma)", on_both(one_step("volume", "gram")), step_bars)
        held("rank1 'gram' step with loss_IM (exp_svd_256_tma)", on_both(one_step("rank1", "gram")),
             step_bars)
        run_svd = one_step("rank1", "svd")

        def svd_pair(dtype):
            # the card's run records U1; the CPU's run that follows takes its signs
            with card_signs_on_cpu() as flips:
                out = run_svd(dev, dtype), run_svd("cpu", dtype)
            s.log(f"  rank1 'svd' ({dtype}): the CPU took the card's U1 signs, {flips} flipped")
            return out

        held("rank1 'svd' step with loss_IM, the CPU at the card's signs", svd_pair, step_bars)

        def validate(device, dtype):
            return {"val_loss": alignment_trainer(device, "volume", state=state, dtype=dtype).validate(
                views["val"], ALIGN_BATCH)}

        held(f"volume validate() over {len(views['val'])} samples", on_both(validate),
             {"val_loss": (rel, 1e-5)})

        # the volume loss's eigenvalue monitor at batch 512 takes 262144 8 x 8
        # matrices, more than cuSOLVER's batched eigensolver takes in one call
        x = torch.randn(32768, 8, 16, device=dev, generator=torch.Generator(device=dev).manual_seed(0))
        g8 = x @ x.transpose(1, 2)
        for b in (16384, 32768):
            try:
                torch.linalg.eigvalsh(g8[:b])
                torch.cuda.synchronize()
                s.log(f"  torch.linalg.eigvalsh of {b} 8 x 8 matrices in one call: taken")
            except RuntimeError as e:
                s.log(f"  torch.linalg.eigvalsh of {b} 8 x 8 matrices in one call: refused ({str(e)[:90]})")
        err = rel_max(losses_mod.eigvalsh_chunked(g8).cpu().double(), torch.linalg.eigvalsh(g8.cpu().double()))
        s.check(err <= 1e-5, f"ops.losses.eigvalsh_chunked of 32768 8 x 8 matrices on the card vs float64 "
                             f"on the CPU: {err:.2e} <= 1e-5 of the largest eigenvalue")
        no_kernel_launches("phase 24")

    # ---------------------------------------------------------------- 25
    def timed_steps(label, trainer, stream, windows=5, steps=10, warmup=2):
        """Median of ``windows`` windows of ``steps`` training steps after a
        warm-up, host clock to synchronize; returns the median ms a step."""
        gen = torch.Generator(device=dev).manual_seed(0)
        for _ in range(warmup):
            trainer._step(*next(stream), gen)
        torch.cuda.synchronize()
        walls = []
        for _ in range(windows):
            t0 = time.perf_counter()
            for _ in range(steps):
                trainer._step(*next(stream), gen)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        median = float(np.median(walls))
        s.timed(f"{label}: median {steps / median:.2f} steps/s = {steps * ALIGN_BATCH / median:.1f} "
                f"samples/s over {windows} windows of {steps} steps (min {steps / max(walls):.2f}, max "
                f"{steps / min(walls):.2f} steps/s); {1e3 * median / steps:.2f} ms a step")
        return 1e3 * median / steps

    def in_memory_h5(td, raws):
        """Empty placeholder files (the dataset keeps the cases whose file
        exists) and an in-memory stand-in for each (``_H5Arrays``), keyed as
        MultimodalDataset opens them."""
        store = {}
        for i, raw in enumerate(raws):
            path = td / f"case_{i:03d}.h5"
            path.touch()
            store[str(path)] = _H5Arrays({h5_path_for_channel(c): v for c, v in raw.items()})
        return store

    def case_rows(labels):
        return [{"patient_id": str(1000 + i), "case_id": f"case_{i:03d}",
                 "label": ("deceased", "living")[int(lab)], "h5_file_path": f"case_{i:03d}.h5"}
                for i, lab in enumerate(labels)]

    def alignment_training_phase():
        """Main path: run_alignment.py with exp_volume_256_tma's flags (and
        --val_interval 100) on the NPZs; step rates with device_data on and
        off and the rank1 "gram" step; then the survival CLI over fold 9 of
        10 of phase 12's cases with the checkpoint aligning the 8 markers,
        predict and the scoring server over its directory."""
        from multimodal_fusion_tpu_torch.cli import run_alignment as cli_align
        from multimodal_fusion_tpu_torch.data import multimodal as multimodal_mod

        reset_counts()
        views = alignment_data()
        save = pre["dir"] / "volume" / "model.npz"
        t0 = time.perf_counter()
        out = cli_align.main(["--base_dir", str(pre["npz"]), "--filename_template", "{marker}.npz",
                              *ALIGN_FLAGS, "--loss_type", "volume", "--val_interval", "100",
                              "--save_path", str(save), "--device", "cuda"])
        wall = time.perf_counter() - t0
        hist = out["history"]
        s.check(len(hist["train_loss"]) == 400 and np.isfinite(hist["train_loss"]).all()
                and len(hist["val_loss"]) == 4 and save.exists()
                and Path(f"{save}.history.json").exists() and Path(f"{save}.scalars.csv").exists(),
                f"run_alignment.py: {len(hist['train_loss'])} steps, losses finite, "
                f"{len(hist['val_loss'])} validations, model.npz, .history.json and .scalars.csv written")
        s.log("  train loss at steps 0, 99, 199, 299, 399: " + ", ".join(
            f"{hist['train_loss'][i]:.4f}" for i in (0, 99, 199, 299, 399)) + "; val: " + ", ".join(
            f"{v['step']}: {v['loss']:.4f}" for v in hist["val_loss"]))
        s.timed(f"run_alignment.py, 400 steps of {ALIGN_BATCH} (volume, 8 x {DIM}) with 4 validations, "
                f"the NPZ reads and table upload included: {wall:.2f} s = {400 / wall:.2f} steps/s")
        pre["ckpt"] = save

        vol = alignment_trainer(dev, "volume")
        vol_stream = vol.batch_stream(views["train"], ALIGN_BATCH, np.random.default_rng(42), True)
        pre["volume_ms"] = timed_steps("volume step, device_data on", vol, vol_stream)
        pre["volume_step"] = lambda: vol._step(*next(vol_stream),
                                               torch.Generator(device=dev).manual_seed(0))
        # the host collate decompresses each of a batch's 8192 NPZ rows' cores
        # (~2.7-4.3 s a step, which the collate dominates): one window of 2
        # steps and no warm-up, so that the script keeps inside its time limit
        off = alignment_trainer(dev, "volume")
        timed_steps("volume step, device_data off", off,
                    off.batch_stream(views["train"], ALIGN_BATCH, np.random.default_rng(42), False),
                    windows=1, steps=2, warmup=0)
        r1 = alignment_trainer(dev, "rank1", "gram")
        r1_stream = r1.batch_stream(views["train"], ALIGN_BATCH, np.random.default_rng(42), True)
        pre["rank1_ms"] = timed_steps("rank1 'gram' step (Jacobi eigensolver), device_data on", r1,
                                      r1_stream, windows=3, steps=5)
        pre["rank1_step"] = lambda: r1._step(*next(r1_stream),
                                             torch.Generator(device=dev).manual_seed(0))

        # the survival CLI with the checkpoint, fold 9 of 10 of phase 12's cases
        raws, labels = mfmf_raw_cases()
        td = pre["dir"] / "survival"
        td.mkdir()
        store = in_memory_h5(td, raws)
        csv_path = td / "dataset.csv"
        write_csv(csv_path, case_rows(labels))
        original = multimodal_mod.read_h5_retrying
        multimodal_mod.read_h5_retrying = lambda path, fn, *a, **k: fn(store[str(path)])
        try:
            aligned_survival(csv_path, td, raws)
        finally:
            multimodal_mod.read_h5_retrying = original
        s.log("  the HDF5 files were NOT read: MultimodalDataset read the cases through an in-memory "
              "stand-in for h5py.File (the card's machine has no h5py)")
        no_kernel_launches("phase 25")

    def aligned_survival(csv_path, td, raws):
        import http.client
        import threading

        from multimodal_fusion_tpu_torch.data.multimodal import MultimodalDataset

        shorthands = ["wsi", "tma"] + list(TABULAR_DIMS)
        align_map = {f"tma={mk}=features": mk for mk in TMA_MARKERS}
        t0 = time.perf_counter()
        out_dir = cli_main.main(
            ["--csv_path", str(csv_path), "--data_root_dir", str(td), "--results_dir", str(td / "results"),
             "--exp_code", "aligned", "--model_type", "svd_gate_random_clam",
             "--target_channels", *shorthands, "--channels_used_in_model", *shorthands,
             "--alignment_model_path", str(pre["ckpt"]),
             "--aligned_channels", *[f"{c}:{m}" for c, m in align_map.items()],
             "--k", "10", "--start_k_fold", "9", "--max_epochs", "2", "--lr", "1e-4",
             "--reg", "1e-5", "--opt", "adam", "--batch_size", "64", "--input_dim", str(DIM),
             "--dropout", "0.25", "--base_weight", "0.9", "--model_size", "64*32", "--inst_number", "8",
             "--output_dim", str(FLAG_DIM), "--alignment_layer_num", "2", "--lambda1", "0.1",
             "--lambda2", "0.1", "--tau1", "1.0", "--tau2", "1.0", "--subtyping", "--enable_svd",
             "--enable_dynamic_gate", "--enable_random_loss", "--seed", "5678", "--device", "cuda"])
        wall = time.perf_counter() - t0
        configs = Configs.load(out_dir / "configs_aligned.json")
        fold = json.loads((out_dir / "fold_9_summary.json").read_text())
        s.check(configs.experiment_config.get("aligned_channels_map") == align_map
                and all(np.isfinite([h["train_loss"], h["val_loss"]]).all() for h in fold["history"]),
                f"cli.main_survival with --alignment_model_path: fold 9, {len(fold['history'])} epochs, "
                "losses finite, the colon mapping of the 8 markers persisted")
        s.timed(f"cli.main_survival.main with the alignment checkpoint, fold 9 of 10, 2 epochs and "
                f"evaluation, the dataset's load-time alignment included: {wall:.2f} s")

        targets = configs.experiment_config.target_channels
        card_ds = results_io.build_dataset(configs, csv_path, td, device=dev)
        cpu_fn = results_io.load_alignment_model(pre["ckpt"], align_map, "cpu")
        cpu_ds = MultimodalDataset(csv_path, td, targets, align_channels=align_map, alignment_apply_fn=cpu_fn)
        err, n = 0.0, 0
        for cid in card_ds.case_ids[:8]:
            got, want = card_ds.get_case(cid)[0], cpu_ds.get_case(cid)[0]
            for ch in align_map:
                err = max(err, float(np.abs(got[f"aligned_{ch}"] - want[f"aligned_{ch}"]).max()))
                n += 1
        s.check(n == 64 and err <= 1e-5, f"aligned_<channel> features on the card vs a CPU run of the "
                                          f"checkpoint: {n} arrays, max abs err {err:.2e} <= 1e-5")

        res = predict(out_dir, csv_path, td, folds=[9], device=dev)
        tr = SurvivalTrainer(configs, out_dir, device=dev)
        direct = tr.evaluate_fold(card_ds, FoldSplit(empty_idx, empty_idx, np.arange(len(card_ds))), 9)
        got = {r["case_id"]: float(r["prob_1"]) for r in res["cases"]}
        err = max(abs(got[c] - p[1]) for c, p in zip(direct["patient_ids"], direct["probs"]))
        s.check(res["n_cases_scored"] == MFMF_CASES and err <= 1e-6,
                f"predict over the aligned run's directory: {res['n_cases_scored']} cases, prob_1 within "
                f"{err:.2e} <= 1e-6 of evaluate_fold")

        loads = []
        plain_load = results_io.load_alignment_model
        results_io.load_alignment_model = lambda *a, **k: loads.append(1) or plain_load(*a, **k)
        httpd = thread = None
        try:
            httpd = make_server(out_dir, td, port=0, device=dev)
            thread = threading.Thread(target=httpd.serve_forever, daemon=True)
            thread.start()
            conn = http.client.HTTPConnection("127.0.0.1", httpd.server_address[1], timeout=600)
            rows = [{k: r[k] for k in ("patient_id", "case_id", "h5_file_path")}
                    for r in case_rows(np.zeros(MFMF_CASES))]
            t0 = time.perf_counter()
            conn.request("POST", "/predict", body=json.dumps({"cases": rows}))
            resp = conn.getresponse()
            body = json.loads(resp.read())
            wall = time.perf_counter() - t0
            conn.close()
        finally:
            results_io.load_alignment_model = plain_load
            if httpd is not None:
                httpd.shutdown()
                httpd.server_close()
            if thread is not None:
                thread.join(timeout=60)
        served = {r["case_id"]: float(r["prob_1"]) for r in body.get("cases", [])}
        err = max((abs(served[c] - got[c]) for c in got), default=float("inf")) if served else float("inf")
        s.check(resp.status == 200 and len(served) == MFMF_CASES and err <= 1e-6 and len(loads) == 1,
                f"make_server over the aligned run: one POST /predict of {len(served)} cases ({resp.status}), "
                f"prob_1 within {err:.2e} <= 1e-6 of predict, the alignment model loaded {len(loads)} time(s)")
        s.timed(f"POST /predict with load-time alignment, {MFMF_CASES} cases x 1 fold: {wall:.3f} s, "
                f"{MFMF_CASES / wall:.1f} cases/s")

    # ---------------------------------------------------------------- 26
    vae_run = {}  # directory

    def vae_phase():
        """Main path: one VAE step card vs CPU with the same draws; then
        train_vae.py with run_vae_train.sh's flags (2 epochs) over the
        living cases of phase 12's 160, its step rate, and
        generate_reconstructed_wsi.py from best.npz over every case, read
        back by MultimodalDataset."""
        from multimodal_fusion_tpu_torch.cli import generate_reconstructed_wsi as cli_generate
        from multimodal_fusion_tpu_torch.cli import train_vae as cli_vae
        from multimodal_fusion_tpu_torch.data import multimodal as multimodal_mod
        from multimodal_fusion_tpu_torch.data.multimodal import MultimodalDataset
        from multimodal_fusion_tpu_torch.train import vae as vae_mod

        reset_counts()
        raws, labels = mfmf_raw_cases()
        x = torch.as_tensor(raws[0]["wsi=features"][:VAE_BATCH])
        g = torch.Generator().manual_seed(26)
        draws = {"encoder": [torch.rand((VAE_BATCH, 512), generator=g) < 0.9],
                 "eps": torch.randn((VAE_BATCH, 128), generator=g),
                 "decoder": [torch.rand((VAE_BATCH, 256), generator=g) < 0.9]}
        card = VAE(generator=torch.Generator(device=dev).manual_seed(42))
        host = VAE(generator=torch.Generator().manual_seed(0))
        host.load_state_dict({k: t.cpu() for k, t in card.state_dict().items()})
        losses = []
        for model, d in ((card, dev), (host, "cpu")):
            loss = vae_loss(x.to(d), *model(x.to(d), train=True, draws=draws))[0]
            loss.backward()
            losses.append(float(loss.detach()))
        errs = grad_errors(card, host)
        worst = max(errs, key=errs.get)
        s.check(rel(*losses) <= 1e-5 and errs[worst] <= 1e-4,
                f"one VAE step of {VAE_BATCH} x {DIM} (run_vae_train.sh's 1024 -> [512, 256] -> 128), "
                f"card vs CPU with the same draws: loss {losses[0]!r} vs {losses[1]!r}, relative "
                f"{rel(*losses):.2e} <= 1e-5; gradients worst relative L2 {errs[worst]:.2e} <= 1e-4 ({worst})")
        del card, host

        td = vae_run["dir"] = Path(tempfile.mkdtemp(prefix="vae_"))
        store = in_memory_h5(td, [{"wsi=features": r["wsi=features"]} for r in raws])
        csv_path = td / "dataset.csv"
        write_csv(csv_path, case_rows(labels))
        reader = lambda path, fn, *a, **k: fn(store[str(path)])  # noqa: E731

        def writer(path, channel, data, compression=None):
            store[str(path)]._arrays[h5_path_for_channel(channel)] = np.asarray(data)

        patched = [(multimodal_mod, "read_h5_retrying", reader), (vae_mod, "read_h5_retrying", reader),
                   (vae_mod, "write_channel", writer)]
        saved = [(mod, name, getattr(mod, name)) for mod, name, _ in patched]
        for mod, name, fn in patched:
            setattr(mod, name, fn)
        try:
            vae_main_path(td, csv_path, store, cli_vae, cli_generate, MultimodalDataset)
        finally:
            for mod, name, fn in saved:
                setattr(mod, name, fn)
        s.log("  the HDF5 files were NOT read or written: the dataset and the writer went through an "
              "in-memory stand-in for h5py.File (the card's machine has no h5py)")
        no_kernel_launches("phase 26")

    def vae_main_path(td, csv_path, store, cli_vae, cli_generate, MultimodalDataset):
        ckpt = td / "ckpt"
        t0 = time.perf_counter()
        out = cli_vae.main(["--csv_path", str(csv_path), "--data_root_dir", str(td), "--label_filter", "living",
                            "--batch_size", str(VAE_BATCH), "--epochs", "2", "--lr", "1e-4",
                            "--latent_dim", "128", "--hidden_dims", "512", "256",
                            "--checkpoint_dir", str(ckpt), "--device", "cuda"])
        wall = time.perf_counter() - t0
        hist = out["history"]
        s.check(len(hist["val_loss"]) == 2 and np.isfinite(hist["train_loss"] + hist["val_loss"]).all()
                and (ckpt / "best.npz").exists() and (ckpt / "latest.npz").exists(),
                f"train_vae.py: 2 epochs, losses finite (train {hist['train_loss']}, val {hist['val_loss']}), "
                "best.npz and latest.npz written")
        ds = WSIVAEDataset(csv_path, td, label_filter="living", seed=42)
        train, _ = split_train_val(ds, val_frac=0.2, seed=42)
        s.timed(f"train_vae.py, 2 epochs over {len(ds.case_ids)} living cases ({len(ds)} patches after the "
                f"10% subsample, {len(train)} of them training), the reads and checkpoints included: "
                f"{wall:.2f} s")

        model = VAE(generator=torch.Generator(device=dev).manual_seed(42))
        trainer = VAETrainer(model, learning_rate=1e-4)
        table = torch.as_tensor(train.materialize(), device=dev)
        rng = np.random.default_rng(42)
        gen = torch.Generator(device=dev).manual_seed(0)

        def step():
            rows = torch.as_tensor(rng.integers(0, len(train), VAE_BATCH), device=dev)
            return trainer._step(table[rows], gen)

        pre["vae_step"] = step
        for _ in range(2):
            step()
        torch.cuda.synchronize()
        walls = []
        for _ in range(5):
            t0 = time.perf_counter()
            for _ in range(10):
                step()
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        median = float(np.median(walls))
        s.timed(f"VAE training step on the device table: median {10 * VAE_BATCH / median:.1f} patches/s over "
                f"5 windows of 10 steps of {VAE_BATCH} (min {10 * VAE_BATCH / max(walls):.1f}, max "
                f"{10 * VAE_BATCH / min(walls):.1f}); {1e2 * median:.2f} ms a step")
        pre["vae_ms"] = 1e2 * median

        t0 = time.perf_counter()
        done = cli_generate.main(["--csv_path", str(csv_path), "--data_root_dir", str(td),
                                  "--checkpoint", str(ckpt / "best.npz"), "--latent_dim", "128",
                                  "--hidden_dims", "512", "256", "--device", "cuda"])
        wall = time.perf_counter() - t0
        n_patches = sum(done.values())
        s.timed(f"generate_reconstructed_wsi.py from best.npz: {len(done)} cases, {n_patches} patches in "
                f"{wall:.2f} s = {n_patches / wall:.1f} patches/s (batches of 256, the reads and writes "
                "in memory)")
        host = VAE(generator=torch.Generator().manual_seed(0))
        restored, _ = load_state(ckpt / "best.npz", {"model": host.state_dict()})
        host.load_state_dict(restored["model"])
        err = 0.0
        for i in (0, 1, 2):
            got = store[str(td / f"case_{i:03d}.h5")]["wsi/reconstructed_features"]
            with torch.no_grad():
                want = host.reconstruct(torch.as_tensor(store[str(td / f"case_{i:03d}.h5")]["wsi/features"]))
            err = max(err, float(np.abs(got - want.numpy()).max()))
        s.check(len(done) == MFMF_CASES and err <= 1e-5,
                f"{len(done)} cases reconstructed; the card's reconstructions vs a CPU run of best.npz "
                f"(3 cases): max abs err {err:.2e} <= 1e-5")
        ds = MultimodalDataset(csv_path, td, ["wsi=reconstructed_features"])
        same = all(np.array_equal(ds.get_case(c)[0]["wsi=reconstructed_features"],
                                  store[str(td / f"{c}.h5")]["wsi/reconstructed_features"])
                   for c in ds.case_ids)
        s.check(len(ds) == MFMF_CASES and same, f"MultimodalDataset reads wsi=reconstructed_features back "
                                                f"exactly as written ({len(ds)} cases)")

    # ---------------------------------------------------------------- 27
    def profile_step(label, step, median_ms):
        """One step under the profiler: device busy share, device ops,
        cudaLaunchKernel calls, the longest device and host ops."""
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile

        step()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            step()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        events = _device_events(prof)
        if not events:
            s.log(f"  {label}: profiler saw no device time: device busy share not measured")
            return
        busy_ms = sum(us for _, us in events) / 1e3
        host = [e for e in prof.key_averages() if e.device_type == DeviceType.CPU]
        launches = sum(e.count for e in host if e.key == "cudaLaunchKernel")
        s.timed(f"{label} under torch.profiler: wall {wall_ms:.2f} ms, device busy {busy_ms:.2f} ms "
                f"({100 * busy_ms / wall_ms:.1f}% of the profiled wall), {sum(e.count for e, _ in events)} "
                f"device ops, {launches} cudaLaunchKernel")
        s.timed(f"estimate: profiled device time over the unprofiled median {median_ms:.2f} ms a step = "
                f"{100 * busy_ms / median_ms:.1f}% device busy (two runs)")
        for e, us in sorted(events, key=lambda x: x[1], reverse=True)[:6]:
            s.timed(f"  device {us / 1e3:8.3f} ms  x{e.count:<5d} {e.key[:90]}")
        for e in sorted(host, key=lambda e: e.self_cpu_time_total, reverse=True)[:5]:
            s.timed(f"  host self {e.self_cpu_time_total / 1e3:8.3f} ms  x{e.count:<5d} {e.key[:60]}")

    def pretraining_profile_phase():
        reset_counts()
        profile_step(f"one volume step at batch {ALIGN_BATCH}", pre["volume_step"], pre["volume_ms"])
        profile_step(f"one rank1 'gram' step at batch {ALIGN_BATCH}", pre["rank1_step"], pre["rank1_ms"])
        profile_step(f"one VAE step at batch {VAE_BATCH}", pre["vae_step"], pre["vae_ms"])
        no_kernel_launches("phase 27")

    # ---------------------------------------------------------------- 28
    big = {}  # the 65536-patch slide, read by phase 29
    held_builds = {}  # phases 5 and 28's host outputs, read by phase 36

    def blockwise_phase():
        """Main path: one 65536-patch slide above FULL_STATS_MAX_N with
        save_similarity=False, whose statistics stream over K1 stripes
        (the stats pass, then the median's refine sweeps), against the whole
        [N, N] K of K1 on the card."""
        n = BIG_N
        slide = clustered_slide(np.random.default_rng(28), n, N_TMA, DIM)
        sweeps = {"calls": 0, "launches": 0, "s": 0.0, "stats_s": 0.0}
        level_pass, stats_pass = build._median_level_pass, build._blockwise_similarity_stats

        def timed_pass(fn, key):
            def run(*args, **kw):  # K1's launches and the wall of each pass
                torch.cuda.synchronize()
                t0, before = time.perf_counter(), similarity_rect.launches
                out = fn(*args, **kw)
                torch.cuda.synchronize()
                sweeps[key] += time.perf_counter() - t0
                if key == "s":
                    sweeps["calls"] += 1
                    sweeps["launches"] += similarity_rect.launches - before
                return out
            return run

        build._median_level_pass = timed_pass(level_pass, "s")
        build._blockwise_similarity_stats = timed_pass(stats_pass, "stats_s")
        reset_counts()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()  # earlier phases' live tensors
        t0 = time.perf_counter()
        try:
            res = build.process_arrays(*slide, **params, save_similarity=False, device=dev)
        finally:
            build._median_level_pass, build._blockwise_similarity_stats = level_pass, stats_pass
        wall = time.perf_counter() - t0
        add_main_path_counts()
        peak = torch.cuda.max_memory_allocated() - held
        stripes = -(-n // STRIPE)
        stats_launches = similarity_rect.launches - sweeps["launches"]
        big["launches"] = similarity_rect.launches
        s.timed(f"{n}-patch slide, blockwise statistics: {wall:.3f} s ({n / wall:.1f} patches/s), "
                f"K1 launches {similarity_rect.launches}: stats pass {stats_launches}, "
                f"{sweeps['calls']} refine sweeps {sweeps['launches']}; peak device memory of the "
                f"build {peak / 2**30:.2f} GiB (above the {held / 2**30:.2f} GiB earlier phases hold)")
        s.check(stats_launches == stripes and sweeps["launches"] == stripes * sweeps["calls"],
                f"stats pass {stats_launches} == {stripes} stripes of {STRIPE} rows, each sweep "
                f"{stripes} stripes")
        s.check(peak < n * n * 4, f"peak device memory {peak / 2**30:.2f} GiB < the whole K's "
                                  f"{n * n * 4 / 2**30:.0f} GiB")
        got = res["host"]["K_stats"]
        f = torch.as_tensor(slide[0], device=dev)
        p = torch.as_tensor(slide[1], device=dev)
        # where the slide's time goes: the two streamed passes (synchronised
        # above), the rest of the build, and one stats stripe's operations
        stripe = similarity_rect(f[:STRIPE], p[:STRIPE], f, p)
        onehot = torch.zeros((n, NUM_SUPER), device=dev)
        onehot[:, 0] = 1.0
        bounds = build._bin_bounds(0, build._MED_L1_SHIFT, build._MED_FANOUT, dev)
        idx = torch.bucketize(stripe.view(torch.int32), bounds, out_int32=True, right=True).reshape(-1)
        ops = {
            "K1": lambda: similarity_rect(f[:STRIPE], p[:STRIPE], f, p),
            "var_mean": lambda: torch.var_mean(stripe, correction=0),
            "aminmax": lambda: torch.aminmax(stripe),
            "one-hot GEMM": lambda: stripe @ onehot,
            "bucketize": lambda: torch.bucketize(stripe.view(torch.int32), bounds, out_int32=True, right=True),
            "bincount with one counter a slot": lambda: torch.bincount(idx, minlength=bounds.numel() + 1),
            "count (bucketize + bincount over 32 lanes a slot)": lambda: build._count_bins(stripe, bounds),
        }
        op_ms = {name: s.cuda_ms(fn, iters=10) for name, fn in ops.items()}
        count_ms = op_ms["count (bucketize + bincount over 32 lanes a slot)"]
        del stripe, idx
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        build.kmeans(f, NUM_SUPER, torch.Generator(device=dev).manual_seed(SEED), n_init=build.N_INIT)
        torch.cuda.synchronize()
        km_s = time.perf_counter() - t0
        reductions = op_ms["var_mean"] + op_ms["aminmax"] + op_ms["one-hot GEMM"] + count_ms
        by_kernel = s.device_ms(
            lambda: build.process_arrays(*slide, **params, save_similarity=False, device=dev), reps=1)
        if by_kernel:
            groups = {"K1": ("sim_kernel",), "GEMM (cuBLAS)": ("gemm", "Kernel2", "cutlass"),
                      "bucketize": ("searchsorted", "bucketize"), "bincount": ("histogram", "Histogram"),
                      "reductions": ("reduce_kernel",)}
            share = dict.fromkeys(list(groups) + ["other"], 0.0)
            for name, ms in by_kernel.items():
                g = next((g for g, keys in groups.items() if any(k in name for k in keys)), "other")
                share[g] += ms
            busy = sum(share.values())
            s.timed(f"{n}-patch slide's device time by kernel (profiled build): "
                    + ", ".join(f"{g} {ms:.1f} ms" for g, ms in share.items())
                    + f"; {busy:.1f} ms busy = {100 * busy / (wall * 1e3):.1f}% of the unprofiled "
                      f"{wall * 1e3:.1f} ms wall (an estimate: two runs)")
            for name, ms in sorted(by_kernel.items(), key=lambda kv: kv[1], reverse=True)[:6]:
                s.timed(f"  device {ms:9.2f} ms  {name[:90]}")
        s.timed(f"{n}-patch slide's {wall:.3f} s: stats pass {sweeps['stats_s']:.3f} s ({stripes} "
                f"stripes), {sweeps['calls']} refine sweeps {sweeps['s']:.3f} s, the rest (KMeans, "
                f"cross similarity, KNN, host) {wall - sweeps['stats_s'] - sweeps['s']:.3f} s, of which "
                f"the super-patch KMeans alone (timed again) {km_s:.3f} s")
        s.timed(f"one stats stripe [{STRIPE}, {n}]: " + ", ".join(f"{k} {v:.4f} ms" for k, v in op_ms.items())
                + f"; the reductions {reductions:.4f} ms = {100 * reductions / (reductions + op_ms['K1']):.1f}% "
                  f"of a stats stripe, the count {count_ms:.4f} ms = "
                  f"{100 * count_ms / (count_ms + op_ms['K1']):.1f}% of a refine stripe")
        check_whole_k(f"{n}-patch slide", got, res["host"], f, p, False)
        big["slide"] = (f, p)
        held_builds["p28"] = res["host"]  # phase 36 holds the 2-rank build to it

    def check_whole_k(label, got, host, f, p, bf16):
        """The streamed statistics against K1's whole K of the same slide:
        minimum, maximum and median bit-equal, mean, std and intra_mean
        within 1e-5 relative."""
        K = similarity_rect(f, p, f, p, 1.0, 1.0, bf16)
        want = build._matrix_stats_dev(K).cpu().numpy()
        labels = torch.as_tensor(host["labels"], device=dev)
        onehot = torch.zeros((K.shape[0], NUM_SUPER), device=dev).scatter_(1, labels[:, None], 1.0)
        s_cc = torch.sum(onehot * (K @ onehot), dim=0)
        diag_c = onehot.T @ torch.diagonal(K)
        counts = onehot.sum(0)
        pairs = counts * counts - counts
        intra = float(torch.sum(torch.where(pairs > 0, (s_cc - diag_c) / pairs.clamp_min(1), 0.0))
                      / torch.sum(pairs > 0))
        del K, onehot
        rel = np.abs(np.array([got[0] - want[0], got[1] - want[1], host["intra_mean"] - intra])) / \
            np.abs(np.array([want[0], want[1], intra]))
        s.log(f"  {label}: streamed [mean, std, min, max, median] {got.tolist()}, whole K "
              f"{want.tolist()}, intra_mean {float(host['intra_mean'])} / {intra}")
        s.check(got[2] == want[2] and got[3] == want[3] and got[4] == want[4],
                f"{label}: min, max and median bit-equal to the whole K's")
        s.check(bool((rel <= 1e-5).all()), f"{label}: mean, std, intra_mean within "
                                           f"{rel.max():.2e} <= 1e-5 relative of the whole K's")

    # ---------------------------------------------------------------- 29
    def stripe_phase():
        """K1 at the stripe shape [1024, 65536, 1024] alone, against its
        plain version on the same rows, timed beside torch.matmul's dot."""
        f, p = big["slide"]
        rf, rp = f[:STRIPE], p[:STRIPE]
        out = similarity_rect(rf, rp, f, p)
        again = similarity_rect(rf, rp, f, p)
        plain = similarity_rect_plain(rf, rp, f, p)
        err = float((out - plain).abs().max())
        s.check(bool(torch.equal(out, again)), "K1 stripe: two launches bit-identical")
        s.check(err <= 1e-5, f"K1 stripe [{STRIPE},{BIG_N},{DIM}]: max abs err {err:.3e} <= 1e-5")
        del out, again, plain
        ms = s.cuda_ms(lambda: similarity_rect(rf, rp, f, p), iters=10)
        plain_ms = s.cuda_ms(lambda: similarity_rect_plain(rf, rp, f, p), iters=5, warmup=1)
        lib_ms = s.cuda_ms(lambda: torch.matmul(rf, f.T), iters=10)
        bound, bound_by = _similarity_bound_ms(STRIPE, BIG_N, DIM, 2, 4)
        s.timed(f"K1 stripe [{STRIPE},{BIG_N},{DIM}] f32: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
                f"torch.matmul feature dot {lib_ms:.4f} ms, bound {bound:.4f} ms ({bound_by}); "
                f"{big['launches']} launches on the {BIG_N}-patch slide")
        s.kernels["similarity_stripe"] = {
            "name": "similarity_stripe", "route": "cuda",
            "source": "multimodal_fusion_tpu_torch/csrc/similarity.cu",
            "replaces": "multimodal_fusion_tpu/ops/pallas_similarity.py:56",
            "launches": big["launches"], "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound, "bound_by": bound_by, "library_ms": lib_ms,
        }
        big.clear()

    # ---------------------------------------------------------------- 30
    def large_modes_phase():
        """The same check in bf16 upload (streamed) and in the sampled mode
        (statistics of the 2048-point subsample, held bit-equal to those of
        K1 on the subsample's rows), at a smaller N."""
        n = MID_N
        slide = clustered_slide(np.random.default_rng(30), n, N_TMA, DIM)
        reset_counts()
        t0 = time.perf_counter()
        res = build.process_arrays(*slide, **params, save_similarity=False, upload_dtype="bfloat16",
                                   device=dev)
        wall = time.perf_counter() - t0
        add_main_path_counts()
        s.timed(f"{n}-patch slide, bf16 upload, blockwise: {wall:.3f} s, "
                f"K1 launches {similarity_rect.launches}")
        f_bf = torch.as_tensor(slide[0], device=dev).to(torch.bfloat16)
        p = torch.as_tensor(slide[1], device=dev)
        check_whole_k(f"{n}-patch slide, bf16 upload", res["host"]["K_stats"], res["host"], f_bf, p, True)

        large_n_stats = build.LARGE_N_STATS
        build.LARGE_N_STATS = "sampled"
        reset_counts()
        t0 = time.perf_counter()
        try:
            res = build.process_arrays(*slide, **params, save_similarity=False, device=dev)
        finally:
            build.LARGE_N_STATS = large_n_stats
        wall = time.perf_counter() - t0
        add_main_path_counts()
        s.timed(f"{n}-patch slide, sampled statistics: {wall:.3f} s, K1 launches "
                f"{similarity_rect.launches}")
        s.check(similarity_rect.launches == 1, "sampled mode: K1 once, on the subsample")
        sel = build._sample_rows([n], 2048, dev)[0]
        f = torch.as_tensor(slide[0], device=dev)
        want = build._matrix_stats_dev(similarity_rect(f[sel], p[sel], f[sel], p[sel])).cpu().numpy()
        s.check(np.array_equal(res["host"]["K_stats"], want),
                f"sampled K_stats {res['host']['K_stats'].tolist()} equal those of K1 on the "
                f"2048 subsample rows {want.tolist()}")

    # ---------------------------------------------------------------- 31
    def blockwise_cpu_phase():
        """Card against CPU with FULL_STATS_MAX_N lowered to 4096: a
        6000-patch slide streamed on both, the CPU from the card's kmeans++
        draws."""
        n = CPU_N
        slide = clustered_slide(np.random.default_rng(31), n, N_TMA, DIM)
        max_n = build.FULL_STATS_MAX_N
        build.FULL_STATS_MAX_N = 4096
        try:
            reset_counts()
            card = build.process_arrays(*slide, **params, save_similarity=False, device=dev)
            add_main_path_counts()
            s.check(similarity_rect.launches > -(-n // STRIPE),
                    f"{n}-patch slide streamed: {similarity_rect.launches} K1 launches")
            h = card["host"]
            g1, g2, g3 = build._generators(SEED, dev)
            nodes = torch.cat([torch.as_tensor(h["sp_feats"], device=dev),
                               torch.as_tensor(slide[2], device=dev)])
            init = {
                "super": kmeans_plus_plus_init(torch.as_tensor(slide[0], device=dev), NUM_SUPER, g1, 10).cpu(),
                "group": kmeans_plus_plus_init(torch.as_tensor(h["sim"], device=dev), NUM_GROUPS, g2, 10).cpu(),
                "hyperedge": kmeans_plus_plus_init(nodes, NUM_HYPEREDGES, g3, 10).cpu(),
            }
            t0 = time.perf_counter()
            cpu = build.process_arrays(*slide, **params, save_similarity=False, device="cpu",
                                       init_centers=init)["host"]
            s.log(f"  CPU build of the {n}-patch slide: {time.perf_counter() - t0:.1f} s (host)")
        finally:
            build.FULL_STATS_MAX_N = max_n
        ari = _ari(cpu["labels"], h["labels"])
        kerr = float(np.abs(cpu["K_stats"] - h["K_stats"]).max())
        ierr = float(abs(cpu["intra_mean"] - h["intra_mean"]))
        s.check(ari >= 0.99, f"{n}-patch streamed build, labels card vs CPU: ARI {ari:.4f} >= 0.99")
        # K within 1e-5 elementwise moves each statistic by at most about that much
        s.check(kerr <= 1e-5 and ierr <= 1e-5,
                f"{n}-patch streamed K_stats and intra_mean card vs CPU: max abs diff "
                f"{max(kerr, ierr):.2e} <= 1e-5")

    # ---------------------------------------------------------------- 32
    def batched_phase():
        """Main path: process_dataset with file_batch=8 against file_batch=1
        on phase 4's slides, windows in turns in this one run; then with
        bucket_patches on 16 slides of 2048-4096 patches
        (``clustered_slide``, seed 22).  Files of each side are compared
        slide by slide."""
        import csv

        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile

        with _hdf5_files() as (td, how):
            s.log(f"  {how}")
            csv_path = make_clustered_dataset(td / "bench", N_FILES, N_PATCHES, N_TMA, DIM, seed=0)
            import h5py

            rng = np.random.default_rng(22)
            rows = []
            (td / "bucket").mkdir()
            for i in range(BUCKET_FILES):
                feats, pos, tma = clustered_slide(rng, int(rng.integers(MFMF_WSI[0], MFMF_WSI[1] + 1)),
                                                  N_TMA, DIM)
                path = td / "bucket" / f"case_{i}.h5"
                with h5py.File(path, "w") as fh:
                    fh["wsi/features"], fh["wsi/positions"], fh["tma/features"] = feats, pos, tma
                rows.append({"patient_id": str(i), "case_id": f"case_{i}", "label": "living",
                             "h5_file_path": path.name})
            write_csv(td / "bucket" / "dataset.csv", rows)
            for label, root, csv_p, extra in (
                ("bench shape", td / "bench", csv_path, {}),
                ("2048-4096 patches, bucket_patches 4096", td / "bucket", td / "bucket" / "dataset.csv",
                 {"bucket_patches": 4096}),
            ):
                def run(fb, csv_=csv_p):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    stats, summary = build.process_dataset(csv_, root, **params, save_similarity=False,
                                                           file_batch=fb, device=dev, **extra)
                    wall = time.perf_counter() - t0
                    s.check(not any("error" in st for st in stats), f"{label}, file_batch={fb}: no errors")
                    return wall, summary["total_patches"], {
                        st["case_id"]: read_hypergraph_group(root / st["h5_path"]) for st in stats}

                run(8)  # warm-up
                walls = {1: [], 8: []}
                outs = {}
                for fb in (1, 8, 8, 1, 1, 8) if not extra else (1, 8, 8, 1):
                    reset_counts()
                    wall, patches, outs[fb] = run(fb)
                    add_main_path_counts()
                    walls[fb].append(wall)
                    files = len(outs[fb])
                    s.check(similarity_rect.launches == files,
                            f"{label}, file_batch={fb}: K1 once a slide ({similarity_rect.launches})")
                pps = {fb: patches / float(np.median(w)) for fb, w in walls.items()}
                s.timed(f"{label}: file_batch=1 {pps[1]:.1f} patches/s, file_batch=8 {pps[8]:.1f} "
                        f"patches/s (medians of {len(walls[1])} windows in turns; walls "
                        f"{[round(w, 4) for w in walls[1]]} / {[round(w, 4) for w in walls[8]]} s)")
                # launches a slide under the CPU profiler, whose cost is per op:
                # file_batch=1 over the first slide alone, 8 over a chunk of 8
                with open(csv_p, newline="") as f:
                    write_csv(root / "first.csv", list(csv.DictReader(f))[:1])
                for fb, csv_, n in ((1, root / "first.csv", 1), (8, csv_p, files)) if not extra else ():
                    with profile(activities=[ProfilerActivity.CPU]) as prof:
                        run(fb, csv_)
                    launches = sum(e.count for e in prof.key_averages()
                                   if e.device_type == DeviceType.CPU and e.key == "cudaLaunchKernel")
                    s.timed(f"{label}, file_batch={fb}: {launches / n:.0f} cudaLaunchKernel a slide over "
                            f"{n} slide{'s' if n > 1 else ''}, K1 1 a slide")
                worst_ari, same_stats, same_super = 1.0, True, True
                for case, a in outs[1].items():
                    b = outs[8][case]
                    worst_ari = min(worst_ari, _ari(a["group_labels"], b["group_labels"]))
                    ka = a["__stats__"]["wsi_aggregation"]["wsi_similarity_matrix_stats"]
                    kb = b["__stats__"]["wsi_aggregation"]["wsi_similarity_matrix_stats"]
                    same_stats &= ka == kb
                    rows_a = np.sort(a["wsi_super/features"], axis=0)
                    rows_b = np.sort(b["wsi_super/features"], axis=0)
                    same_super &= bool(np.abs(rows_a - rows_b).max() <= 1e-4)
                s.check(same_stats, f"{label}: K_stats of every slide equal, file_batch 8 vs 1")
                s.check(same_super and worst_ari >= 0.99,
                        f"{label}: super-patch means equal as sets within 1e-4 (the same "
                        f"super-patch labels), group labels ARI >= {worst_ari:.4f} >= 0.99")

    # ---------------------------------------------------------------- 33
    def cache_rebuild_phase():
        """Main path: the build CLI on 3 bench-shape slides, then
        --cache_similarity (the cached K against K1's K, bit for bit), then
        --rebuild --threshold_median_ratio 1.0, held against a CPU rebuild
        of the same cache from the card's draws."""
        from multimodal_fusion_tpu_torch.cli import preprocess_hypergraph as cli_build

        with _hdf5_files() as (td, how):
            s.log(f"  {how}")
            csv_path = make_clustered_dataset(td, 3, N_PATCHES, N_TMA, DIM, seed=33)
            base = ["--csv_path", str(csv_path), "--data_root_dir", str(td), "--device", "cuda",
                    "--num_wsi_super_patches", str(NUM_SUPER), "--num_groups", str(NUM_GROUPS),
                    "--hypergraph_k", str(K), "--num_hyperedges", str(NUM_HYPEREDGES)]
            reset_counts()
            t0 = time.perf_counter()
            cli_build.main(base + ["--no_save_similarity"])
            cached = cli_build.main(base + ["--cache_similarity"])
            t1 = time.perf_counter()
            rebuilt = cli_build.main(base + ["--rebuild", "--threshold_median_ratio", "1.0"])
            t2 = time.perf_counter()
            add_main_path_counts()
            s.timed(f"CLI: build + --cache_similarity of 3 x {N_PATCHES} patches {t1 - t0:.3f} s, "
                    f"--rebuild {t2 - t1:.3f} s; K1 launches {similarity_rect.launches}")
            s.check(not any("error" in r for r in cached + rebuilt), "cache and rebuild: no errors")
            s.check(similarity_rect.launches == 6, "K1: once a slide in the build, once in the cache")
            for i in range(3):
                h5 = td / f"case_{i}.h5"
                feats, pos = build.load_wsi_data(h5)
                tma = build.load_tma_data(h5)
                group = read_hypergraph_group(h5)
                f, p = torch.as_tensor(feats, device=dev), torch.as_tensor(pos, device=dev)
                K_card = similarity_rect(f, p, f, p).cpu().numpy()
                s.check(np.array_equal(group["similarity/wsi_internal"], K_card),
                        f"case_{i}: cached K equals K1's K bit for bit")
                thr = group["__stats__"]["hypergraph"]["threshold"]
                s.check(bool((group["edge_weights"] >= thr).all()),
                        f"case_{i}: every kept weight >= the threshold {thr:.6f} "
                        f"({group['edge_weights'].size} of "
                        f"{group['__stats__']['hypergraph']['num_edges']} edges)")
                # the card's draws of the rebuild's three stages, for a CPU rebuild
                gen = lambda: torch.Generator(device=dev).manual_seed(SEED)  # noqa: E731
                nodes = np.concatenate([group["wsi_super/features"], tma])
                init = {
                    "super": kmeans_plus_plus_init(f, NUM_SUPER, gen(), 10).cpu(),
                    "group": kmeans_plus_plus_init(torch.as_tensor(group["similarity/wsi_tma"], device=dev),
                                                   NUM_GROUPS, gen(), 10).cpu(),
                    "hyperedge": kmeans_plus_plus_init(torch.as_tensor(nodes, device=dev),
                                                       NUM_HYPEREDGES, gen(), 10).cpu(),
                }
                cpu_h5 = td / f"cpu_{i}.h5"
                with open_h5_retrying(cpu_h5, "w") as dst:
                    for key, arr in (("wsi/features", feats), ("wsi/positions", pos), ("tma/features", tma),
                                     ("hypergraph/similarity/wsi_internal", K_card)):
                        dst.create_dataset(key, data=arr)
                build.rebuild_hypergraph_from_similarity(
                    cpu_h5, NUM_SUPER, NUM_GROUPS, K, NUM_HYPEREDGES, 1.0, SEED, device="cpu",
                    init_centers=init)
                want = read_hypergraph_group(cpu_h5)
                # a patch whose cluster the two float orders decide differently
                # moves two super-patch means; the super-patch labels (at
                # convergence, each patch's nearest mean) are held by ARI as
                # phase 4 holds them, the other rows' edge weights to 1e-5
                def nearest(sp):
                    return torch.cdist(f, torch.as_tensor(sp, device=dev)).argmin(1).cpu().numpy()

                sp_ari = _ari(nearest(want["wsi_super/features"]), nearest(group["wsi_super/features"]))
                ari = _ari(want["group_labels"], group["group_labels"])
                row_err = np.abs(want["wsi_super/features"] - group["wsi_super/features"]).max(axis=1)
                same = np.concatenate([row_err <= 1e-4, np.ones(len(tma), bool)])
                wc = dict(zip(map(tuple, want["edge_index"].T.tolist()), want["edge_weights"]))
                wk = dict(zip(map(tuple, group["edge_index"].T.tolist()), group["edge_weights"]))
                jac = len(wc.keys() & wk.keys()) / max(len(wc.keys() | wk.keys()), 1)
                w_err = max((abs(wc[e] - wk[e]) for e in wc.keys() & wk.keys() if same[e[0]] and same[e[1]]),
                            default=0.0)
                s.check(sp_ari >= 0.99 and ari >= 0.99 and jac >= 0.99 and w_err <= 1e-5,
                        f"case_{i}: rebuild card vs CPU: super-patch labels ARI {sp_ari:.4f} >= 0.99 "
                        f"({int((row_err > 1e-4).sum())} means apart by more than 1e-4, largest "
                        f"{row_err.max():.2e}), group ARI {ari:.4f} >= 0.99, edge Jaccard {jac:.4f} >= "
                        f"0.99, weights of the other rows' edges {w_err:.2e} <= 1e-5")

    # ---------------------------------------------------------------- 34
    def dense_graph_phase():
        """Main path: build_hypergraph_data at 2048 points on the card (K1)
        against the CPU."""
        from multimodal_fusion_tpu_torch.hypergraph.dense_graph import build_hypergraph_data

        feats, pos, _ = clustered_slide(np.random.default_rng(34), DENSE_N, 1, DIM)
        reset_counts()
        t0 = time.perf_counter()
        card = build_hypergraph_data(feats, pos, threshold_median_ratio=1.0, device=dev)
        wall = time.perf_counter() - t0
        add_main_path_counts()
        s.timed(f"build_hypergraph_data at {DENSE_N} points: {wall * 1e3:.2f} ms, "
                f"{card['edge_index'].shape[1]} edges, K1 launches {similarity_rect.launches}")
        cpu = build_hypergraph_data(feats, pos, threshold_median_ratio=1.0, device="cpu")
        from multimodal_fusion_tpu_torch.ops.similarity import median_offdiag

        # edges as [N, N] masks (row-major order on both sides)
        n = DENSE_N
        on_card = np.zeros((n, n), bool)
        on_card[tuple(card["edge_index"])] = True
        on_cpu = np.zeros((n, n), bool)
        on_cpu[tuple(cpu["edge_index"])] = True
        K_cpu = similarity_rect_plain(*(torch.as_tensor(x) for x in (feats, pos, feats, pos))).numpy()
        thr = float(median_offdiag(torch.as_tensor(K_cpu)))
        differ = on_card != on_cpu
        near = bool((np.abs(K_cpu[differ] - thr) <= 2e-5).all())
        s.check(near and differ.sum() <= 1e-3 * on_cpu.sum(),
                f"dense graph card vs CPU: {int(differ.sum())} of {int(on_cpu.sum())} edges differ, all "
                f"within 2e-5 of the threshold {thr:.6f} (K within 1e-5 of the plain version on each side)")
        wk = np.zeros((n, n), np.float32)
        wk[tuple(card["edge_index"])] = card["edge_attr"]
        wc = np.zeros((n, n), np.float32)
        wc[tuple(cpu["edge_index"])] = cpu["edge_attr"]
        both = on_card & on_cpu
        w_err = float(np.abs(wk[both] - wc[both]).max()) if both.any() else 0.0
        p_err = float(np.abs(card["pooled_feature"] - cpu["pooled_feature"]).max())
        s.check(w_err <= 1e-5 and p_err <= 1e-6,
                f"dense graph weights {w_err:.2e} <= 1e-5, pooled feature {p_err:.2e} <= 1e-6")

    # ------------------------------------------------------- 35-39: the mesh
    from multimodal_fusion_tpu_torch.parallel import dryrun
    from multimodal_fusion_tpu_torch.parallel.mesh import make_mesh
    from multimodal_fusion_tpu_torch.parallel.multihost import launch, run_gang

    world1 = {}  # the NCCL world of 1 in this process, made in phase 35

    def mesh1():
        if "mesh" not in world1:
            world1["mesh"] = make_mesh(1, device="cuda")
            s.log(f"  world of 1: backend {world1['mesh'].backend}, device {world1['mesh'].device}")
        return world1["mesh"]

    def gang(world, calls, timeout=GANG_TIMEOUT):
        """Each rank's results of ``calls`` in a gang of ``world`` ranks on
        this card (gloo), with the gang's wall."""
        torch.cuda.empty_cache()  # the ranks share the card with this process's cache
        t0 = time.perf_counter()
        results, _ = run_gang("multimodal_fusion_tpu_torch.parallel.dryrun:run_calls", world,
                              {"calls": calls, "device": "cuda"}, timeout=timeout, device="cuda")
        wall = time.perf_counter() - t0
        for rank, res in enumerate(results):
            for i, r in enumerate(res):
                if isinstance(r, dict) and "raised" in r:
                    raise RuntimeError(f"rank {rank}, call {i} ({calls[i][0]}): {r}")
        return results, wall

    def add_rank_launches(results, idx, label):
        """A gang call's kernel launches in each rank, added to the main path's."""
        per_rank = [res[idx]["launches"] for res in results]
        for launches in per_rank:
            for name, k in launches.items():
                main_path_launches[name] += k
        s.log(f"  {label}: launches per rank " + "; ".join(
            ", ".join(f"{n} {k}" for n, k in l.items() if k) or "none" for l in per_rank))
        return per_rank

    def same_build(label, got, want):
        """The bars of phases 4, 5 and 28: median, min and max bit for bit,
        mean, std and intra_mean 1e-5 relative."""
        g, w = np.asarray(got["K_stats"]), np.asarray(want["K_stats"])
        exact = bool(np.array_equal(g[2:], w[2:]))
        rel = float(np.max(np.abs(g[:2].astype(np.float64) - w[:2]) / np.abs(w[:2])))
        intra = float(abs(got["intra_mean"] - want["intra_mean"]) / abs(want["intra_mean"]))
        s.check(exact and rel <= 1e-5 and intra <= 1e-5,
                f"{label}: median, min, max bit-equal ({exact}), mean/std {rel:.2e} and "
                f"intra_mean {intra:.2e} <= 1e-5 relative")

    def mesh_build_phase():
        """Phase 4's 8 slides through process_dataset(mesh=) on an NCCL
        world of 1, against the unsharded process_dataset, in turns."""
        from multimodal_fusion_tpu_torch.io.h5io import read_hypergraph_group

        mesh = mesh1()
        with _hdf5_files() as (td, how):
            s.log(f"  {how}")
            roots = {side: td / side for side in ("unsharded", "mesh")}
            for root in roots.values():
                make_clustered_dataset(root, N_FILES, N_PATCHES, N_TMA, DIM, seed=0)
            walls = {side: [] for side in roots}
            out = {}
            # the first collectives set NCCL up: one slide built before the windows
            build.process_arrays(*clustered_slide(np.random.default_rng(1), N_PATCHES, N_TMA, DIM),
                                 **params, save_similarity=False, device=dev, mesh=mesh)
            for side in ("unsharded", "mesh") * 3:
                reset_counts()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                stats, _ = build.process_dataset(
                    roots[side] / "dataset.csv", roots[side], **params, save_similarity=False,
                    pipeline_depth=4, device=dev, mesh=mesh if side == "mesh" else None)
                walls[side].append(time.perf_counter() - t0)
                s.check(not any("error" in st for st in stats), f"{side}: no per-file errors")
                if side == "mesh":
                    launches = similarity_rect.launches
                    add_main_path_counts()
                    s.check(launches == N_FILES, f"K1 launched once a slide under the mesh "
                                                 f"({launches} == {N_FILES}), a [{N_PATCHES}, {N_PATCHES}] stripe")
                out[side] = stats
            for a, b in zip(out["mesh"], out["unsharded"]):
                ga, gb = (a["wsi_aggregation"], b["wsi_aggregation"])
                sa, sb = ga["wsi_similarity_matrix_stats"], gb["wsi_similarity_matrix_stats"]
                same_build(f"{a['case_id']} mesh vs unsharded",
                           {"K_stats": [sa[k] for k in ("mean", "std", "min", "max", "median")],
                            "intra_mean": ga["avg_intra_cluster_similarity"]},
                           {"K_stats": [sb[k] for k in ("mean", "std", "min", "max", "median")],
                            "intra_mean": gb["avg_intra_cluster_similarity"]})
                fa = read_hypergraph_group(roots["mesh"] / a["h5_path"])
                fb = read_hypergraph_group(roots["unsharded"] / b["h5_path"])
                s.check(all(np.array_equal(fa[k], fb[k]) for k in ("edge_index", "group_labels")),
                        f"{a['case_id']}: edges and groups equal")
        pps = {side: N_FILES * N_PATCHES / float(np.median(w)) for side, w in walls.items()}
        s.timed(f"process_dataset, {N_FILES} x {N_PATCHES} patches, medians of 3 windows in "
                f"turns: mesh (NCCL world of 1) {pps['mesh']:.1f} patches/s, unsharded "
                f"{pps['unsharded']:.1f} patches/s (walls {walls})")

    mesh_gang = {}  # phases 36-38's gang: its calls' slices, then its outcome

    def mesh_training_steps():
        """Phase 38's steps: (label, dryrun function, kwargs)."""
        bars = {"loss": 1e-5, "grad": 1e-4, "param": 1e-5}
        exact = flag_config()
        exact.dropout, exact.enable_random_loss = 0.0, False
        mf = dataclasses.replace(exact, model_type="mfmf", dropout=0.0, output_dim=MFMF_DIM,
                                 fusion_blocks_sequence=DEFAULT_FUSION_SEQUENCE)
        mf.extra = dict(exact.extra, attention_num_heads=MFMF_HEADS)
        win = dict(G=MESH_WINDOW, wsi=MESH_WSI, tma=16)
        return [
            ("flagship", "check_survival_step", dict(config=exact, tol=bars, **win)),
            ("flagship, dropout 0.25", "check_survival_step", dict(config=flag_config(), **win)),
            ("MFMF", "check_survival_step", dict(config=mf, tol=bars, **win)),
            ("VAE", "check_vae_step", dict(B=VAE_BATCH, input_dim=DIM, hidden=(512, 256),
                                           latent=128)),
            ("alignment (volume)", "check_alignment_step",
             dict(B=ALIGN_BATCH, markers=list(TMA_MARKERS), feature_dim=DIM, num_layers=2,
                  loss_type="volume", lambda2=0.0)),
        ]

    def shared_gang(phase):
        """Phase ``phase``'s calls' results in each rank of one gang of 2
        ranks on the card (gloo) that runs the calls of phases 36, 37 and
        38 in turn: each rank starts once for the three."""
        if "outcome" not in mesh_gang:
            groups = {
                36: [(f"{DRY}:build_clustered", dict(n_patches=n, slide_seed=seed, n_tma=N_TMA, dim=DIM,
                                                      save_similarity=False, **params), {"data": 2})
                     for n, seed in ((build.FULL_STATS_MAX_N, 5), (BIG_N, 28))],
                37: [(f"{DRY}:check_extraction", dict(compute_dtype=dtype, n_patches=2 * VIT_BATCH,
                                                       patch=256, batch_size=VIT_BATCH), {"data": 2})
                     for dtype in ("float32", "bfloat16")],
                38: [(f"{DRY}:{fn}", kw, {"data": 2}) for _, fn, kw in mesh_training_steps()],
            }
            calls, slices = [], {}
            for p_, group in groups.items():
                slices[p_] = slice(len(calls), len(calls) + len(group))
                calls += group
            try:
                results, wall = gang(2, calls)
            except Exception as exc:
                mesh_gang["outcome"] = exc
                raise
            mesh_gang.update(outcome=results, slices=slices)
            s.timed(f"one gang of 2 ranks on one card for phases 36-38 ({len(calls)} calls): {wall:.1f} "
                    "s wall (process start-up included; an overhead, not a speed-up: the ranks share "
                    "the card)")
        if isinstance(mesh_gang["outcome"], Exception):
            raise RuntimeError("the gang of phases 36-38 failed") from mesh_gang["outcome"]
        return [res[mesh_gang["slices"][phase]] for res in mesh_gang["outcome"]]

    def mesh_large_phase():
        """2 ranks sharing the card (gloo): phase 5's 32768-patch slide in
        full statistics (a [16384, 32768] K1 stripe per rank) and phase 28's
        65536-patch slide in streamed statistics, held to phases 5 and 28."""
        results = shared_gang(36)
        for i, (n, key) in enumerate(((build.FULL_STATS_MAX_N, "p5"), (BIG_N, "p28"))):
            per_rank = add_rank_launches(results, i, f"{n}-patch slide")
            share = n // 2
            want_k1 = [1, 1] if key == "p5" else [-(-share // STRIPE)] * 2
            got_k1 = [l["similarity"] for l in per_rank]
            s.check(got_k1[0] >= want_k1[0] and got_k1[1] >= want_k1[1],
                    f"{n}-patch slide: K1 per rank {got_k1} (stats pass {want_k1} stripes"
                    + (" and the refine sweeps)" if key == "p28" else ")"))
            s.timed(f"{n}-patch slide, 2 ranks: build walls per rank "
                    + ", ".join(f"{r[i]['wall']:.3f} s" for r in results))
            if key in held_builds:
                want = held_builds[key]
                same_build(f"{n}-patch slide, 2 ranks vs phase {key[1:]}", results[0][i]["host"], want)
                s.log(f"  super-patch labels equal to phase {key[1:]}'s: "
                      f"{bool(np.array_equal(results[0][i]['host']['labels'], want['labels']))}")
            else:
                s.check(False, f"phase {key[1:]} left no build to hold the {n}-patch slide to")

    def mesh_extraction_phase():
        """ViT-L/16 extraction with each batch sharded: world 1 (NCCL) and 2
        ranks (gloo), float32 and bfloat16, against the unsharded extractor."""
        kw = dict(n_patches=2 * VIT_BATCH, patch=256, batch_size=VIT_BATCH)
        for dtype in ("float32", "bfloat16"):
            res = dryrun.check_extraction(mesh1(), compute_dtype=dtype, timed_calls=3, **kw)
            main_path_launches["attention"] += res["launches"]
            s.check(res["launches"] == 2 * VIT_DEPTH, f"world 1 {dtype}: K3 {res['launches']} "
                                                      f"launches == {2 * VIT_DEPTH}")
            s.timed(f"extraction {dtype}, world 1: rel L2 {res['rel_l2']:.2e}, least cosine "
                    f"{res['min_cosine']:.6f}; {2 * VIT_BATCH / res['ms'] * 1e3:.1f} patches/s "
                    f"(unsharded {2 * VIT_BATCH / res['unsharded_ms'] * 1e3:.1f})")
        results = shared_gang(37)
        for i, dtype in enumerate(("float32", "bfloat16")):
            per = [r[i] for r in results]
            for r in per:
                main_path_launches["attention"] += r["launches"]
            s.check(all(r["launches"] == 2 * VIT_DEPTH for r in per),
                    f"2 ranks {dtype}: K3 per rank {[r['launches'] for r in per]} == {2 * VIT_DEPTH} "
                    f"({VIT_BATCH // 2} rows of each of 2 batches)")
            s.log(f"  2 ranks {dtype}: rel L2 {[f'{r['rel_l2']:.2e}' for r in per]}, least cosine "
                  f"{[f'{r['min_cosine']:.6f}' for r in per]} (checked in each rank: 1e-5 / 0.999)")

    def mesh_training_phase():
        """One window of each trainer sharded and unsharded: world 1 (NCCL)
        and 2 ranks (gloo); dropout 0 for the equality, the flagship's 0.25
        for the ranks' equality."""
        steps = mesh_training_steps()
        for label, fn, kw in steps:
            res = getattr(dryrun, fn)(mesh1(), timed_steps=5, **kw)
            if "tol" not in kw and fn == "check_survival_step":
                s.check(res["ranks_equal"] and res["finite"], f"{label}: finite loss")
            if "launches" in res:
                for name, k in res["launches"].items():
                    main_path_launches[name] += k
            rate = (MESH_WINDOW if fn == "check_survival_step" else kw["B"])
            s.timed(f"{label}, world 1: loss {res['loss']:.6f}, rel: loss {res['loss_rel']:.2e}, "
                    + (f"grads {res['grad_rel']:.2e}, " if "grad_rel" in res else "")
                    + f"params {res['param_rel']:.2e}; {rate / res['ms'] * 1e3:.1f} "
                    f"{'cases' if fn == 'check_survival_step' else 'samples'}/s (unsharded "
                    f"{rate / res['unsharded_ms'] * 1e3:.1f})"
                    + (f"; launches {res['launches']}" if "launches" in res else ""))
        results = shared_gang(38)
        for i, (label, fn, kw) in enumerate(steps):
            per = [r[i] for r in results]
            if fn == "check_survival_step":
                add_rank_launches(results, i, label)
            s.log(f"  {label}, 2 ranks: rel loss {per[0]['loss_rel']:.2e}, grads "
                  f"{per[0]['grad_rel']:.2e}, params {per[0]['param_rel']:.2e}, ranks equal "
                  f"{per[0]['ranks_equal']} (held in each rank)")
        s.check(all(l["attention"] > 0 and l["attention_bwd"] > 0
                    for l in (r[2]["launches"] for r in results)),
                "MFMF under the mesh: K3 and K4 launched in every rank")

    def gang_phase():
        """parallel/multihost.py's gang of 2 and dryrun_multichip(4) on the
        card, started together: most of each gang's wall is its ranks'
        start-up, and each checks its own ranks."""
        from concurrent.futures import ThreadPoolExecutor

        def walled(fn, *args, **kwargs):
            t0 = time.perf_counter()
            return fn(*args, **kwargs), time.perf_counter() - t0

        torch.cuda.empty_cache()
        with ThreadPoolExecutor(max_workers=2) as ex:
            gang2 = ex.submit(walled, launch, 2, timeout=GANG_TIMEOUT, device="cuda")
            dry4 = ex.submit(walled, dryrun.dryrun_multichip, 4, timeout=GANG_TIMEOUT, device="cuda")
            (out, wall2), (text, wall4) = gang2.result(), dry4.result()
        ok = [line for line in out.splitlines() if line.startswith("multihost OK")]
        s.check(len(ok) == 2, f"multihost gang of 2: {len(ok)} OK lines ({wall2:.1f} s wall)")
        for line in ok:
            s.log(f"  {line}")
        s.check(text.count("dryrun_multichip(4): ") == 4 and "mesh {'replica': 2, 'data': 2}" in text,
                f"dryrun_multichip(4): 4 OK lines ({wall4:.1f} s wall, beside the gang of 2)")

    # ---------------------------------------------------------------- 40
    exported = {}  # the artifacts' directory, read by phases 41-42

    def padded_window(raws, channels, wsi, tma):
        """Numpy channels and masks of ``raws`` in an artifact's layout: bags
        padded to ``wsi`` / ``tma`` patches with their masks, tabular groups
        [B, 1, dim]."""
        chans, masks = {}, {}
        for ch in channels:
            if ch.startswith(("wsi=", "tma=")):
                n = wsi if ch.startswith("wsi") else tma
                chans[ch] = np.zeros((len(raws), n, DIM), np.float32)
                masks[ch] = np.zeros((len(raws), n), bool)
                for i, r in enumerate(raws):
                    chans[ch][i, :len(r[ch])] = r[ch]
                    masks[ch][i, :len(r[ch])] = True
            else:
                chans[ch] = np.stack([r[ch] for r in raws])
        return chans, masks

    def on_card(tree):
        return {k: torch.as_tensor(v, device=dev) for k, v in tree.items()}

    def live_outputs(model, chans, masks):
        """(probabilities, risk) of ``model``'s eval forward on the card, as
        a serving artifact computes them."""
        n = len(next(iter(chans.values())))
        with torch.no_grad():
            res = model({"channels": on_card(chans), "masks": on_card(masks)},
                        torch.zeros(n, dtype=torch.int64, device=dev), train=False)
        risk = res["risk"] if "risk" in res else res["logits"][:, 1]
        return res["probabilities"].cpu().numpy(), risk.cpu().numpy()

    def in_turns(label, unit, per_call, runs, windows=5, calls=4):
        """Each of ``runs`` (name -> a call on tensors held on the card) over
        ``windows`` windows of ``calls`` calls, the runs in turns window by
        window; prints each one's median rate in ``unit``/s."""
        walls = {name: [] for name in runs}
        with torch.no_grad():
            for fn in runs.values():
                fn()
            for _ in range(windows):
                for name, fn in runs.items():
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    for _ in range(calls):
                        fn()
                    torch.cuda.synchronize()
                    walls[name].append(time.perf_counter() - t0)
        for name, w in walls.items():
            rates = sorted(calls * per_call / x for x in w)
            s.timed(f"{label}, {name}: median {calls * per_call / float(np.median(w)):.1f} {unit}/s "
                    f"over {windows} windows of {calls} calls (min {rates[0]:.1f}, max {rates[-1]:.1f})")

    def export_phase():
        """Main path: the flagship's serving artifact, exported from fold 0
        of phase 16's results dir at bench.py's inference cell for the CPU
        and the card, against evaluate_fold and the live model; then MFMF's
        from phase 12's trained fold."""
        from multimodal_fusion_tpu_torch.utils import export

        reset_counts()
        raws, labels = mfmf_raw_cases()
        rd = flag["dir"] / "serve"
        td = exported["dir"] = Path(tempfile.mkdtemp(prefix="export_"))
        t0 = time.perf_counter()
        programs, meta = export.export_serving_fn(rd, fold=0, wsi_patches=INF_WSI, tma_patches=INF_TMA)
        wall = time.perf_counter() - t0
        out = export.write_serving_artifact(td / "flagship", programs, meta)
        sizes = {p: export.program_path(out, p).stat().st_size for p in meta["platforms"]}
        s.check(meta["batch"] == "symbolic" and meta["platforms"] == ["cpu", "cuda"],
                f"export_serving_fn: batch {meta['batch']!r} (symbolic), platforms {meta['platforms']}")
        s.timed(f"export_serving_fn, {len(meta['channels'])} channels at {INF_WSI} WSI x {INF_TMA} TMA "
                f"patches x {DIM}, both platforms: {wall:.2f} s wall; artifact bytes "
                + ", ".join(f"{p} {n}" for p, n in sizes.items()))
        art = export.load_serving_artifact(out)
        cpu_art = export.load_serving_artifact(out, device="cpu")
        live = ModelFactory.create_model(flag_config(), device=dev)
        load_model(rd / "s_0_checkpoint.npz", live)
        live.eval()
        want = flag.get("fold_0_eval")  # phase 16's evaluate_fold of fold 0 over the 160 cases
        if want is None:
            tr = SurvivalTrainer(Configs(flag["ec"], flag_config()), rd, device=dev)
            want = tr.evaluate_fold(_CaseTable(raws, labels), FoldSplit(empty_idx, empty_idx,
                                                                         np.arange(MFMF_CASES)), 0)
        want_p, want_r = np.asarray(want["probs"]), np.asarray(want["risk"]).reshape(-1)
        for size in (8, 64):
            got_p, got_r, live_p, live_r = [], [], [], []
            for s0 in range(0, MFMF_CASES, size):
                chans, masks = padded_window(raws[s0:s0 + size], meta["channels"], INF_WSI, INF_TMA)
                p, r = art.call(chans, masks)
                lp, lr = live_outputs(live, chans, masks)
                got_p.append(p), got_r.append(r), live_p.append(lp), live_r.append(lr)
            got_p, got_r = np.concatenate(got_p), np.concatenate(got_r)
            e_live = max(np.abs(got_p - np.concatenate(live_p)).max(),
                         np.abs(got_r - np.concatenate(live_r)).max())
            e_eval = max(np.abs(got_p - want_p).max(), np.abs(got_r - want_r).max())
            s.check(got_p.shape == (MFMF_CASES, 2) and e_live <= 1e-5 and e_eval <= 1e-5,
                    f"artifact on the card, windows of {size}: probabilities and risk of {MFMF_CASES} "
                    f"cases within {e_live:.2e} of the live model on the same padded windows and "
                    f"{e_eval:.2e} of evaluate_fold (<= 1e-5; |risk| up to {np.abs(want_r).max():.2f})")
        chans, masks = padded_window(raws[:8], meta["channels"], INF_WSI, INF_TMA)
        t0 = time.perf_counter()
        cp, cr = cpu_art.call(chans, masks)
        cpu_wall = time.perf_counter() - t0
        gp, gr = art.call(chans, masks)
        e_cpu = max(np.abs(cp - gp).max(), np.abs(cr - gr).max())
        s.check(e_cpu <= 1e-4, f"the CPU program vs the card's on 8 cases: {e_cpu:.2e} <= 1e-4 "
                               f"({cpu_wall:.1f} s on the host)")

        chans, masks = padded_window(raws[:64], meta["channels"], INF_WSI, INF_TMA)
        c, m = on_card(chans), on_card(masks)
        zero = torch.zeros(64, dtype=torch.int64, device=dev)
        in_turns("flagship, 64-case windows on the card", "cases", 64,
                 {"artifact program": lambda: art.module(c, m),
                  "live eval forward": lambda: live({"channels": c, "masks": m}, zero, train=False)})
        t0 = time.perf_counter()
        for _ in range(3):
            art.call(chans, masks)
        s.timed(f"ServingArtifact.call on 64-case numpy windows (upload and fetch included): "
                f"{3 * 64 / (time.perf_counter() - t0):.1f} cases/s over 3 calls")
        no_kernel_launches("phase 40, the flagship's artifact")

        mrd = mfmf["dir"] / "device_data_True"  # phase 12's trained fold 0
        Configs(mfmf["ec"], mfmf["mc"]).save(mrd / "configs_mfmf_config0.json")
        t0 = time.perf_counter()
        programs, mmeta = export.export_serving_fn(mrd, fold=0, wsi_patches=INF_WSI, tma_patches=INF_TMA)
        s.timed(f"export_serving_fn, MFMF (attention forced to the plain formulation), both "
                f"platforms: {time.perf_counter() - t0:.2f} s wall")
        mart = export.load_serving_artifact(export.write_serving_artifact(td / "mfmf", programs, mmeta))
        mlive = ModelFactory.create_model(mfmf["mc"], device=dev)
        load_model(mrd / "s_0_checkpoint.npz", mlive)
        mlive.eval()
        chans, masks = padded_window(raws[:16], mmeta["channels"], INF_WSI, INF_TMA)
        reset_counts()
        p, r = mart.call(chans, masks)
        k3 = attention_fwd.launches
        lp, lr = live_outputs(mlive, chans, masks)
        routes = {k: v for k, v in attention_fwd.route_launches.items() if v}
        s.check(mmeta["batch"] == "symbolic" and k3 == 0 and attention_fwd.launches == 3,
                f"MFMF artifact: batch {mmeta['batch']!r}, K3 launched {k3} times in its call; the "
                f"live model's eval forward {attention_fwd.launches} times ({routes})")
        err = max(np.abs(p - lp).max(), np.abs(r - lr).max())
        s.check(err <= 1e-4, f"MFMF artifact vs the live model (K3's narrow routes) on 16 cases: "
                             f"{err:.2e} <= 1e-4")

    # ---------------------------------------------------------------- 41
    def pretrained_export_phase():
        """Main path: the alignment model's artifact from phase 25's
        checkpoint and the VAE's from phase 26's, against the live models."""
        from multimodal_fusion_tpu_torch.utils import export

        reset_counts()
        td = exported["dir"]
        t0 = time.perf_counter()
        programs, meta = export.export_alignment_fn(pre["ckpt"])
        wall = time.perf_counter() - t0
        art = export.load_serving_artifact(export.write_serving_artifact(td / "alignment", programs, meta))
        s.check(meta["batch"] == "symbolic" and meta["markers"] == sorted(TMA_MARKERS)
                and (meta["num_layers"], meta["feature_dim"]) == (2, DIM),
                f"export_alignment_fn ({wall:.2f} s): batch {meta['batch']!r}, {len(meta['markers'])} "
                f"markers x {meta['feature_dim']}, {meta['num_layers']} layers")
        live = MultiModalAlignmentModel(meta["markers"], feature_dim=DIM, num_layers=2,
                                        generator=torch.Generator(device=dev).manual_seed(0))
        load_model(pre["ckpt"], live)
        live.eval()
        rng = np.random.default_rng(41)
        feats = {mk: rng.standard_normal((ALIGN_BATCH, DIM), dtype=np.float32) for mk in meta["markers"]}
        got = art(feats)
        cf = on_card(feats)
        with torch.no_grad():
            want = {mk: t.cpu().numpy() for mk, t in live(cf).items()}
        err = max(np.abs(got[mk] - want[mk]).max() for mk in want)
        s.check(err <= 1e-5, f"alignment artifact vs the live model, {ALIGN_BATCH} samples x "
                             f"{len(want)} markers: {err:.2e} <= 1e-5")
        in_turns(f"alignment apply pass, batches of {ALIGN_BATCH}", "samples", ALIGN_BATCH,
                 {"artifact program": lambda: art.module(cf), "live model": lambda: live(cf)},
                 calls=10)

        ckpt = vae_run["dir"] / "ckpt" / "best.npz"
        t0 = time.perf_counter()
        programs, meta = export.export_vae_fn(ckpt)
        wall = time.perf_counter() - t0
        art = export.load_serving_artifact(export.write_serving_artifact(td / "vae", programs, meta))
        s.check(meta["batch"] == "symbolic" and (meta["input_dim"], meta["encoder_hidden"],
                                                 meta["latent_dim"]) == (DIM, [512, 256], 128),
                f"export_vae_fn ({wall:.2f} s): batch {meta['batch']!r}, {meta['input_dim']} -> "
                f"{meta['encoder_hidden']} -> {meta['latent_dim']}")
        vae = VAE(input_dim=meta["input_dim"], encoder_hidden=meta["encoder_hidden"],
                  decoder_hidden=meta["decoder_hidden"], latent_dim=meta["latent_dim"],
                  generator=torch.Generator(device=dev).manual_seed(0))
        restored, _ = load_state(ckpt, {"model": vae.state_dict()})
        vae.load_state_dict(restored["model"])
        vae.eval()
        x = np.concatenate([r["wsi=features"] for r in mfmf_raw_cases()[0][:2]])[:4 * VAE_BATCH]
        got = art(x)
        xc = torch.as_tensor(x, device=dev)
        with torch.no_grad():
            mu = vae.encode(xc)
            want = (vae.decode(mu).cpu().numpy(), mu.cpu().numpy())
        err = max(np.abs(g - w).max() for g, w in zip(got, want))
        s.check(err <= 1e-5, f"VAE artifact vs the live model (mean-latent reconstruction), {len(x)} "
                             f"patches: x_hat and mu within {err:.2e} <= 1e-5")
        in_turns(f"VAE reconstruction, batches of {len(x)} patches", "patches", len(x),
                 {"artifact program": lambda: art.module(xc),
                  "live model": lambda: vae.decode(vae.encode(xc))}, calls=10)
        no_kernel_launches("phase 41")

    # ---------------------------------------------------------------- 42
    def import_robust_phase():
        """Main path: phase 16's five folds saved as reference .pt
        checkpoints and converted back by import_results_dir, predict over
        both dirs; the robustness sweep over a detach results dir."""
        from multimodal_fusion_tpu_torch.cli.import_torch_results import import_results_dir
        from multimodal_fusion_tpu_torch.data.splits import save_fold_split
        from multimodal_fusion_tpu_torch.utils.robust import robustness_sweep

        reset_counts()
        raws, labels = mfmf_raw_cases()
        rd, td = flag["dir"] / "serve", exported["dir"]
        ref = td / "reference"
        ref.mkdir()
        cfg = next(rd.glob("configs_*.json"))
        shutil.copy(cfg, ref / cfg.name)
        for fold in range(SERVE_FOLDS):
            sd = {k: t.cpu() for k, t in load_state(rd / f"s_{fold}_checkpoint.npz", {
                "params": ModelFactory.create_model(flag_config(), device=dev).state_dict()})[0][
                "params"].items()}
            if fold % 2:  # as the reference's VAE / alignment trainers save, compiled
                sd = {"model_state_dict": {f"_orig_mod.{k}": t for k, t in sd.items()}}
            torch.save(sd, ref / f"s_{fold}_checkpoint.pt")
        t0 = time.perf_counter()
        res = import_results_dir(ref, td / "converted", device=dev)
        s.check(res["folds"] == list(range(SERVE_FOLDS)) and res["unmapped_keys"] == {},
                f"import_results_dir: folds {res['folds']} (plain and wrapped, _orig_mod.-prefixed "
                f".pt files), no unused keys; {time.perf_counter() - t0:.2f} s")

        rows = case_rows(labels)
        by_path = {r["h5_file_path"]: raw for r, raw in zip(rows, raws)}
        csv_path, request = td / "cases.csv", td / "request.csv"
        write_csv(csv_path, rows)
        write_csv(request, rows[:64])
        original = results_io.build_dataset
        results_io.build_dataset = lambda configs, csv_path, data_root_dir, align=None, **_: _CsvCases(
            csv_path, by_path)
        try:
            want = predict(rd, request, rd, output_path=td / "original", device=dev)["cases"]
            got = predict(td / "converted", request, td, output_path=td / "converted_pred",
                          device=dev)["cases"]
            cols = ["risk", "prob_0", "prob_1"] + [f"fold_{f}_prob_1" for f in range(SERVE_FOLDS)]
            same = [(g["case_id"], g["prediction"]) for g in got] == [
                (w["case_id"], w["prediction"]) for w in want]
            err = max(abs(float(g[c]) - float(w[c])) for g, w in zip(got, want) for c in cols)
            s.check(same and len(got) == 64 and err <= 1e-6,
                    f"predict over the converted dir vs the original, {len(got)} cases x "
                    f"{SERVE_FOLDS} folds: max abs diff {err:.2e} <= 1e-6")

            det = flag_config("svd_gate_random_clam_detach")
            rrd = td / "robust"
            rrd.mkdir()
            Configs(flag["ec"], det).save(rrd / f"configs_{flag['ec'].exp_name}.json")
            ds = _CsvCases(csv_path, by_path)
            splits = create_k_fold_splits(ds.labels, SERVE_FOLDS, flag["ec"].seed)
            for fold in (0, 1):
                save_model(rrd / f"s_{fold}_checkpoint.npz",
                           ModelFactory.create_model(det, seed=200 + fold, device=dev))
                save_fold_split(splits[fold], ds.case_ids, rrd / f"splits_{fold}.csv")
            drops = (0.0, 0.1, 0.2, 0.3, 0.4, 0.5)
            t0 = time.perf_counter()
            sweep = robustness_sweep(rrd, csv_path, rrd, drop_probs=drops, device=dev)
            wall = time.perf_counter() - t0
        finally:
            results_io.build_dataset = original
        s.check(len(sweep) == 2 * len(drops) and (rrd / "robustness.csv").exists()
                and (rrd / "robustness.json").exists(),
                f"robustness_sweep: {len(sweep)} rows (2 folds x {len(drops)} drop_probs), "
                "robustness.csv and .json written")
        s.timed(f"robustness_sweep over 2 folds x {len(drops)} drop_probs at the flagship's width "
                f"({len(splits[0].test_idx)} test cases a fold): {wall:.2f} s wall")
        tr = SurvivalTrainer(Configs(flag["ec"], det), rrd, device=dev)
        for fold in (0, 1):
            row = next(r for r in sweep if r["fold"] == fold and r["drop_prob"] == 0.0)
            ev = tr.evaluate_fold(ds, splits[fold], fold)
            s.check((row["auc"], row["acc"], row["loss"]) == (ev["auc"], ev["acc"], ev["loss"]),
                    f"fold {fold}, drop_prob 0: auc {row['auc']!r}, acc {row['acc']!r}, loss "
                    f"{row['loss']!r} equal evaluate_fold's")
        s.log("  sweep: " + "; ".join(f"fold {r['fold']} p {r['drop_prob']}: auc {r['auc']:.4f} "
                                      f"loss {r['loss']:.4f}" for r in sweep))
        no_kernel_launches("phase 42")

    # ---------------------------------------------------------------- 43
    def mfu_phase():
        """utils/mfu.measure_device on the card: the flagship's eval forward
        at phase 15's batch in float32 and bf16, ViT-L/16 bf16 at a batch of
        32 (the counter sees its dense layers, not K3), and K1 at
        [4096, 4096, 1024] with its analytic operations and bytes."""
        from multimodal_fusion_tpu_torch.utils.mfu import measure_device

        chans = ["wsi=features", "tma=cd3=features", "clinical=val", "clinical=mask"]
        mc = ModelConfig(model_type="svd_gate_random_clam", n_classes=2, input_dim=DIM,
                         model_size="64*32", dropout=0.25, output_dim=128,
                         channels_used_in_model=chans, channel_input_dims={"clinical=val": 16})
        rng = np.random.default_rng(0)
        shapes = {"wsi=features": (INF_BATCH, INF_WSI, DIM), "tma=cd3=features": (INF_BATCH, INF_TMA, DIM),
                  "clinical=val": (INF_BATCH, 1, 16)}
        channels = {k: torch.as_tensor(rng.standard_normal(v, dtype=np.float32), device=dev)
                    for k, v in shapes.items()}
        channels["clinical=mask"] = torch.ones((INF_BATCH, 1, 16), device=dev)
        masks = {"wsi=features": torch.ones((INF_BATCH, INF_WSI), dtype=torch.bool, device=dev),
                 "tma=cd3=features": torch.ones((INF_BATCH, INF_TMA), dtype=torch.bool, device=dev)}
        label = torch.zeros(INF_BATCH, dtype=torch.int64, device=dev)
        model = ModelFactory.create_model(mc, seed=0, device=dev).eval()
        model16 = copy.deepcopy(model).to(torch.bfloat16)
        ch16 = {k: v.to(torch.bfloat16) for k, v in channels.items()}

        def forward(m, chans_):
            with torch.no_grad():
                return m({"channels": chans_, "masks": masks}, label, train=False)

        vit_model = vit_large_16(torch.Generator(device=dev).manual_seed(SEED)).to(torch.bfloat16).eval()
        images = torch.randn((VIT_BATCH, 224, 224, 3), device=dev, dtype=torch.bfloat16)

        def vit_forward(x):
            with torch.no_grad():
                return vit_model(x)

        feats, pos, _ = clustered_slide(np.random.default_rng(0), N_PATCHES, N_TMA, DIM)
        f, p = torch.as_tensor(feats, device=dev), torch.as_tensor(pos, device=dev)
        ops, nbytes = _similarity_work(N_PATCHES, N_PATCHES, DIM, p.shape[1], 4)
        cases = {
            f"flagship eval forward, float32, {INF_BATCH} x {INF_WSI} WSI": measure_device(
                forward, (model, channels), iters=20, dtype="float32", work_items=INF_BATCH),
            f"flagship eval forward, bf16, {INF_BATCH} x {INF_WSI} WSI": measure_device(
                forward, (model16, ch16), iters=20, dtype="bfloat16", work_items=INF_BATCH),
            f"ViT-L/16 bf16, {VIT_BATCH} images (dense layers counted, K3 not)": measure_device(
                vit_forward, (images,), iters=5, dtype="bfloat16", work_items=VIT_BATCH),
            f"K1 [{N_PATCHES}, {N_PATCHES}, {DIM}] (analytic operations and bytes)": measure_device(
                lambda a, b: similarity_rect(a, b, a, b, 1.0, 1.0, False), (f, p), iters=20,
                flops_override=ops, bytes_override=nbytes),
        }
        for label_, rep in cases.items():
            s.timed(f"{label_}: {1e3 * rep['sec_per_call']:.4f} ms a call, "
                    f"{rep['achieved_tflops']:.3f} TFLOP/s of {rep['flops_per_call']:.6g} FLOPs, mfu "
                    f"{rep['mfu']:.4f} of {rep['peak_tflops']:.0f} TFLOP/s ({rep['mxu_dtype']}), "
                    f"fraction_of_roofline {rep['fraction_of_roofline']:.4f} ({rep['bound']}-bound, "
                    f"bytes {rep['bytes_model']}), low_snr {rep['low_snr']}")
            s.check(rep["flops_per_call"] and 0 < rep["mfu"] <= 1 and not rep.get("suspect_roofline"),
                    f"{label_}: 0 < mfu {rep['mfu']:.4f} <= 1, no suspect_roofline")
        s.check(cases[next(iter(cases))]["device_kind"] == torch.cuda.get_device_name(0).lower(),
                f"measure_device's device_kind {cases[next(iter(cases))]['device_kind']!r}")

    # ---------------------------------------------------------------- 44
    def mfmf_config1_phase():
        """mfmf_config1's fusion order at full width through ``train_fold``
        (K3 and K4 on their general routes for blocks 2 and 3, narrow_k for
        block 1), its training rate on the device tables, one 16-case window
        card vs CPU at phase 12's bars, a profile of one window; then one
        ``train_fold`` of mfmf_config2 (narrow_q blocks only)."""
        from torch.profiler import ProfilerActivity, profile

        raws, labels = mfmf_raw_cases()
        ds = _CaseTable(raws, labels)
        mc, ec = mfmf_configs(MFMF_CONFIG1, "mfmf_config1")
        split = create_k_fold_splits(ds.labels, MFMF_FOLDS, ec.seed)[0]
        sizes = (len(split.train_idx), len(split.val_idx), len(split.test_idx))
        n_train = MFMF_EPOCHS * -(-sizes[0] // MFMF_BATCH)
        n_eval = (MFMF_EPOCHS + 1) * -(-sizes[1] // 16) + -(-sizes[2] // 16)
        td = Path(tempfile.mkdtemp(prefix="mfmf1_"))
        try:
            tr = SurvivalTrainer(Configs(ec, mc), td / "config1", device=dev)
            reset_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            summary = tr.train_fold(ds, split, 0)
            wall = time.perf_counter() - t0
            add_main_path_counts()
            s.timed(f"mfmf_config1 train_fold: {MFMF_EPOCHS} epochs of {sizes[0]} cases + evaluation "
                    f"in {wall:.2f} s")
            # blocks 2 and 3 (512 result tokens against 4096 WSI, 4096
            # reconstructed against 512) general, block 1 (512 TMA tokens
            # against 5 tabular) narrow_k
            want_fwd = {"general": 2 * (n_train + n_eval), "narrow_q": 0, "narrow_k": n_train + n_eval}
            want_bwd = {"general": 2 * n_train, "narrow_q": 0, "narrow_k": n_train}
            s.check(attention_fwd.route_launches == want_fwd and attention_bwd.route_launches == want_bwd,
                    f"mfmf_config1: routes K3 {attention_fwd.route_launches}, K4 "
                    f"{attention_bwd.route_launches} (want {want_fwd}, {want_bwd}: K4 general twice a "
                    f"train window, {n_train} windows)")
            hist = summary["history"]
            probs = [p_["prob"] for p_ in json.loads((td / "config1" / "fold_0_summary.json").read_text())
                     ["patient_results"].values()]
            s.check(all(np.isfinite([h_["train_loss"], h_["val_loss"]]).all() for h_ in hist)
                    and np.isfinite(probs).all() and np.asarray(probs).shape == (sizes[2], 2),
                    f"mfmf_config1: losses finite, {len(probs)} test probabilities finite")
            s.log("  history: " + "; ".join(
                f"epoch {h_['epoch']}: train {h_['train_loss']:.6f} val {h_['val_loss']:.6f} "
                f"auc {h_['val_auc']:.4f}" for h_ in hist))

            # the device path's rate: 64-case windows (row gather + the
            # trainer's step) after a warm-up
            all_idx = np.concatenate([split.train_idx, split.val_idx, split.test_idx]).astype(np.int64)
            tables, row_of = tr._device_tables(ds, all_idx)
            rows = torch.as_tensor([row_of[int(i)] for i in split.train_idx], dtype=torch.int64)
            model = tr._build_model(0)
            opt = make_optimizer(ec.optimizer, ec.weight_decay, model.parameters(), ec.lr)
            gen = torch.Generator(device=dev).manual_seed(0)

            def device_window(i):
                idx = rows[(i % 2) * MFMF_BATCH:(i % 2 + 1) * MFMF_BATCH].to(dev)
                return tr._train_step(model, opt, tr._gather_window(tables, idx), gen)

            device_window(0)
            torch.cuda.synchronize()
            walls = []
            for i in range(MFMF_TIMED_WINDOWS):
                t0 = time.perf_counter()
                device_window(i + 1)
                torch.cuda.synchronize()
                walls.append(time.perf_counter() - t0)
            rates = sorted(MFMF_BATCH / w for w in walls)
            s.log("  window walls (s): " + ", ".join(f"{w:.4f}" for w in walls))
            s.timed(f"mfmf_config1 training, device path: median {MFMF_BATCH / float(np.median(walls)):.1f} "
                    f"cases/s over {MFMF_TIMED_WINDOWS} windows of {MFMF_BATCH} (min {rates[0]:.1f}, "
                    f"max {rates[-1]:.1f}; median window {1e3 * float(np.median(walls)):.2f} ms)")

            # one window's device time by kernel
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                device_window(1)
                torch.cuda.synchronize()
                wall_ms = (time.perf_counter() - t0) * 1e3
            events = _device_events(prof)
            if events:
                busy_ms = sum(us for _, us in events) / 1e3
                k3_ms = sum(us for e, us in events if "attn_" in e.key and "attn_bwd" not in e.key) / 1e3
                k4_ms = sum(us for e, us in events if "attn_bwd" in e.key) / 1e3
                s.timed(f"one mfmf_config1 {MFMF_BATCH}-case training window under torch.profiler: wall "
                        f"{wall_ms:.2f} ms, device busy {busy_ms:.2f} ms, K3 {k3_ms:.3f} ms, K4 {k4_ms:.3f} "
                        f"ms ({100 * (k3_ms + k4_ms) / busy_ms:.1f}% of device time), "
                        f"{sum(e.count for e, _ in events)} device ops")
                for e, us in sorted(events, key=lambda x: x[1], reverse=True)[:8]:
                    s.timed(f"  {us / 1e3:8.3f} ms  x{e.count:<5d} {e.key[:90]}")
            else:
                s.log("  profiler saw no device time: the window's kernels not measured")

            # one 16-case window's gradients on the card against a CPU run of
            # the port from the same weights and window (phase 12's bars)
            window = tr._gather_window(tables, rows[:16].to(dev))
            card = tr._build_model(0)
            host = ModelFactory.create_model(mc, device="cpu")
            host.load_state_dict({k: t_.cpu() for k, t_ in card.state_dict().items()})
            cpu_tr = SurvivalTrainer(Configs(ec, mc), td / "cpu", device="cpu")
            cpu_window = {"channels": {k: t_.cpu() for k, t_ in window["channels"].items()},
                          "masks": {k: t_.cpu() for k, t_ in window["masks"].items()},
                          "label": window["label"].cpu()}
            loss_card = float(tr._train_step(card, torch.optim.SGD(card.parameters(), lr=0.0), window,
                                             torch.Generator(device=dev)))
            t0 = time.perf_counter()
            loss_cpu = float(cpu_tr._train_step(host, torch.optim.SGD(host.parameters(), lr=0.0),
                                                cpu_window, torch.Generator()))
            s.log(f"  CPU run of one 16-case window: {time.perf_counter() - t0:.1f} s (host)")
            cpu_grads = {n: p_.grad for n, p_ in host.named_parameters()}
            errs = {}
            for n, p_ in card.named_parameters():  # k_proj biases as in phase 12
                scale = cpu_grads[n.replace("k_proj.bias", "k_proj.weight")].norm()
                errs[n] = float((p_.grad.cpu() - cpu_grads[n]).norm() / scale.clamp_min(1e-30))
            worst = max(errs, key=errs.get)
            s.log("  largest gradient errors: " + ", ".join(
                f"{n} {errs[n]:.2e}" for n in sorted(errs, key=errs.get, reverse=True)[:4]))
            s.check(errs[worst] <= 1e-4, f"mfmf_config1, one 16-case window's gradients, card vs CPU: "
                                         f"worst relative L2 {errs[worst]:.2e} <= 1e-4 over {len(errs)} "
                                         f"tensors ({worst})")
            rel = abs(loss_card - loss_cpu) / abs(loss_cpu)
            s.check(rel <= 1e-5, f"mfmf_config1, one 16-case window's loss, card {loss_card!r} vs CPU "
                                 f"{loss_cpu!r}: relative {rel:.2e} <= 1e-5")
            del host, cpu_window, cpu_grads, card, model, opt, tables

            # mfmf_config2: every block has the 5 tabular tokens on its q side
            mc2, ec2 = mfmf_configs(MFMF_CONFIG2, "mfmf_config2")
            tr2 = SurvivalTrainer(Configs(ec2, mc2), td / "config2", device=dev)
            reset_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            summary2 = tr2.train_fold(ds, split, 0)
            wall = time.perf_counter() - t0
            add_main_path_counts()
            want_fwd = {"general": 0, "narrow_q": 3 * (n_train + n_eval), "narrow_k": 0}
            want_bwd = {"general": 0, "narrow_q": 3 * n_train, "narrow_k": 0}
            s.check(attention_fwd.route_launches == want_fwd and attention_bwd.route_launches == want_bwd,
                    f"mfmf_config2 train_fold ({wall:.2f} s): routes K3 {attention_fwd.route_launches}, "
                    f"K4 {attention_bwd.route_launches} (want {want_fwd}, {want_bwd})")
            s.check(all(np.isfinite([h_["train_loss"], h_["val_loss"]]).all() for h_ in summary2["history"]),
                    "mfmf_config2: losses finite")
        finally:
            shutil.rmtree(td, ignore_errors=True)

    # ---------------------------------------------------------------- 45
    def keep_logits(tr):
        """Wrap ``tr._eval_summary`` to keep the evaluated cases' logits."""
        kept = {}
        plain = tr._eval_summary

        def summary(dataset, outs, *args, **kwargs):
            kept["logits"] = torch.cat([o[0] for o in outs]).float().cpu().numpy()
            return plain(dataset, outs, *args, **kwargs)

        tr._eval_summary = summary
        return kept

    def matrix_phase():
        """Main path: six of the experiment matrix's smoke representatives
        (tests/test_experiment_matrix.py's SMOKE, phase 19 runs the
        seventh) through ``cli.main_survival.run`` at the matrix's own
        widths over fold 9 of 10 of phase 12's cases, 1 epoch each; the
        fold-9 checkpoint evaluated on the CPU against the card; then the
        demo's models on the card against the CPU."""
        import importlib.util

        from multimodal_fusion_tpu_torch.demo import example_usage as demo

        spec = importlib.util.spec_from_file_location("exp_matrix", ROOT / "experiments" / "matrix.py")
        matrix = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(matrix)
        raws, labels = mfmf_raw_cases()
        ds = _CaseTable(raws, labels)
        td = Path(tempfile.mkdtemp(prefix="matrix_"))
        fold9 = create_k_fold_splits(ds.labels, 10, 5678)[9]
        sizes = (len(fold9.train_idx), len(fold9.val_idx), len(fold9.test_idx))
        n_train = -(-sizes[0] // MFMF_BATCH)
        n_eval = 2 * -(-sizes[1] // 16) + -(-sizes[2] // 16)
        test_only = FoldSplit(empty_idx, empty_idx, fold9.test_idx)
        try:
            for name in MATRIX_RUNS:
                exp_code = name.rsplit("/", 1)[-1]
                argv = [str(a) for a in matrix.build_argv(name, "cases.csv", td, td / exp_code)]
                args = cli_main.parse_args(argv + ["--start_k_fold", "9", "--max_epochs", "1", "--tpu_opts",
                                                   '{"device_data": true}', "--device", "cuda"])
                reset_counts()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out_dir = cli_main.run(args, ds)
                wall = time.perf_counter() - t0
                add_main_path_counts()
                if args.model_type == "mfmf":
                    want_fwd = {"general": 2 * (n_train + n_eval), "narrow_q": 0, "narrow_k": n_train + n_eval}
                    want_bwd = {"general": 2 * n_train, "narrow_q": 0, "narrow_k": n_train}
                    s.check(attention_fwd.route_launches == want_fwd
                            and attention_bwd.route_launches == want_bwd,
                            f"{exp_code}: routes K3 {attention_fwd.route_launches}, K4 "
                            f"{attention_bwd.route_launches} (want {want_fwd}, {want_bwd}: K3 general "
                            f"twice a window, K4 general twice a train window, {n_train} train windows)")
                else:
                    no_kernel_launches(f"phase 45, {exp_code}")
                names = {p_.name for p_ in out_dir.iterdir()}
                want_files = {f"configs_{exp_code}.json", "splits_9.csv", "s_9_checkpoint.npz",
                              "fold_9_epochs.csv", "fold_9_summary.json", "summary.csv",
                              "detailed_results_for_plotting.json"}
                s.check(want_files <= names, f"{exp_code} (model_type {args.model_type}, "
                                             f"{len(args.target_channels)} channels): "
                                             f"{sorted(want_files - names) or 'all'} result files written")
                fold = json.loads((out_dir / "fold_9_summary.json").read_text())
                s.check(all(np.isfinite([h_["train_loss"], h_["val_loss"]]).all() for h_ in fold["history"]),
                        f"{exp_code}: losses finite ({len(fold['history'])} epoch): " + "; ".join(
                            f"train {h_['train_loss']:.6f} val {h_['val_loss']:.6f}" for h_ in fold["history"]))
                s.timed(f"{exp_code}: cli.main_survival.run over fold 9 of 10 ({sizes[0]} train, {sizes[1]} "
                        f"val, {sizes[2]} test cases), 1 epoch and evaluation, its device tables included: "
                        f"{wall:.2f} s, {sum(sizes) / wall:.1f} cases/s (the fold's {sum(sizes)} cases over "
                        "the wall)")

                # the fold-9 checkpoint on the card and on the CPU over the test split
                configs = Configs.load(out_dir / f"configs_{exp_code}.json")
                card_tr, cpu_tr = (SurvivalTrainer(configs, out_dir, device=d) for d in (dev, "cpu"))
                card_kept, cpu_kept = keep_logits(card_tr), keep_logits(cpu_tr)
                reset_counts()  # launches of the comparison are not the main path's
                card = card_tr.evaluate_fold(ds, test_only, 9)
                t0 = time.perf_counter()
                host = cpu_tr.evaluate_fold(ds, test_only, 9)
                s.log(f"  CPU evaluate_fold of {exp_code}'s {sizes[2]} test cases: "
                      f"{time.perf_counter() - t0:.1f} s (host)")
                run_probs = np.asarray([fold["patient_results"][p_]["prob"] for p_ in host["patient_ids"]])
                p_err = float(np.abs(np.asarray(host["probs"]) - run_probs).max())
                l_err = float(np.abs(cpu_kept["logits"] - card_kept["logits"]).max())
                s.check(host["patient_ids"] == card["patient_ids"] and p_err <= 1e-5 and l_err <= 1e-4,
                        f"{exp_code}: the fold-9 checkpoint's evaluate_fold on the CPU vs the card: "
                        f"probabilities {p_err:.2e} <= 1e-5 of the run's test probabilities, logits "
                        f"{l_err:.2e} <= 1e-4 of the card's ({len(host['patient_ids'])} cases)")
        finally:
            shutil.rmtree(td, ignore_errors=True)

        # the demo (multimodal_fusion_tpu_torch/demo/example_usage.py) on the
        # card against the CPU with the same weights
        reset_counts()
        for model_type in demo.MODEL_TYPES:
            model = ModelFactory.create_model(demo.make_config(model_type), seed=0, device=dev)
            got = demo.demonstrate(model_type, dev, model)
            host = ModelFactory.create_model(demo.make_config(model_type), seed=0, device="cpu")
            host.load_state_dict({k: t_.cpu() for k, t_ in model.state_dict().items()})
            want = demo.demonstrate(model_type, "cpu", host)
            err = float((got["logits"].cpu() - want["logits"]).abs().max())
            s.check(err <= 1e-4 and bool(torch.isfinite(got["train_loss"]).all()),
                    f"demo {model_type}: eval logits card vs CPU {err:.2e} <= 1e-4, train loss finite")
        no_kernel_launches("phase 45, the demo")

    s.phase("1. device and kernel build", device_phase)
    s.phase("2. K1 similarity kernel vs plain", similarity_phase)
    s.phase("3. K2 knn kernel vs plain", knn_phase)
    s.phase("4. main path: 8 x 4096-patch build", main_path_phase)
    s.phase("5. one 32768-patch slide", large_slide_phase)
    s.phase("6. one 4096-node slide", large_node_phase)
    s.phase("7. where one main-path slide's time goes", profile_phase)
    s.phase("8. K3 attention kernel vs plain", attention_phase)
    s.phase("9. main path: ViT-L/16 TMA feature extraction", vit_phase)
    s.phase("10. where one ViT-L/16 batch's time goes", vit_profile_phase)
    s.phase("11. K4 attention backward kernel vs plain", attention_bwd_phase)
    s.phase("12. main path: MFMF survival training", mfmf_phase)
    s.phase("13. where one MFMF training window's time goes", mfmf_profile_phase)
    s.phase("14. flagship svd_gate_random_clam forward, card vs CPU", flagship_phase)
    s.phase("15. main path: flagship inference throughput", flagship_inference_phase)
    s.phase("16. main path: serving", serving_phase)
    s.phase("17. where one flagship inference window's time goes", flagship_profile_phase)
    s.phase("18. flagship training window, card vs CPU", flagship_train_check_phase)
    s.phase("19. main path: flagship training", flagship_training_phase)
    s.phase("20. where one flagship training window's time goes", flagship_train_profile_phase)
    s.phase("21. the rest of the zoo, card vs CPU", zoo_phase)
    s.phase("22. main path: build -> cust_omics training, evaluate_fold, predict", cust_omics_phase)
    s.phase("23. where one cust_omics training window's time goes", cust_omics_profile_phase)
    s.phase("24. alignment step, card vs CPU", alignment_step_phase)
    s.phase("25. main path: alignment training -> survival CLI, predict, serve", alignment_training_phase)
    s.phase("26. main path: VAE training -> reconstructed features", vae_phase)
    s.phase("27. where one pretraining step's time goes", pretraining_profile_phase)
    s.phase(f"28. main path: one {BIG_N}-patch slide, blockwise statistics", blockwise_phase)
    s.phase(f"29. K1 stripe [{STRIPE},{BIG_N},{DIM}] vs plain", stripe_phase)
    s.phase("30. main path: bf16 upload and sampled statistics", large_modes_phase)
    s.phase(f"31. blockwise build card vs CPU at {CPU_N} patches", blockwise_cpu_phase)
    s.phase("32. main path: the batched build, file_batch=8 vs 1", batched_phase)
    s.phase("33. main path: build CLI --cache_similarity, --rebuild", cache_rebuild_phase)
    s.phase("34. main path: the dense graph", dense_graph_phase)
    s.phase("35. main path: mesh build, NCCL world of 1", mesh_build_phase)
    s.phase("36. main path: mesh build, 2 ranks on the card", mesh_large_phase)
    s.phase("37. main path: mesh extraction", mesh_extraction_phase)
    s.phase("38. main path: data-parallel training", mesh_training_phase)
    s.phase("39. the multihost gang and the dry run on the card", gang_phase)
    s.phase("40. main path: the flagship's serving artifact", export_phase)
    s.phase("41. main path: the alignment and VAE artifacts", pretrained_export_phase)
    s.phase("42. main path: reference import and the robustness sweep", import_robust_phase)
    s.phase("43. device MFU accounting", mfu_phase)
    s.phase("44. main path: MFMF mfmf_config1 and mfmf_config2 training", mfmf_config1_phase)
    s.phase("45. main path: the experiment matrix through the training CLI", matrix_phase)
    if world1:  # the NCCL world of 1 of phases 35-38
        torch.distributed.destroy_process_group()
    for d in (mfmf, flag, flag_train, zoo, hg_run, pre, vae_run, exported):
        if "dir" in d:
            shutil.rmtree(d["dir"], ignore_errors=True)

    for name, launches in main_path_launches.items():
        if name in s.kernels:
            s.kernels[name]["launches"] = launches
            if name in routed:  # per route: main-path launches and times by shape
                s.kernels[name]["routes"] = {
                    r: {"launches": main_path_routes[name][r], "ms": route_ms[name][r]} for r in ROUTES}
        s.check(launches >= 1, f"{name} kernel launched on the main path ({launches})")
    # K1 at the stripe shape: its launches are those of the 65536-patch slide (phase 28)
    entries = list(counters) + ["similarity_stripe"]
    if "similarity_stripe" in s.kernels:
        s.check(s.kernels["similarity_stripe"]["launches"] >= 1,
                f"similarity_stripe launched on the main path ({s.kernels['similarity_stripe']['launches']})")
    missing = set(entries) - set(s.kernels)
    if missing:
        s.failures.append(f"no measurements for {sorted(missing)}")
    s.log(s.walls_line())
    if s.failures:
        print("chip_smoke FAILED:\n  " + "\n  ".join(s.failures), file=sys.stderr)
        return 1
    print(json.dumps({"kernels": [s.kernels[name] for name in entries]}))
    print(s.card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

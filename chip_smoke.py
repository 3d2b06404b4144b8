#!/usr/bin/env python3
"""Chip smoke test of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``multimodal_fusion_tpu_torch/csrc``,
holds each against its plain PyTorch version on the card, and drives the
port's three paths through their entry points:

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
  window step; its throughput and a profile of one window.  K4 (the
  attention backward) is held against its plain version at MFMF's three
  block shapes first.

Every phase must pass: the script exits non-zero otherwise, and also when
no CUDA device is present (it never falls back to the CPU).

The line before the last is a JSON object with one entry per kernel
(launches on the main path, error against the plain version, times, bound);
the last line is ``{"ok": true, "device": {...}}``.  Times come from CUDA
events and stand beside the card's name and power limit.
"""

from __future__ import annotations

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

# H100 SXM data-sheet peaks (dense): non-tensor float32, bf16 tensor cores
# and HBM3 bandwidth
PEAK_F32_FLOPS = 67e12
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES_PER_S = 3.35e12

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

    def log(self, msg: str) -> None:
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
        includes whenever it exceeds the kernels' time."""
        from torch.profiler import ProfilerActivity, profile

        fn()
        self.torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            self.torch.cuda.synchronize()
        out: dict = {}
        for e, us in _device_events(prof):
            name = e.key.replace("void ", "").replace("(anonymous namespace)::", "").split("(")[0]
            out[name] = out.get(name, 0.0) + us / 1e3 / reps
        return out

    def phase(self, name: str, fn) -> None:
        self.log(f"== {name}")
        t0 = time.perf_counter()
        try:
            fn()
        except Exception:  # a failed phase fails the run; later phases still report
            self.log(traceback.format_exc())
            self.failures.append(f"{name}: exception")
        self.log(f"   ({name}: {time.perf_counter() - t0:.1f} s wall)")


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


def _similarity_bound_ms(m, n, d, p, feat_bytes):
    ops = (2 * d + 3 * p + 5) * m * n + 2 * (m + n) * d
    nbytes = (m + n) * d * feat_bytes + (m + n) * p * 4 + m * n * 4
    return max(ops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES_PER_S) * 1e3, (
        "operations" if ops / PEAK_F32_FLOPS >= nbytes / PEAK_BYTES_PER_S else "bytes"
    )


def _knn_bound_ms(n, d, k):
    ops = 2 * n * n * d + 4 * n * n + 2 * n * d
    nbytes = n * d * 4 + n * k * 8
    return max(ops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES_PER_S) * 1e3, (
        "operations" if ops / PEAK_F32_FLOPS >= nbytes / PEAK_BYTES_PER_S else "bytes"
    )


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
    t_ops = ops / (PEAK_F32_FLOPS if itemsize == 4 else PEAK_BF16_FLOPS)
    t_bytes = nbytes / PEAK_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


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
    """The larger of the operations at the f32 non-tensor (or bf16 tensor)
    peak and the bytes at the HBM rate, in ms, and which one it is."""
    t_ops = ops / (PEAK_F32_FLOPS if itemsize == 4 else PEAK_BF16_FLOPS)
    t_bytes = nbytes / PEAK_BYTES_PER_S
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


class _CaseTable:
    """The dataset interface ``SurvivalTrainer.train_fold`` reads
    (``case_ids``, ``labels``, ``get_case``) over cases held in host
    memory: the card's machine has no h5py or pandas to read the HDF5
    layout that ``data.multimodal.MultimodalDataset`` reads."""

    has_survival_time = False

    def __init__(self, raws, labels):
        self.case_ids = [f"case_{i:03d}" for i in range(len(raws))]
        self._cases = dict(zip(self.case_ids, zip(raws, (int(x) for x in labels))))
        self.labels = np.asarray(labels, np.int64)

    def __len__(self):
        return len(self.case_ids)

    def get_case(self, case_id):
        return self._cases[case_id]


def _mfmf_cases(rng, markers, tabular_dims):
    """``MFMF_CASES`` raw cases as ``MultimodalDataset.get_case`` returns
    them: a WSI bag of 2048-4096 patches x 1024 and its reconstruction
    (the bag plus small noise), each marker's 9-16 TMA patches, and each
    tabular group's [1, D] values with a 0/1 mask; balanced labels."""
    raws = []
    for _ in range(MFMF_CASES):
        n = int(rng.integers(MFMF_WSI[0], MFMF_WSI[1] + 1))
        wsi = rng.standard_normal((n, DIM), dtype=np.float32)
        raw = {"wsi=features": wsi,
               "wsi=reconstructed_features": wsi + 0.05 * rng.standard_normal((n, DIM), dtype=np.float32)}
        for mk in markers:
            n_tma = int(rng.integers(MFMF_TMA[0], MFMF_TMA[1] + 1))
            raw[f"tma={mk}=features"] = rng.standard_normal((n_tma, DIM), dtype=np.float32)
        for group, dim in tabular_dims.items():
            raw[f"{group}=val"] = rng.standard_normal((1, dim), dtype=np.float32)
            raw[f"{group}=mask"] = (rng.random((1, dim)) > 0.2).astype(np.float32)
        raws.append(raw)
    return raws, rng.permutation(np.arange(MFMF_CASES) % 2)


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
    from multimodal_fusion_tpu_torch.channels import TMA_MARKERS, parse_channels
    from multimodal_fusion_tpu_torch.config import Configs, ExperimentConfig, ModelConfig
    from multimodal_fusion_tpu_torch.data.splits import create_k_fold_splits
    from multimodal_fusion_tpu_torch.data.tma_extraction import (
        extract_marker_features,
        make_feature_extractor,
        save_marker_npz,
    )
    from multimodal_fusion_tpu_torch.device import resolve_device
    from multimodal_fusion_tpu_torch.hypergraph import build
    from multimodal_fusion_tpu_torch.io.fixtures import (
        TABULAR_DIMS,
        clustered_slide,
        make_clustered_dataset,
    )
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
    from multimodal_fusion_tpu_torch.ops.knn_kernel import knn
    from multimodal_fusion_tpu_torch.ops.similarity_kernel import (
        similarity_rect,
        similarity_rect_plain,
    )
    from multimodal_fusion_tpu_torch.train.optim import make_optimizer
    from multimodal_fusion_tpu_torch.train.survival import SurvivalTrainer

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

        def timed(label, q, k, v, valid_k=None):
            """Kernel, plain and SDPA (yardstick, no mask) times, and the
            bound over the keys this call needs."""
            b, t_q, h, hd = q.shape
            ms = s.cuda_ms(lambda: attention_fwd(q, k, v))
            dev_ms = s.device_ms(lambda: attention_fwd(q, k, v))
            route_ms["attention"]["general"][label] = {"ms": ms, "device_ms": sum(dev_ms.values())}
            plain_ms = s.cuda_ms(lambda: plain_fused_attention(q, k, v), iters=5)
            qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
            lib_ms = s.cuda_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt))
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
                s.timed(f"K3 ViT bf16 at {VIT_TOKENS - 1} tokens: device {edge:.4f} ms against "
                        f"{full:.4f} ms at {VIT_TOKENS}: the edge takes {100 * (1 - edge / full):.1f}% "
                        f"of the kernel's time")
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
        markers = torch.as_tensor(np.concatenate(
            [np.arange(64)[None] < rng.integers(MFMF_TMA[0], MFMF_TMA[1] + 1, (b, 1))
             for _ in range(8)], axis=1), device=dev)
        wsi = torch.as_tensor(np.arange(4096)[None] < rng.integers(MFMF_WSI[0], MFMF_WSI[1] + 1, (b, 1)),
                              device=dev)
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

    # ---------------------------------------------------------------- 12
    mfmf = {}  # trainer, model, tables and timing window, read by phase 13

    def mfmf_phase():
        """The slice's main path: MFMF survival training at mfmf_config0
        width through ``SurvivalTrainer.train_fold``."""
        chans = parse_channels(["wsi", "tma"] + [f"{g}_mask" for g in TABULAR_DIMS])
        t0 = time.perf_counter()
        raws, labels = _mfmf_cases(np.random.default_rng(12), TMA_MARKERS, TABULAR_DIMS)
        ds = _CaseTable(raws, labels)
        s.log(f"  {MFMF_CASES} in-memory cases ({len(chans)} channels) drawn in "
              f"{time.perf_counter() - t0:.1f} s (host)")
        mc = ModelConfig(model_type="mfmf", n_classes=2, input_dim=DIM, model_size="64*32",
                         dropout=0.25, inst_number=8, base_weight=0.9, subtyping=True,
                         output_dim=MFMF_DIM, channels_used_in_model=chans,
                         channel_input_dims={f"{g}=val": d for g, d in TABULAR_DIMS.items()},
                         fusion_blocks_sequence=DEFAULT_FUSION_SEQUENCE)
        mc.extra["attention_num_heads"] = MFMF_HEADS
        ec = ExperimentConfig(exp_name="mfmf_config0", seed=5678, k_folds=MFMF_FOLDS,
                              max_epochs=MFMF_EPOCHS, batch_size=MFMF_BATCH, lr=1e-4,
                              optimizer="adam", weight_decay=1e-5, scheduler="plateau",
                              scheduler_params={"mode": "min", "patience": 15, "factor": 0.5},
                              device_data=True)
        split = create_k_fold_splits(ds.labels, MFMF_FOLDS, ec.seed)[0]
        sizes = (len(split.train_idx), len(split.val_idx), len(split.test_idx))
        s.check(sizes == (128, 16, 16), f"fold 0: {sizes} train/val/test cases")
        n_train = MFMF_EPOCHS * -(-sizes[0] // MFMF_BATCH)
        n_eval = (MFMF_EPOCHS + 1) * -(-sizes[1] // 16) + -(-sizes[2] // 16)

        td = Path(tempfile.mkdtemp(prefix="mfmf_"))
        mfmf["dir"] = td
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
                    f"{sizes[0]} cases + evaluation in {wall:.2f} s"
                    + (" (the model's first CUDA use included)" if device_data else ""))
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
        # the host path: each window read, padded and uploaded (prefetched
        # on a thread, as train_fold runs it), 3 windows end to end
        order = np.concatenate([split.train_idx, split.train_idx[:MFMF_BATCH]])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _, w in tr._windows_prefetched(ds, order, MFMF_BATCH):
            tr._train_step(model, opt, tr._to_device(w), gen)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        s.timed(f"MFMF training, host path: {len(order) / wall:.1f} cases/s over "
                f"{len(order) // MFMF_BATCH} windows of {MFMF_BATCH} ({wall:.3f} s)")
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
    if "dir" in mfmf:
        shutil.rmtree(mfmf["dir"], ignore_errors=True)

    for name, launches in main_path_launches.items():
        if name in s.kernels:
            s.kernels[name]["launches"] = launches
            if name in routed:  # per route: main-path launches and times by shape
                s.kernels[name]["routes"] = {
                    r: {"launches": main_path_routes[name][r], "ms": route_ms[name][r]} for r in ROUTES}
        s.check(launches >= 1, f"{name} kernel launched on the main path ({launches})")
    missing = set(counters) - set(s.kernels)
    if missing:
        s.failures.append(f"no measurements for {sorted(missing)}")
    if s.failures:
        print("chip_smoke FAILED:\n  " + "\n  ".join(s.failures), file=sys.stderr)
        return 1
    print(json.dumps({"kernels": [s.kernels[name] for name in counters]}))
    print(s.card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

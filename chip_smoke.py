#!/usr/bin/env python3
"""Chip smoke test of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``multimodal_fusion_tpu_torch/csrc``,
holds each against its plain PyTorch version on the card, drives the
per-slide hypergraph build through its entry points at the benchmark's shape
(8 slides x 4096 patches x 1024-d features + 32 TMA cores, 100/10/5/10,
``save_similarity=False``, ``pipeline_depth=4``), checks the result against
a CPU rebuild, then builds one 32768-patch slide and one slide with 4096
graph nodes.  Every phase must pass: the script exits non-zero otherwise,
and also when no CUDA device is present (it never falls back to the CPU).

The line before the last is a JSON object with one entry per kernel
(launches on the main path, error against the plain version, times, bound);
the last line is ``{"ok": true, "device": {...}}``.  Times come from CUDA
events and stand beside the card's name and power limit.
"""

from __future__ import annotations

import json
import subprocess
import sys
import tempfile
import time
import traceback
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent

# H100 SXM data-sheet peaks (dense): non-tensor float32 and HBM3 bandwidth
PEAK_F32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12

# the benchmark's build configuration (bench.py)
N_FILES, N_PATCHES, N_TMA, DIM = 8, 4096, 32, 1024
NUM_SUPER, NUM_GROUPS, K, NUM_HYPEREDGES = 100, 10, 5, 10
SEED = 42
MAIN_PATH_WINDOWS = 5  # timed windows of N_FILES slides; the median is reported
LARGE_NODES = 4096  # graph nodes at which the build's node KNN switches to K2


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

    def phase(self, name: str, fn) -> None:
        self.log(f"== {name}")
        t0 = time.perf_counter()
        try:
            fn()
        except Exception:  # a failed phase fails the run; later phases still report
            self.log(traceback.format_exc())
            self.failures.append(f"{name}: exception")
        self.log(f"   ({name}: {time.perf_counter() - t0:.1f} s wall)")


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
    from multimodal_fusion_tpu_torch.device import resolve_device
    from multimodal_fusion_tpu_torch.hypergraph import build
    from multimodal_fusion_tpu_torch.io.fixtures import clustered_slide, make_clustered_dataset
    from multimodal_fusion_tpu_torch.ops import _cuda
    from multimodal_fusion_tpu_torch.ops.kmeans import kmeans_plus_plus_init
    from multimodal_fusion_tpu_torch.ops.knn import knn_indices_blockwise
    from multimodal_fusion_tpu_torch.ops.knn_kernel import knn
    from multimodal_fusion_tpu_torch.ops.similarity_kernel import (
        similarity_rect,
        similarity_rect_plain,
    )

    dev = resolve_device("cuda")
    s = Smoke(torch)
    counters = {"similarity": similarity_rect, "knn": knn}
    main_path_launches = {name: 0 for name in counters}
    main_path_ms_per_slide: list = []  # phase 4's median window, read by phase 7

    def reset_counts():
        for fn in counters.values():
            fn.launches = 0

    def add_main_path_counts():
        for name, fn in counters.items():
            main_path_launches[name] += fn.launches

    def check_k1(label, rf, rp, cf, cp, bf16=False, stripe=4096):
        """K1 against its plain version on the same inputs: max abs err <= 1e-5
        and two launches bit-identical.  The plain version runs in row
        stripes (whole, its float64 temporaries at 32768 patches would take
        tens of GiB beside the kernel's two 4 GiB outputs); returns (err,
        the plain K assembled in float32)."""
        out = similarity_rect(rf, rp, cf, cp, 1.0, 1.0, bf16)
        again = similarity_rect(rf, rp, cf, cp, 1.0, 1.0, bf16)
        s.check(bool(torch.equal(out, again)), f"K1 {label}: two launches bit-identical")
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

    def check_k2(label, x, k, exact):
        """K2 against its plain version on ``x``; returns (max abs distance
        difference, the kernel's indices).  ``exact`` (integer-valued
        features: every distance exact in f32, ties many) demands identical
        indices.

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
            ptxas = [ln.strip() for ln in info["log"].splitlines()
                     if "registers" in ln or "spill" in ln]
            s.log(f"    {name}: {info['seconds']:.2f} s; " + " | ".join(ptxas))

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
            err, _ = check_k1(label, rf, rp, cf, cp, bf)
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
            err, _ = check_k2(label, x, k, exact)
            ms = s.cuda_ms(lambda: knn(x, k), iters=20)
            plain_ms = s.cuda_ms(lambda: knn_indices_blockwise(x, k), iters=20)
            bound, bound_by = _knn_bound_ms(n, DIM, k)
            s.timed(f"K2 {label} D={DIM}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
                    f"bound {bound:.4f} ms ({bound_by}); no single PyTorch call computes it")
            if not exact:  # the large-node build's call
                s.kernels["knn"] = {
                    "name": "knn", "route": "cuda",
                    "source": "multimodal_fusion_tpu_torch/csrc/knn.cu",
                    "replaces": "multimodal_fusion_tpu/ops/pallas_knn.py:35",
                    "max_abs_err": err, "ms": ms,
                    "plain_ms": plain_ms, "bound_ms": bound, "bound_by": bound_by,
                    "library_ms": None,
                }

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
                          exact=False)
        s.check(np.array_equal(i_k.cpu().numpy(), res["host"]["knn_idx"]),
                "K2 relaunched on the build's nodes gives the build's neighbour lists")

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

        from torch.autograd import DeviceType

        def dev_us(e):
            return getattr(e, "device_time_total", None) or getattr(e, "cuda_time_total", 0)

        # device-side entries only (kernels and copies): the operator entries
        # above them carry the same device time again
        events = [e for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA and dev_us(e) > 0]
        busy_ms = sum(dev_us(e) for e in events) / 1e3
        if not events:
            s.log("  profiler saw no device time: device busy share not measured")
            return
        s.timed(f"one {N_PATCHES}-patch slide under torch.profiler: wall {wall_ms:.2f} ms, "
                f"device busy {busy_ms:.2f} ms ({100 * busy_ms / wall_ms:.1f}% of the "
                f"profiled wall), {sum(e.count for e in events)} device ops")
        if main_path_ms_per_slide:
            # an estimate: the profiler inflates host time, so the profiled
            # device time is set against phase 4's unprofiled wall per slide
            per_slide = main_path_ms_per_slide[0]
            s.timed(f"estimate: profiled device time over phase 4's median {per_slide:.2f} ms "
                    f"per slide = {100 * busy_ms / per_slide:.1f}% device busy (two runs)")
        for e in sorted(events, key=dev_us, reverse=True)[:10]:
            s.timed(f"  {dev_us(e) / 1e3:8.3f} ms  x{e.count:<5d} {e.key[:90]}")

    s.phase("1. device and kernel build", device_phase)
    s.phase("2. K1 similarity kernel vs plain", similarity_phase)
    s.phase("3. K2 knn kernel vs plain", knn_phase)
    s.phase("4. main path: 8 x 4096-patch build", main_path_phase)
    s.phase("5. one 32768-patch slide", large_slide_phase)
    s.phase("6. one 4096-node slide", large_node_phase)
    s.phase("7. where one main-path slide's time goes", profile_phase)

    for name, launches in main_path_launches.items():
        if name in s.kernels:
            s.kernels[name]["launches"] = launches
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

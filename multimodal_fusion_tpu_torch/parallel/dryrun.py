"""Dry run of the parallel layer (counterpart of ``__graft_entry__``'s
``dryrun_multichip``), and the sharded-against-unsharded checks it runs.

``dryrun_multichip(n, device)`` starts n ranks (``multihost.run_gang``;
on the card by default, ``device="cpu"`` for gloo on the host) and each
runs, with tiny shapes:

- the flagship training step on a (2, n/2) ``(replica, data)`` mesh for
  even n >= 4 (a 1-axis mesh otherwise);
- the sharded single-slide build;
- a sharded VAE step and a sharded alignment step;

each held against the same step unsharded in the rank, and prints its OK
line as ``MULTICHIP_r05.json``'s tail does.

The ``check_*`` functions run inside a rank of an initialised world (or
with ``mesh=None``, which compares the unsharded step with itself).  Each
makes its inputs from a seed with numpy, runs the step sharded over
``mesh`` and unsharded on the rank's device, raises AssertionError past
its tolerance and returns its numbers.
"""

from __future__ import annotations

import importlib
import inspect
import sys
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from multimodal_fusion_tpu_torch.device import resolve_device
from multimodal_fusion_tpu_torch.parallel.mesh import (
    Mesh,
    all_reduce,
    make_mesh,
    make_mesh_2d,
    place_batch,
)

FLAGSHIP_CHANNELS = ["wsi=features", "tma=cd3=features", "tma=cd8=features", "clinical=val",
                     "clinical=mask"]
MFMF_CHANNELS = ["wsi=features", "wsi=reconstructed_features", "tma=cd3=features",
                 "tma=cd8=features", "clinical=val", "clinical=mask", "blood=val", "blood=mask"]
TABULAR_DIMS = {"clinical": 16, "blood": 24}


def _device(mesh: Optional[Mesh], device) -> torch.device:
    return mesh.device if mesh is not None else resolve_device(device)


def _rel(a, b) -> float:
    """max |a - b| over max |b|, over one tensor or a list of them taken
    together (a gradient that is zero up to rounding has no scale of its
    own)."""
    if isinstance(a, (list, tuple)):
        a = torch.cat([t.reshape(-1) for t in a])
        b = torch.cat([t.reshape(-1) for t in b])
    a, b = a.double(), b.double()
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30)) if b.numel() else 0.0


def kernel_launches() -> Dict[str, int]:
    """The launch counts of the port's four kernel wrappers (K1-K4)."""
    from multimodal_fusion_tpu_torch.ops.attention_kernel import attention_bwd, attention_fwd
    from multimodal_fusion_tpu_torch.ops.knn_kernel import knn
    from multimodal_fusion_tpu_torch.ops.similarity_kernel import similarity_rect

    return {"similarity": similarity_rect.launches, "knn": knn.launches,
            "attention": attention_fwd.launches, "attention_bwd": attention_bwd.launches}


def _since(before: Dict[str, int]) -> Dict[str, int]:
    return {k: v - before[k] for k, v in kernel_launches().items()}


def _ms_per_call(fn, calls: int, device: torch.device) -> Optional[float]:
    """Wall milliseconds per call of ``fn`` (synchronised on a card), or
    None for no calls."""
    if calls <= 0:
        return None
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    sync()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    sync()
    return (time.perf_counter() - t0) / calls * 1e3


def _ranks_equal(mesh: Optional[Mesh], tensors: Sequence[torch.Tensor]) -> bool:
    """Whether every rank holds the same ``tensors``, bit for bit."""
    flat = torch.cat([t.detach().reshape(-1).float() for t in tensors])
    return bool(torch.equal(all_reduce(mesh, flat, "max"), all_reduce(mesh, flat, "min")))


def survival_cases(n: int, input_dim: int, wsi: int, tma: int, channels: Sequence[str],
                   tabular_dims: Optional[Dict[str, int]] = None, seed: int = 0):
    """``n`` raw cases (``get_case`` layout) of the given channels and their
    labels (alternating 0, 1), from numpy draws: WSI bags of ``wsi`` - 2 to
    ``wsi`` patches, TMA markers of ``tma`` // 2 to ``tma`` patches, tabular
    groups of ``tabular_dims`` (group -> width; default ``TABULAR_DIMS``)."""
    dims = TABULAR_DIMS if tabular_dims is None else tabular_dims
    rng = np.random.default_rng(seed)
    raws = []
    for _ in range(n):
        raw = {}
        nw = int(rng.integers(max(1, wsi - 2), wsi + 1))
        for ch in channels:
            if ch.startswith("wsi="):
                raw[ch] = rng.standard_normal((nw, input_dim)).astype(np.float32)
            elif ch.startswith("tma="):
                nt = int(rng.integers(max(1, tma // 2), tma + 1))
                raw[ch] = rng.standard_normal((nt, input_dim)).astype(np.float32)
            elif ch.endswith("=val"):
                raw[ch] = rng.standard_normal((1, dims[ch.split("=")[0]])).astype(np.float32)
            elif ch.endswith("=mask"):
                dim = dims[ch.split("=")[0]]
                raw[ch] = (rng.random((1, dim)) > 0.2).astype(np.float32)
        raws.append(raw)
    return raws, [i % 2 for i in range(n)]


def survival_config(model_type: str = "svd_gate_random_clam", input_dim: int = 64,
                    model_size: str = "32*16", output_dim: int = 64, dropout: float = 0.0,
                    channels: Sequence[str] = FLAGSHIP_CHANNELS, **extra):
    from multimodal_fusion_tpu_torch.config import ModelConfig

    cfg = ModelConfig(
        model_type=model_type, n_classes=2, input_dim=input_dim, model_size=model_size,
        dropout=dropout, output_dim=output_dim, channels_used_in_model=list(channels),
        channel_input_dims={f"{g}=val": d for g, d in TABULAR_DIMS.items()
                            if f"{g}=val" in channels},
    )
    cfg.extra.update(extra)
    return cfg


def check_survival_step(mesh: Optional[Mesh], G: int = 8, config=None, input_dim: int = 64,
                        wsi: int = 16, tma: int = 4, lr: float = 1e-2, remat: bool = False,
                        device=None, tol: Optional[Dict[str, float]] = None,
                        timed_steps: int = 0) -> Dict:
    """One training window (``train.survival.window_step``) of ``G`` cases,
    sharded over ``mesh`` and unsharded, from the same weights: the
    losses, the summed gradients and the parameters after an SGD step of
    ``lr`` (Adam's first step, about lr * sign(g), would turn gradients that
    are zero up to rounding into parameter differences), each as max
    |difference| over max |value|; whether every
    rank's parameters are identical; whether the loss is finite; the
    kernels' launches in the sharded step.  ``tol`` maps "loss", "grad" and
    "param" to the bars checked (at dropout > 0 the draws differ from the
    unsharded run's, and only the ranks' equality and the loss's finiteness
    are held).  ``timed_steps`` more steps of each give the milliseconds
    per window, sharded and unsharded."""
    from multimodal_fusion_tpu_torch.data.batching import make_window
    from multimodal_fusion_tpu_torch.models.factory import ModelFactory
    from multimodal_fusion_tpu_torch.train.optim import make_optimizer, set_lr
    from multimodal_fusion_tpu_torch.train.survival import window_step

    dev = _device(mesh, device)
    cfg = config if config is not None else survival_config(input_dim=input_dim)
    raws, labels = survival_cases(G, cfg.input_dim, wsi, tma, cfg.channels_used_in_model,
                                  {k.split("=")[0]: v for k, v in cfg.channel_input_dims.items()})
    window = make_window(raws, labels)

    def run(m):
        model = ModelFactory.create_model(cfg, seed=0, device=dev)
        params = [p for p in model.parameters()]
        opt = make_optimizer("sgd", 0.0, params, lr)
        gen = torch.Generator(device=dev).manual_seed(0)
        w = place_batch(m, window, batch_size=G)
        w = {k: _to(w[k], dev) for k in ("channels", "masks", "label")}

        def step():
            return window_step(model, opt, w, gen, m, remat, G)

        before = kernel_launches()
        loss = step()
        launches = _since(before)
        grads = [p.grad.detach().clone() for p in params if p.grad is not None]
        params = [p.detach().clone() for p in params]
        set_lr(opt, 0.0)  # timed steps do the same work and leave the weights
        return loss.float().cpu(), grads, params, launches, _ms_per_call(step, timed_steps, dev)

    loss_s, grads_s, params_s, launches, ms_s = run(mesh)
    loss_u, grads_u, params_u, _, ms_u = run(None)
    out = {
        "loss": float(loss_s),
        "loss_rel": _rel(loss_s, loss_u),
        "grad_rel": _rel(grads_s, grads_u),
        "param_rel": _rel(params_s, params_u),
        "ranks_equal": _ranks_equal(mesh, params_s),
        "finite": bool(torch.isfinite(loss_s)),
        "launches": launches,
        "ms": ms_s,
        "unsharded_ms": ms_u,
    }
    bars = tol or {}
    bad = {k: out[f"{k}_rel"] for k, bar in bars.items() if not out[f"{k}_rel"] <= bar}
    if bad or not (out["ranks_equal"] and out["finite"]):
        raise AssertionError(f"sharded survival step vs unsharded: {out} (bars {bars})")
    return out


def check_flagship_step(mesh: Optional[Mesh], G: int = 8, dropout: float = 0.0, **kw) -> Dict:
    """``check_survival_step`` on the flagship ``svd_gate_random_clam`` (its
    rank-1 SVD group loss reads the gathered window).  Its random-modality
    loss draws from the generator like dropout, so it is on only where
    dropout is (the JAX package's parity tests turn it off too)."""
    cfg = survival_config(dropout=dropout)
    cfg.enable_random_loss = dropout > 0
    return check_survival_step(mesh, G, cfg, **kw)


def _to(tree, dev):
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    t = torch.as_tensor(np.asarray(tree))
    return t.to(dev, dtype=torch.int64 if t.dtype == torch.int32 else None)


def check_build(mesh: Optional[Mesh], n_patches: int = 128, dim: int = 32, n_tma: int = 4,
                full_stats: bool = True, device=None, seed: int = 1, arrays=None,
                **build) -> Dict:
    """One slide's build (``hypergraph.build.process_arrays``) sharded over
    ``mesh`` and unsharded: the median, min and max equal bit for bit, the
    mean, std and intra-cluster mean within 1e-5 relative, the labels and
    edges equal.  ``full_stats=False`` streams the statistics (the path
    above ``FULL_STATS_MAX_N``).  The slide is ``io.fixtures.clustered_slide``
    drawn from ``seed``, or ``arrays`` = (features, positions, TMA
    features)."""
    from multimodal_fusion_tpu_torch.hypergraph import build as build_mod
    from multimodal_fusion_tpu_torch.io.fixtures import clustered_slide

    dev = _device(mesh, device)
    feats, pos, tma = (arrays if arrays is not None
                       else clustered_slide(np.random.default_rng(seed), n_patches, n_tma, dim))
    n_patches = feats.shape[0]
    params = dict(num_wsi_super_patches=4, num_groups=2, hypergraph_k=2, num_hyperedges=3,
                  save_similarity=False)
    params.update(build)
    limit = build_mod.FULL_STATS_MAX_N
    try:
        if not full_stats:
            build_mod.FULL_STATS_MAX_N = min(limit, n_patches - 1)
        got = build_mod.process_arrays(feats, pos, tma, device=dev, mesh=mesh, **params)
        want = build_mod.process_arrays(feats, pos, tma, device=dev, **params)
    finally:
        build_mod.FULL_STATS_MAX_N = limit
    return compare_builds(got, want)


def check_sharded_similarity(mesh: Mesh, n: int = 256, dim: int = 64, bf16_exact: bool = False,
                             device=None) -> Dict:
    """This rank's stripe of ``combined_similarity_auto(mesh=)``
    (``sharded_combined_similarity``: its row block of an ``n``-patch axis,
    the columns all-gathered) against the same rows of the whole square K,
    bit for bit: K1 on the card, its plain version on the CPU."""
    from multimodal_fusion_tpu_torch.ops.similarity_kernel import combined_similarity_auto

    dev = _device(mesh, device)
    rng = np.random.default_rng(7)
    f = torch.as_tensor((rng.standard_normal((n, dim)) / np.sqrt(dim)).astype(np.float32), device=dev)
    p = torch.as_tensor(rng.uniform(0, 4, (n, 2)).astype(np.float32), device=dev)
    rows = slice(mesh.rank * (n // mesh.size), (mesh.rank + 1) * (n // mesh.size))
    before = kernel_launches()
    stripe = combined_similarity_auto(f[rows], p[rows], 0.7, 1.3, bf16_exact, mesh=mesh)
    launches = _since(before)["similarity"]
    whole = combined_similarity_auto(f, p, 0.7, 1.3, bf16_exact)[rows]
    out = {"equal": bool(torch.equal(stripe, whole)), "shape": list(stripe.shape),
           "launches": launches}
    if not out["equal"]:
        raise AssertionError(f"sharded similarity stripe vs the whole K: {out}")
    return out


def build_clustered(mesh: Optional[Mesh], n_patches: int, slide_seed: int, n_tma: int = 32,
                    dim: int = 1024, device=None, **build) -> Dict:
    """One clustered-blob slide (``io.fixtures.clustered_slide`` from
    ``slide_seed``) built with ``process_arrays`` under ``mesh``: its host outputs
    (statistics, labels, edges), K1's launches in this rank and the wall
    seconds."""
    from multimodal_fusion_tpu_torch.hypergraph import build as build_mod
    from multimodal_fusion_tpu_torch.io.fixtures import clustered_slide

    dev = _device(mesh, device)
    slide = clustered_slide(np.random.default_rng(slide_seed), n_patches, n_tma, dim)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    sync()
    before, t0 = kernel_launches(), time.perf_counter()
    res = build_mod.process_arrays(*slide, device=dev, mesh=mesh, **build)
    sync()
    wall = time.perf_counter() - t0
    keep = ("K_stats", "intra_mean", "labels", "group_labels", "knn_idx", "hyperedge_labels")
    return {"host": {k: res["host"][k] for k in keep}, "arrays": {"edge_index": res["arrays"]["edge_index"]},
            "launches": _since(before), "wall": wall}


def compare_builds(got: Dict, want: Dict, rel: float = 1e-5) -> Dict:
    """``check_build``'s comparison of two ``process_arrays`` results."""
    g, w = got["host"], want["host"]
    ks, kw = np.asarray(g["K_stats"], np.float64), np.asarray(w["K_stats"], np.float64)
    stats_rel = float(np.max(np.abs(ks[:2] - kw[:2]) / np.maximum(np.abs(kw[:2]), 1e-30)))
    intra_rel = float(abs(g["intra_mean"] - w["intra_mean"]) / max(abs(w["intra_mean"]), 1e-30))
    exact = bool(np.array_equal(np.asarray(g["K_stats"])[2:], np.asarray(w["K_stats"])[2:]))
    same = {k: bool(np.array_equal(g[k], w[k]))
            for k in ("labels", "group_labels", "knn_idx", "hyperedge_labels")}
    edges = bool(np.array_equal(got["arrays"]["edge_index"], want["arrays"]["edge_index"]))
    out = {"stats_rel": stats_rel, "intra_rel": intra_rel, "median_min_max_equal": exact,
           "edges_equal": edges, **{f"{k}_equal": v for k, v in same.items()}}
    if not (stats_rel <= rel and intra_rel <= rel and exact and edges and all(same.values())):
        raise AssertionError(f"sharded build vs unsharded: {out}")
    return out


def train_fold(mesh: Optional[Mesh], configs: Dict, csv_path, data_root_dir,
               channels: Sequence[str], log_dir, fold: int = 0, k: int = 3, split_seed: int = 0,
               init_state=None, device=None) -> Dict:
    """``SurvivalTrainer.train_fold`` of fold ``fold`` of a k-fold split of
    the dataset at ``csv_path`` under ``mesh`` (``configs``: the
    ``Configs`` dict); ``init_state``: an npz (``train.checkpoint``) of the
    model's starting weights.  Returns {"summary": the fold summary,
    "params": the trained parameters as numpy}."""
    from multimodal_fusion_tpu_torch.config import Configs
    from multimodal_fusion_tpu_torch.data.multimodal import MultimodalDataset
    from multimodal_fusion_tpu_torch.data.splits import create_k_fold_splits
    from multimodal_fusion_tpu_torch.train.checkpoint import load_model
    from multimodal_fusion_tpu_torch.train.survival import SurvivalTrainer

    ds = MultimodalDataset(csv_path, data_root_dir, list(channels))
    split = create_k_fold_splits(ds.labels, k, split_seed)[fold]
    tr = SurvivalTrainer(Configs.from_dict(configs), log_dir, device=device, mesh=mesh)
    if init_state is not None:
        build = tr._build_model

        def from_state(fold_idx):
            model = build(fold_idx)
            load_model(init_state, model)
            return model

        tr._build_model = from_state
    summary = tr.train_fold(ds, split, fold)
    return {"summary": summary,
            "params": {k: v.detach().cpu().numpy() for k, v in tr._fold_state.state_dict().items()}}


def check_vae_step(mesh: Optional[Mesh], B: int = 16, input_dim: int = 32,
                   hidden: Sequence[int] = (16,), latent: int = 8, lr: float = 1e-2,
                   device=None, tol: float = 1e-5, timed_steps: int = 0) -> Dict:
    """One VAE step (``VAETrainer._step``) on ``B`` rows sharded and
    unsharded, the dropout masks and noise drawn as the unsharded step
    draws them: the losses, the summed gradients and the parameters after
    the step (and, with ``timed_steps``, milliseconds per step of each).
    The step is SGD's, as in ``check_survival_step``: AdamW's first step
    would turn rounding-level differences of near-zero gradients into
    parameter differences of about lr."""
    from multimodal_fusion_tpu_torch.models.vae import VAE
    from multimodal_fusion_tpu_torch.train.vae import VAETrainer

    dev = _device(mesh, device)
    x = torch.as_tensor(np.random.default_rng(2).standard_normal((B, input_dim)).astype(np.float32))

    def run(m):
        model = VAE(input_dim=input_dim, encoder_hidden=list(hidden),
                    decoder_hidden=list(reversed(hidden)), latent_dim=latent,
                    generator=torch.Generator(device=dev).manual_seed(0))
        tr = VAETrainer(model, learning_rate=lr)
        tr.mesh, tr.optimizer = m, torch.optim.SGD(model.parameters(), lr=lr)
        gen = torch.Generator(device=dev).manual_seed(3)
        xs = place_batch(m, x).to(dev)
        losses = tr._step(xs, gen, batch=B)
        grads = [p.grad.detach().clone() for p in model.parameters()]
        params = [p.detach().clone() for p in model.parameters()]
        tr.lr = 0.0  # timed steps do the same work and leave the weights
        return (torch.stack(losses).cpu(), grads, params,
                _ms_per_call(lambda: tr._step(xs, gen, batch=B), timed_steps, dev))

    loss_s, grads_s, params_s, ms_s = run(mesh)
    loss_u, grads_u, params_u, ms_u = run(None)
    out = {"loss": float(loss_s[0]), "loss_rel": _rel(loss_s, loss_u),
           "grad_rel": _rel(grads_s, grads_u), "param_rel": _rel(params_s, params_u),
           "ranks_equal": _ranks_equal(mesh, params_s), "ms": ms_s, "unsharded_ms": ms_u}
    if not (out["loss_rel"] <= tol and out["grad_rel"] <= 10 * tol and out["param_rel"] <= tol
            and out["ranks_equal"]):
        raise AssertionError(f"sharded VAE step vs unsharded: {out}")
    return out


def check_alignment_step(mesh: Optional[Mesh], B: int = 16, markers: Sequence[str] = ("cd3", "cd8", "he"),
                         feature_dim: int = 32, num_layers: int = 1, n_neg: Optional[int] = None,
                         loss_type: str = "rank1", lambda2: float = 0.1, lr: float = 1e-4,
                         device=None, tol: float = 1e-5, timed_steps: int = 0) -> Dict:
    """One alignment step (``MultiModalAlignmentTrainer._step``) of ``B``
    positives and ``n_neg`` negatives (default ``B``; a count that does not
    divide the mesh stays whole on every rank) sharded and unsharded: the
    losses, the summed gradients and the parameters after an SGD step (as
    in ``check_vae_step``)."""
    from multimodal_fusion_tpu_torch.models.alignment import MultiModalAlignmentModel
    from multimodal_fusion_tpu_torch.train.alignment import MultiModalAlignmentTrainer

    dev = _device(mesh, device)
    rng = np.random.default_rng(4)
    n_neg = B if n_neg is None else n_neg
    # rows of norm about 1: the volume loss's Gram determinants stay of order 1
    scale = 1.0 / np.sqrt(feature_dim)
    pos = {m: torch.as_tensor((rng.standard_normal((B, feature_dim)) * scale).astype(np.float32),
                              device=dev) for m in markers}
    neg = {m: torch.as_tensor((rng.standard_normal((n_neg, feature_dim)) * scale).astype(np.float32),
                              device=dev) for m in markers}

    def run(m):
        model = MultiModalAlignmentModel(list(markers), feature_dim=feature_dim,
                                         num_layers=num_layers,
                                         generator=torch.Generator(device=dev).manual_seed(0))
        tr = MultiModalAlignmentTrainer(model, learning_rate=lr, loss_type=loss_type,
                                        lambda2=lambda2)
        tr.mesh, tr.optimizer = m, torch.optim.SGD(tr.params, lr=lr)
        gen = torch.Generator(device=dev).manual_seed(5)
        loss, _ = tr._step(pos, neg if lambda2 else None, lr, gen)
        grads = [p.grad.detach().clone() for p in tr.params]
        params = [p.detach().clone() for p in tr.params]
        # timed steps at learning rate 0: the same work, the weights left
        return (loss.float().cpu(), grads, params, _ms_per_call(
            lambda: tr._step(pos, neg if lambda2 else None, 0.0, gen), timed_steps, dev))

    loss_s, grads_s, params_s, ms_s = run(mesh)
    loss_u, grads_u, params_u, ms_u = run(None)
    out = {"loss": float(loss_s), "loss_rel": _rel(loss_s, loss_u),
           "grad_rel": _rel(grads_s, grads_u), "param_rel": _rel(params_s, params_u),
           "ranks_equal": _ranks_equal(mesh, params_s), "ms": ms_s, "unsharded_ms": ms_u}
    if not (out["loss_rel"] <= tol and out["grad_rel"] <= 10 * tol and out["param_rel"] <= tol
            and out["ranks_equal"]):
        raise AssertionError(f"sharded alignment step vs unsharded: {out}")
    return out


def check_extraction(mesh: Optional[Mesh], vit: Optional[Dict] = None, n_patches: int = 10,
                     patch: int = 48, batch_size: int = 4, compute_dtype: str = "float32",
                     device=None, timed_calls: int = 0) -> Dict:
    """Extraction (``data.tma_extraction.make_feature_extractor``) of
    ``n_patches`` uint8 patches with each batch's rows sharded over
    ``mesh`` and unsharded, from the same seeded ViT (``vit``: its
    constructor's arguments; default ViT-L/16): the relative L2 error of
    the features (<= 1e-5 in float32) and the least cosine of a patch's
    features (>= 0.999 in bfloat16), the attention kernel's launches in
    the sharded run, and with ``timed_calls`` the milliseconds per call of
    each."""
    from multimodal_fusion_tpu_torch.data.tma_extraction import make_feature_extractor
    from multimodal_fusion_tpu_torch.models.vit import ViT

    dev = _device(mesh, device)
    model = ViT(**(vit or {}), generator=torch.Generator(device=dev).manual_seed(0))
    rng = np.random.default_rng(6)
    patches = list(rng.integers(0, 256, (n_patches, patch, patch, 3), dtype=np.uint8))
    sharded = make_feature_extractor(model, batch_size, compute_dtype, mesh=mesh)
    before = kernel_launches()
    got = sharded(patches)
    launches = _since(before)["attention"]
    unsharded = make_feature_extractor(model, batch_size, compute_dtype, device=dev)
    want = unsharded(patches)
    rel = float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))
    cos = float(np.min(np.sum(got * want, 1) / np.maximum(
        np.linalg.norm(got, axis=1) * np.linalg.norm(want, axis=1), 1e-30)))
    out = {"rel_l2": rel, "min_cosine": cos, "launches": launches, "shape": list(got.shape),
           "ms": _ms_per_call(lambda: sharded(patches), timed_calls, dev),
           "unsharded_ms": _ms_per_call(lambda: unsharded(patches), timed_calls, dev)}
    ok = rel <= 1e-5 if compute_dtype == "float32" else cos >= 0.999
    if not ok:
        raise AssertionError(f"sharded extraction vs unsharded: {out}")
    return out


def mesh_for(mesh_shape: Optional[Dict[str, int]], device="cuda") -> Optional[Mesh]:
    """The mesh of a ``{"replica": R, "data": N}`` shape over the whole
    world (a world of 1 gives a 1-rank mesh, not None)."""
    if mesh_shape is None:
        return None
    r, d = int(mesh_shape.get("replica", 0)), int(mesh_shape.get("data", 0))
    if r > 1:
        return make_mesh_2d(r, max(d, 1), device=device)
    return make_mesh(max(d, 1), device=device)


def run_calls(calls: Sequence, device: str = "cuda") -> List:
    """In a rank of a ``multihost.run_gang``: each call ("module:function",
    kwargs, mesh shape or None) in turn, the function given ``mesh=`` where
    it takes one; returns each call's value, or {"raised": exception type,
    "message": text} for a call that raised (the tests' expected errors)."""
    out = []
    for target, kwargs, mesh_shape in calls:
        module, name = target.split(":")
        fn = getattr(importlib.import_module(module), name)
        kwargs = dict(kwargs)
        if "mesh" in inspect.signature(fn).parameters:
            kwargs["mesh"] = mesh_for(mesh_shape, device)
        try:
            out.append(fn(**kwargs))
        except (AssertionError, ValueError, RuntimeError) as e:
            out.append({"raised": type(e).__name__, "message": str(e)})
    return out


def _dryrun_rank(device: str = "cuda") -> List[str]:
    """The dry run in one rank of an n-rank world."""
    n = dist.get_world_size()
    if n >= 4 and n % 2 == 0:
        mesh, shape = make_mesh_2d(2, n // 2, device=device), {"replica": 2, "data": n // 2}
    else:
        mesh, shape = make_mesh(n, device=device), {"data": n}
    lines = []

    def ok(msg):
        lines.append(f"dryrun_multichip({n}): {msg}")
        print(lines[-1], flush=True)

    check_flagship_step(mesh, G=2 * n, tol={"loss": 1e-5, "grad": 1e-4, "param": 1e-5})
    ok(f"OK (mesh {shape})")
    check_build(mesh, n_patches=16 * n)
    ok("sharded single-slide build OK")
    check_vae_step(mesh, B=2 * n)
    ok("sharded VAE train step OK")
    check_alignment_step(mesh, B=2 * n)
    ok("sharded alignment train step OK")
    return lines


def dryrun_multichip(n_devices: int, timeout: float = 600.0, device: str = "cuda",
                     workdir=None) -> str:
    """Start ``n_devices`` ranks (``multihost.run_gang``) that each run the
    dry run; prints and returns rank 0's OK lines."""
    from multimodal_fusion_tpu_torch.parallel.multihost import run_gang

    results, _ = run_gang("multimodal_fusion_tpu_torch.parallel.dryrun:_dryrun_rank", n_devices,
                          {"device": device}, timeout=timeout, device=device, workdir=workdir)
    text = "\n".join(results[0])
    print(text, flush=True)
    return text


if __name__ == "__main__":
    dryrun_multichip(int(sys.argv[1]) if len(sys.argv) > 1 else 2,
                     device=sys.argv[2] if len(sys.argv) > 2 else "cuda")

#!/usr/bin/env python3
"""Time K3 and K4 (the fused-attention forward and backward) and one
mfmf_config1 training window from several checkouts of the repo, in turns,
on one CUDA card.

    python tools/attention_turns.py PARENT_TREE CHANGE_TREE [--order 0,1,1,0]

Each turn is a fresh process that imports ``multimodal_fusion_tpu_torch``
from its tree (building that tree's kernels into the tree's own
``_build/`` on first use) and times, with CUDA events after a warm-up:

- K3 (``attention_fwd``) and K4 (``attention_bwd``) at mfmf_config1's two
  general blocks, [64 x 8 heads, 512 x 4096, 16] with the WSI bag's key
  mask (2048-4096 valid of 4096) and [64 x 8, 4096 x 512, 16] with the 8
  markers' bucket mask (9-16 valid of each 64), and at the bag shape [1 x
  8, 4096, 64] with no mask, each in float32 and bf16; K3 also at the ViT's
  shape [32 x 16, 257, 64] with no mask; the inputs come from one numpy
  seed, so every tree sees the same numbers; beside each K4 time, how far
  one call moved the tracer's counter ``attention_bwd.one_pass`` (1 where
  the float32 general route took its one pass; 0 for a tree without it);
- one 64-case training window of mfmf_config1 (its model at the script's
  width, ``SurvivalTrainer._train_step`` with Adam) on a window held on the
  card, the median of 5 after 2 warm-ups.

Each turn prints one JSON line; the parent process prints them and, per
tree, the median of its turns.  Run it from any directory; every tree
needs the port's package at its root.
"""

from __future__ import annotations

import argparse
import json
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

SEED = 15
B, H, HD = 64, 8, 16
WSI, TMA, MARKERS = (2048, 4096), (9, 16), 8


def _card() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "nvidia-smi failed"


def _masks(np, torch, rng, dev):
    markers = torch.as_tensor(np.concatenate(
        [np.arange(64)[None] < rng.integers(TMA[0], TMA[1] + 1, (B, 1)) for _ in range(MARKERS)], axis=1),
        device=dev)
    wsi = torch.as_tensor(np.arange(4096)[None] < rng.integers(WSI[0], WSI[1] + 1, (B, 1)), device=dev)
    return markers, wsi


def worker(tree: str) -> dict:
    sys.path.insert(0, str(Path(tree).resolve()))
    import numpy as np
    import torch

    from multimodal_fusion_tpu_torch.ops.attention_kernel import attention_bwd, attention_fwd
    from multimodal_fusion_tpu_torch.utils import profiling

    if not torch.cuda.is_available():
        raise SystemExit("attention_turns: needs a CUDA card")
    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED)

    def randn(shape, dtype):
        return torch.as_tensor(rng.standard_normal(shape, dtype=np.float32), device=dev).to(dtype)

    def cuda_ms(fn, iters=10, warmup=3):
        for _ in range(warmup):
            fn()
        torch.cuda.synchronize()
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(iters):
            fn()
        e1.record()
        e1.synchronize()
        return e0.elapsed_time(e1) / iters

    def one_pass(fn):
        before = profiling.counters().get("attention_bwd.one_pass", 0)
        fn()
        return profiling.counters().get("attention_bwd.one_pass", 0) - before

    markers, wsi = _masks(np, torch, rng, dev)
    shapes = [("config1 block 2 [64x8, 512x4096, 16]", (B, 512, H, HD), (B, 4096, H, HD), wsi),
              ("config1 block 3 [64x8, 4096x512, 16]", (B, 4096, H, HD), (B, 512, H, HD), markers),
              ("bag [1x8, 4096, 64]", (1, 4096, 8, 64), (1, 4096, 8, 64), None)]
    k3, k4, k4_one_pass = {}, {}, {}
    for label, qs, ks, mask in shapes:
        for dtype, name in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
            q, k, v, do = randn(qs, dtype), randn(ks, dtype), randn(ks, dtype), randn(qs, dtype)
            k3[f"{label} {name}"] = cuda_ms(lambda: attention_fwd(q, k, v, mask))
            o, m, l = attention_fwd(q, k, v, mask)
            dsum = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
            k4[f"{label} {name}"] = cuda_ms(lambda: attention_bwd(q, k, v, do, m, l, dsum, mask))
            k4_one_pass[f"{label} {name}"] = one_pass(lambda: attention_bwd(q, k, v, do, m, l, dsum, mask))
            del q, k, v, do, o, m, l, dsum
    vit = (32, 257, 16, 64)
    q, k, v = randn(vit, torch.float32), randn(vit, torch.float32), randn(vit, torch.float32)
    k3["ViT [32x16, 257, 64] f32"] = cuda_ms(lambda: attention_fwd(q, k, v))
    return {"tree": tree, "card": _card(), "k3_ms": k3, "k4_ms": k4, "k4_one_pass": k4_one_pass,
            "window_ms": _window_ms(np, torch, rng, dev)}


def _window_ms(np, torch, rng, dev) -> float:
    """Median wall of one 64-case mfmf_config1 training window (forward,
    loss, backward, Adam) on a window held on the card."""
    from multimodal_fusion_tpu_torch.channels import TMA_MARKERS, parse_channels
    from multimodal_fusion_tpu_torch.config import Configs, ExperimentConfig, ModelConfig
    from multimodal_fusion_tpu_torch.io.fixtures import TABULAR_DIMS
    from multimodal_fusion_tpu_torch.models.factory import ModelFactory
    from multimodal_fusion_tpu_torch.train.optim import make_optimizer
    from multimodal_fusion_tpu_torch.train.survival import SurvivalTrainer

    order = [{"q": "tma", "kv": "other"}, {"q": "result", "kv": "wsi"}, {"q": "reconstruct", "kv": "result"}]
    chans = parse_channels(["wsi", "tma"] + [f"{g}_mask" for g in TABULAR_DIMS])
    mc = ModelConfig(model_type="mfmf", n_classes=2, input_dim=1024, model_size="64*32", dropout=0.25,
                     inst_number=8, base_weight=0.9, subtyping=True, output_dim=128,
                     channels_used_in_model=chans,
                     channel_input_dims={f"{g}=val": d for g, d in TABULAR_DIMS.items()},
                     fusion_blocks_sequence=order)
    mc.extra["attention_num_heads"] = H
    ec = ExperimentConfig(exp_name="mfmf_config1", seed=5678, k_folds=5, max_epochs=1, batch_size=B,
                          lr=1e-4, optimizer="adam", weight_decay=1e-5, scheduler="plateau",
                          scheduler_params={"mode": "min", "patience": 15, "factor": 0.5})
    gen = torch.Generator(device=dev).manual_seed(SEED)
    n_wsi = torch.as_tensor(rng.integers(WSI[0], WSI[1] + 1, B), device=dev)
    wsi_mask = torch.arange(4096, device=dev)[None] < n_wsi[:, None]
    wsi = torch.randn((B, 4096, 1024), generator=gen, device=dev) * wsi_mask[..., None]
    channels = {"wsi=features": wsi, "wsi=reconstructed_features": wsi * 0.9}
    masks = {"wsi=features": wsi_mask, "wsi=reconstructed_features": wsi_mask}
    for mk in TMA_MARKERS:
        n_tma = torch.as_tensor(rng.integers(TMA[0], TMA[1] + 1, B), device=dev)
        mask = torch.arange(64, device=dev)[None] < n_tma[:, None]
        channels[f"tma={mk}=features"] = torch.randn((B, 64, 1024), generator=gen, device=dev) * mask[..., None]
        masks[f"tma={mk}=features"] = mask
    for grp, dim in TABULAR_DIMS.items():
        channels[f"{grp}=val"] = torch.randn((B, 1, dim), generator=gen, device=dev)
        channels[f"{grp}=mask"] = (torch.rand((B, 1, dim), generator=gen, device=dev) > 0.2).float()
    window = {"channels": channels, "masks": masks,
              "label": torch.as_tensor(np.arange(B) % 2, dtype=torch.int64, device=dev)}
    log_dir = tempfile.mkdtemp(prefix="attention_turns_")
    tr = SurvivalTrainer(Configs(ec, mc), log_dir, device=dev)
    model = ModelFactory.create_model(mc, seed=0, device=dev)
    opt = make_optimizer(ec.optimizer, ec.weight_decay, model.parameters(), ec.lr)
    walls = []
    for i in range(7):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tr._train_step(model, opt, window, gen)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    shutil.rmtree(log_dir, ignore_errors=True)
    return float(np.median(walls[2:])) * 1e3


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("trees", nargs="*")
    ap.add_argument("--order", default=None, help="comma-separated tree indices (default 0,1,1,0)")
    ap.add_argument("--worker", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.worker:
        print(json.dumps(worker(args.worker)), flush=True)
        return 0
    order = [int(x) for x in (args.order or ",".join(
        str(i) for i in list(range(len(args.trees))) + list(reversed(range(len(args.trees)))))).split(",")]
    results: dict = {}
    for i in order:
        out = subprocess.run([sys.executable, str(Path(__file__).resolve()), "--worker", args.trees[i]],
                             capture_output=True, text=True)
        if out.returncode != 0:
            print(out.stdout + out.stderr, file=sys.stderr)
            return 1
        line = out.stdout.strip().splitlines()[-1]
        print(line, flush=True)
        results.setdefault(args.trees[i], []).append(json.loads(line))
    for tree, runs in results.items():
        print(f"== {tree} ({runs[0]['card']}), {len(runs)} turns: median ms")
        for kernel in ("k3", "k4"):
            for label in runs[0][f"{kernel}_ms"]:
                vals = sorted(r[f"{kernel}_ms"][label] for r in runs)
                path = f", one_pass {runs[0]['k4_one_pass'][label]}" if kernel == "k4" else ""
                print(f"  {kernel.upper()} {label}: {vals[len(vals) // 2]:.4f} "
                      f"(turns {', '.join(f'{v:.4f}' for v in vals)}{path})")
        vals = sorted(r["window_ms"] for r in runs)
        print(f"  mfmf_config1 64-case training window: {vals[len(vals) // 2]:.2f} "
              f"(turns {', '.join(f'{v:.2f}' for v in vals)})")
    return 0


if __name__ == "__main__":
    sys.exit(main())

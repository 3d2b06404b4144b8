"""Cross-modal alignment pretraining (counterpart of
``multimodal_fusion_tpu.train.alignment``).

Reference: ``alignment/trainer.py:24-810``: a step-based loop over recycled
batches; the rank-1 SVD or Gram-volume loss (plus the match predictor's
BCE against global negatives, loss_IM, when lambda2 > 0 under rank1);
decoupled AdamW over the alignment layers only (the match predictor stays
at its initialisation, reference :108-116); CosineAnnealingLR (T_max 100,
eta_min 1e-6) stepped when an epoch wraps; validation every
``val_interval`` steps, capped at ``val_max_batches``; the best checkpoint,
periodic saves, early stopping on the validation loss and a
``.history.json`` dump.

Execution, as the JAX trainer runs it:

- the batch order comes from ``np.random.default_rng(seed)`` in both
  packages, so the port draws the very same batches (the partial tail
  batch of an epoch trains too);
- ``scan_steps`` is accepted and the steps run one after another: the JAX
  package fuses S steps into one ``lax.scan`` dispatch whose numerics equal
  sequential steps, so the history does not depend on it;
- ``device_data`` ("auto", True, False) uploads the training view once
  (``device_tables``) and turns each batch into row gathers on the device,
  with the host collate's per-batch negative count and start offset;
- the match predictor's dropout draws from a ``torch.Generator`` on the
  run's device seeded with ``seed`` (jax.random's draws cannot be
  reproduced);
- ``mesh_shape`` ({"data": N} or {"replica": R, "data": N}) trains data
  parallel over the ranks of a launch (``parallel.mesh``): each rank runs
  the alignment layers on its rows of the batch and of the negatives (a
  leaf whose rows do not divide the mesh, such as a small negative pool,
  stays whole), the aligned rows are gathered, and every rank computes the
  batch's loss whole (the rank-1 SVD and volume losses couple all the
  batch's rows), with the match predictor's dropout drawn by every rank
  from its copy of the generator, kept in step; the loss is divided by the
  mesh size and the gradients summed.  Validation runs whole on every
  rank; rank 0 writes the checkpoints and logs.

Per-step losses stay on the device until the next validation boundary.
"""

from __future__ import annotations

import json
import math
import time
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch

from multimodal_fusion_tpu_torch.models.alignment import MultiModalAlignmentModel
from multimodal_fusion_tpu_torch.ops.losses import (
    binary_cross_entropy,
    rank1_svd_loss_from_dict,
    volume_loss,
)
from multimodal_fusion_tpu_torch.parallel.mesh import (
    all_gather_rows_dict,
    all_reduce_grads,
    mesh_from_shape,
    place_batch,
)
from multimodal_fusion_tpu_torch.train.checkpoint import save_model
from multimodal_fusion_tpu_torch.train.optim import set_lr
from multimodal_fusion_tpu_torch.utils.profiling import StageTimer, span


def make_alignment_apply_fn(model: MultiModalAlignmentModel):
    """Numpy-in / numpy-out aligned features on the model's device (the
    counterpart of the reference's load-time alignment,
    multimodal_dataset.py:396-425)."""
    device = next(model.parameters()).device

    @torch.no_grad()
    def fn(features: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
        out = model({k: torch.as_tensor(np.asarray(v, np.float32), device=device)
                     for k, v in features.items()})
        return {k: v.cpu().numpy() for k, v in out.items()}

    return fn


class MultiModalAlignmentTrainer:
    def __init__(
        self,
        model: MultiModalAlignmentModel,
        learning_rate: float = 1e-4,
        weight_decay: float = 1e-5,
        loss_type: str = "rank1",
        tau1: float = 0.1,
        tau2: float = 0.1,
        lambda1: float = 1.0,
        lambda2: float = 0.1,
        loss2_chunk_size: Optional[int] = None,
        val_max_batches: Optional[int] = None,
        early_stopping_patience: int = 10,
        early_stopping_min_delta: float = 1e-4,
        verbose_timing: bool = False,
        scan_steps: int = 1,
        mesh_shape=None,
        scalar_log_path: Optional[str | Path] = None,
        svd_impl: str = "gram",
    ):
        if loss_type not in ("rank1", "volume"):
            raise ValueError(f"unsupported loss type {loss_type}")
        if svd_impl not in ("gram", "svd"):
            raise ValueError(f"unsupported svd impl {svd_impl}")
        self.model = model
        self.device = next(model.parameters()).device
        self.mesh = mesh_from_shape(mesh_shape, self.device)
        self.is_main = self.mesh is None or self.mesh.is_main
        self.loss_type = loss_type
        self.svd_impl = svd_impl
        self.tau1, self.tau2 = tau1, tau2
        self.lambda1, self.lambda2 = lambda1, lambda2
        self.loss2_chunk_size = loss2_chunk_size
        self.val_max_batches = val_max_batches
        self.patience = early_stopping_patience
        self.min_delta = early_stopping_min_delta
        self.base_lr = learning_rate
        self.scan_steps = max(1, int(scan_steps))  # see the module docstring
        # decoupled AdamW over the alignment layers only (reference :108-116,
        # :112); the match predictor gets neither an update nor decay
        self.params = list(model.alignment_layers.parameters())
        self.optimizer = torch.optim.AdamW(self.params, lr=learning_rate, betas=(0.9, 0.999),
                                           eps=1e-8, weight_decay=weight_decay)
        # one CSV row per validation interval, flushed at once (reference
        # tqdm live postfix + val logging, alignment/trainer.py:334-342)
        self.scalars = None
        if scalar_log_path is not None and self.is_main:
            from multimodal_fusion_tpu_torch.utils.scalars import ScalarWriter

            self.scalars = ScalarWriter(scalar_log_path)
        # per-stage wall clock (reference trainer.py:88-102): data_loading,
        # train_step, validation
        self.timer = None
        if verbose_timing:
            self.timer = StageTimer()
        self.best_val_loss = float("inf")
        self.early_stop_counter = 0
        self.history: Dict[str, List] = {
            "train_loss": [], "val_loss": [], "svd_values": [], "steps": []
        }

    # ------------------------------------------------------------------

    def _aligned(self, batch: Dict[str, torch.Tensor], rows: Optional[int]):
        """The alignment layers on ``batch``; where it holds this rank's
        share of ``rows`` rows, the whole batch's aligned rows, gathered."""
        aligned = self.model(batch)
        if rows is not None and next(iter(batch.values())).shape[0] != rows:
            aligned = all_gather_rows_dict(self.mesh, aligned)
        return aligned

    def _loss(self, pos: Dict[str, torch.Tensor], neg: Optional[Dict[str, torch.Tensor]],
              generator: Optional[torch.Generator], train: bool, rows=(None, None)):
        """(loss, svd_values) of one batch; ``neg`` None leaves out loss_IM.
        ``rows``: the batch's and the negatives' row counts where ``pos`` and
        ``neg`` hold this rank's rows of them (``_step``)."""
        aligned = self._aligned(pos, rows[0])
        if self.loss_type == "rank1":
            loss, svd_vals = rank1_svd_loss_from_dict(
                aligned, self.tau1, self.tau2, self.lambda1, self.loss2_chunk_size,
                impl=self.svd_impl,
            )
            if self.lambda2 != 0 and neg is not None:
                aligned_neg = self._aligned(neg, rows[1])
                # insertion order (the collate's modality_names), the
                # reference's torch.cat(feat_dict.values()) layout: the
                # frozen predictor's input blocks must line up
                keys = list(aligned)
                pos_fused = torch.cat([aligned[k] for k in keys], dim=1)
                neg_fused = torch.cat([aligned_neg[k] for k in keys], dim=1)
                allf = torch.cat([pos_fused, neg_fused], dim=0)
                labels = torch.cat([torch.ones(pos_fused.shape[0], device=allf.device),
                                    torch.zeros(neg_fused.shape[0], device=allf.device)])
                pred = self.model.predict_match(allf, generator=generator, train=train)
                loss = loss + self.lambda2 * binary_cross_entropy(pred[:, 0], labels)
        else:
            # insertion order: the volume loss anchors on feature_list[0]
            # (reference trainer.py:157-201), not the alphabetically first
            loss, svd_vals = volume_loss([aligned[k] for k in aligned], self.tau1)
        return loss, svd_vals

    def _step(self, pos, neg, lr: float, generator: Optional[torch.Generator]):
        """One AdamW update at ``lr``; returns (loss, svd_values), detached
        and left on the device.  Under a mesh each rank keeps its rows of
        ``pos`` and ``neg`` (per leaf), and the loss every rank computes
        whole is divided by the mesh size before the gradients are summed."""
        rows, n = (None, None), 1
        if self.mesh is not None:
            n = self.mesh.size
            rows = tuple(None if b is None else next(iter(b.values())).shape[0] for b in (pos, neg))
            pos, neg = place_batch(self.mesh, pos), place_batch(self.mesh, neg)
        loss, svd_vals = self._loss(pos, neg, generator, train=True, rows=rows)
        grads = torch.autograd.grad(loss / n, self.params)
        for p, g in zip(self.params, grads):
            p.grad = g
        all_reduce_grads(self.mesh, self.params)
        set_lr(self.optimizer, lr)
        self.optimizer.step()
        return loss.detach(), svd_vals.detach()

    def _to_device(self, batch: Optional[Dict[str, np.ndarray]]):
        if batch is None:
            return None
        return {k: torch.as_tensor(v, device=self.device) for k, v in batch.items()}

    def _lr_for_epoch(self, epoch: int) -> float:
        # CosineAnnealingLR(T_max=100, eta_min=1e-6), stepped per epoch wrap
        eta_min = 1e-6
        return eta_min + (self.base_lr - eta_min) * (1 + math.cos(math.pi * (epoch % 200) / 100)) / 2

    def batch_stream(self, train_view, batch_size: int, rng: np.random.Generator,
                     device_data: bool):
        """Endless (positives, negatives or None, lr) of steps 0, 1, ...: an
        epoch is one ``rng.permutation`` of the view, its partial tail batch
        included (the reference DataLoader has no drop_last, run.py:148),
        and the learning rate follows the epoch.  ``device_data`` uploads
        the view's ``device_tables`` once and gathers each batch on the
        device, with the host collate's per-batch negative count and start
        offset (``get_negatives_for_batch``: a tail batch needs fewer
        negatives); otherwise each batch is the view's ``collate``.
        Negatives are left out at lambda2 = 0."""
        n = len(train_view)
        if device_data:
            feats_np, neg_idx_np = train_view.device_tables()
            feats = {m: torch.as_tensor(v, device=self.device) for m, v in feats_np.items()}
            neg_idx = {m: torch.as_tensor(v, dtype=torch.int64, device=self.device)
                       for m, v in neg_idx_np.items()}
            pool_len = int(next(iter(neg_idx_np.values())).shape[0])
            ratio = float(getattr(train_view, "mismatch_ratio", 0.0))
        step_id, epoch = 0, 0
        while True:
            order = rng.permutation(n)
            lr = self._lr_for_epoch(epoch)
            for start in range(0, n, batch_size):
                positions = order[start:start + batch_size]
                if not device_data:
                    pos, neg = train_view.collate(positions, step_id)
                    yield (self._to_device(pos),
                           self._to_device(neg if self.lambda2 != 0 else None), lr)
                else:
                    bp = torch.as_tensor(positions, dtype=torch.int64, device=self.device)
                    need = int(np.ceil(len(positions) * max(0.0, ratio)))
                    neg = None
                    if self.lambda2 != 0 and need > 0 and pool_len > 0:
                        first = (step_id * need) % pool_len
                        sel = (first + torch.arange(need, device=self.device)) % pool_len
                        neg = {m: t[neg_idx[m][sel]] for m, t in feats.items()}
                    yield {m: t[bp] for m, t in feats.items()}, neg, lr
                step_id += 1
            epoch += 1

    def train(
        self,
        train_view,
        val_view,
        max_steps: int,
        batch_size: int = 64,
        val_interval: int = 100,
        save_path: Optional[str | Path] = None,
        save_interval: Optional[int] = None,
        seed: int = 42,
        verbose: bool = False,
        device_data="auto",
    ) -> Dict:
        """``train_view`` / ``val_view``: an ``AlignedSubsetView`` (or the
        dataset itself) with ``__len__`` and ``collate(positions,
        batch_id)``.  ``device_data`` "auto" keeps the training view on the
        device whenever its feature tables fit ``DEVICE_DATA_AUTO_BUDGET``;
        True forces it, False takes the host collate."""
        if device_data == "auto":
            from multimodal_fusion_tpu_torch.train.survival import DEVICE_DATA_AUTO_BUDGET

            can = hasattr(train_view, "device_tables")
            nbytes = 0
            if can:
                n_mod = len(self.model.modality_names) or 8
                nbytes = len(train_view) * 4 * self.model.feature_dim * n_mod
            device_data = can and nbytes <= DEVICE_DATA_AUTO_BUDGET
            if can and not device_data:
                print(f"device_data=auto: feature tables are ~{nbytes / 2**30:.1f} GiB — "
                      "using the host collate path")
        rng = np.random.default_rng(seed)
        generator = torch.Generator(device=self.device).manual_seed(seed)
        # the reference resets early-stop state at the top of every train()
        # (trainer.py:715-721)
        self.best_val_loss = float("inf")
        self.early_stop_counter = 0

        n = len(train_view)
        # a batch never exceeds the dataset (DataLoader semantics); the
        # clamp keeps the device path's negative count equal to the host's
        batch_size = min(batch_size, max(n, 1))
        if self.lambda2 != 0:
            # fail loudly like the reference (alignment/trainer.py:305-306)
            _, probe_neg = train_view.collate(np.arange(min(2, n)), 0)
            if probe_neg is None:
                raise RuntimeError(
                    "Negative features not provided by dataset but "
                    f"lambda2={self.lambda2} requests loss_IM — build the "
                    "view with a mismatch pool or set lambda2=0"
                )
        t0 = time.time()
        pending: List = []  # (loss, svd_values) per step, on the device

        def flush_pending():
            if not pending:
                return
            losses = torch.stack([p[0] for p in pending]).float().cpu().numpy()
            svds = torch.stack([p[1] for p in pending]).cpu().numpy()
            base = len(self.history["train_loss"])
            for i in range(len(pending)):
                self.history["train_loss"].append(float(losses[i]))
                self.history["svd_values"].append(svds[i].tolist())
                self.history["steps"].append(base + i)
            pending.clear()

        batches = self.batch_stream(train_view, batch_size, rng, device_data)
        # the stages are the tracer's spans; verbose_timing also times them
        stage = self.timer.stage if self.timer else span
        step_i = 0
        while step_i < max_steps:
            with stage("data_loading"):
                pos, neg, lr = next(batches)
            with stage("train_step"):
                pending.append(self._step(pos, neg, lr, generator))
                if self.timer and self.device.type == "cuda":
                    torch.cuda.synchronize(self.device)
            step_i += 1

            if save_interval and save_path and step_i % save_interval == 0 and self.is_main:
                save_model(f"{save_path}.step_{step_i}", self.model)

            # the reference validates only on val_interval multiples
            # (trainer.py:761-776; no extra final-step validation)
            if step_i % val_interval == 0:
                flush_pending()
                with stage("validation"):
                    val_loss = self.validate(val_view, batch_size)
                self.history["val_loss"].append({"step": step_i - 1, "loss": val_loss})
                if self.scalars is not None:
                    svd_last = self.history["svd_values"][-1] if self.history["svd_values"] else []
                    self.scalars.write({
                        "step": step_i,
                        "train_loss": self.history["train_loss"][-1]
                        if self.history["train_loss"] else float("nan"),
                        "val_loss": val_loss,
                        "svd_top": svd_last[0] if svd_last else float("nan"),
                    })
                if verbose and self.is_main:
                    print(f"step {step_i}: train={self.history['train_loss'][-1]:.4f} "
                          f"val={val_loss:.4f}")
                # reference order (trainer.py:768-776): the best checkpoint on
                # a plain improvement; min_delta gates only the early-stop
                # bookkeeping (which alone updates best_val_loss)
                if val_loss < self.best_val_loss and save_path and self.is_main:
                    save_model(save_path, self.model, extra={"step": step_i - 1})
                if val_loss < self.best_val_loss - self.min_delta:
                    self.best_val_loss = val_loss
                    self.early_stop_counter = 0
                else:
                    self.early_stop_counter += 1
                    if self.patience > 0 and self.early_stop_counter >= self.patience:
                        break
        flush_pending()
        if self.timer:
            self.timer.print_report()
        return {
            "history": self.history,
            "best_val_loss": self.best_val_loss,
            "elapsed_s": time.time() - t0,
        }

    @torch.no_grad()
    def validate(self, val_view, batch_size: int = 64) -> float:
        """Mean loss over ceil(n / batch_size) batches of ``val_view`` in
        order (the reference validates every loader batch, the partial tail
        included, trainer.py:647-649), at most ``val_max_batches``; no
        dropout."""
        n = len(val_view)
        n_batches = max(1, -(-n // batch_size))
        max_batches = self.val_max_batches if self.val_max_batches is not None else n_batches
        losses = []
        for b in range(min(max_batches, n_batches)):
            positions = np.arange(b * batch_size, min((b + 1) * batch_size, n))
            if len(positions) == 0:
                continue
            pos, neg = val_view.collate(positions, b)
            loss, _ = self._loss(self._to_device(pos),
                                 self._to_device(neg if self.lambda2 != 0 else None), None, False)
            losses.append(loss)
        if not losses:
            return float("nan")
        return float(np.mean(torch.stack(losses).cpu().numpy().astype(np.float64)))

    def save_history(self, path: str | Path, config: Optional[Dict] = None):
        """``.history.json`` dump (reference run.py:192-224)."""
        if not self.is_main:
            return
        payload = {"history": self.history, "best_val_loss": self.best_val_loss}
        if config:
            payload["config"] = config
        Path(path).write_text(json.dumps(payload, indent=2))

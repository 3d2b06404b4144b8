"""VAE training and the reconstructed-feature writer (counterpart of
``multimodal_fusion_tpu.train.vae``).

Reference: ``vae/train.py:23-651``: decoupled AdamW and ReduceLROnPlateau
on the validation loss; latest / best checkpoints with the optimizer,
scheduler and history state, and resume; the LR-reduce count drives a
patch-resample schedule (0 reductions: every 10% of the epochs; 1: every
5%; 2 or more: every epoch); early stop in the endgame (LR at its floor or
two reductions).  ``generate_reconstructed_wsi.py:26-274`` runs every patch
of each h5 through the best model and writes gzip
``wsi/reconstructed_features``.

Execution, as the JAX trainer runs it:

- the batch order comes from ``np.random.default_rng(seed)`` in both
  packages (the final short batch wraps around);
- dropout and the reparameterisation draw from a ``torch.Generator`` on the
  run's device seeded with ``seed``; validation draws z from its own
  generator (``seed + 1``) with no dropout.  jax.random's draws cannot be
  reproduced;
- ``scan_steps`` is accepted and the steps run one after another (the JAX
  package fuses S of them into one dispatch with identical numerics);
- ``device_data`` ("auto", True, False) keeps the current patch subsample
  on the device (uploaded again after a resample) and makes each batch a
  row gather;
- ``mesh_shape`` ({"data": N} or {"replica": R, "data": N}) trains data
  parallel over the ranks of a launch (``parallel.mesh``): each rank keeps
  its rows of every batch (a batch that does not divide the mesh stays
  whole), every rank draws the whole batch's dropout masks and noise from
  its copy of the generator, kept in step, and keeps its rows, so a
  sharded run draws the unsharded run's numbers; the batch-mean losses are
  averaged and the gradients summed over the ranks.  Rank 0 writes the
  checkpoints and logs.
"""

from __future__ import annotations

import csv
import json
import time
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch

from multimodal_fusion_tpu_torch.io.h5io import read_h5_retrying, write_channel
from multimodal_fusion_tpu_torch.models.vae import DROPOUT, VAE, vae_loss
from multimodal_fusion_tpu_torch.parallel.mesh import (
    all_reduce,
    all_reduce_grads,
    mesh_from_shape,
    place_batch,
    rows_of,
)
from multimodal_fusion_tpu_torch.train.checkpoint import load_state, save_state
from multimodal_fusion_tpu_torch.train.optim import set_lr

_ADAM_STATE = ("step", "exp_avg", "exp_avg_sq")


class VAETrainer:
    def __init__(
        self,
        model: VAE,
        learning_rate: float = 1e-3,
        weight_decay: float = 1e-5,
        plateau_patience: int = 10,
        plateau_factor: float = 0.5,
        min_lr: float = 1e-6,
        checkpoint_dir: Optional[str | Path] = None,
        scan_steps: int = 1,
        plateau_threshold: float = 1e-4,
        early_stop_patience: int = 10,
        early_stop_min_delta: float = 1e-4,
        mesh_shape=None,
        scalar_log_path: Optional[str | Path] = None,
        tb_log_dir: Optional[str | Path] = None,
    ):
        self.model = model
        self.device = next(model.parameters()).device
        self.mesh = mesh_from_shape(mesh_shape, self.device)
        self.is_main = self.mesh is None or self.mesh.is_main
        # decoupled AdamW, the reference's torch optim.AdamW
        self.optimizer = torch.optim.AdamW(model.parameters(), lr=learning_rate,
                                           betas=(0.9, 0.999), eps=1e-8,
                                           weight_decay=weight_decay)
        self.base_lr = learning_rate
        self.lr = learning_rate
        self.min_lr = min_lr
        self.plateau_patience = plateau_patience
        self.plateau_factor = plateau_factor
        self.plateau_threshold = plateau_threshold
        self.early_stop_patience = early_stop_patience
        self.early_stop_min_delta = early_stop_min_delta
        self._plateau_best = float("inf")
        self._plateau_count = 0
        self.lr_reduce_count = 0
        self.checkpoint_dir = Path(checkpoint_dir) if checkpoint_dir else None
        self.history: Dict[str, List[float]] = {
            "train_loss": [], "val_loss": [], "recon_loss": [], "kld_loss": [], "lr": []
        }
        self.epoch = 0
        self.global_step = 0
        self.scan_steps = max(1, int(scan_steps))  # see the module docstring
        # one CSV row per epoch, flushed at once (reference TB scalars,
        # vae/train.py:162-165)
        self.scalars = None
        if scalar_log_path is not None and self.is_main:
            from multimodal_fusion_tpu_torch.utils.scalars import ScalarWriter

            self.scalars = ScalarWriter(scalar_log_path)
        # TensorBoard event files with the reference's tag names
        # (vae/train.py:84,162-165,227-231)
        self.tb = None
        if tb_log_dir is not None and self.is_main:
            from multimodal_fusion_tpu_torch.utils.tbevents import TBEventWriter

            self.tb = TBEventWriter(tb_log_dir)

    # ------------------------------------------------------------------

    def _mesh_draws(self, batch: int, x: torch.Tensor, generator, train: bool):
        """The draws of an unsharded forward over the whole batch, in its
        order (encoder keep masks, eps, decoder keep masks), each cut to this
        rank's rows of ``x``."""
        rows = slice(None) if x.shape[0] == batch else rows_of(self.mesh, batch)
        keep = 1.0 - DROPOUT

        def masks(layers):
            if not train:
                return None
            return [(torch.rand((batch, layer.out_features), generator=generator,
                                device=generator.device) < keep)[rows] for layer in layers[:-1]]

        enc = masks(list(self.model.encoder.encoder.values()))
        eps = torch.randn((batch, self.model.latent_dim), generator=generator,
                          device=generator.device)[rows]
        dec = masks(list(self.model.decoder.decoder.values())[:-1])
        return {"encoder": enc, "eps": eps, "decoder": dec}

    def _forward_loss(self, x, batch: int, generator, train: bool, draws=None):
        """(total, recon, kld) of this rank's rows ``x`` of a ``batch``-row
        batch; under a mesh the draws are the whole batch's
        (``_mesh_draws``)."""
        if self.mesh is not None and generator is not None and draws is None:
            draws, generator = self._mesh_draws(batch, x, generator, train), None
        x_hat, mean, log_var = self.model(x, generator=generator, train=train, draws=draws)
        return vae_loss(x, x_hat, mean, log_var)

    def _step(self, x: torch.Tensor, generator: Optional[torch.Generator], draws=None,
              batch: Optional[int] = None):
        """One AdamW update at ``self.lr``; returns (total, recon, kld),
        detached and left on the device.  Under a mesh ``x`` holds this
        rank's rows of a ``batch``-row batch (or all of it): the batch means
        are rank means over equal shards, so each rank's loss is divided by
        the mesh size and the gradients summed."""
        batch = x.shape[0] if batch is None else batch
        total, recon, kld = self._forward_loss(x, batch, generator, True, draws)
        n = 1 if self.mesh is None else self.mesh.size
        self.optimizer.zero_grad(set_to_none=True)
        (total / n).backward()
        all_reduce_grads(self.mesh, list(self.model.parameters()))
        set_lr(self.optimizer, self.lr)
        self.optimizer.step()
        parts = torch.stack([total.detach(), recon.detach(), kld.detach()])
        if self.mesh is not None:
            parts = all_reduce(self.mesh, parts) / n
        return tuple(parts)

    @staticmethod
    def _index_batches(n: int, batch_size: int, shuffle_rng=None):
        """The index walk of ``WSIVAEDataset.batches`` (shuffle and the
        wrap-around of the final short batch) without the features: the
        device path gathers the same rows."""
        order = np.arange(n)
        if shuffle_rng is not None:
            shuffle_rng.shuffle(order)
        for start in range(0, n, batch_size):
            idxs = order[start:start + batch_size]
            if len(idxs) < batch_size:
                idxs = np.concatenate([idxs, order[: batch_size - len(idxs)]])
            yield idxs

    def _batches(self, dataset, batch_size: int, shuffle_rng, table):
        """(this rank's rows of a batch, the batch's row count): a host
        batch is cut before its upload, a device batch gathers only these
        rows."""
        if table is None:
            for x in dataset.batches(batch_size, shuffle_rng):
                yield torch.as_tensor(place_batch(self.mesh, x), device=self.device), len(x)
        else:
            for rows in self._index_batches(len(dataset), batch_size, shuffle_rng):
                yield table[torch.as_tensor(place_batch(self.mesh, rows), device=self.device)], len(rows)

    def train_epoch(self, dataset, batch_size: int, generator, shuffle_rng,
                    table=None) -> Dict[str, float]:
        """One pass over ``dataset``; the per-batch losses stay on the
        device until the epoch ends (one host sync)."""
        parts = [self._step(x, generator, batch=b) for x, b in self._batches(dataset, batch_size,
                                                                           shuffle_rng, table)]
        self.global_step += len(parts)
        if not parts:
            return {"loss": float("nan"), "recon": float("nan"), "kld": float("nan")}
        stacked = torch.stack([torch.stack(p) for p in parts]).cpu().numpy()  # [n, 3]
        return {name: float(np.mean(stacked[:, i])) for i, name in
                enumerate(("loss", "recon", "kld"))}

    @torch.no_grad()
    def validate(self, dataset, batch_size: int, generator, table=None) -> float:
        """Mean loss over ``dataset`` in order, z drawn from ``generator``,
        no dropout."""
        losses = []
        for x, b in self._batches(dataset, batch_size, None, table):
            losses.append(self._forward_loss(x, b, generator, False)[0])
        if not losses:
            return float("nan")
        stacked = torch.stack(losses)
        if self.mesh is not None:
            stacked = all_reduce(self.mesh, stacked) / self.mesh.size
        return float(np.mean(stacked.cpu().numpy()))

    def plateau_step(self, val_loss: float) -> None:
        """ReduceLROnPlateau(min) with torch's default relative threshold
        (improvement when val < best * (1 - threshold)), and the reduce
        count."""
        if val_loss < self._plateau_best * (1.0 - self.plateau_threshold):
            self._plateau_best = val_loss
            self._plateau_count = 0
        else:
            self._plateau_count += 1
            if self._plateau_count > self.plateau_patience:
                new_lr = max(self.lr * self.plateau_factor, self.min_lr)
                if new_lr < self.lr:
                    self.lr = new_lr
                    self.lr_reduce_count += 1
                self._plateau_count = 0

    def resample_interval(self, total_epochs: int) -> int:
        """Resample schedule by LR-reduce count (reference
        vae/train.py:302-333): 0 reductions -> every 10% of the epochs;
        1 -> every 5%; 2 or more -> every epoch."""
        if self.lr_reduce_count == 0:
            return max(1, total_epochs // 10)
        if self.lr_reduce_count == 1:
            return max(1, total_epochs // 20)
        return 1

    @property
    def lr_at_floor(self) -> bool:
        return self.lr <= self.min_lr

    # ------------------------------------------------------------------

    def _optimizer_tree(self) -> Dict[str, Dict[str, torch.Tensor]]:
        state = self.optimizer.state_dict()["state"]
        return {str(i): {k: s[k] for k in _ADAM_STATE} for i, s in state.items()}

    def save_checkpoint(self, tag: str) -> None:
        if self.checkpoint_dir is None or not self.is_main:
            return
        self.checkpoint_dir.mkdir(parents=True, exist_ok=True)
        save_state(
            self.checkpoint_dir / f"{tag}.npz",
            {"model": self.model.state_dict(), "opt": self._optimizer_tree()},
            extra={
                "epoch": self.epoch,
                "global_step": self.global_step,
                "lr": self.lr,
                "lr_reduce_count": self.lr_reduce_count,
                # the plateau tracker (the reference checkpoints the whole
                # scheduler.state_dict, vae/train.py:267)
                "plateau_best": self._plateau_best,
                "plateau_count": self._plateau_count,
            },
        )
        (self.checkpoint_dir / f"{tag}_history.json").write_text(json.dumps(self.history))

    def resume(self, tag: str = "latest") -> bool:
        if self.checkpoint_dir is None:
            return False
        path = self.checkpoint_dir / f"{tag}.npz"
        if not path.exists():
            return False
        restored, extras = load_state(path, {"model": self.model.state_dict()})
        self.model.load_state_dict(restored["model"])
        with np.load(path, allow_pickle=False) as data:
            opt = {}
            for k in data.files:
                parts = k.split("/")
                if parts[0] == "opt" and len(parts) == 3:
                    opt.setdefault(int(parts[1]), {})[parts[2]] = torch.as_tensor(data[k])
        osd = self.optimizer.state_dict()
        osd["state"] = opt
        self.optimizer.load_state_dict(osd)
        self.epoch = int(extras.get("epoch", 0))
        self.global_step = int(extras.get("global_step", 0))
        self.lr = float(extras.get("lr", self.base_lr))
        self.lr_reduce_count = int(extras.get("lr_reduce_count", 0))
        self._plateau_best = float(extras.get("plateau_best", float("inf")))
        self._plateau_count = int(extras.get("plateau_count", 0))
        hist_path = self.checkpoint_dir / f"{tag}_history.json"
        if hist_path.exists():
            self.history = json.loads(hist_path.read_text())
        return True

    # ------------------------------------------------------------------

    def fit(
        self,
        train_ds,
        val_ds,
        epochs: int,
        batch_size: int = 256,
        seed: int = 42,
        verbose: bool = False,
        resample: bool = True,
        device_data="auto",
    ) -> Dict:
        """``device_data`` keeps the current patch subsample on the device
        (uploaded again only after a resample) and makes batches row
        gathers; "auto" takes it whenever the tables fit
        ``DEVICE_DATA_AUTO_BUDGET``, True forces it, False opts out."""
        if device_data == "auto":
            from multimodal_fusion_tpu_torch.train.survival import DEVICE_DATA_AUTO_BUDGET

            nbytes = (len(train_ds) + len(val_ds)) * 4 * self.model.input_dim
            can = hasattr(train_ds, "materialize") and hasattr(val_ds, "materialize")
            device_data = can and nbytes <= DEVICE_DATA_AUTO_BUDGET
            if can and not device_data:
                print(f"device_data=auto: patch tables are ~{nbytes / 2**30:.1f} GiB — "
                      "using the host batch path")
        train_gen = torch.Generator(device=self.device).manual_seed(seed)
        val_gen = torch.Generator(device=self.device).manual_seed(seed + 1)
        shuffle_rng = np.random.default_rng(seed)
        best_val = float("inf")
        early_stop_counter = 0
        t0 = time.time()
        start = self.epoch
        table_train = table_val = None

        def upload(ds):
            return torch.as_tensor(ds.materialize(), device=self.device)

        if device_data:
            table_train, table_val = upload(train_ds), upload(val_ds)
        for epoch in range(start, epochs):
            self.epoch = epoch
            tr = self.train_epoch(train_ds, batch_size, train_gen, shuffle_rng, table=table_train)
            val_loss = self.validate(val_ds, batch_size, val_gen, table=table_val)
            reduces_before = self.lr_reduce_count
            self.plateau_step(val_loss)
            if self.tb is not None:  # reference tags, vae/train.py:162-165,227-243
                self.tb.add_scalar("Train/Loss", tr["loss"], epoch)
                self.tb.add_scalar("Train/ReconLoss", tr["recon"], epoch)
                self.tb.add_scalar("Train/KLDLoss", tr["kld"], epoch)
                self.tb.add_scalar("Train/LearningRate", self.lr, epoch)
                self.tb.add_scalar("Val/Loss", val_loss, epoch)
                if self.lr_reduce_count > reduces_before:
                    self.tb.add_scalar("Train/LRReduceCount", self.lr_reduce_count, epoch)
                self.tb.flush()
            self.history["train_loss"].append(tr["loss"])
            self.history["recon_loss"].append(tr["recon"])
            self.history["kld_loss"].append(tr["kld"])
            self.history["val_loss"].append(val_loss)
            self.history["lr"].append(self.lr)
            if self.scalars is not None:
                self.scalars.write({
                    "epoch": epoch,
                    "step": self.global_step,
                    "train_loss": tr["loss"],
                    "recon_loss": tr["recon"],
                    "kld_loss": tr["kld"],
                    "val_loss": val_loss,
                    "lr": self.lr,
                })
            if verbose:
                print(f"epoch {epoch}: train={tr['loss']:.4f} val={val_loss:.4f} lr={self.lr:.2e}")
            self.save_checkpoint("latest")
            # reference early stop (vae/train.py:596-627): an improvement by
            # min_delta saves best and resets the counter; otherwise the
            # counter advances only in the endgame (LR at its floor or two
            # reductions), and training stops after early_stop_patience
            # epochs without one
            if val_loss < best_val - self.early_stop_min_delta:
                best_val = val_loss
                early_stop_counter = 0
                self.save_checkpoint("best")
            elif self.lr_at_floor or self.lr_reduce_count >= 2:
                early_stop_counter += 1
                if early_stop_counter >= self.early_stop_patience:
                    break
            if resample and (epoch + 1) % self.resample_interval(epochs) == 0:
                train_ds.resample_patches()
                if device_data:
                    table_train = upload(train_ds)
                    if val_ds is train_ds:  # one dataset: val resamples too
                        table_val = table_train
                    elif (getattr(val_ds, "parent", None) is not None
                          and getattr(val_ds, "parent", None) is getattr(train_ds, "parent", None)):
                        # subset views of one dataset: the parent's resample
                        # moved the val rows too, as the host path sees them
                        table_val = upload(val_ds)
        return {"best_val_loss": best_val, "elapsed_s": time.time() - t0, "history": self.history}


# ---------------------------------------------------------------------------
# Reconstruction writer (reference vae/generate_reconstructed_wsi.py)
# ---------------------------------------------------------------------------

@torch.no_grad()
def generate_reconstructed_wsi(
    model: VAE,
    csv_path,
    data_root_dir,
    batch_size: int = 256,
) -> Dict[str, int]:
    """Run every case's ``wsi/features`` through the VAE from the mean
    latent (no draw, no dropout) on the model's device, ``batch_size``
    patches at a time, and write gzip ``wsi/reconstructed_features`` into
    the same h5; returns {case_id: patches}.  The CSV is read with the
    stdlib ``csv`` module; rows whose h5 file is missing are skipped."""
    device = next(model.parameters()).device
    with open(csv_path, newline="") as f:
        rows = list(csv.DictReader(f))
    done: Dict[str, int] = {}
    root = Path(data_root_dir)
    for row in rows:
        h5_path = root / row["h5_file_path"]
        if not h5_path.exists():
            continue
        feats = read_h5_retrying(h5_path, lambda f: np.asarray(f["wsi/features"]))
        out = np.empty_like(feats)
        for start in range(0, feats.shape[0], batch_size):
            chunk = torch.as_tensor(feats[start:start + batch_size], device=device)
            out[start:start + chunk.shape[0]] = model.reconstruct(chunk).cpu().numpy()
        write_channel(h5_path, "wsi=reconstructed_features", out, compression="gzip")
        done[str(row.get("case_id", h5_path.stem))] = int(feats.shape[0])
    return done

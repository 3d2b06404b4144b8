"""K-fold survival trainer (counterpart of
``multimodal_fusion_tpu.train.survival``).

Reference semantics (``downstream_survival/trainer.py:580-1185``), as the
JAX package runs them:

- one optimizer update per gradient-accumulation **window** of
  ``batch_size`` cases: the cases are padded to a shared bucket and run as
  one batched forward (the JAX package's vmap over cases is the port's
  leading case axis), the window loss is ``(sum(per-case losses) +
  group_loss) / G`` (reference trainer.py:799-831) and one optimizer step
  fires per window;
- window group losses (rank-1 SVD, CLIP, AUCM, Cox) read the window's
  stacked results, its labels and, where the dataset CSV has them, the
  cases' ``time`` and ``event``; models with ``stashes_group_logits``
  (AUC-CLAM) add one group loss over the whole evaluated set to the
  validation loss (reference trainer.py:906-912);
- early stopping on a configurable metric (auc/acc/loss, mode max/min) with
  ``stop_epoch`` minimum (reference :487-578);
- per-fold checkpoints, final val + test evaluation with AUROC, a
  per-patient probability dump, the same log files as the JAX trainer.

Execution options (``ExperimentConfig``):

- ``device_data`` ("auto", the default, True or False): keep the fold's
  cases on the device as one padded table per channel, so that a window is
  a row gather on the device instead of a host pad and upload.  "auto"
  takes it when the tables fit ``DEVICE_DATA_AUTO_BUDGET``.  Numerics equal
  the host path's through the mask-aware padding of the models.
- ``scan_windows``: accepted; the windows run one after another (the JAX
  package fuses W of them into one dispatch with numerics equal to
  sequential steps).
- ``compute_dtype="bfloat16"`` (model config) evaluates in bfloat16, as
  the JAX package's ``_make_eval_step`` does: a bfloat16 copy of the
  parameters and of the window's floating inputs, outputs cast back to
  float32 for the metrics.  Training stays float32.
- ``remat``: each segment of the training forward (a CLAM branch, an
  MFMF attention block: ``BaseModel.segment``) runs under
  ``torch.utils.checkpoint`` and is recomputed when the backward pass
  reaches it, so the backward holds one segment's activations at a time.
  The generator's state is replayed for each recompute, so dropout draws
  the same numbers and the gradients equal those without remat.  A model
  with one bag branch (CLAM, AUC-CLAM) marks no segment: checkpointing its
  whole forward would lower no peak.
- ``mesh_shape`` ({"data": N} or {"replica": R, "data": N}) trains data
  parallel over the ranks of a ``torchrun`` (or ``parallel.multihost``)
  launch (``parallel.mesh``): every rank builds the same window and keeps
  its rows (a window whose size does not divide the mesh stays whole on
  every rank), case losses are summed locally, the group losses read the
  window's rows gathered from every rank, and the gradients are summed
  over the ranks before each step (``window_step``).  With the device
  tables each rank gathers only its rows of a window; evaluation gathers
  the outputs in case order.  Rank 0 writes the checkpoints, logs and
  results.  A world smaller than the shape trains unsharded, with the JAX
  package's message.  At dropout 0 a sharded run equals the unsharded one;
  with dropout every rank draws from its own copy of the generator, so its
  draws differ from the unsharded run's (the ranks' parameters stay
  identical).

Dropout draws from a ``torch.Generator`` on the run's device seeded like
the JAX trainer's key (``seed * 1000 + fold``); the draws differ from
jax.random's.  At a model's default dropout of 0 training is deterministic
and follows the JAX trainer's trajectory: the window order comes from
numpy in both.
"""

from __future__ import annotations

import copy
import json
import time
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from multimodal_fusion_tpu_torch.config import Configs
from multimodal_fusion_tpu_torch.data.batching import make_window, pad_case, window_bag_sizes
from multimodal_fusion_tpu_torch.data.splits import FoldSplit, WeightedRandomSampler, save_fold_split
from multimodal_fusion_tpu_torch.device import resolve_device
from multimodal_fusion_tpu_torch.models.factory import ModelFactory
from multimodal_fusion_tpu_torch.parallel.mesh import (
    all_gather_rows_dict,
    all_reduce,
    all_reduce_grads,
    barrier,
    divides,
    mesh_from_shape,
    place_batch,
    rows_of,
)
from multimodal_fusion_tpu_torch.train.checkpoint import load_model, save_model
from multimodal_fusion_tpu_torch.train.metrics import accuracy, binary_auroc, multiclass_auroc_macro
from multimodal_fusion_tpu_torch.train.optim import LRSchedule, make_optimizer, set_lr
from multimodal_fusion_tpu_torch.utils.logging import FoldLogger
from multimodal_fusion_tpu_torch.utils.profiling import span
from multimodal_fusion_tpu_torch.utils.tree import tree_leaves, tree_map

# device_data="auto" takes the device tables only when they fit this
# budget (the JAX package's rule, kept as it is)
DEVICE_DATA_AUTO_BUDGET = 8 * 2**30

# what a window carries to the device: ``time`` and ``event`` feed the Cox
# group loss where the dataset has them
_WINDOW_KEYS = ("channels", "masks", "label", "time", "event")


class EarlyStopping:
    def __init__(self, patience=25, stop_epoch=10, mode="max", min_delta=0.0):
        self.patience = patience
        self.stop_epoch = stop_epoch
        mode = str(mode).lower()
        if mode not in ("max", "min"):
            # anything else would silently take the min branch and restore
            # the worst epoch
            raise ValueError(f"mode must be 'max' or 'min', got {mode!r}")
        self.mode = mode
        self.min_delta = min_delta
        self.counter = 0
        self.best_score = -np.inf if mode == "max" else np.inf
        self.early_stop = False
        self._saved_once = False

    def step(self, epoch: int, score: float) -> bool:
        """Returns True when this epoch improved (caller saves checkpoint)."""
        if self.mode == "max":
            better = score > self.best_score + self.min_delta
        else:
            better = score < self.best_score - self.min_delta
        if better:
            self.best_score = score
            self.counter = 0
            self._saved_once = True
            return True
        if not self._saved_once:
            # first evaluation with a degenerate metric (e.g. NaN AUC on a
            # single-class val split): still record a checkpoint, but keep
            # best_score open so any finite score later counts as improvement
            self._saved_once = True
            self.counter = 0
            return True
        self.counter += 1
        if self.counter >= self.patience and epoch > self.stop_epoch:
            self.early_stop = True
        return False


def window_step(model, optimizer, window, generator, mesh=None, remat: bool = False,
                n_cases: Optional[int] = None) -> torch.Tensor:
    """One window update: ``(sum of the case losses + the group loss) / G``
    and one optimizer step; returns the window's mean case loss (0-d,
    detached).

    Under ``mesh`` the window holds this rank's rows of the ``n_cases``
    window's cases, or the whole window where it does not divide the mesh.
    Case losses are summed locally (divided by the mesh size where every
    rank holds the whole window); the group loss reads the window's
    results gathered from every rank, and every rank computes it whole, so
    it is divided by the mesh size (the gather's backward sums the ranks'
    gradients); the gradients are then summed over the mesh, which gives
    every rank the unsharded window's gradient.

    The step is the span ``train.window``, tiled by ``train.forward``,
    ``train.backward`` and ``train.optimizer`` (``utils.profiling``)."""
    labels = window["label"]
    G = labels.shape[0] if n_cases is None else n_cases
    n = 1 if mesh is None else mesh.size
    sharded = mesh is not None and labels.shape[0] != G
    case = {"channels": window["channels"], "masks": window["masks"]}

    model.remat = remat
    with span("train.window"):
        with span("train.forward"):
            res = model(case, labels, generator=generator, train=True)
            losses = model.loss_fn(res["logits"], labels, res)
            total = losses.sum() if sharded or n == 1 else losses.sum() / n
            if model.has_group_loss():
                group = dict(res, label=labels)
                if "time" in window:  # the Cox partial likelihood's inputs
                    group["time"], group["event"] = window["time"], window["event"]
                if sharded:
                    per_case = {k: v for k, v in group.items() if torch.is_tensor(v)
                                and v.ndim >= 1 and v.shape[0] == labels.shape[0]}
                    group.update(all_gather_rows_dict(mesh, per_case))
                total = total + model.group_loss_fn(group) / n
        with span("train.backward"):
            optimizer.zero_grad(set_to_none=True)
            (total / G).backward()
            all_reduce_grads(mesh, [p for p in model.parameters()])
        with span("train.optimizer"):
            optimizer.step()
        if sharded:
            return all_reduce(mesh, losses.detach().sum()) / G
        return losses.detach().mean()


def _group_eval(model):
    """The validation group loss of a ``stashes_group_logits`` model, bound
    to its group-loss parameters as they are now (before training), as the
    JAX trainer binds a copy of the model state taken before the train
    steps donate the live one; None for other models."""
    if not getattr(model, "stashes_group_logits", False):
        return None
    return model.frozen_group_loss_fn()


class SurvivalTrainer:
    def __init__(self, configs: Configs, log_dir: Union[str, Path],
                 device: Optional[Union[str, torch.device]] = None, mesh=None):
        self.configs = configs
        self.exp = configs.experiment_config
        self.device = resolve_device(device)
        self.log_dir = Path(log_dir)
        self.log_dir.mkdir(parents=True, exist_ok=True)
        # data parallelism over the launch's ranks (module docstring); a
        # caller that built the mesh already passes it
        self.mesh = mesh if mesh is not None else mesh_from_shape(self.exp.mesh_shape, self.device)
        if self.mesh is not None:
            self.device = self.mesh.device
        self.is_main = self.mesh is None or self.mesh.is_main
        self.remat = bool(self.exp.get("remat", False))
        # evaluation dtype (None: the parameters' float32)
        self.compute_dtype = (torch.bfloat16 if configs.model_config.get("compute_dtype", "float32")
                              == "bfloat16" else None)

    # ------------------------------------------------------------------
    # model, windows, tables
    # ------------------------------------------------------------------

    def _build_model(self, fold_idx: int):
        return ModelFactory.create_model(self.configs.model_config, seed=self.exp.seed + fold_idx,
                                         device=self.device)

    def _to_device(self, window) -> Dict[str, Any]:
        """A numpy window (``data.batching.make_window``) as tensors on the
        run's device: channels float32, masks bool, labels int64, and the
        cases' float32 ``time`` and ``event`` where the window has them."""
        def put(x):
            t = torch.as_tensor(x)
            return t.to(self.device, dtype=torch.int64 if t.dtype == torch.int32 else None)

        return {k: tree_map(put, window[k]) for k in _WINDOW_KEYS if k in window}

    def _device_tables(self, dataset, indices):
        """The cases at ``indices`` as one device-resident table per channel
        (every case padded to one bucket per channel over all of them), so a
        training or eval window is a row gather on the device.  Each case is
        padded on the host and copied into its row: the host never holds the
        stacked tables.

        Returns ``(tables, row_of)`` (``row_of`` maps dataset index -> table
        row), or ``(None, None)`` when ``device_data`` is "auto" and the
        tables would exceed ``DEVICE_DATA_AUTO_BUDGET``."""
        raws, labels = [], []
        cids = [dataset.case_ids[int(i)] for i in indices]
        for cid in cids:
            raw, label = dataset.get_case(cid)
            raws.append(raw)
            labels.append(label)
        sizes = window_bag_sizes(raws)
        first = pad_case(raws[0], labels[0], sizes)
        first = {k: first[k] for k in ("channels", "masks", "label")}
        nbytes = len(raws) * sum(np.asarray(x).nbytes for x in tree_leaves(first))
        if nbytes > DEVICE_DATA_AUTO_BUDGET:
            if self.exp.get("device_data", "auto") == "auto":
                print(f"device_data=auto: tables are {nbytes / 2**30:.1f} GiB "
                      f"(> {DEVICE_DATA_AUTO_BUDGET / 2**30:.0f} GiB budget) — "
                      "using the host window path")
                return None, None
            print(f"device_data: tables are {nbytes / 2**30:.1f} GiB — ensure they fit "
                  "device memory (or disable exp.device_data)")

        def empty(x):
            x = torch.as_tensor(np.asarray(x))
            dtype = torch.int64 if x.dtype == torch.int32 else x.dtype
            return torch.empty((len(raws),) + tuple(x.shape), dtype=dtype, device=self.device)

        tables = tree_map(empty, first)
        for r, (raw, label) in enumerate(zip(raws, labels)):
            case = first if r == 0 else pad_case(raw, label, sizes)
            for key in tables:
                if isinstance(tables[key], dict):
                    for ch, t in tables[key].items():
                        t[r].copy_(torch.from_numpy(np.asarray(case[key][ch])))
                else:
                    tables[key][r] = int(case[key])
        if getattr(dataset, "has_survival_time", False):
            for key, values in (("time", dataset.case_to_time), ("event", dataset.case_to_event)):
                tables[key] = torch.as_tensor(np.asarray([values[c] for c in cids], np.float32),
                                              device=self.device)
        row_of = {int(i): r for r, i in enumerate(indices)}
        return tables, row_of

    @staticmethod
    def _gather_window(tables, idx: torch.Tensor):
        """Row-gather a window out of the device tables."""
        return tree_map(lambda t: t.index_select(0, idx), tables)

    def _windows(self, dataset, indices: Sequence[int], G: int):
        """Yield (case ids, numpy window) of <= G cases each, with the
        cases' ``time`` and ``event`` when the dataset CSV has them."""
        case_ids = [dataset.case_ids[i] for i in indices]
        with_time = getattr(dataset, "has_survival_time", False)
        for start in range(0, len(case_ids), G):
            chunk = case_ids[start : start + G]
            raws, labels = [], []
            for cid in chunk:
                raw, label = dataset.get_case(cid)
                raws.append(raw)
                labels.append(label)
            window = make_window(raws, labels)
            if with_time:
                window["time"] = np.asarray([dataset.case_to_time[c] for c in chunk], np.float32)
                window["event"] = np.asarray([dataset.case_to_event[c] for c in chunk], np.float32)
            yield chunk, window

    def _windows_prefetched(self, dataset, indices: Sequence[int], G: int, depth: int = 2):
        """Producer-consumer wrapper over ``_windows``: the next windows'
        reads and padding run on a background thread while the device
        trains on the current one (order and results identical).

        Abort safety: if the consumer stops early (a step raised, the
        generator is closed), the producer's bounded-timeout put notices the
        stop flag and exits; a plain blocking put would deadlock
        ``ThreadPoolExecutor.__exit__`` on the full queue.  Producer
        exceptions are re-raised in the consumer instead of passing for a
        clean end of data."""
        import queue as queue_mod
        from concurrent.futures import ThreadPoolExecutor

        q: queue_mod.Queue = queue_mod.Queue(maxsize=depth)
        sentinel = object()
        stop = False

        def put(item) -> bool:
            while not stop:
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue_mod.Full:
                    continue
            return False

        def producer():
            try:
                for item in self._windows(dataset, indices, G):
                    if not put(item):
                        return
            except BaseException as e:  # noqa: BLE001 — re-raised by the consumer
                put(("__error__", e))
            else:
                put(sentinel)

        with ThreadPoolExecutor(max_workers=1) as pool:
            pool.submit(producer)
            try:
                while True:
                    item = q.get()
                    if item is sentinel:
                        break
                    if isinstance(item, tuple) and len(item) == 2 and item[0] == "__error__":
                        raise item[1]
                    yield item
            finally:
                stop = True
                # drain so a producer blocked in put() sees the flag promptly
                while not q.empty():
                    try:
                        q.get_nowait()
                    except queue_mod.Empty:
                        break

    # ------------------------------------------------------------------
    # steps
    # ------------------------------------------------------------------

    def _train_step(self, model, optimizer, window, generator) -> torch.Tensor:
        """One window update (``window_step``) on this rank's rows of
        ``window`` under a mesh."""
        n_cases = window["label"].shape[0]
        return window_step(model, optimizer, place_batch(self.mesh, window, batch_size=n_cases),
                           generator, self.mesh, self.remat, n_cases)

    def _compute_model(self, model):
        """``model`` itself, or under ``compute_dtype="bfloat16"`` a bfloat16
        copy of it (a model already in bfloat16 is returned as it is)."""
        if self.compute_dtype is None or next(model.parameters()).dtype == self.compute_dtype:
            return model
        return copy.deepcopy(model).to(self.compute_dtype)

    @torch.no_grad()
    def _eval_window(self, model, window, generator=None, drop_prob=None):
        """(logits, probabilities, predictions, per-case losses, risk) of one
        window, float32, left on the device.  ``model`` is in the compute
        dtype (``_compute_model``); the window's floating inputs are cast to
        it.  ``drop_prob`` reaches the forward only when given (the detach
        models' inference-time modality dropout, drawn from ``generator``)."""
        channels = window["channels"]
        if self.compute_dtype is not None:
            channels = {k: v.to(self.compute_dtype) if v.is_floating_point() else v
                        for k, v in channels.items()}
        case = {"channels": channels, "masks": window["masks"]}
        kw = {} if drop_prob is None else {"generator": generator, "drop_prob": drop_prob}
        res = model(case, window["label"], train=False, **kw)
        losses = model.loss_fn(res["logits"], window["label"], res)
        # log-risk for the C-index: the Cox head's output when present, the
        # positive-class logit otherwise
        risk = res["risk"] if "risk" in res else res["logits"][:, 1:2]
        out = (res["logits"], res["probabilities"], res["predictions"], losses, risk)
        return tuple(t.float() if t.is_floating_point() else t for t in out)

    def _eval_window_placed(self, model, window, n_cases: int, generator=None, drop_prob=None):
        """``_eval_window`` on ``window``, this rank's rows of an
        ``n_cases`` window under a mesh (or all of it), the outputs gathered
        back in case order."""
        out = self._eval_window(model, window, generator, drop_prob)
        if window["label"].shape[0] == n_cases:
            return out
        got = all_gather_rows_dict(self.mesh, dict(enumerate(out)))
        return tuple(got[i] for i in range(len(out)))

    # ------------------------------------------------------------------
    # evaluation
    # ------------------------------------------------------------------

    def _evaluate(self, dataset, indices, model, tables=None, row_of=None,
                  drop_prob: Optional[float] = None, seed: int = 0,
                  group_eval=None) -> Dict[str, Any]:
        """Evaluate the cases at ``indices`` in windows of min(batch_size,
        16); results stay on the device until one host sync at the end.
        ``drop_prob`` draws from a generator on the run's device seeded with
        ``seed``.  ``group_eval`` (models with ``stashes_group_logits``: their
        ``frozen_group_loss_fn``) adds its group loss over all the evaluated
        cases to the loss."""
        G = min(self.exp.batch_size, 16)
        model = self._compute_model(model)
        generator = (None if drop_prob is None
                     else torch.Generator(device=self.device).manual_seed(seed))
        outs = []
        if tables is not None:
            rows = torch.as_tensor([row_of[int(i)] for i in indices], dtype=torch.int64)
            patient_ids = [dataset.case_ids[int(i)] for i in indices]
            labels = [np.asarray(dataset.labels)[np.asarray(indices, int)]]
            for s in range(0, len(rows), G):
                idx = rows[s : s + G]
                n_cases = len(idx)
                if divides(self.mesh, n_cases):
                    idx = idx[rows_of(self.mesh, n_cases)]
                outs.append(self._eval_window_placed(
                    model, self._gather_window(tables, idx.to(self.device)), n_cases, generator,
                    drop_prob))
        else:
            patient_ids, labels = [], []
            for chunk, window in self._windows(dataset, indices, G):
                window.pop("time", None)  # evaluation reads channels, masks, labels
                window.pop("event", None)
                labels.append(np.asarray(window["label"]))
                patient_ids.extend(chunk)
                n_cases = len(window["label"])
                placed = self._to_device(place_batch(self.mesh, window, batch_size=n_cases))
                outs.append(self._eval_window_placed(model, placed, n_cases, generator, drop_prob))
        return self._eval_summary(dataset, outs, labels, patient_ids, group_eval)

    def _eval_summary(self, dataset, outs, all_labels, patient_ids,
                      group_eval=None) -> Dict[str, Any]:
        group_loss = None
        if group_eval is not None and outs:
            # one group loss over the whole evaluated set, added to the
            # case mean like the reference's batch_log['loss'] += group_loss
            with torch.no_grad():
                logits = torch.cat([o[0] for o in outs])
                label = torch.as_tensor(np.concatenate(all_labels), dtype=torch.int64,
                                        device=logits.device)
                group_loss = float(group_eval({"logits": logits, "label": label}))
        if outs:
            logits, probs, preds, losses, risk = (
                torch.cat([o[j].reshape(o[j].shape[0], -1) for o in outs]).cpu().numpy()
                for j in range(5)
            )
        else:
            probs = preds = losses = risk = np.zeros((0, 1))
        preds, risk = preds.reshape(-1), risk.reshape(-1)
        labels = np.concatenate(all_labels) if all_labels else np.zeros((0,), int)
        out = {
            # macro multiclass AUROC above 2 classes (reference
            # trainer.py:916-921)
            "auc": binary_auroc(probs[:, 1], labels) if probs.shape[1] == 2
            else multiclass_auroc_macro(probs, labels),
            "acc": accuracy(preds, labels),
            "loss": float(losses.mean()) + (0.0 if group_loss is None
                                             else group_loss / max(len(labels), 1)),
            "probs": probs,
            "preds": preds,
            "labels": labels,
            "risk": risk,
            "patient_ids": patient_ids,
        }
        if getattr(dataset, "has_survival_time", False):
            from multimodal_fusion_tpu_torch.train.metrics import concordance_index

            time_arr = np.asarray([dataset.case_to_time[c] for c in patient_ids])
            event_arr = np.asarray([dataset.case_to_event[c] for c in patient_ids])
            out["c_index"] = concordance_index(risk, time_arr, event_arr)
        return out

    # ------------------------------------------------------------------

    def train_fold(self, dataset, split: FoldSplit, fold_idx: int) -> Dict[str, Any]:
        exp = self.exp
        if self.is_main:
            save_fold_split(split, dataset.case_ids, self.log_dir / f"splits_{fold_idx}.csv")

        model = self._build_model(fold_idx)
        group_eval = _group_eval(model)
        optimizer = make_optimizer(exp.optimizer, exp.weight_decay, model.parameters(), exp.lr)
        tables = row_of = None
        if exp.get("device_data", "auto"):  # "auto" and True both try; False skips
            all_idx = np.concatenate([split.train_idx, split.val_idx, split.test_idx]).astype(np.int64)
            tables, row_of = self._device_tables(dataset, all_idx)
        schedule = LRSchedule(exp.lr, exp.scheduler_params if exp.scheduler else None)
        if exp.scheduler:
            schedule.config.setdefault("type", exp.scheduler)
            schedule.kind = schedule.config.get("type")

        train_labels = dataset.labels[split.train_idx]
        sampler = (WeightedRandomSampler(train_labels, exp.seed + fold_idx)
                   if exp.weighted_sampling else None)
        shuffle_rng = np.random.default_rng(exp.seed + fold_idx)
        # the early_stopping flag gates both the stop and the best-checkpoint
        # restore (reference trainer.py:691-744)
        use_early_stop = bool(exp.get("early_stopping", True))
        stopper = EarlyStopping(patience=exp.patience, stop_epoch=exp.min_epochs,
                                mode=exp.monitor_mode)
        ckpt_path = self.log_dir / f"s_{fold_idx}_checkpoint.npz"
        generator = torch.Generator(device=self.device).manual_seed(exp.seed * 1000 + fold_idx)
        history: List[Dict[str, float]] = []
        logger = (FoldLogger(self.log_dir, fold_idx, self.configs.model_config.n_classes)
                  if self.is_main else None)

        for epoch in range(exp.max_epochs):
            t0 = time.time()
            if sampler is not None:
                order = split.train_idx[sampler.sample_epoch()]
            else:
                order = shuffle_rng.permutation(split.train_idx)
            lr = schedule.lr_for_epoch(epoch)
            set_lr(optimizer, lr)
            # per-window losses stay on the device until the epoch ends
            epoch_losses: List[torch.Tensor] = []
            if tables is not None:
                rows = torch.as_tensor([row_of[int(i)] for i in order], dtype=torch.int64)
                for s in range(0, len(rows), exp.batch_size):
                    idx = rows[s : s + exp.batch_size]
                    n_cases = len(idx)
                    if divides(self.mesh, n_cases):
                        idx = idx[rows_of(self.mesh, n_cases)]  # this rank's rows only
                    window = self._gather_window(tables, idx.to(self.device))
                    epoch_losses.append(window_step(model, optimizer, window, generator,
                                                    self.mesh, self.remat, n_cases))
            else:
                for _, window in self._windows_prefetched(dataset, order, exp.batch_size):
                    n_cases = len(window["label"])
                    placed = self._to_device(place_batch(self.mesh, window, batch_size=n_cases))
                    epoch_losses.append(window_step(model, optimizer, placed, generator,
                                                    self.mesh, self.remat, n_cases))
            losses_np = torch.stack(epoch_losses).cpu().numpy() if epoch_losses else np.asarray([])

            val = self._evaluate(dataset, split.val_idx, model, tables, row_of,
                                 group_eval=group_eval)
            metric = val[exp.monitor_metric]
            schedule.plateau_step(val["loss"])
            improved = stopper.step(epoch, metric)
            if improved and use_early_stop and self.is_main:
                save_model(ckpt_path, model)
            history.append({
                "epoch": epoch,
                "lr": lr,
                "train_loss": float(losses_np.mean()) if losses_np.size else float("nan"),
                "val_loss": val["loss"],
                "val_auc": val["auc"],
                "val_acc": val["acc"],
                "time_s": time.time() - t0,
            })
            if logger is not None:
                logger.log_epoch(epoch, lr, history[-1]["train_loss"], val, history[-1]["time_s"])
            if exp.get("verbose", True) and self.is_main:
                h = history[-1]
                print(f"fold {fold_idx} epoch {epoch}: train_loss={h['train_loss']:.4f} "
                      f"val_loss={h['val_loss']:.4f} val_auc={h['val_auc']:.4f}")
            if use_early_stop and stopper.early_stop:
                break

        if use_early_stop:
            barrier(self.mesh)  # rank 0 wrote the checkpoint
            if ckpt_path.exists():  # restore the best checkpoint
                load_model(ckpt_path, model)
        elif self.is_main:
            # reference without the flag: persist and evaluate the final weights
            save_model(ckpt_path, model)

        val = self._evaluate(dataset, split.val_idx, model, tables, row_of, group_eval=group_eval)
        test = self._evaluate(dataset, split.test_idx, model, tables, row_of,
                              group_eval=group_eval)

        # per-patient probability dump (reference trainer.py:1013)
        patient_results = {
            pid: {"prob": test["probs"][i].tolist(), "label": int(test["labels"][i])}
            for i, pid in enumerate(test["patient_ids"])
        }
        summary = {
            "fold": fold_idx,
            "val_auc": val["auc"],
            "val_acc": val["acc"],
            "test_auc": test["auc"],
            "test_acc": test["acc"],
            "history": history,
        }
        if self.is_main:
            (self.log_dir / f"fold_{fold_idx}_summary.json").write_text(
                json.dumps({**summary, "patient_results": patient_results}, indent=2)
            )
            logger.finalize(summary)
        self._fold_state = model
        return summary

    # ------------------------------------------------------------------

    def evaluate_fold(
        self,
        dataset,
        split: FoldSplit,
        fold_idx: int,
        checkpoint_path: Optional[Union[str, Path]] = None,
        drop_prob: Optional[float] = None,
        seed: int = 0,
    ) -> Dict[str, Any]:
        """Eval-only path: load a fold checkpoint and evaluate the test split
        (reference trainer.py:1044-1169).  ``drop_prob`` (inference-time
        modality dropout, each case zeroing each modality with that
        probability, drawn from a generator seeded with ``seed``) runs on
        the models that implement it, the ``*_detach`` svd_gate family, and
        raises for the others, as in the JAX trainer."""
        model = self._build_model(fold_idx)
        if drop_prob is not None and not getattr(model, "supports_drop_prob", False):
            raise ValueError(f"{type(model).__name__} does not support inference-time modality "
                             "dropout (drop_prob); use a *_detach variant")
        group_eval = _group_eval(model)
        load_model(Path(checkpoint_path or self.log_dir / f"s_{fold_idx}_checkpoint.npz"), model)
        res = self._evaluate(dataset, split.test_idx, model, drop_prob=drop_prob, seed=seed,
                             group_eval=group_eval)
        return {k: res[k] for k in ("auc", "acc", "loss", "patient_ids")} | {
            "probs": res["probs"].tolist(),
            "labels": res["labels"].tolist(),
            "preds": res["preds"].tolist(),
            "risk": res["risk"].tolist(),
        } | ({"c_index": res["c_index"]} if "c_index" in res else {})

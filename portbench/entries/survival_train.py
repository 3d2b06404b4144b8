"""Survival training on the device tables, as ``SurvivalTrainer.train_fold``
runs it with ``device_data``: each step gathers a window of cases out of
the tables (``_gather_window``, the rows uploaded as ``train_fold`` uploads
them) and makes one update (``window_step``); an epoch (every row once, in
an order drawn from the seed) ends with the trainer's one read of its
window losses.

Set-up builds the trainer (its log directory a temporary one in
``TMPDIR``), the cohort on the card in the layout of the trainer's
``device_data`` tables, the model as ``train_fold`` builds it, given the
benchmark's weights, and the optimizer, and drives that same object
through its first ``traffic.reference_steps`` windows (the first epoch's,
rows all different): their losses, the first step's gradient (read back
from Adam's first moment) and each leaf's change after them are what the
check holds against the plain reference.  The window goes on from there.
"""

from __future__ import annotations

import tempfile
from typing import Dict, List

import numpy as np
import torch

from portbench.entries._plant import patch
from portbench.harness import compare, draw, manifest, traffic


def cohort(cell, seed: int, device) -> traffic.Cohort:
    """The cohort of ``seed`` in the trainer's table layout: bags padded to
    the program's bucket ladder."""
    from multimodal_fusion_tpu_torch.ops.masked import bucket_size

    return traffic.cohort(cell.traffic, cell.config["model"], seed, device, bucket_size)


class Entry:
    unit = "cases"

    def __init__(self, cell, seed: int, device: torch.device, spans):
        from multimodal_fusion_tpu_torch.config import Configs, ExperimentConfig, ModelConfig
        from multimodal_fusion_tpu_torch.train import survival
        from multimodal_fusion_tpu_torch.train.optim import make_optimizer

        self.survival, self.spans, self.device, self.config = survival, spans, device, cell.config
        experiment = dict(cell.config["experiment"], seed=draw.derive(seed, "experiment") % 2**31)
        configs = Configs(ExperimentConfig.from_dict(experiment),
                          ModelConfig.from_dict(cell.config["model"]))
        self.logs = tempfile.TemporaryDirectory(prefix="portbench-")
        self.trainer = survival.SurvivalTrainer(configs, self.logs.name, device=device)
        self.cohort = cohort(cell, seed, device)
        self.reference = manifest.reference(cell.config["reference"])
        self.weights = draw.weights(self.reference.weight_spec(cell.config), seed, device)
        self.model = self.trainer._build_model(0)
        self.model.load_state_dict(self.weights)
        masks = self.cohort.tables["masks"]
        self.tma = [ch for ch in masks if ch.startswith("tma=")]
        self.pad = {"wsi": masks["wsi=features"].shape[1], "tma": masks[self.tma[0]].shape[1]}

        exp = self.trainer.exp
        self.optimizer = make_optimizer(exp.optimizer, exp.weight_decay, self.model.parameters(),
                                        exp.lr)
        # the trainer's dropout generator, seeded as train_fold seeds fold 0's
        self.generator = torch.Generator(device=device).manual_seed(exp.seed * 1000)
        n_cases = len(self.cohort.labels)
        self.windows = traffic.epochs(n_cases, int(exp.batch_size), seed, "epochs")
        self.per_epoch = -(-n_cases // int(exp.batch_size))
        self.epoch_losses: List[torch.Tensor] = []
        self.failed = 0

        steps = int(cell.traffic["reference_steps"])
        if steps > self.per_epoch:
            raise ValueError("the reference steps must fall in the first epoch (distinct rows)")
        names = {p: n for n, p in self.model.named_parameters()}
        beta1 = self.optimizer.param_groups[0]["betas"][0]
        self.first_rows, self.losses = [], []
        for t in range(steps):
            rows, loss = self._step()
            self.first_rows.append(rows)
            self.losses.append(float(loss))
            if t == 0:
                self.grad = {names[p]: float(st["exp_avg"].norm()) / (1 - beta1)
                             for p, st in self.optimizer.state.items()}
        self.change = {n: float((p.detach() - self.weights[n]).norm())
                       for n, p in self.model.named_parameters()}

    def _step(self):
        rows = next(self.windows)
        with self.spans("gather_window"):
            idx = torch.as_tensor(rows, dtype=torch.int64)
            window = self.trainer._gather_window(self.cohort.tables, idx.to(self.device))
        with self.spans("window_step"):
            loss = self.survival.window_step(self.model, self.optimizer, window, self.generator,
                                             mesh=self.trainer.mesh, remat=self.trainer.remat,
                                             n_cases=len(rows))
        self.epoch_losses.append(loss)
        if len(self.epoch_losses) == self.per_epoch:
            with self.spans("epoch_losses"):
                torch.stack(self.epoch_losses).cpu()
            self.epoch_losses = []
        return rows, loss

    def step(self):
        """One window; its record is the valid and padded lengths of its
        cases, as the reference's ``count`` reads them."""
        rows, _ = self._step()
        lengths = self.cohort.lengths
        return len(rows), {"wsi": lengths["wsi=features"][rows],
                           "tma": np.stack([lengths[ch][rows] for ch in self.tma], axis=1),
                           "pad": self.pad}

    def release(self) -> None:
        """Free the program's state; the cohort and the weights, which the
        benchmark made, stay for the reference."""
        self.model = self.trainer = self.optimizer = self.epoch_losses = None
        self.logs.cleanup()

    def check(self) -> Dict[str, float]:
        c = self.cohort
        ref = self.reference.train(self.weights, self.config, c.tables, c.lengths, c.labels,
                                   self.first_rows)
        return gaps({"losses": self.losses, "grad": self.grad, "change": self.change}, ref)


def gaps(program: Dict, ref: Dict) -> Dict[str, float]:
    """Each step's loss, the first gradient's worst leaf and the change's
    worst leaf (the leaves the reference moves) against the reference."""
    return {
        "loss_gap": compare.relative_gap(program["losses"], ref["losses"]),
        "grad_gap": compare.leaf_gap(program["grad"], ref["grad"]),
        "change_gap": compare.leaf_gap(program["change"], ref["change"],
                                       compare.moved(ref["grad_raw"])),
    }


def control(cell, seed: int, device) -> Dict[str, float]:
    """The readings of the reference in TF32 put in the program's place,
    on the inputs and first windows of ``seed``."""
    config = cell.config
    reference = manifest.reference(config["reference"])
    weights = draw.weights(reference.weight_spec(config), seed, device)
    c = cohort(cell, seed, device)
    windows = traffic.epochs(len(c.labels), int(config["experiment"]["batch_size"]), seed, "epochs")
    rows = [next(windows) for _ in range(int(cell.traffic["reference_steps"]))]
    ref = reference.train(weights, config, c.tables, c.lengths, c.labels, rows)
    low = reference.train(weights, config, c.tables, c.lengths, c.labels, rows, tf32=True)
    return gaps(low, ref)


def _unchanged_state():
    """Each step runs its forward and backward and leaves the parameters
    and the optimizer's state as they were."""
    from multimodal_fusion_tpu_torch.train import survival

    real = survival.window_step

    class Idle:
        def __init__(self, optimizer):
            self.optimizer = optimizer

        def zero_grad(self, set_to_none=True):
            self.optimizer.zero_grad(set_to_none=set_to_none)

        def step(self):
            pass

    def window_step(model, optimizer, *args, **kwargs):
        return real(model, Idle(optimizer), *args, **kwargs)

    return patch(survival, "window_step", window_step)


def _half_batch():
    """Each step trains on the first half of its window, the loss the mean
    over that half."""
    from multimodal_fusion_tpu_torch.train import survival

    real = survival.window_step

    def cut(tree, n):
        if isinstance(tree, dict):
            return {k: cut(v, n) for k, v in tree.items()}
        return tree[:n]

    def window_step(model, optimizer, window, *args, n_cases=None, **kwargs):
        half = window["label"].shape[0] // 2
        return real(model, optimizer, cut(window, half), *args, n_cases=half, **kwargs)

    return patch(survival, "window_step", window_step)


def _altered_answer():
    """The first case of every window gets a logit 1.0 off where the model
    produces it."""
    from multimodal_fusion_tpu_torch.models.mfmf import MFMF

    real = MFMF.forward

    def forward(self, *args, **kwargs):
        res = real(self, *args, **kwargs)
        bump = torch.zeros_like(res["logits"])
        bump[0, 0] = 1.0
        res["logits"] = res["logits"] + bump
        res["probabilities"] = torch.softmax(res["logits"], dim=-1)
        return res

    return patch(MFMF, "forward", forward)


FAULTS = {"unchanged_state": _unchanged_state, "half_batch": _half_batch,
          "altered_answer": _altered_answer}

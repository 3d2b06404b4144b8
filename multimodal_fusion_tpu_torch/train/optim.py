"""Optimizers and epoch-level LR schedules (counterpart of
``multimodal_fusion_tpu.train.optim``).

Torch-semantics parity (reference ``downstream_survival/trainer.py:158-219``):
- Adam with coupled L2 (weight_decay added to the gradient, not decoupled
  AdamW): ``torch.optim.Adam(weight_decay=...)``, which is the JAX
  package's ``add_decayed_weights`` -> ``scale_by_adam`` chain;
  SGD(momentum=0.9) with coupled L2; AdamW with decoupled decay.
- Five epoch-stepped schedulers: step, cosine, cosine_warm_restart, plateau,
  exponential.  The schedule is a function of the epoch index computed on
  the host; the trainer writes it into the optimizer's param groups
  (``set_lr``) before each epoch.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Iterable, Optional

import torch


def make_optimizer(opt: str, weight_decay: float, params: Iterable[torch.nn.Parameter],
                   lr: float = 1e-4) -> torch.optim.Optimizer:
    """The optimizer of ``opt`` ('adam', 'sgd' or 'adamw') over ``params``."""
    params = list(params)
    if opt == "adam":
        return torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                                weight_decay=weight_decay or 0.0)
    if opt == "sgd":
        return torch.optim.SGD(params, lr=lr, momentum=0.9, weight_decay=weight_decay or 0.0)
    if opt == "adamw":
        return torch.optim.AdamW(params, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                                 weight_decay=weight_decay)
    raise NotImplementedError(f"optimizer {opt!r}")


def set_lr(optimizer: torch.optim.Optimizer, lr: float) -> None:
    for group in optimizer.param_groups:
        group["lr"] = lr


class LRSchedule:
    """Epoch-indexed LR schedule with torch scheduler semantics."""

    def __init__(self, base_lr: float, config: Optional[Dict[str, Any]] = None):
        self.base_lr = base_lr
        self.config = config or {}
        self.kind = self.config.get("type")
        # plateau state
        self._plateau_scale = 1.0
        self._plateau_best = None
        self._plateau_count = 0

    def lr_for_epoch(self, epoch: int) -> float:
        c = self.config
        if self.kind is None:
            return self.base_lr
        if self.kind == "step":
            step_size = c.get("step_size", 50)
            gamma = c.get("gamma", 0.5)
            return self.base_lr * gamma ** (epoch // step_size)
        if self.kind == "cosine":
            T_max = c.get("T_max", 200)
            eta_min = c.get("eta_min", 0.0)
            return eta_min + (self.base_lr - eta_min) * (1 + math.cos(math.pi * epoch / T_max)) / 2
        if self.kind == "cosine_warm_restart":
            T_0 = c.get("T_0", 10)
            T_mult = c.get("T_mult", 2)
            if T_mult < 1:
                # torch CosineAnnealingWarmRestarts validates the same way;
                # T_mult <= 0 would make the restart loop below non-terminating
                raise ValueError(f"Expected T_mult >= 1, got {T_mult}")
            eta_min = c.get("eta_min", 0.0)
            t, T_i = epoch, T_0
            while t >= T_i:
                t -= T_i
                T_i *= T_mult
            return eta_min + (self.base_lr - eta_min) * (1 + math.cos(math.pi * t / T_i)) / 2
        if self.kind == "exponential":
            gamma = c.get("gamma", 0.95)
            return self.base_lr * gamma**epoch
        if self.kind == "plateau":
            return self.base_lr * self._plateau_scale
        raise ValueError(f"Unknown scheduler type: {self.kind}")

    def plateau_step(self, metric: float) -> None:
        """ReduceLROnPlateau update; call once per epoch with the monitored
        metric (only meaningful for kind == 'plateau')."""
        if self.kind != "plateau":
            return
        mode = self.config.get("mode", "min")
        patience = self.config.get("patience", 10)
        factor = self.config.get("factor", 0.5)
        # torch ReduceLROnPlateau default rel threshold: sub-threshold noise
        # must not reset the patience counter or the LR never reduces
        threshold = self.config.get("threshold", 1e-4)
        better = self._plateau_best is None or (
            metric < self._plateau_best * (1.0 - threshold)
            if mode == "min"
            else metric > self._plateau_best * (1.0 + threshold)
        )
        if better:
            self._plateau_best = metric
            self._plateau_count = 0
        else:
            self._plateau_count += 1
            if self._plateau_count > patience:
                self._plateau_scale *= factor
                self._plateau_count = 0

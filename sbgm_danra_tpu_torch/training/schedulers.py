"""Host-side learning-rate schedulers and early stopping (a copy of
``sbgm_danra_tpu/training/schedulers.py``, pure Python).

The pipeline calls ``scheduler.step(val_loss)`` each epoch and writes the new
rate into the optimizer's parameter groups (``TrainState.with_learning_rate``).
"""

from __future__ import annotations

import math
from typing import Optional

from sbgm_danra_tpu_torch.config import Config


class LRScheduler:
    def __init__(self, base_lr: float):
        self.base_lr = base_lr
        self.lr = base_lr
        self.epoch = 0

    def step(self, val_loss: Optional[float] = None) -> float:
        self.epoch += 1
        self.lr = self._compute(val_loss)
        return self.lr

    def _compute(self, val_loss: Optional[float]) -> float:  # pragma: no cover
        raise NotImplementedError

    def state_dict(self) -> dict:
        return {"lr": self.lr, "epoch": self.epoch}

    def load_state_dict(self, d: dict) -> None:
        self.lr = d["lr"]
        self.epoch = d["epoch"]


class ConstantLR(LRScheduler):
    def _compute(self, val_loss):
        return self.lr


class StepLR(LRScheduler):
    def __init__(self, base_lr: float, step_size: int = 10, gamma: float = 0.1):
        super().__init__(base_lr)
        self.step_size = step_size
        self.gamma = gamma

    def _compute(self, val_loss):
        return self.base_lr * self.gamma ** (self.epoch // self.step_size)


class CosineAnnealingLR(LRScheduler):
    def __init__(self, base_lr: float, t_max: int = 100, eta_min: float = 1e-6):
        super().__init__(base_lr)
        self.t_max = t_max
        self.eta_min = eta_min

    def _compute(self, val_loss):
        t = min(self.epoch, self.t_max)
        return self.eta_min + 0.5 * (self.base_lr - self.eta_min) * (
            1.0 + math.cos(math.pi * t / self.t_max)
        )


class ReduceLROnPlateau(LRScheduler):
    """torch-equivalent plateau scheduler (rel threshold mode)."""

    def __init__(
        self,
        base_lr: float,
        factor: float = 0.5,
        patience: int = 5,
        threshold: float = 0.01,
        min_lr: float = 1e-6,
    ):
        super().__init__(base_lr)
        self.factor = factor
        self.patience = patience
        self.threshold = threshold
        self.min_lr = min_lr
        self.best = math.inf
        self.bad_epochs = 0

    def _compute(self, val_loss):
        if val_loss is None:
            return self.lr
        if val_loss < self.best * (1.0 - self.threshold):
            self.best = val_loss
            self.bad_epochs = 0
        else:
            self.bad_epochs += 1
            if self.bad_epochs > self.patience:
                self.bad_epochs = 0
                return max(self.lr * self.factor, self.min_lr)
        return self.lr

    def state_dict(self) -> dict:
        d = super().state_dict()
        d.update(best=self.best, bad_epochs=self.bad_epochs)
        return d

    def load_state_dict(self, d: dict) -> None:
        super().load_state_dict(d)
        self.best = d.get("best", math.inf)
        self.bad_epochs = d.get("bad_epochs", 0)


class EarlyStopping:
    """Configured-but-unused in the reference (default_config.yaml:127-130);
    functional here."""

    def __init__(self, patience: int = 50, min_delta: float = 1e-4):
        self.patience = patience
        self.min_delta = min_delta
        self.best = math.inf
        self.bad_epochs = 0

    def update(self, val_loss: float) -> bool:
        """Returns True when training should stop."""
        if val_loss < self.best - self.min_delta:
            self.best = val_loss
            self.bad_epochs = 0
        else:
            self.bad_epochs += 1
        return self.bad_epochs >= self.patience

    def state_dict(self) -> dict:
        return {"best": self.best, "bad_epochs": self.bad_epochs}

    def load_state_dict(self, d: dict) -> None:
        self.best = d["best"]
        self.bad_epochs = d["bad_epochs"]


def make_scheduler(cfg: Config) -> LRScheduler:
    """Scheduler factory (reference training_utils.py:708-739)."""
    t = cfg.training
    p = t.lr_scheduler_params
    name = (t.lr_scheduler or "none").lower()
    if name in ("none", "constant"):
        return ConstantLR(t.learning_rate)
    if name == "steplr":
        return StepLR(t.learning_rate, p.step_size, p.gamma)
    if name in ("cosineannealing", "cosineannealinglr"):
        return CosineAnnealingLR(t.learning_rate, p.t_max, p.eta_min)
    if name == "reducelronplateau":
        return ReduceLROnPlateau(
            t.learning_rate, p.factor, p.patience, p.threshold, p.min_lr
        )
    raise ValueError(f"Unknown lr_scheduler: {t.lr_scheduler}")

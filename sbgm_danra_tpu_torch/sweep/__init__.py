"""Hyperparameter sweeps: samplers, pruners, sqlite-backed studies (the study
engine copied from the JAX package, the runner on the port's trainer)."""

from sbgm_danra_tpu_torch.sweep.study import (
    GPSampler,
    HaltonSampler,
    RandomSampler,
    Study,
    SuccessiveHalvingPruner,
    Trial,
    TrialPruned,
)

__all__ = [
    "Study",
    "GPSampler",
    "Trial",
    "TrialPruned",
    "RandomSampler",
    "HaltonSampler",
    "SuccessiveHalvingPruner",
]

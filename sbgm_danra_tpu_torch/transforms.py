"""Normalisation transforms and their inverses (a copy of the parts of
``sbgm_danra_tpu/transforms.py`` that the port reads).

The data path normalises each variable with the forward transforms, built
from the global-statistics JSONs (``transform_from_stats``,
``load_global_stats``); generation answers in the HR target's normalised space,
and the inverses turn a field back into physical units. The arithmetic is the
JAX module's, on numpy arrays or torch tensors alike (``_xp``): numpy in gives
numpy out, so that the dataset's worker threads never touch a device.

- ``ZScore``: (x - mean) / (std + 1e-8); ``LinearScale``: the affine map from
  [data_min, data_max] to [out_low, out_high]; ``LogTransform``: log(x + eps),
  eps = 0.01, then optional scaling in log space, with [log_min, log_max]
  expanded by buffer_frac x range per side; ``Compose``;

- ``ZScoreBack``: x (std + 1e-8) + mean;
- ``LinearScaleBack``: the affine map from [out_low, out_high] back to
  [data_min, data_max];
- ``LogBackTransform``: undo the log-space scaling (the [log_min, log_max]
  range expanded by buffer_frac / 2 per side, the JAX module's asymmetric
  convention), clamp to [clamp_log_min, clamp_log_max] and exponentiate;
  stats-built inverses clamp to the observed log min and max.

``build_back_transforms_from_stats`` gives the dict keyed ``{var}_hr``,
``{cond}_lr`` and ``generated``; ``back_transforms_for_config`` calls it as
``sbgm_danra_tpu/cli/entries.py:30-57`` does and returns ``{}``, with the same
warning, when the statistics are missing.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
from typing import Dict, Optional, Sequence

import numpy as np
import torch

logger = logging.getLogger(__name__)

_EPS = 1e-8
_LOG_TYPES = ("log", "log_01", "log_minus1_1", "log_zscore")


def _xp(x):
    """torch for tensors, numpy for arrays and scalars."""
    return torch if isinstance(x, torch.Tensor) else np


class Transform:
    """A callable array -> array."""

    def __call__(self, x):  # pragma: no cover - interface
        raise NotImplementedError


@dataclasses.dataclass(frozen=True)
class Identity(Transform):
    def __call__(self, x):
        return x


@dataclasses.dataclass(frozen=True)
class ZScore(Transform):
    """(x - mean) / (std + 1e-8)."""

    mean: float
    std: float

    def __call__(self, x):
        return (x - self.mean) / (self.std + _EPS)


@dataclasses.dataclass(frozen=True)
class ZScoreBack(Transform):
    mean: float
    std: float

    def __call__(self, x):
        return x * (self.std + _EPS) + self.mean


@dataclasses.dataclass(frozen=True)
class LinearScale(Transform):
    """Map [data_min, data_max] -> [out_low, out_high]."""

    out_low: float
    out_high: float
    data_min: float = 0.0
    data_max: float = 1.0

    def __call__(self, x):
        old_range = self.data_max - self.data_min
        new_range = self.out_high - self.out_low
        return ((x - self.data_min) * new_range) / old_range + self.out_low


@dataclasses.dataclass(frozen=True)
class LinearScaleBack(Transform):
    """Map [out_low, out_high] back to [data_min, data_max]."""

    out_low: float = 0.0
    out_high: float = 1.0
    data_min: float = 0.0
    data_max: float = 1.0

    def __call__(self, x):
        old_range = self.out_high - self.out_low
        new_range = self.data_max - self.data_min
        return ((x - self.out_low) * new_range) / old_range + self.data_min


def _check_log_params(t) -> None:
    if t.scale_type == "log_zscore":
        if t.log_mean is None or t.log_std is None:
            raise ValueError("log_zscore requires log_mean and log_std")
    elif t.scale_type in ("log_01", "log_minus1_1"):
        if t.log_min is None or t.log_max is None:
            raise ValueError(f"{t.scale_type} requires log_min and log_max")
    elif t.scale_type != "log":
        raise ValueError(f"Unknown log scale_type: {t.scale_type}")


def _expanded_log_range(log_min, log_max, frac):
    if log_min is None or log_max is None:
        return log_min, log_max
    rng = log_max - log_min
    return log_min - frac * rng, log_max + frac * rng


@dataclasses.dataclass(frozen=True)
class LogTransform(Transform):
    """log(x + eps), then optional scaling in log space ('log' | 'log_01' |
    'log_minus1_1' | 'log_zscore'); [log_min, log_max] expanded by
    buffer_frac x range per side."""

    scale_type: str = "log_zscore"
    eps: float = 0.01
    log_mean: Optional[float] = None
    log_std: Optional[float] = None
    log_min: Optional[float] = None
    log_max: Optional[float] = None
    buffer_frac: float = 0.5

    def __post_init__(self):
        _check_log_params(self)

    def __call__(self, x):
        logx = _xp(x).log(x + self.eps)
        if self.scale_type == "log_zscore":
            return (logx - self.log_mean) / (self.log_std + _EPS)
        lo, hi = _expanded_log_range(self.log_min, self.log_max, self.buffer_frac)
        if self.scale_type == "log_01":
            return (logx - lo) / (hi - lo)
        if self.scale_type == "log_minus1_1":
            return 2.0 * (logx - lo) / (hi - lo) - 1.0
        return logx  # 'log'


@dataclasses.dataclass(frozen=True)
class Compose(Transform):
    transforms: tuple

    def __call__(self, x):
        for t in self.transforms:
            x = t(x)
        return x


@dataclasses.dataclass(frozen=True)
class LogBackTransform(Transform):
    """Invert log-space scaling, clamp, exponentiate (see the module's notes)."""

    scale_type: str = "log_zscore"
    log_mean: Optional[float] = None
    log_std: Optional[float] = None
    log_min: Optional[float] = None
    log_max: Optional[float] = None
    buffer_frac: float = 0.5
    clamp_log_min: Optional[float] = None
    clamp_log_max: Optional[float] = None

    def __post_init__(self):
        _check_log_params(self)

    def _range(self):
        return _expanded_log_range(self.log_min, self.log_max, self.buffer_frac / 2.0)

    def __call__(self, x):
        if self.scale_type == "log_01":
            lo, hi = self._range()
            logx = x * (hi - lo) + lo
        elif self.scale_type == "log_zscore":
            logx = x * (self.log_std + _EPS) + self.log_mean
        elif self.scale_type == "log_minus1_1":
            lo, hi = self._range()
            logx = 0.5 * (x + 1.0) * (hi - lo) + lo
        else:  # 'log'
            logx = x
        clo = float("-inf") if self.clamp_log_min is None else float(self.clamp_log_min)
        chi = float("inf") if self.clamp_log_max is None else float(self.clamp_log_max)
        xp = _xp(logx)
        return xp.exp(xp.clip(logx, clo, chi))


def transform_from_stats(transform_type: str, stats, buffer_frac: float = 0.5) -> Transform:
    """The forward transform from a global-stats dict (mean/std/min/max and
    log_mean/log_std/log_min/log_max)."""
    if transform_type == "zscore":
        return ZScore(mean=stats["mean"], std=stats["std"])
    if transform_type in ("scale01", "01"):
        return LinearScale(0.0, 1.0, data_min=stats["min"], data_max=stats["max"])
    if transform_type == "scale_minus1_1":
        return LinearScale(-1.0, 1.0, data_min=stats["min"], data_max=stats["max"])
    if transform_type in _LOG_TYPES:
        return LogTransform(
            scale_type=transform_type, log_mean=stats["log_mean"], log_std=stats["log_std"],
            log_min=stats["log_min"], log_max=stats["log_max"], buffer_frac=buffer_frac,
        )
    if transform_type in (None, "none"):
        return Identity()
    raise ValueError(f"Unknown transform type: {transform_type}")


def back_transform_from_stats(transform_type: str, stats, buffer_frac: float = 0.5) -> Transform:
    """The inverse transform from a global-stats dict (mean/std/min/max and
    log_mean/log_std/log_min/log_max)."""
    if transform_type == "zscore":
        return ZScoreBack(mean=stats["mean"], std=stats["std"])
    if transform_type in ("scale01", "01"):
        return LinearScaleBack(0.0, 1.0, data_min=stats["min"], data_max=stats["max"])
    if transform_type == "scale_minus1_1":
        return LinearScaleBack(-1.0, 1.0, data_min=stats["min"], data_max=stats["max"])
    if transform_type in _LOG_TYPES:
        return LogBackTransform(
            scale_type=transform_type, log_mean=stats["log_mean"], log_std=stats["log_std"],
            log_min=stats["log_min"], log_max=stats["log_max"], buffer_frac=buffer_frac,
            clamp_log_min=stats["log_min"], clamp_log_max=stats["log_max"],
        )
    if transform_type in (None, "none"):
        return Identity()
    raise ValueError(f"Unknown transform type: {transform_type}")


def stats_path(root: str, model: str, variable: str, domain_str: str, crop_region_str: str,
               split: str) -> str:
    """Where the statistics pipeline writes a variable's global-stats JSON."""
    fname = (f"global_stats__{model}__{domain_str}__crop__{crop_region_str}"
             f"__{variable}__{split}.json")
    return os.path.join(root, model, variable, split, fname)


def load_global_stats(root: str, model: str, variable: str, domain_str: str,
                      crop_region_str: str, split: str) -> Optional[Dict[str, float]]:
    """A variable's global-stats dict, or None where the file is missing."""
    path = stats_path(root, model, variable, domain_str, crop_region_str, split)
    if not os.path.exists(path):
        return None
    with open(path, "r") as f:
        return json.load(f)


def _load_required_stats(root, model, variable, domain_str, crop_region_str, split):
    stats = load_global_stats(root, model, variable, domain_str, crop_region_str, split)
    if stats is None:
        path = stats_path(root, model, variable, domain_str, crop_region_str, split)
        raise FileNotFoundError(f"Global stats not found: {path} — run the statistics "
                                "pipeline first (sbgm_danra_tpu.pipelines.stats_pipeline).")
    return stats


def build_back_transforms_from_stats(
    hr_var: str, hr_model: str, domain_str_hr: str, crop_region_str_hr: str,
    hr_scaling_method: str, hr_buffer_frac: float, lr_vars: Sequence[str], lr_model: str,
    domain_str_lr: str, crop_region_str_lr: str, lr_scaling_methods: Sequence[str],
    lr_buffer_frac: float, split: str, stats_dir_root: str,
) -> Dict[str, Transform]:
    """Inverse transforms keyed '{var}_hr', '{cond}_lr' and 'generated' (the HR
    target's space); raises ``FileNotFoundError`` on a missing stats file."""
    hr_stats = _load_required_stats(stats_dir_root, hr_model, hr_var, domain_str_hr,
                                    crop_region_str_hr, split)
    inv_hr = back_transform_from_stats(hr_scaling_method, hr_stats, hr_buffer_frac)
    bt: Dict[str, Transform] = {f"{hr_var}_hr": inv_hr, "generated": inv_hr}
    for cond, method in zip(lr_vars, lr_scaling_methods):
        lr_stats = _load_required_stats(stats_dir_root, lr_model, cond, domain_str_lr,
                                        crop_region_str_lr, split)
        bt[f"{cond}_lr"] = back_transform_from_stats(method, lr_stats, lr_buffer_frac)
    return bt


def back_transforms_for_config(cfg) -> Dict[str, Transform]:
    """The run config's back-transforms, read as the JAX CLI reads them; ``{}``
    with a warning when the statistics files are missing."""
    hr, lr = cfg.highres, cfg.lowres
    cutouts = cfg.transforms.sample_w_cutouts

    def crop(domains):
        return "_".join(map(str, domains)) if (cutouts and domains) else "full"

    try:
        return build_back_transforms_from_stats(
            hr_var=hr.variable, hr_model=hr.model,
            domain_str_hr=f"{hr.full_domain_dims[0]}x{hr.full_domain_dims[1]}",
            crop_region_str_hr=crop(hr.cutout_domains), hr_scaling_method=hr.scaling_method,
            hr_buffer_frac=hr.buffer_frac, lr_vars=list(lr.condition_variables or ()),
            lr_model=lr.model,
            domain_str_lr=f"{lr.full_domain_dims[0]}x{lr.full_domain_dims[1]}",
            crop_region_str_lr=crop(lr.cutout_domains),
            lr_scaling_methods=list(lr.scaling_methods or ()), lr_buffer_frac=lr.buffer_frac,
            split="all", stats_dir_root=cfg.paths.stats_load_dir,
        )
    except FileNotFoundError as e:
        logger.warning("Back transforms unavailable (%s); proceeding without.", e)
        return {}

"""HR <-> LR correlation analysis (a copy of
``sbgm_danra_tpu/pipelines/correlations.py``).

Per (HR variable, LR variable) pair on their shared dates, optionally through
a transform per variable:

- the temporal correlation of the domain-mean daily series, Pearson or
  Spearman;
- the per-pixel correlation over time, as one vectorised covariance
  computation.
"""

from __future__ import annotations

import logging
from typing import Dict, Optional, Sequence

import numpy as np

from sbgm_danra_tpu_torch.data import zarrlite
from sbgm_danra_tpu_torch.data.dataset import extract_2d
from sbgm_danra_tpu_torch.utils.dates import file_date
from sbgm_danra_tpu_torch.utils.units import correct_variable_units

logger = logging.getLogger(__name__)


def _rank(x: np.ndarray) -> np.ndarray:
    order = np.argsort(x)
    ranks = np.empty_like(order, dtype=np.float64)
    ranks[order] = np.arange(len(x))
    return ranks


def compute_temporal_correlation(
    series_a: np.ndarray, series_b: np.ndarray, method: str = "pearson"
) -> float:
    """Correlation of two daily domain-mean series."""
    a = np.asarray(series_a, np.float64)
    b = np.asarray(series_b, np.float64)
    if method == "spearman":
        a, b = _rank(a), _rank(b)
    elif method != "pearson":
        raise ValueError(f"Unknown method: {method}")
    return float(np.corrcoef(a, b)[0, 1])


def compute_spatial_correlation(
    fields_a: np.ndarray, fields_b: np.ndarray, method: str = "pearson"
) -> np.ndarray:
    """Per-pixel correlation over the time axis of (T, H, W) fields: one pass
    of centred cross-products; NaN where a pixel's series is constant."""
    a = np.asarray(fields_a, np.float64)
    b = np.asarray(fields_b, np.float64)
    if method == "spearman":
        a = np.apply_along_axis(_rank, 0, a)
        b = np.apply_along_axis(_rank, 0, b)
    a = a - a.mean(axis=0)
    b = b - b.mean(axis=0)
    num = (a * b).mean(axis=0)
    den = a.std(axis=0) * b.std(axis=0)
    with np.errstate(invalid="ignore", divide="ignore"):
        corr = num / den
    return np.where(den > 0, corr, np.nan)


def run_correlations(
    hr_store: str,
    lr_store: str,
    hr_variable: str,
    lr_variable: str,
    hr_model: str = "DANRA",
    lr_model: str = "ERA5",
    crop: Optional[Sequence[int]] = None,
    transforms: Optional[Dict[str, object]] = None,
    methods: Sequence[str] = ("pearson", "spearman"),
    max_days: Optional[int] = None,
) -> Dict[str, object]:
    """The pair's analysis on their common dates; also returns the two
    domain-mean series, which the correlation figures plot."""
    g_hr, g_lr = zarrlite.open_group(hr_store), zarrlite.open_group(lr_store)
    map_hr = {file_date(k): k for k in g_hr.keys()}
    map_lr = {file_date(k): k for k in g_lr.keys()}
    dates = sorted(set(map_hr) & set(map_lr))
    if max_days:
        dates = dates[:max_days]
    if not dates:
        raise ValueError("No common dates between HR and LR stores")

    def load(g, m, var, model, d):
        f = correct_variable_units(var, model, extract_2d(g, m[d], var))
        if crop is not None:
            x1, x2, y1, y2 = crop
            f = f[x1:x2, y1:y2]
        if transforms and var in transforms:
            f = np.asarray(transforms[var](f), np.float32)
        return f

    hr = np.stack([load(g_hr, map_hr, hr_variable, hr_model, d) for d in dates])
    lr = np.stack([load(g_lr, map_lr, lr_variable, lr_model, d) for d in dates])

    out: Dict[str, object] = {"dates": dates, "n_days": len(dates)}
    mean_hr = hr.mean(axis=(1, 2))
    mean_lr = lr.mean(axis=(1, 2))
    out["mean_series_hr"] = mean_hr
    out["mean_series_lr"] = mean_lr
    for method in methods:
        out[f"temporal_{method}"] = compute_temporal_correlation(mean_hr, mean_lr, method)
        out[f"spatial_{method}"] = compute_spatial_correlation(hr, lr, method)
    return out

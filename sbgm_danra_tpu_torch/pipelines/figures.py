"""Data-analysis figures: per-variable statistics and correlation plots (a
copy of ``sbgm_danra_tpu/pipelines/figures.py``).

The statistics series are computed by streaming over the store (one field in
memory at a time, a bounded pixel reservoir for the pooled histogram), so the
figures scale to a full archive. matplotlib is imported inside each figure
function (``utils/plotting.pyplot``, Agg).
"""

from __future__ import annotations

import logging
import os
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from sbgm_danra_tpu_torch.data import zarrlite
from sbgm_danra_tpu_torch.data.dataset import extract_2d
from sbgm_danra_tpu_torch.utils.dates import file_date
from sbgm_danra_tpu_torch.utils.plotting import pyplot
from sbgm_danra_tpu_torch.utils.units import VARIABLE_REGISTRY, correct_variable_units

logger = logging.getLogger(__name__)


def _meta(var: str) -> Tuple[str, str]:
    info = VARIABLE_REGISTRY.get(var, {})
    return info.get("unit", ""), info.get("cmap", "viridis")


def per_timestep_series(
    store: str,
    var: str,
    model: str,
    crop: Optional[Sequence[int]] = None,
    max_days: Optional[int] = None,
    pool_pixels: int = 200_000,
    seed: int = 0,
) -> Dict[str, np.ndarray]:
    """Stream the store once: daily stats series + a bounded pixel reservoir.

    Returns {dates, mean, std, min, max, median, p25, p75, pooled, example,
    example_date}; ``pooled`` is a uniform pixel subsample across all days.
    """
    group = zarrlite.open_group(store)
    keys = sorted(group.keys())
    if max_days:
        keys = keys[:max_days]
    rng = np.random.default_rng(seed)
    series: Dict[str, list] = {
        k: [] for k in ("mean", "std", "min", "max", "median", "p25", "p75")
    }
    dates, pool = [], []
    per_day = max(1, pool_pixels // max(len(keys), 1))
    example, example_date = None, None
    for key in keys:
        field = correct_variable_units(var, model, extract_2d(group, key, var))
        if crop is not None:
            x1, x2, y1, y2 = crop
            field = field[x1:x2, y1:y2]
        flat = field.ravel()
        dates.append(file_date(key))
        series["mean"].append(flat.mean())
        series["std"].append(flat.std())
        series["min"].append(flat.min())
        series["max"].append(flat.max())
        q = np.percentile(flat, (25, 50, 75))
        series["p25"].append(q[0])
        series["median"].append(q[1])
        series["p75"].append(q[2])
        pool.append(rng.choice(flat, size=min(per_day, flat.size), replace=False))
        if example is None:
            example, example_date = field, dates[-1]
    out: Dict[str, np.ndarray] = {k: np.asarray(v) for k, v in series.items()}
    out["dates"] = np.asarray(dates)
    out["pooled"] = np.concatenate(pool) if pool else np.empty((0,))
    out["example"] = example
    out["example_date"] = example_date
    return out


def plot_variable_statistics(
    var: str,
    model: str,
    series: Dict[str, np.ndarray],
    out_dir: str,
    suffix: str = "daily",
) -> Dict[str, str]:
    """Write the per-variable statistics figures; returns their paths."""
    plt = pyplot()
    os.makedirs(out_dir, exist_ok=True)
    unit, cmap = _meta(var)
    t = np.arange(len(series["dates"]))
    written = {}

    # 1. field example
    if series.get("example") is not None:
        fig, ax = plt.subplots(figsize=(6, 5))
        im = ax.imshow(series["example"], cmap=cmap)
        ax.invert_yaxis()
        ax.set_title(f"{model} {var} on {series['example_date']}")
        fig.colorbar(im, ax=ax, label=unit)
        path = os.path.join(out_dir, f"field_example_{model}_{var}.png")
        fig.savefig(path, dpi=150)
        plt.close(fig)
        written["field_example"] = path

    # 2. mean +- std time series
    fig, ax = plt.subplots(figsize=(10, 5))
    ax.plot(t, series["mean"], color="k", lw=1, alpha=0.8)
    ax.fill_between(
        t, series["mean"] - series["std"], series["mean"] + series["std"],
        alpha=0.25, color="k", label="mean ± std",
    )
    ax.set_title(f"{model} {var}: daily mean ± std")
    ax.set_xlabel("day index")
    ax.set_ylabel(f"{var} ({unit})")
    ax.legend()
    path = os.path.join(out_dir, f"mean_std_time_series_{model}_{var}_{suffix}.png")
    fig.savefig(path, dpi=150)
    plt.close(fig)
    written["mean_std_time_series"] = path

    # 3. per-stat panels
    keys = [k for k in ("mean", "std", "min", "max", "median", "p25", "p75") if k in series]
    n_cols, n_rows = 2, (len(keys) + 1) // 2
    fig, axs = plt.subplots(n_rows, n_cols, figsize=(12, 3 * n_rows),
                            constrained_layout=True)
    axs = np.atleast_1d(axs).ravel()
    for ax, k in zip(axs, keys):
        ax.plot(t, series[k], alpha=0.85)
        ax.set_title(f"{var} {k}")
        ax.grid(True, alpha=0.4)
    for ax in axs[len(keys):]:
        fig.delaxes(ax)
    path = os.path.join(out_dir, f"stats_panels_{model}_{var}_{suffix}.png")
    fig.savefig(path, dpi=150)
    plt.close(fig)
    written["stats_panels"] = path

    # 4. pooled pixel histogram (linear + log-count)
    pooled = series.get("pooled")
    if pooled is not None and pooled.size:
        fig, axs = plt.subplots(1, 2, figsize=(11, 4), constrained_layout=True)
        for ax, log in zip(axs, (False, True)):
            ax.hist(pooled, bins=100, log=log, alpha=0.85)
            ax.set_xlabel(f"{var} ({unit})")
            ax.set_ylabel("count (log)" if log else "count")
        fig.suptitle(f"{model} {var}: pooled pixel distribution")
        path = os.path.join(out_dir, f"histogram_pixels_{model}_{var}_{suffix}.png")
        fig.savefig(path, dpi=150)
        plt.close(fig)
        written["histogram_pixels"] = path

    # 5. histograms of the daily stats
    fig, axs = plt.subplots(1, len(keys), figsize=(3 * len(keys), 3),
                            constrained_layout=True)
    for ax, k in zip(np.atleast_1d(axs).ravel(), keys):
        ax.hist(series[k], bins=30, alpha=0.85)
        ax.set_title(k)
    fig.suptitle(f"{model} {var}: distribution of daily statistics")
    path = os.path.join(out_dir, f"histogram_time_series_{model}_{var}_{suffix}.png")
    fig.savefig(path, dpi=150)
    plt.close(fig)
    written["histogram_time_series"] = path

    logger.info("statistics figures for %s/%s -> %s", model, var, out_dir)
    return written


def plot_correlation_figures(
    result: Dict[str, object],
    hr_var: str,
    lr_var: str,
    hr_model: str,
    lr_model: str,
    out_dir: str,
) -> Dict[str, str]:
    """The temporal-series figure and the spatial correlation maps of a
    ``pipelines.correlations.run_correlations`` result."""
    plt = pyplot()
    os.makedirs(out_dir, exist_ok=True)
    written = {}
    pair = f"{hr_model}_{hr_var}_vs_{lr_model}_{lr_var}"

    mean_hr = result.get("mean_series_hr")
    mean_lr = result.get("mean_series_lr")
    if mean_hr is not None and mean_lr is not None:
        t = np.arange(len(mean_hr))
        fig, ax = plt.subplots(figsize=(11, 5))
        ax.plot(t, mean_hr, label=f"{hr_var} ({hr_model})", marker="o", ms=2.5)
        ax.plot(t, mean_lr, label=f"{lr_var} ({lr_model})", marker="x", ms=2.5)
        corr = result.get("temporal_pearson")
        if corr is not None:
            ax.text(0.03, 0.95, f"pearson r = {corr:.3f}", transform=ax.transAxes,
                    va="top", bbox=dict(boxstyle="round", fc="wheat", alpha=0.6))
        ax.set_xlabel("day index")
        ax.set_ylabel("domain mean")
        ax.set_title(f"Temporal correlation: {hr_var} ({hr_model}) vs {lr_var} ({lr_model})")
        ax.legend()
        ax.grid(True, alpha=0.4)
        path = os.path.join(out_dir, f"temporal_series_{pair}.png")
        fig.savefig(path, dpi=150)
        plt.close(fig)
        written["temporal_series"] = path

    for method in ("pearson", "spearman"):
        cmap_key = f"spatial_{method}"
        corr_map = result.get(cmap_key)
        if corr_map is None:
            continue
        fig, ax = plt.subplots(figsize=(8, 6))
        im = ax.imshow(np.asarray(corr_map), cmap="RdBu_r", vmin=-1, vmax=1)
        ax.invert_yaxis()
        ax.set_title(f"Spatial {method} correlation: {hr_var} vs {lr_var}")
        fig.colorbar(im, ax=ax, label="correlation coefficient")
        path = os.path.join(out_dir, f"correlation_map_{method}_{pair}.png")
        fig.savefig(path, dpi=150)
        plt.close(fig)
        written[cmap_key] = path
    logger.info("correlation figures for %s -> %s", pair, out_dir)
    return written

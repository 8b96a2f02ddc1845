"""Figures (a copy of ``sbgm_danra_tpu/utils/plotting.py``): conditions, truth
and generated grids, pixel and error histograms, the batch grid, loss curves
and single fields.

matplotlib is imported inside each figure function, on the Agg backend, never
when the module is imported: the card machine has no matplotlib.
``plot_or_skip`` is what the entry points call: the figure, or one log line
saying it was skipped where matplotlib is missing.
"""

from __future__ import annotations

import logging
from typing import Callable, Dict, Optional

import numpy as np

from sbgm_danra_tpu_torch.utils.units import VARIABLE_REGISTRY

logger = logging.getLogger(__name__)


def pyplot():
    """matplotlib's pyplot on the Agg backend (ImportError without matplotlib)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def plot_or_skip(name: str, fn: Callable, *args, **kwargs):
    """``fn(*args, **kwargs)``; where matplotlib cannot be imported, one log
    line ("figure <name> skipped: matplotlib missing") and None."""
    try:
        import matplotlib  # noqa: F401
    except ImportError:
        logger.info("figure %s skipped: matplotlib missing", name)
        return None
    return fn(*args, **kwargs)


def _save(fig, path: Optional[str], dpi: int = 150):
    """With ``path``: the figure written there and closed."""
    if path:
        fig.savefig(path, dpi=dpi)
        pyplot().close(fig)
    return fig


def _squeeze_geo(value: np.ndarray) -> np.ndarray:
    """Strip the CFG mask channel from a value||mask geo map."""
    v = np.asarray(value)
    if v.ndim == 3 and v.shape[-1] in (1, 2):
        return v[..., 0]
    return v


def plot_samples_and_generated(batch: Dict, generated: np.ndarray, cfg=None,
                               path: Optional[str] = None, dpi: int = 150):
    """Rows: LR conditions, geo, HR truth, generated; columns: samples."""
    plt = pyplot()
    x = np.asarray(batch["x"])
    n = min(x.shape[0], 8)
    rows = [("truth", x[..., 0]), ("generated", np.asarray(generated))]
    cond = batch.get("cond_img")
    if cond is not None:
        cond = np.asarray(cond)
        for c in range(cond.shape[-1]):
            rows.insert(0, (f"cond{c}", cond[..., c]))
    for geo_key in ("lsm_cond", "topo_cond"):
        if batch.get(geo_key) is not None:
            rows.insert(-2, (geo_key, np.stack([_squeeze_geo(v)
                                                for v in np.asarray(batch[geo_key])])))
    fig, axes = plt.subplots(len(rows), n, figsize=(2.2 * n, 2.2 * len(rows)), squeeze=False)
    for r, (name, data) in enumerate(rows):
        for i in range(n):
            img = data[min(i, data.shape[0] - 1)]
            axes[r][i].imshow(img)
            if i == 0:
                axes[r][i].set_ylabel(name, fontsize=8)
            axes[r][i].set_xticks([])
            axes[r][i].set_yticks([])
    fig.tight_layout()
    return _save(fig, path, dpi)


def plot_pixel_histograms(gen: np.ndarray, ref: np.ndarray, unit: str = "",
                          path: Optional[str] = None):
    """Pooled pixel values of the generated fields and the truth, with mean
    lines and the bias in the title."""
    plt = pyplot()
    gen = np.asarray(gen).ravel()
    ref = np.asarray(ref).ravel()
    fig, ax = plt.subplots(figsize=(8, 4))
    ax.hist(gen, bins=50, alpha=0.5, label="Generated")
    ax.hist(ref, bins=50, alpha=0.5, color="r", label="Eval")
    gm, rm = float(np.nanmean(gen)), float(np.nanmean(ref))
    ax.axvline(rm, color="r", alpha=0.5, linestyle="--", label=f"Eval mean, {rm:.2f}")
    ax.axvline(gm, color="b", alpha=0.5, linestyle="--", label=f"Generated mean, {gm:.2f}")
    ax.set_title(f"Distribution of generated and eval images, bias: {gm - rm:.2f}")
    ax.set_xlabel(f"Pixel value {f'[{unit}]' if unit else ''}")
    ax.set_ylabel("Count")
    ax.legend()
    fig.tight_layout()
    return _save(fig, path)


def plot_error_histograms(abs_err: np.ndarray, rmse: np.ndarray, path: Optional[str] = None):
    """Two panels: per-pixel RMSE and MAE histograms over all samples."""
    plt = pyplot()
    fig, axs = plt.subplots(2, 1, figsize=(12, 6))
    axs[0].hist(np.asarray(rmse).ravel(), bins=150, alpha=0.7, edgecolor="k")
    axs[0].set_title("RMSE for all pixels")
    axs[0].set_ylabel("Count")
    axs[1].hist(np.asarray(abs_err).ravel(), bins=70, alpha=0.7, edgecolor="k")
    axs[1].set_title("MAE for all pixels")
    axs[1].set_xlabel("Error")
    axs[1].set_ylabel("Count")
    fig.tight_layout()
    return _save(fig, path)


_GRID_CMAPS = {"lsm": "binary", "topo": "terrain", "sdf": "coolwarm"}


def plot_batch_grid(batch: Dict, hr_var: str = "temp", n_samples: int = 3,
                    path: Optional[str] = None):
    """Rows: samples; columns: the batch's keys (HR, LR conditions, geo, SDF),
    each with its colormap."""
    plt = pyplot()
    keys = []
    hr_key = f"{hr_var}_hr"
    if hr_key in batch:
        keys.append(hr_key)
    keys += sorted(k for k in batch if k.endswith("_lr"))
    keys += [k for k in ("lsm", "topo", "sdf") if k in batch]
    if not keys:
        raise ValueError("no plottable keys in batch")
    n = min(n_samples, len(np.asarray(batch[keys[0]])))
    fig, axes = plt.subplots(n, len(keys), figsize=(2.4 * len(keys), 2.4 * n), squeeze=False)
    for c, key in enumerate(keys):
        data = np.asarray(batch[key])
        base = key.replace("_hr", "").replace("_lr", "")
        cmap = _GRID_CMAPS.get(base) or cmap_for(base)
        for r in range(n):
            img = _squeeze_geo(data[min(r, data.shape[0] - 1)])
            axes[r][c].imshow(np.asarray(img).squeeze(), cmap=cmap)
            if r == 0:
                axes[r][c].set_title(key, fontsize=9)
            axes[r][c].set_xticks([])
            axes[r][c].set_yticks([])
    fig.tight_layout()
    return _save(fig, path)


def plot_losses(history: Dict, path: Optional[str] = None):
    """Train and validation loss curves."""
    plt = pyplot()
    fig, ax = plt.subplots(figsize=(6, 4))
    for key in ("train_loss", "val_loss"):
        if history.get(key):
            ax.plot(history[key], label=key)
    ax.set_xlabel("epoch")
    ax.set_ylabel("DSM loss")
    ax.set_yscale("log")
    ax.legend()
    fig.tight_layout()
    return _save(fig, path)


def cmap_for(var: str) -> str:
    return VARIABLE_REGISTRY.get(var, {}).get("cmap", "viridis")


def plot_sample(field: np.ndarray, var: str = "temp", lsm: Optional[np.ndarray] = None,
                mask_ocean: bool = False, title: Optional[str] = None,
                path: Optional[str] = None):
    """One field with a colorbar, the ocean optionally masked."""
    plt = pyplot()
    field = np.asarray(field).squeeze()
    if mask_ocean and lsm is not None:
        field = np.where(np.asarray(lsm).squeeze() > 0.5, field, np.nan)
    fig, ax = plt.subplots(figsize=(5, 4))
    im = ax.imshow(field, cmap=cmap_for(var))
    unit = VARIABLE_REGISTRY.get(var, {}).get("unit", "")
    fig.colorbar(im, ax=ax, label=unit)
    ax.set_title(title or VARIABLE_REGISTRY.get(var, {}).get("long_name", var))
    ax.set_xticks([])
    ax.set_yticks([])
    fig.tight_layout()
    return _save(fig, path)


def plot_sample_with_boxplot(field: np.ndarray, var: str = "temp",
                             lsm: Optional[np.ndarray] = None, mask_ocean: bool = False,
                             path: Optional[str] = None):
    """The field's map beside a boxplot of its values."""
    plt = pyplot()
    field = np.asarray(field).squeeze()
    values = field
    if mask_ocean and lsm is not None:
        masked = np.where(np.asarray(lsm).squeeze() > 0.5, field, np.nan)
        values = masked[np.isfinite(masked)]
        field = masked
    fig, (ax_map, ax_box) = plt.subplots(1, 2, figsize=(8, 4),
                                         gridspec_kw={"width_ratios": [3, 1]})
    im = ax_map.imshow(field, cmap=cmap_for(var))
    fig.colorbar(im, ax=ax_map, label=VARIABLE_REGISTRY.get(var, {}).get("unit", ""))
    ax_map.set_xticks([])
    ax_map.set_yticks([])
    flat = np.asarray(values).ravel()
    ax_box.boxplot(flat[~np.isnan(flat)])
    ax_box.set_xticks([])
    fig.tight_layout()
    return _save(fig, path)

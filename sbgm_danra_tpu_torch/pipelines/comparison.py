"""Comparison of two datasets: radially averaged 2-D power spectra, single-day
fields, daily bias / RMSE / correlation series, and ``run_comparison`` over
two stores with seasonal spectra (a numpy copy of
``sbgm_danra_tpu/pipelines/comparison.py``).

The spectrum answers whether a field carries realistic variance at fine
wavelengths or is blurry; ``Evaluation.power_spectrum_comparison`` reads it
for generated fields, ``run_comparison`` for two stores (DANRA against ERA5).
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from sbgm_danra_tpu_torch.data import zarrlite
from sbgm_danra_tpu_torch.data.dataset import extract_2d
from sbgm_danra_tpu_torch.utils.dates import file_date, season_of
from sbgm_danra_tpu_torch.utils.units import correct_variable_units

logger = logging.getLogger(__name__)


def compute_2d_power_spectrum(field: np.ndarray) -> np.ndarray:
    """|FFT2|^2, zero frequency centred."""
    f = np.fft.fftshift(np.fft.fft2(np.asarray(field, dtype=np.float64)))
    return np.abs(f) ** 2


def radial_average(power: np.ndarray) -> np.ndarray:
    """Mean power in integer radial wavenumber bins."""
    h, w = power.shape
    cy, cx = h // 2, w // 2
    yy, xx = np.ogrid[:h, :w]
    r = np.sqrt((yy - cy) ** 2 + (xx - cx) ** 2).astype(np.int64)
    n_bins = r.max() + 1
    sums = np.bincount(r.ravel(), weights=power.ravel(), minlength=n_bins)
    counts = np.bincount(r.ravel(), minlength=n_bins)
    return sums / np.maximum(counts, 1)


def spectrum_of_fields(fields: Sequence[np.ndarray]) -> np.ndarray:
    """Mean radial spectrum over a set of days."""
    spectra = [radial_average(compute_2d_power_spectrum(f)) for f in fields]
    n = min(len(s) for s in spectra)
    return np.mean([s[:n] for s in spectra], axis=0)


@dataclasses.dataclass
class SpectrumComparison:
    wavelengths: np.ndarray  # km (or grid units * dx)
    spectrum_a: np.ndarray
    spectrum_b: np.ndarray
    mse: float
    log_mse: float
    ratio: np.ndarray

    def as_dict(self) -> Dict[str, np.ndarray]:
        return dataclasses.asdict(self)


def compare_power_spectra(
    fields_a: Sequence[np.ndarray],
    fields_b: Sequence[np.ndarray],
    dx_km: float = 2.5,
) -> SpectrumComparison:
    """Radial-spectrum comparison on the wavelength axis lambda_k = n dx / k,
    with MSE, log-MSE and ratio metrics (the DC bin left out of the metrics)."""
    sa = spectrum_of_fields(fields_a)
    sb = spectrum_of_fields(fields_b)
    n = min(len(sa), len(sb))
    sa, sb = sa[:n], sb[:n]
    nx = max(fields_a[0].shape)
    k = np.arange(n)
    with np.errstate(divide="ignore"):
        wavelengths = np.where(k > 0, nx * dx_km / np.maximum(k, 1), np.inf)
    valid = slice(1, None)
    mse = float(np.mean((sa[valid] - sb[valid]) ** 2))
    log_mse = float(
        np.mean((np.log10(sa[valid] + 1e-30) - np.log10(sb[valid] + 1e-30)) ** 2)
    )
    ratio = sa / np.maximum(sb, 1e-30)
    return SpectrumComparison(wavelengths, sa, sb, mse, log_mse, ratio)


def _safe_corr(a: np.ndarray, b: np.ndarray) -> float:
    """Pearson r of the flattened fields; NaN (without numpy's divide warning)
    where either field is constant, since the correlation is undefined there."""
    a = np.ravel(np.asarray(a, np.float64))
    b = np.ravel(np.asarray(b, np.float64))
    if a.std() == 0.0 or b.std() == 0.0:
        return float("nan")
    return float(np.corrcoef(a, b)[0, 1])


def compare_fields(a: np.ndarray, b: np.ndarray) -> Dict[str, object]:
    """Single-day statistics and the difference map."""
    diff = np.asarray(a, np.float64) - np.asarray(b, np.float64)
    return {
        "mean_a": float(np.mean(a)),
        "mean_b": float(np.mean(b)),
        "std_a": float(np.std(a)),
        "std_b": float(np.std(b)),
        "bias": float(diff.mean()),
        "rmse": float(np.sqrt((diff**2).mean())),
        "mae": float(np.abs(diff).mean()),
        "corr": _safe_corr(a, b),
        "diff_map": diff,
    }


def compare_timeseries(
    fields_a: Sequence[np.ndarray], fields_b: Sequence[np.ndarray]
) -> Dict[str, np.ndarray]:
    """Daily bias, RMSE and correlation series."""
    bias, rmse, corr = [], [], []
    for a, b in zip(fields_a, fields_b):
        d = np.asarray(a, np.float64) - np.asarray(b, np.float64)
        bias.append(d.mean())
        rmse.append(np.sqrt((d**2).mean()))
        corr.append(_safe_corr(a, b))
    return {
        "bias": np.asarray(bias),
        "rmse": np.asarray(rmse),
        "corr": np.asarray(corr),
    }


def _load_common(
    store_a: str, store_b: str, var: str, model_a: str, model_b: str,
    crop: Optional[Sequence[int]] = None, max_days: Optional[int] = None,
) -> Tuple[List[str], List[np.ndarray], List[np.ndarray]]:
    ga, gb = zarrlite.open_group(store_a), zarrlite.open_group(store_b)
    map_a = {file_date(k): k for k in ga.keys()}
    map_b = {file_date(k): k for k in gb.keys()}
    dates = sorted(set(map_a) & set(map_b))
    if max_days:
        dates = dates[:max_days]

    def load(g, m, model, date):
        f = correct_variable_units(var, model, extract_2d(g, m[date], var))
        if crop is not None:
            x1, x2, y1, y2 = crop
            f = f[x1:x2, y1:y2]
        return f

    fa = [load(ga, map_a, model_a, d) for d in dates]
    fb = [load(gb, map_b, model_b, d) for d in dates]
    return dates, fa, fb


def run_comparison(
    store_a: str,
    store_b: str,
    variable: str,
    model_a: str = "DANRA",
    model_b: str = "ERA5",
    modes: Sequence[str] = ("field", "timeseries", "distribution"),
    crop: Optional[Sequence[int]] = None,
    dx_km: float = 2.5,
    by_season: bool = False,
    max_days: Optional[int] = None,
) -> Dict[str, object]:
    """Compare two stores of the same variable on their common dates; with
    ``by_season`` also the spectra of each season with at least two days."""
    dates, fa, fb = _load_common(store_a, store_b, variable, model_a, model_b, crop, max_days)
    if not dates:
        raise ValueError("No common dates between the stores")
    out: Dict[str, object] = {"dates": dates}
    if "field" in modes:
        out["field"] = compare_fields(fa[0], fb[0])
    if "timeseries" in modes:
        out["timeseries"] = compare_timeseries(fa, fb)
    if "distribution" in modes:
        out["spectrum"] = compare_power_spectra(fa, fb, dx_km).as_dict()
        out["histogram"] = {
            "values_a": np.concatenate([f.ravel() for f in fa]),
            "values_b": np.concatenate([f.ravel() for f in fb]),
        }
    if by_season:
        seasons: Dict[int, object] = {}
        for s in (1, 2, 3, 4):
            idx = [i for i, d in enumerate(dates) if season_of(d) == s]
            if len(idx) >= 2:
                seasons[s] = compare_power_spectra(
                    [fa[i] for i in idx], [fb[i] for i in idx], dx_km
                ).as_dict()
        out["seasonal_spectra"] = seasons
    return out

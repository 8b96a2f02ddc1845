"""Radially averaged 2-D power spectra (a numpy copy of the spectrum
estimator of ``sbgm_danra_tpu/pipelines/comparison.py:33-98``): does a
generated field carry realistic variance at fine wavelengths, or is it
blurry? ``Evaluation.power_spectrum_comparison`` reads it. The rest of that
module (field and time-series comparison of the stores, ``run_comparison``)
is not ported (ROADMAP Queue 1 item 5).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Sequence

import numpy as np


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

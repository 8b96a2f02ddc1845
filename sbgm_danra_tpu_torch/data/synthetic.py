"""Synthetic DANRA/ERA5-like dataset generator (a copy of
``sbgm_danra_tpu/data/synthetic.py``: the same seed writes the same files).

The reference ships only placeholder data (data_examples/*/test_file.txt), so
tests, smoke runs and benchmarks need a generator that produces physically
plausible fields in the exact on-disk layout the loaders expect:

- smooth spatially correlated daily fields (FFT low-pass noise + seasonal
  cycle) for temperature; log-normal sparse fields for precipitation;
- the LR (ERA5) field is a blurred version of the HR (DANRA) field plus noise,
  so there is a real downscaling signal to learn;
- a synthetic land-sea mask and topography over the full domain;
- zarr stores at data_{MODEL}/size_{HxW}/{var}_{HxW}/zarr_files/{split}.zarr
  with one group per day (named {var}_{HxW}_{YYYYMMDD}, array key 'data');
- global-stats JSONs in the layout the transform factories read.

Temperature is stored in Kelvin and ERA5 precipitation in meters so the
unit-correction path (``utils/units.py``) is exercised end to end.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

logger = logging.getLogger(__name__)

from sbgm_danra_tpu_torch import transforms as T
from sbgm_danra_tpu_torch.data import zarrlite
from sbgm_danra_tpu_torch.data.paths import build_data_path, lsm_path, topo_path
from sbgm_danra_tpu_torch.utils.units import correct_variable_units


def smooth_noise(rng: np.random.Generator, shape: Tuple[int, int], corr: float = 0.15):
    """Spatially correlated Gaussian field via FFT low-pass filtering."""
    h, w = shape
    white = rng.normal(size=shape)
    fy = np.fft.fftfreq(h)[:, None]
    fx = np.fft.fftfreq(w)[None, :]
    filt = np.exp(-((fy**2 + fx**2) / (2 * corr**2)))
    field = np.fft.ifft2(np.fft.fft2(white) * filt).real
    std = field.std()
    return (field / std if std > 0 else field).astype(np.float32)


def make_geography(rng: np.random.Generator, shape: Tuple[int, int]):
    """Synthetic land-sea mask (threshold of smooth noise) + topography."""
    base = smooth_noise(rng, shape, corr=0.06)
    lsm = (base > -0.1).astype(np.float32)
    topo = np.where(lsm > 0, 50.0 + 400.0 * np.maximum(base, 0) ** 1.5, 0.0)
    topo = topo + 5.0 * smooth_noise(rng, shape, corr=0.3) * lsm
    return lsm, topo.astype(np.float32)


def _blur(field: np.ndarray, factor: int = 4) -> np.ndarray:
    """Box blur: average-pool factor x factor blocks, bilinear upsample back.

    Mimics the ~12x resolution gap between ERA5 (~31 km) and DANRA (2.5 km)
    while keeping the large-scale structure intact.
    """
    from sbgm_danra_tpu_torch.ops.resize import resize_bilinear

    h, w = field.shape
    hp, wp = -(-h // factor) * factor, -(-w // factor) * factor
    padded = np.pad(field, ((0, hp - h), (0, wp - w)), mode="edge")
    small = padded.reshape(hp // factor, factor, wp // factor, factor).mean(axis=(1, 3))
    return resize_bilinear(small, (hp, wp))[:h, :w]


def daily_fields(
    rng: np.random.Generator,
    date: str,
    shape: Tuple[int, int],
    topo: np.ndarray,
    variables: Sequence[str] = ("temp", "prcp"),
) -> Dict[str, Dict[str, np.ndarray]]:
    """One day of HR (DANRA) + LR (ERA5) fields in raw storage units.

    Covers the full all-channels variable set of the reference
    (full_run_all_data_config.yaml:47-56): temp/prcp plus cape, water-vapour
    fluxes, mean-sea-level pressure and the four pressure-level geopotentials.
    Each variable is stored in the units its unit-correction expects
    (utils/units.py correct_variable_units: ERA5 CAPE in J/kg, msl in Pa,
    z_pl_* as geopotential m^2/s^2), so multi-variable configs exercise the
    same correction paths real archives would."""
    doy = int(date[4:6]) * 30 + int(date[6:8])
    seasonal = 10.0 * np.cos(2 * np.pi * (doy - 200) / 365.0)
    out: Dict[str, Dict[str, np.ndarray]] = {"DANRA": {}, "ERA5": {}}

    def put(var, hr, lr):
        if var in variables:
            out["DANRA"][var] = np.asarray(hr, np.float32)
            out["ERA5"][var] = np.asarray(lr, np.float32)

    # temperature (Kelvin on disk)
    t_anom = 4.0 * smooth_noise(rng, shape, corr=0.1)
    temp_hr = 281.0 + seasonal + t_anom - 0.006 * topo
    put("temp", temp_hr, _blur(temp_hr) + 0.5 * smooth_noise(rng, shape, corr=0.3))
    # precipitation: sparse log-normal (DANRA stores mm, ERA5 stores meters)
    p_base = smooth_noise(rng, shape, corr=0.12)
    prcp_hr_mm = np.where(p_base > 0.4, np.exp(1.5 * p_base) - 1.0, 0.0)
    prcp_lr_mm = np.maximum(_blur(prcp_hr_mm) + 0.05 * smooth_noise(rng, shape, corr=0.4), 0.0)
    put("prcp", prcp_hr_mm, prcp_lr_mm / 1000.0)  # meters on disk
    # CAPE: sparse and summer-peaked; ERA5 stores J/kg (corrected to kJ/kg)
    if "cape" in variables:
        c_base = smooth_noise(rng, shape, corr=0.1)
        warm = max(0.0, 1.0 + seasonal / 10.0)
        cape_hr = np.maximum(c_base - 0.3, 0.0) * 800.0 * warm  # J/kg
        # DANRA has no cape correction (units.py) -> store kJ/kg directly;
        # ERA5 stores J/kg and is corrected to kJ/kg at load
        put("cape", cape_hr / 1000.0, np.maximum(_blur(cape_hr), 0.0))
    # water-vapour fluxes: signed, synoptic-scale (kg/m/s both models)
    for var in ("ewvf", "nwvf"):
        if var in variables:
            f_hr = 120.0 * smooth_noise(rng, shape, corr=0.08)
            put(var, f_hr, _blur(f_hr) + 5.0 * smooth_noise(rng, shape, corr=0.3))
    # mean-sea-level pressure: ERA5 stores Pa (corrected to hPa)
    if "msl" in variables:
        msl_pa = 101325.0 + 800.0 * smooth_noise(rng, shape, corr=0.05)
        put("msl", msl_pa / 100.0, msl_pa)  # DANRA convention hPa; ERA5 Pa
    # pressure-level geopotentials: ERA5 stores m^2/s^2 (corrected to height m)
    z_means = {"z_pl_250": 10400.0, "z_pl_500": 5600.0,
               "z_pl_850": 1450.0, "z_pl_1000": 110.0}
    for var, zbar in z_means.items():
        if var in variables:
            z_m = zbar + (8.0 + zbar / 200.0) * smooth_noise(rng, shape, corr=0.06) \
                + 3.0 * seasonal
            put(var, z_m, z_m * 9.81)  # DANRA height (m); ERA5 geopotential
    missing = set(variables) - set(out["DANRA"])
    if missing:
        raise ValueError(f"synthetic generator has no recipe for {sorted(missing)}")
    return out


def date_range(start: str, n_days: int) -> List[str]:
    import datetime as dt

    d0 = dt.date(int(start[:4]), int(start[4:6]), int(start[6:8]))
    return [(d0 + dt.timedelta(days=i)).strftime("%Y%m%d") for i in range(n_days)]


class _StreamStats:
    """Streaming accumulator of the global-stats JSON schema (mean, std, min,
    max of the values and of log(max(x, 0) + 0.01)).

    Lets ``generate`` write day-by-day instead of materializing the whole
    archive: a 4,000-day 589x789 run peaked near 100 GiB RSS with the
    stack-everything design (one float32 copy of every field held to the end,
    plus float64 stats copies); streaming bounds memory at one day. Shifted
    sum-of-squares in float64 (shift = first chunk's mean) keeps the variance
    numerically safe for large-offset fields like msl (~1e5 Pa)."""

    def __init__(self, log_eps: float = 0.01):
        self.log_eps = log_eps
        self.n = 0
        self._shift = 0.0
        self._s = self._ss = 0.0
        self._ls = self._lss = 0.0
        self._lshift = 0.0
        self.mn = self.lmn = float("inf")
        self.mx = self.lmx = float("-inf")

    def update(self, x: np.ndarray) -> None:
        x = np.asarray(x, dtype=np.float64)
        if x.size == 0:
            return
        lx = np.log(np.maximum(x, 0) + self.log_eps)
        if self.n == 0:
            self._shift = float(x.mean())
            self._lshift = float(lx.mean())
        d, ld = x - self._shift, lx - self._lshift
        self.n += x.size
        self._s += float(d.sum())
        self._ss += float((d * d).sum())
        self._ls += float(ld.sum())
        self._lss += float((ld * ld).sum())
        self.mn = min(self.mn, float(x.min()))
        self.mx = max(self.mx, float(x.max()))
        self.lmn = min(self.lmn, float(lx.min()))
        self.lmx = max(self.lmx, float(lx.max()))

    def result(self) -> Dict[str, float]:
        if self.n == 0:
            raise ValueError(
                "no values accumulated (empty crop region or zero days?)"
            )
        m, lm = self._s / self.n, self._ls / self.n
        var = max(self._ss / self.n - m * m, 0.0)
        lvar = max(self._lss / self.n - lm * lm, 0.0)
        return {
            "mean": self._shift + m,
            "std": float(np.sqrt(var)),
            "min": self.mn,
            "max": self.mx,
            "log_mean": self._lshift + lm,
            "log_std": float(np.sqrt(lvar)),
            "log_min": self.lmn,
            "log_max": self.lmx,
        }


@dataclasses.dataclass
class SyntheticSpec:
    root: str
    full_domain: Tuple[int, int] = (64, 96)
    n_days: int = 48
    start_date: str = "20000101"
    variables: Tuple[str, ...] = ("temp", "prcp")
    splits: Optional[Dict[str, Tuple[int, int]]] = None  # split -> (start, stop) day idx
    crop_region: Optional[Tuple[int, int, int, int]] = None
    seed: int = 0

    def resolved_splits(self) -> Dict[str, Tuple[int, int]]:
        if self.splits is not None:
            return self.splits
        n = self.n_days
        n_train = max(int(0.7 * n), 1)
        n_valid = max(int(0.15 * n), 1)
        return {
            "train": (0, n_train),
            "valid": (n_train, n_train + n_valid),
            "test": (n_train + n_valid, n),
            "all": (0, n),
        }


def generate(spec: SyntheticSpec) -> Dict[str, str]:
    """Write the synthetic dataset; returns paths of the written artifacts."""
    if spec.n_days < 1:
        raise ValueError(f"SyntheticSpec.n_days must be >= 1, got {spec.n_days}")
    if spec.crop_region is not None:
        x1, x2, y1, y2 = spec.crop_region
        if x2 <= x1 or y2 <= y1:
            raise ValueError(
                f"SyntheticSpec.crop_region {spec.crop_region} has zero area "
                "(expected x1 < x2 and y1 < y2, rows-first)"
            )
    rng = np.random.default_rng(spec.seed)
    h, w = spec.full_domain
    size = f"{h}x{w}"
    dates = date_range(spec.start_date, spec.n_days)
    lsm, topo = make_geography(rng, spec.full_domain)

    os.makedirs(os.path.dirname(lsm_path(spec.root)), exist_ok=True)
    os.makedirs(os.path.dirname(topo_path(spec.root)), exist_ok=True)
    np.savez(lsm_path(spec.root), data=lsm)
    np.savez(topo_path(spec.root), data=topo)

    # Stream day-by-day: write each field into every split whose range holds
    # the day, and fold unit-corrected values into streaming stats — memory
    # stays O(one day) regardless of n_days (see _StreamStats).
    splits = spec.resolved_splits()
    written = {}
    groups: Dict[Tuple[str, str, str], zarrlite.Group] = {}
    for model in ("DANRA", "ERA5"):
        for var in spec.variables:
            for split in splits:
                path = build_data_path(spec.root, model, var, spec.full_domain, split)
                os.makedirs(os.path.dirname(path), exist_ok=True)
                groups[(model, var, split)] = zarrlite.open_group(path, mode="w")
                written[f"{model}/{var}/{split}"] = path

    regions = {"full": None}
    if spec.crop_region is not None:
        regions["_".join(map(str, spec.crop_region))] = spec.crop_region
    stats_acc = {
        (model, var, crop_str): _StreamStats()
        for model in ("DANRA", "ERA5")
        for var in spec.variables
        for crop_str in regions
    }

    for di, date in enumerate(dates):
        day = daily_fields(rng, date, spec.full_domain, topo, spec.variables)
        for model in ("DANRA", "ERA5"):
            for var in spec.variables:
                field = day[model][var]
                for split, (lo, hi) in splits.items():
                    if lo <= di < min(hi, spec.n_days):
                        day_group = groups[(model, var, split)].create_group(
                            f"{var}_{size}_{date}"
                        )
                        day_group.array("data", field)
                # stats on unit-corrected values over all generated days (the
                # 'all' split), full domain and (if given) the crop region
                corrected = correct_variable_units(var, model, field)
                for crop_str, region in regions.items():
                    if region is None:
                        stats_acc[(model, var, crop_str)].update(corrected)
                    else:
                        x1, x2, y1, y2 = region
                        stats_acc[(model, var, crop_str)].update(
                            corrected[x1:x2, y1:y2]
                        )
        if (di + 1) % 512 == 0:
            logger.info("synthetic: %d/%d days generated", di + 1, spec.n_days)

    for (model, var, crop_str), acc in stats_acc.items():
        spath = T.stats_path(
            os.path.join(spec.root, "stats"), model, var, size, crop_str, "all"
        )
        os.makedirs(os.path.dirname(spath), exist_ok=True)
        with open(spath, "w") as f:
            json.dump(acc.result(), f, indent=2)
    written["stats_root"] = os.path.join(spec.root, "stats")
    written["lsm"] = lsm_path(spec.root)
    written["topo"] = topo_path(spec.root)
    return written

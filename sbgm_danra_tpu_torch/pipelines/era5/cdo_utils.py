"""CDO-based daily aggregation, regridding and npz conversion.

Re-design of era5_download_pipeline/pipeline/cdo_utils.py:24-193. CDO is an
external binary (absent here); every invocation goes through an injectable
``runner(argv)`` so command construction and file-flow logic are testable, and
production use just passes ``subprocess_runner``.

Daily statistic per variable matches the reference (:24-38): precipitation and
potential evaporation are daily SUMS, CAPE a daily MAX, everything else a
daily MEAN.

The port's own copy of ``sbgm_danra_tpu/pipelines/era5/cdo_utils.py``
(host only: no JAX, no torch).
"""

from __future__ import annotations

import logging
import os
import subprocess
from typing import Callable, Dict, Optional, Sequence

import numpy as np

logger = logging.getLogger(__name__)

Runner = Callable[[Sequence[str]], None]

DAILY_STAT: Dict[str, str] = {
    "prcp": "daysum",
    "pev": "daysum",
    "cape": "daymax",
}
DEFAULT_STAT = "daymean"


def subprocess_runner(argv: Sequence[str]) -> None:
    try:
        subprocess.run(list(argv), check=True, capture_output=True)
    except FileNotFoundError as e:
        raise RuntimeError(
            f"External tool '{argv[0]}' is not installed in this environment"
        ) from e


def daily_stat_for(variable: str) -> str:
    return DAILY_STAT.get(variable, DEFAULT_STAT)


def register_daily_stat(variable: str, stat: str) -> None:
    """Register a config-declared per-variable daily statistic."""
    if stat not in ("daymean", "daysum", "daymax", "daymin"):
        raise ValueError(f"Unknown daily statistic: {stat}")
    DAILY_STAT[variable] = stat


def convert_to_daily_stat(
    src_nc: str, dst_nc: str, variable: str, runner: Runner = subprocess_runner
) -> str:
    """Hourly -> daily statistic via cdo (reference :24-38)."""
    runner(["cdo", "-O", daily_stat_for(variable), src_nc, dst_nc])
    return dst_nc


def generate_regridding_weights(
    src_nc: str, grid_file: str, weights_nc: str, runner: Runner = subprocess_runner
) -> str:
    """Bilinear weight generation (cdo genbil, reference :83-99)."""
    runner(["cdo", "-O", f"genbil,{grid_file}", src_nc, weights_nc])
    return weights_nc


def regrid_to_danra(
    src_nc: str,
    dst_nc: str,
    grid_file: str,
    weights_nc: Optional[str] = None,
    runner: Runner = subprocess_runner,
) -> str:
    """Bilinear remap onto the DANRA grid (reference :40-80); reuses weights
    when provided (remap) else computes them inline (remapbil)."""
    if weights_nc and os.path.exists(weights_nc):
        runner(["cdo", "-O", f"remap,{grid_file},{weights_nc}", src_nc, dst_nc])
    else:
        runner(["cdo", "-O", f"remapbil,{grid_file}", src_nc, dst_nc])
    return dst_nc


_CANDIDATE_VARS = ("t2m", "tp", "cape", "msl", "pev", "z", "nwvf", "ewvf", "var")


def find_data_var(names: Sequence[str], variable: str) -> str:
    """Tolerant nc variable discovery (reference _find_data_var :101-144):
    prefer an exact/known name, else the single non-coordinate variable."""
    coords = {"time", "valid_time", "lat", "latitude", "lon", "longitude", "level", "number", "expver"}
    data_vars = [n for n in names if n not in coords]
    if variable in data_vars:
        return variable
    for cand in _CANDIDATE_VARS:
        if cand in data_vars:
            return cand
    if len(data_vars) == 1:
        return data_vars[0]
    raise ValueError(f"Cannot identify data variable among {names} for '{variable}'")


def convert_daily_to_npz(
    times: Sequence[str],
    fields: np.ndarray,
    out_dir: str,
    variable: str,
    domain_dims: Sequence[int] = (589, 789),
) -> int:
    """Write one npz per day: {var}_{HxW}_{YYYYMMDD}.npz (reference :146-193).

    ``times``: YYYYMMDD strings; ``fields``: (T, H, W). Reading the nc file is
    the caller's job (netCDF4 is absent here; production can route through
    ``cdo -outputf`` or install netCDF4).
    """
    os.makedirs(out_dir, exist_ok=True)
    size = f"{domain_dims[0]}x{domain_dims[1]}"
    n = 0
    for date, field in zip(times, np.asarray(fields)):
        path = os.path.join(out_dir, f"{variable}_{size}_{date}.npz")
        np.savez_compressed(path, data=field.astype(np.float32))
        n += 1
    return n

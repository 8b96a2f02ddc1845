"""CDS API downloads: per-variable, per-year (and pressure-level) requests.

Re-design of era5_download_pipeline/pipeline/download.py:15-101: builds CDS
request dicts for hourly single-level and pressure-level ERA5 over a bounding
box and submits them through an injectable client (the real ``cdsapi.Client``
when installed; a fake in tests). ``pull_all`` fans out over variable x year
(x level) with a thread pool, like the reference's ThreadPoolExecutor.

The port's own copy of ``sbgm_danra_tpu/pipelines/era5/download.py``
(host only: no JAX, no torch).
"""

from __future__ import annotations

import concurrent.futures as cf
import dataclasses
import logging
import os
from typing import Callable, Dict, List, Optional, Sequence, Tuple

logger = logging.getLogger(__name__)

# CDS names for the variables the reference pulls (era5_pipeline.yaml:1-40).
# Both the framework's variable names (temp/prcp/...) and the reference
# config's nc shorts (t2m/tp/wvf_north/...) resolve.
CDS_VARIABLE_NAMES: Dict[str, str] = {
    "temp": "2m_temperature",
    "t2m": "2m_temperature",
    "prcp": "total_precipitation",
    "tp": "total_precipitation",
    "cape": "convective_available_potential_energy",
    "msl": "mean_sea_level_pressure",
    "pev": "potential_evaporation",
    "nwvf": "vertical_integral_of_northward_water_vapour_flux",
    "wvf_north": "vertical_integral_of_northward_water_vapour_flux",
    "ewvf": "vertical_integral_of_eastward_water_vapour_flux",
    "wvf_east": "vertical_integral_of_eastward_water_vapour_flux",
    "z": "geopotential",
}


def register_variable(short: str, cds_name: str) -> None:
    """Register a config-declared variable so ``build_request`` resolves it."""
    CDS_VARIABLE_NAMES[short] = cds_name


@dataclasses.dataclass(frozen=True)
class DownloadSpec:
    variables: Tuple[str, ...]
    years: Tuple[int, ...]
    area: Tuple[float, float, float, float] = (60.0, -80.0, 40.0, 40.0)  # N W S E
    out_dir: str = "./era5_raw"
    pressure_levels: Tuple[int, ...] = ()  # empty: single-level
    max_workers: int = 4


def build_request(variable: str, year: int, area, pressure_level: Optional[int] = None) -> Dict:
    """CDS request payload (reference download.py:15-69)."""
    if variable not in CDS_VARIABLE_NAMES:
        raise ValueError(f"Unknown ERA5 variable: {variable}")
    req = {
        "product_type": "reanalysis",
        "variable": CDS_VARIABLE_NAMES[variable],
        "year": str(year),
        "month": [f"{m:02d}" for m in range(1, 13)],
        "day": [f"{d:02d}" for d in range(1, 32)],
        "time": [f"{h:02d}:00" for h in range(24)],
        "area": list(area),
        "format": "netcdf",
    }
    if pressure_level is not None:
        req["pressure_level"] = str(pressure_level)
    return req


def dataset_name(pressure_level: Optional[int]) -> str:
    return (
        "reanalysis-era5-pressure-levels"
        if pressure_level is not None
        else "reanalysis-era5-single-levels"
    )


def target_path(out_dir: str, variable: str, year: int, pressure_level: Optional[int] = None) -> str:
    suffix = f"_pl{pressure_level}" if pressure_level is not None else ""
    return os.path.join(out_dir, f"era5_{variable}{suffix}_{year}.nc")


def make_cds_client():
    """Real cdsapi client, or a clear gate when the package is absent."""
    try:
        import cdsapi  # type: ignore
    except ImportError as e:
        raise RuntimeError(
            "cdsapi is not installed in this environment; pass a client callable "
            "(client(dataset, request, target)) to run the download pipeline"
        ) from e
    c = cdsapi.Client()
    return lambda dataset, request, target: c.retrieve(dataset, request, target)


def download_year(
    client: Callable[[str, Dict, str], None],
    spec: DownloadSpec,
    variable: str,
    year: int,
    pressure_level: Optional[int] = None,
) -> str:
    """One (variable, year[, level]) request; skips existing files (resume)."""
    os.makedirs(spec.out_dir, exist_ok=True)
    target = target_path(spec.out_dir, variable, year, pressure_level)
    if os.path.exists(target):
        logger.info("skip existing %s", target)
        return target
    request = build_request(variable, year, spec.area, pressure_level)
    client(dataset_name(pressure_level), request, target)
    return target


def pull_all(client: Callable[[str, Dict, str], None], spec: DownloadSpec) -> List[str]:
    """Thread-pooled fan-out over variable x year (x level) (reference :72-101)."""
    jobs = []
    for var in spec.variables:
        for year in spec.years:
            if spec.pressure_levels:
                jobs += [(var, year, pl) for pl in spec.pressure_levels]
            else:
                jobs.append((var, year, None))
    out: List[str] = []
    with cf.ThreadPoolExecutor(max_workers=spec.max_workers) as pool:
        futs = [pool.submit(download_year, client, spec, v, y, p) for v, y, p in jobs]
        for f in futs:
            out.append(f.result())
    return out

"""On-cluster processing worker: hourly nc -> daily stat -> regrid -> daily npz.

Re-design of era5_download_pipeline/cli/run_lumi.py:24-150 with its resume
semantics: a year is complete when every day of the year has an npz on disk
(leap-aware); partial years are DELETED and redone (:24-47). External steps
(cdo) and the nc reader are injected for testability and gating.

The port's own copy of ``sbgm_danra_tpu/pipelines/era5/worker.py``
(host only: no JAX, no torch).
"""

from __future__ import annotations

import concurrent.futures as cf
import glob
import logging
import os
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from sbgm_danra_tpu_torch.pipelines.era5.cdo_utils import (
    Runner,
    convert_daily_to_npz,
    convert_to_daily_stat,
    regrid_to_danra,
    subprocess_runner,
)
from sbgm_danra_tpu_torch.utils.dates import is_leap_year

logger = logging.getLogger(__name__)

# Reader: nc path -> (list of YYYYMMDD, fields (T, H, W)).
NCReader = Callable[[str], Tuple[List[str], np.ndarray]]


def days_in_year(year: int) -> int:
    return 366 if is_leap_year(year) else 365


def year_npz_paths(out_dir: str, variable: str, year: int, domain_dims) -> List[str]:
    size = f"{domain_dims[0]}x{domain_dims[1]}"
    return sorted(glob.glob(os.path.join(out_dir, f"{variable}_{size}_{year}????.npz")))


def year_complete(
    out_dir: str, variable: str, year: int, domain_dims, cleanup_partial: bool = True
) -> bool:
    """Completeness check; deletes partial years so they redo (reference :24-47)."""
    paths = year_npz_paths(out_dir, variable, year, domain_dims)
    expected = days_in_year(year)
    if len(paths) == expected:
        return True
    if paths and cleanup_partial:
        logger.warning(
            "%s %d partial (%d/%d days); deleting for redo", variable, year,
            len(paths), expected,
        )
        for p in paths:
            os.remove(p)
    return False


def process_year(
    raw_nc: str,
    variable: str,
    year: int,
    out_dir: str,
    grid_file: str,
    nc_reader: NCReader,
    domain_dims: Sequence[int] = (589, 789),
    weights_nc: Optional[str] = None,
    runner: Runner = subprocess_runner,
    work_dir: Optional[str] = None,
) -> int:
    """hourly nc -> daily stat -> regrid -> per-day npz (reference :49-130)."""
    work_dir = work_dir or out_dir
    os.makedirs(work_dir, exist_ok=True)
    daily_nc = os.path.join(work_dir, f"{variable}_{year}_daily.nc")
    regrid_nc = os.path.join(work_dir, f"{variable}_{year}_danra.nc")
    convert_to_daily_stat(raw_nc, daily_nc, variable, runner)
    regrid_to_danra(daily_nc, regrid_nc, grid_file, weights_nc, runner)
    times, fields = nc_reader(regrid_nc)
    n = convert_daily_to_npz(times, fields, out_dir, variable, domain_dims)
    for tmp in (daily_nc, regrid_nc):
        if os.path.exists(tmp):
            os.remove(tmp)
    return n


def run_worker(
    raw_dir: str,
    out_root: str,
    variables: Sequence[str],
    years: Sequence[int],
    grid_file: str,
    nc_reader: NCReader,
    domain_dims: Sequence[int] = (589, 789),
    runner: Runner = subprocess_runner,
    max_workers: int = 4,
    pressure_levels: Sequence[int] = (),
) -> Dict[str, List[int]]:
    """Pool over (variable, year[, level]) with completeness-based resume.

    With ``pressure_levels``, each (var, level) pair becomes its own output
    variable ``{var}_pl_{level}`` reading the level-suffixed raw file that
    ``download.target_path`` writes — the naming the training configs condition
    on (z_pl_250..z_pl_1000). ``{var}`` in raw_dir/out_root resolves per
    variable (the reference's lumi directory layout).
    """
    jobs = []
    # (output variable name, raw filename stem, bare source variable) triples
    if pressure_levels:
        streams = [
            (f"{var}_pl_{pl}", f"era5_{var}_pl{pl}", var)
            for var in variables
            for pl in pressure_levels
        ]
    else:
        streams = [(var, f"era5_{var}", var) for var in variables]
    for out_var, stem, src_var in streams:
        if "{var}" in out_root:
            out_dir = out_root.format(var=out_var)
        else:
            out_dir = os.path.join(out_root, out_var)
        os.makedirs(out_dir, exist_ok=True)
        # Raw dirs are laid out by stream.py per BARE variable (stream.py
        # rsyncs every level's file into remote_dir.format(var=<bare var>));
        # the level suffix lives in the filename stem, not the directory.
        in_dir = raw_dir.format(var=src_var) if "{var}" in raw_dir else raw_dir
        for year in years:
            if year_complete(out_dir, out_var, year, domain_dims):
                logger.info("%s %d already complete; skipping", out_var, year)
                continue
            raw_nc = os.path.join(in_dir, f"{stem}_{year}.nc")
            if not os.path.exists(raw_nc):
                logger.warning("missing raw file %s; skipping", raw_nc)
                continue
            jobs.append((out_var, year, raw_nc, out_dir))

    done: Dict[str, List[int]] = {v: [] for v, _, _ in streams}
    with cf.ThreadPoolExecutor(max_workers=max_workers) as pool:
        futs = {
            pool.submit(
                process_year, raw_nc, var, year, out_dir, grid_file,
                nc_reader, domain_dims, None, runner,
            ): (var, year)
            for var, year, raw_nc, out_dir in jobs
        }
        for fut in cf.as_completed(futs):
            var, year = futs[fut]
            try:
                n = fut.result()
                done[var].append(year)
                logger.info("%s %d: %d days written", var, year, n)
            except Exception as e:
                logger.error("%s %d failed: %s", var, year, e)
    return done

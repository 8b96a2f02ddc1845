"""ERA5 acquisition CLI (reference era5_download_pipeline/cli/run_local.py,
run_local_pressure.py, run_lumi.py).

    python -m sbgm_danra_tpu_torch.cli.main_era5_app --config_path configs/era5_pipeline.yaml \
        --mode {download,stream,process} [--dry_run]

Modes:
- ``download``: local CDS pulls over variable x year (x pressure level) —
  the reference's run_local / run_local_pressure drivers (pressure levels come
  from the config's ``pressure_levels`` list).
- ``stream``: download -> rsync to the remote -> delete local, with the
  redo-newest-remote-year resume rule (reference pipeline/stream.py:84-141).
- ``process``: on-cluster hourly->daily->regrid->per-day-npz worker with
  year-completeness resume (reference cli/run_lumi.py:49-150).

``--dry_run`` prints the planned jobs and exits without touching the network
or external binaries (cdsapi/cdo/rsync are absent in many environments).

The port's own copy of ``sbgm_danra_tpu/cli/main_era5_app.py`` on the port's
``pipelines/era5``: host only (no JAX, no torch). The CDS client
(``download.make_cds_client``), the ``cdo`` / ``rsync`` / ``ssh`` runners
and the netCDF reader (``_nc_reader``) are injectable as there.
"""

from __future__ import annotations

import argparse
import logging
import os

logger = logging.getLogger(__name__)


def _nc_reader(path):
    """netCDF reader for the process mode; gated on netCDF4 availability.

    Returns (YYYYMMDD strings, fields) — the worker/npz naming contract
    (per-day files ``{var}_{HxW}_{YYYYMMDD}.npz``, reference cdo_utils.py:146-193).
    """
    try:
        import netCDF4  # type: ignore
    except ImportError as e:
        raise RuntimeError(
            "netCDF4 is not installed; pass a custom nc_reader to run_worker"
        ) from e
    from sbgm_danra_tpu_torch.pipelines.era5.cdo_utils import find_data_var

    ds = netCDF4.Dataset(path)
    time_name = "time" if "time" in ds.variables else "valid_time"
    raw_times = netCDF4.num2date(ds[time_name][:], ds[time_name].units)
    times = [t.strftime("%Y%m%d") for t in raw_times]
    # process_year hands us '{variable}_{year}_danra.nc'; find_data_var does
    # tolerant discovery so the leading token is enough even for z_pl_* names
    var = find_data_var(list(ds.variables), os.path.basename(path).split("_")[0])
    return times, ds[var][:]


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description="ERA5 acquisition pipeline")
    parser.add_argument("--config_path", required=True)
    parser.add_argument("--mode", required=True, choices=["download", "stream", "process"])
    parser.add_argument("--dry_run", action="store_true",
                        help="print the planned jobs without running them")
    parser.add_argument("--raw_dir", default=None,
                        help="process mode: directory of raw hourly nc files")
    parser.add_argument("--out_root", default=None,
                        help="process mode: root for per-variable npz output")
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO)

    from sbgm_danra_tpu_torch.pipelines.era5.config import load_era5_config

    cfg = load_era5_config(args.config_path)
    spec = cfg.download_spec()

    if args.dry_run:
        n_levels = max(1, len(cfg.pressure_levels))
        jobs = len(cfg.variables) * len(cfg.year_list) * n_levels
        print(f"mode={args.mode} variables={sorted(cfg.variables)} "
              f"years={cfg.years[0]}-{cfg.years[1]} levels={list(cfg.pressure_levels)} "
              f"jobs={jobs} area={list(cfg.area)} tmp_dir={cfg.tmp_dir}")
        return

    if args.mode == "download":
        from sbgm_danra_tpu_torch.pipelines.era5.download import make_cds_client, pull_all

        paths = pull_all(make_cds_client(), spec)
        logger.info("downloaded %d files into %s", len(paths), cfg.tmp_dir)

    elif args.mode == "stream":
        if cfg.remote is None:
            raise SystemExit("stream mode needs a lumi:/remote: block in the config")
        from sbgm_danra_tpu_torch.pipelines.era5.download import make_cds_client
        from sbgm_danra_tpu_torch.pipelines.era5.stream import download_transfer_delete

        done = download_transfer_delete(
            make_cds_client(), spec, cfg.remote.target, cfg.remote.raw_dir
        )
        for var, years in done.items():
            logger.info("%s: streamed %d years", var, len(years))

    elif args.mode == "process":
        from sbgm_danra_tpu_torch.pipelines.era5.worker import run_worker

        raw_dir = args.raw_dir or (cfg.remote.raw_dir if cfg.remote else cfg.tmp_dir)
        out_root = args.out_root or (cfg.remote.npz_dir if cfg.remote else cfg.tmp_dir)
        done = run_worker(
            raw_dir, out_root, sorted(cfg.variables), cfg.year_list,
            cfg.grid_file, _nc_reader, max_workers=cfg.max_workers,
            pressure_levels=cfg.pressure_levels,
        )
        for var, years in done.items():
            logger.info("%s: processed %d years", var, len(years))


if __name__ == "__main__":
    main()

"""ERA5 acquisition ETL: CDS downloads, CDO regridding, transfer, streaming.

Re-design of the reference era5_download_pipeline/. All external dependencies
(cdsapi, the cdo binary, rsync/ssh) are injected as callables so the pipeline
logic — resume, year-completeness, streaming, regridding command construction —
is testable without network or binaries, and cleanly gated when they are absent.

The port's own copy of ``sbgm_danra_tpu/pipelines/era5/``: host-only modules
(no JAX, no torch) whose registries (``download.CDS_VARIABLE_NAMES``,
``cdo_utils.DAILY_STAT``) are the port's own: loading a config here leaves
the JAX package's registries as they were.
"""

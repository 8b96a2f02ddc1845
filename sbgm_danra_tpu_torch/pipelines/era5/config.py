"""ERA5 pipeline YAML config (reference era5_download_pipeline/cfg/*.yaml).

Re-design of the reference's ad-hoc yaml dicts (era5_pipeline.yaml:1-40,
era5_pressure_pipeline.yaml) as a typed schema: variables with per-variable
daily statistics, bounding box, year range, pressure levels, and the remote
(cluster) directory layout used by the streaming transfer.

The port's own copy of ``sbgm_danra_tpu/pipelines/era5/config.py``
(host only: no JAX, no torch).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

from sbgm_danra_tpu_torch.pipelines.era5.cdo_utils import register_daily_stat
from sbgm_danra_tpu_torch.pipelines.era5.download import DownloadSpec, register_variable


@dataclasses.dataclass(frozen=True)
class VariableSpec:
    """One ERA5 variable: CDS long name, short nc name, daily aggregation."""

    cds_name: str
    short: str
    daily_stat: str  # daymean | daysum | daymax | daymin


@dataclasses.dataclass(frozen=True)
class RemoteSpec:
    """Cluster-side layout for the streaming transfer (reference lumi: block)."""

    user: str
    host: str
    raw_dir: str
    daily_dir: str = ""
    npz_dir: str = ""

    @property
    def target(self) -> str:
        return f"{self.user}@{self.host}"


@dataclasses.dataclass(frozen=True)
class Era5PipelineConfig:
    variables: Dict[str, VariableSpec]
    years: Tuple[int, int]  # inclusive range
    area: Tuple[float, float, float, float] = (60.0, -80.0, 40.0, 40.0)
    pressure_levels: Tuple[int, ...] = ()
    max_workers: int = 3
    tmp_dir: str = "/tmp/era5_downloads"
    grid_file: str = ""
    weights_file: str = ""
    remote: Optional[RemoteSpec] = None

    @property
    def year_list(self) -> Tuple[int, ...]:
        return tuple(range(self.years[0], self.years[1] + 1))

    def download_spec(self) -> DownloadSpec:
        return DownloadSpec(
            variables=tuple(self.variables),
            years=self.year_list,
            area=self.area,
            out_dir=self.tmp_dir,
            pressure_levels=self.pressure_levels,
            max_workers=self.max_workers,
        )


def _resolve_env_tolerant(value):
    """``${env:VAR}`` substitution; undefined vars stay literal (paths that a
    given mode never touches must not block the modes that run)."""
    import os
    import re

    if isinstance(value, str):
        return re.sub(
            r"\$\{env:([A-Za-z_][A-Za-z0-9_]*)\}",
            lambda m: os.environ.get(m.group(1), m.group(0)),
            value,
        )
    if isinstance(value, dict):
        return {k: _resolve_env_tolerant(v) for k, v in value.items()}
    if isinstance(value, list):
        return [_resolve_env_tolerant(v) for v in value]
    return value


def load_era5_config(path: str) -> Era5PipelineConfig:
    """Parse an era5_pipeline.yaml-style file into the typed config (PyYAML
    is imported here, not with the module)."""
    import yaml

    with open(path) as f:
        raw = _resolve_env_tolerant(yaml.safe_load(f))

    variables: Dict[str, VariableSpec] = {}
    for cds_name, spec in (raw.get("variables") or {}).items():
        short = spec["short"]
        variables[short] = VariableSpec(
            cds_name=cds_name, short=short, daily_stat=spec.get("daily_stat", "daymean")
        )
        register_variable(short, cds_name)
        register_daily_stat(short, variables[short].daily_stat)

    years = raw.get("years") or [1991, 2020]
    remote = None
    lumi = raw.get("lumi") or raw.get("remote")
    if lumi:
        remote = RemoteSpec(
            user=lumi["user"],
            host=lumi["host"],
            raw_dir=lumi.get("raw_dir", ""),
            daily_dir=lumi.get("daily_dir", ""),
            npz_dir=lumi.get("npz_dir", ""),
        )
    return Era5PipelineConfig(
        variables=variables,
        years=(int(years[0]), int(years[-1])),
        area=tuple(raw.get("area") or (60, -80, 40, 40)),
        pressure_levels=tuple(raw.get("pressure_levels") or ()),
        max_workers=int(raw.get("max_workers", 3)),
        tmp_dir=raw.get("tmp_dir", "/tmp/era5_downloads"),
        grid_file=raw.get("grid_file", ""),
        weights_file=raw.get("weights_file", ""),
        remote=remote,
    )

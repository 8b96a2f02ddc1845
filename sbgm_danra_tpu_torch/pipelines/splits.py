"""Train/valid/test splits of date-keyed stores (a copy of
``sbgm_danra_tpu/pipelines/splits.py``).

The dates common to the HR variable's store and every LR condition's are
split by year ranges ("Time") or by fractions of a seeded shuffle
("Random"), and each split is written as a store of its own in the standard
layout (``data/paths.py``).
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np

from sbgm_danra_tpu_torch.data import zarrlite
from sbgm_danra_tpu_torch.data.paths import build_data_path
from sbgm_danra_tpu_torch.utils.dates import file_date

logger = logging.getLogger(__name__)


@dataclasses.dataclass
class SplitSpec:
    """Either year ranges (Time) or fractions (Random), per split name."""

    method: str = "Time"  # Time | Random
    # Time: split -> (first_year, last_year) inclusive
    year_ranges: Optional[Dict[str, Tuple[int, int]]] = None
    # Random: split -> fraction
    fractions: Optional[Dict[str, float]] = None
    seed: int = 0


DEFAULT_YEAR_RANGES = {
    "train": (1990, 2015),
    "valid": (2016, 2018),
    "test": (2019, 2022),
}


def common_dates(groups: Sequence[zarrlite.Group]) -> List[str]:
    sets = []
    for g in groups:
        dates = set()
        for key in g.keys():
            try:
                dates.add(file_date(key))
            except ValueError:
                pass
        sets.append(dates)
    out = set.intersection(*sets) if sets else set()
    return sorted(out)


def assign_splits(dates: Sequence[str], spec: SplitSpec) -> Dict[str, List[str]]:
    if spec.method == "Time":
        ranges = spec.year_ranges or DEFAULT_YEAR_RANGES
        out: Dict[str, List[str]] = {name: [] for name in ranges}
        for d in dates:
            year = int(d[:4])
            for name, (lo, hi) in ranges.items():
                if lo <= year <= hi:
                    out[name].append(d)
                    break
        return out
    if spec.method == "Random":
        fracs = spec.fractions or {"train": 0.7, "valid": 0.15, "test": 0.15}
        dates = list(dates)
        np.random.default_rng(spec.seed).shuffle(dates)
        out = {}
        start = 0
        names = list(fracs)
        for i, name in enumerate(names):
            n = len(dates) - start if i == len(names) - 1 else int(fracs[name] * len(dates))
            out[name] = sorted(dates[start : start + n])
            start += n
        return out
    raise ValueError(f"Unknown split method: {spec.method}")


def write_split_store(src: zarrlite.Group, dst_path: str, dates: Sequence[str]) -> int:
    """Copy the day-groups for ``dates`` from src into a new store at dst_path."""
    date_map = {}
    for key in src.keys():
        try:
            date_map[file_date(key)] = key
        except ValueError:
            pass
    dst = zarrlite.open_group(dst_path, mode="w")
    n = 0
    for d in dates:
        key = date_map.get(d)
        if key is None:
            continue
        src_day = src[key]
        dst_day = dst.create_group(key)
        if isinstance(src_day, zarrlite.ZArray):
            continue
        for arr_key in src_day.keys():
            dst_day.array(arr_key, src_day[arr_key][...])
        n += 1
    return n


def create_data_splits(
    data_dir: str,
    variables: Mapping[str, Sequence[str]],  # model -> [vars]
    full_domain_dims: Tuple[int, int],
    spec: Optional[SplitSpec] = None,
    source_split: str = "all",
) -> Dict[str, int]:
    """Intersect dates across every (model, var) store, then write splits."""
    spec = spec or SplitSpec()
    groups = {}
    for model, vars_ in variables.items():
        for var in vars_:
            path = build_data_path(data_dir, model, var, full_domain_dims, source_split)
            groups[(model, var)] = zarrlite.open_group(path)
    dates = common_dates(list(groups.values()))
    if not dates:
        raise ValueError("No common dates across the requested stores")
    split_dates = assign_splits(dates, spec)
    written = {}
    for (model, var), src in groups.items():
        for split, ds in split_dates.items():
            dst = build_data_path(data_dir, model, var, full_domain_dims, split)
            n = write_split_store(src, dst, ds)
            written[f"{model}/{var}/{split}"] = n
            logger.info("%s/%s %s: %d days", model, var, split, n)
    return written


def create_splits_from_config(cfg, spec: Optional[SplitSpec] = None) -> Dict[str, int]:
    variables = {
        cfg.highres.model: [cfg.highres.variable],
        cfg.lowres.model: list(cfg.lowres.condition_variables or ()),
    }
    if spec is None:
        s = cfg.splits
        if s.method == "Time":
            spec = SplitSpec(
                method="Time",
                year_ranges={
                    "train": tuple(s.train_years),
                    "valid": tuple(s.valid_years),
                    "test": tuple(s.test_years),
                },
            )
        else:
            spec = SplitSpec(method="Random", fractions=s.fractions, seed=s.seed)
    return create_data_splits(
        cfg.paths.data_dir, variables, tuple(cfg.highres.full_domain_dims), spec
    )

"""Preprocessing: small fixture stores, filtering and format conversion (a
copy of ``sbgm_danra_tpu/pipelines/preprocess.py``).

- ``create_small_data_batches``: N common dates of every (model, variable)
  store, drawn with a seeded generator, copied into small stores for tests;
- ``filter_store``: day-groups with a wrong shape, a missing key or an
  unreadable or non-finite array;
- ``npz_dir_to_zarr`` / ``fields_to_zarr``: one group per day-file, one array
  per npz key.
"""

from __future__ import annotations

import logging
import os
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np

from sbgm_danra_tpu_torch.data import zarrlite
from sbgm_danra_tpu_torch.data.paths import build_data_path
from sbgm_danra_tpu_torch.utils.dates import file_date

logger = logging.getLogger(__name__)


def npz_dir_to_zarr(npz_dir: str, zarr_path: str) -> int:
    """Convert a directory of daily npz files to a zarr store; returns the days written."""
    group = zarrlite.open_group(zarr_path, mode="w")
    n = 0
    for fname in sorted(os.listdir(npz_dir)):
        if not fname.endswith(".npz"):
            continue
        stem = fname[: -len(".npz")]
        try:
            with np.load(os.path.join(npz_dir, fname)) as z:
                day = group.create_group(stem)
                for key in z.files:
                    day.array(key, np.asarray(z[key]))
            n += 1
        except Exception as e:
            logger.warning("skipping %s: %s", fname, e)
    return n


def fields_to_zarr(zarr_path: str, fields: Mapping[str, np.ndarray], key: str = "data") -> None:
    """Write a {day_name: field} dict into a store (one group per day)."""
    group = zarrlite.open_group(zarr_path, mode="w")
    for name, field in fields.items():
        group.create_group(name).array(key, np.asarray(field))


def filter_store(
    store_path: str,
    expected_shape: Optional[Tuple[int, int]] = None,
    required_keys: Sequence[str] = (),
) -> Dict[str, List[str]]:
    """Report corrupt or malformed day-groups:
    {"ok": [...], "bad_shape": [...], "missing_key": [...], "corrupt": [...]}."""
    group = zarrlite.open_group(store_path)
    report: Dict[str, List[str]] = {"ok": [], "bad_shape": [], "missing_key": [], "corrupt": []}
    for name in group.keys():
        try:
            day = group[name]
            keys = day.keys() if isinstance(day, zarrlite.Group) else []
            for rk in required_keys:
                if rk not in keys:
                    report["missing_key"].append(name)
                    break
            else:
                arr_key = keys[0] if keys else None
                if arr_key is None:
                    report["corrupt"].append(name)
                    continue
                arr = day[arr_key][...]
                if expected_shape is not None and arr.shape[-2:] != tuple(expected_shape):
                    report["bad_shape"].append(name)
                elif not np.isfinite(arr).all():
                    report["corrupt"].append(name)
                else:
                    report["ok"].append(name)
        except Exception as e:
            logger.warning("corrupt entry %s: %s", name, e)
            report["corrupt"].append(name)
    return report


def create_small_data_batches(
    data_dir: str,
    out_dir: str,
    variables: Mapping[str, Sequence[str]],  # model -> vars
    full_domain_dims: Tuple[int, int],
    n_samples: int = 8,
    source_split: str = "all",
    out_split: str = "all_small",
    seed: int = 0,
) -> Dict[str, int]:
    """Sample ``n_samples`` common dates into small fixture stores."""
    groups = {}
    for model, vars_ in variables.items():
        for var in vars_:
            path = build_data_path(data_dir, model, var, full_domain_dims, source_split)
            groups[(model, var)] = zarrlite.open_group(path)
    date_sets = [{file_date(k) for k in g.keys()} for g in groups.values()]
    dates = sorted(set.intersection(*date_sets))
    if not dates:
        raise ValueError("No common dates")
    rng = np.random.default_rng(seed)
    chosen = sorted(rng.choice(dates, size=min(n_samples, len(dates)), replace=False))

    written = {}
    for (model, var), src in groups.items():
        date_map = {file_date(k): k for k in src.keys()}
        dst_path = build_data_path(out_dir, model, var, full_domain_dims, out_split)
        dst = zarrlite.open_group(dst_path, mode="w")
        n = 0
        for d in chosen:
            key = date_map[d]
            day = src[key]
            out_day = dst.create_group(key)
            for arr_key in day.keys():
                out_day.array(arr_key, day[arr_key][...])
            n += 1
        written[f"{model}/{var}"] = n
    return written

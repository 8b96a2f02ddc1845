"""Global statistics: the normalisation contract (a copy of
``sbgm_danra_tpu/pipelines/stats_pipeline.py``).

Per (model, variable) the daily fields of a split are streamed, unit-corrected
and optionally cropped, and folded into the global mean, std, min and max and
their log-space variants; the JSON goes where ``transforms.load_global_stats``
reads it (``transforms.stats_path``). The sums are float64 and unshifted, in
the JAX module's order, so both packages write the same numbers. Also the
temporal aggregation of daily fields into weekly, monthly or yearly
composites, in memory (``aggregate_fields``) or streamed
(``aggregate_stream``).
"""

from __future__ import annotations

import concurrent.futures as cf
import datetime
import json
import logging
import os
from typing import Dict, Mapping, Optional, Sequence

import numpy as np

from sbgm_danra_tpu_torch import transforms as T
from sbgm_danra_tpu_torch.data import zarrlite
from sbgm_danra_tpu_torch.data.dataset import extract_2d
from sbgm_danra_tpu_torch.data.paths import build_data_path
from sbgm_danra_tpu_torch.utils.units import correct_variable_units

logger = logging.getLogger(__name__)

LOG_EPS = 0.01  # the log transform's eps


class StreamingStats:
    """Constant-memory accumulation of global and log-space statistics."""

    def __init__(self):
        self.n = 0
        self.sum = 0.0
        self.sumsq = 0.0
        self.min = np.inf
        self.max = -np.inf
        self.log_sum = 0.0
        self.log_sumsq = 0.0
        self.log_min = np.inf
        self.log_max = -np.inf

    def update(self, field: np.ndarray) -> None:
        x = np.asarray(field, dtype=np.float64).ravel()
        self.n += x.size
        self.sum += x.sum()
        self.sumsq += (x * x).sum()
        self.min = min(self.min, float(x.min()))
        self.max = max(self.max, float(x.max()))
        logx = np.log(np.maximum(x, 0.0) + LOG_EPS)
        self.log_sum += logx.sum()
        self.log_sumsq += (logx * logx).sum()
        self.log_min = min(self.log_min, float(logx.min()))
        self.log_max = max(self.log_max, float(logx.max()))

    def finalize(self) -> Dict[str, float]:
        if self.n == 0:
            raise ValueError("No data accumulated")
        mean = self.sum / self.n
        var = max(self.sumsq / self.n - mean * mean, 0.0)
        log_mean = self.log_sum / self.n
        log_var = max(self.log_sumsq / self.n - log_mean * log_mean, 0.0)
        return {
            "n": self.n,
            "mean": mean,
            "std": float(np.sqrt(var)),
            "min": self.min,
            "max": self.max,
            "log_mean": log_mean,
            "log_std": float(np.sqrt(log_var)),
            "log_min": self.log_min,
            "log_max": self.log_max,
        }


_AGG_METHODS = {"mean": np.mean, "sum": np.sum, "max": np.max, "min": np.min}


def _group_key(t: datetime.datetime, agg_time: str):
    if agg_time == "weekly":
        iso = t.isocalendar()
        return (iso[0], iso[1])
    if agg_time == "monthly":
        return (t.year, t.month)
    if agg_time == "yearly":
        return (t.year,)
    raise ValueError(f"Unsupported aggregation_time: {agg_time}")


def _period_start(key, agg_time: str) -> datetime.datetime:
    if agg_time == "weekly":
        return datetime.datetime.fromisocalendar(key[0], key[1], 1)
    if agg_time == "monthly":
        return datetime.datetime(key[0], key[1], 1)
    return datetime.datetime(key[0], 1, 1)


def aggregate_fields(
    fields: Sequence[np.ndarray],
    timestamps: Sequence,
    agg_time: str,
    agg_method: str = "mean",
) -> Dict[str, object]:
    """Daily fields grouped by ISO week, month or year and reduced with mean,
    sum, max or min; each group's timestamp is its period's start. ``daily``
    returns the stack as it is."""
    ts = [datetime.datetime.fromisoformat(t) if isinstance(t, str) else t for t in timestamps]
    if len(fields) != len(ts):
        raise ValueError(f"{len(fields)} fields vs {len(ts)} timestamps")
    stack = np.stack([np.asarray(f) for f in fields])
    if agg_time == "daily":
        return {"cutouts": stack, "stack": stack.ravel(), "timestamps": ts}
    if agg_method not in _AGG_METHODS:
        raise ValueError(f"Unsupported aggregation method: {agg_method}")

    groups: Dict[tuple, list] = {}
    for idx, t in enumerate(ts):
        groups.setdefault(_group_key(t, agg_time), []).append(idx)

    reduce = _AGG_METHODS[agg_method]
    out_fields = [reduce(stack[groups[key]], axis=0) for key in sorted(groups)]
    out_ts = [_period_start(key, agg_time) for key in sorted(groups)]
    agg = np.stack(out_fields)
    return {"cutouts": agg, "stack": agg.ravel(), "timestamps": out_ts}


def aggregate_stream(items, agg_time: str, agg_method: str = "mean"):
    """Constant-memory variant of :func:`aggregate_fields`.

    ``items`` yields (field, timestamp) in date order; each period's composite
    is reduced as its days arrive (a running sum, max or min and a count), so
    one field is held at a time. Yields (period_start, composite) as periods
    complete; a period that reappears after it closed raises ``ValueError``
    (the input is out of date order).
    """
    if agg_method not in _AGG_METHODS:
        raise ValueError(f"Unsupported aggregation method: {agg_method}")

    acc, count, cur = None, 0, None
    closed = set()
    for field, ts in items:
        t = datetime.datetime.fromisoformat(ts) if isinstance(ts, str) else ts
        field = np.asarray(field, np.float64)
        if agg_time == "daily":
            yield t, field
            continue
        key = _group_key(t, agg_time)
        if key != cur:
            if cur is not None:
                closed.add(cur)
                yield _period_start(cur, agg_time), (acc / count if agg_method == "mean"
                                                     else acc)
            if key in closed:
                raise ValueError(
                    f"period {key} reappeared after being closed; "
                    "aggregate_stream requires date-ordered input"
                )
            acc, count, cur = field.copy(), 1, key
        else:
            count += 1
            if agg_method == "mean" or agg_method == "sum":
                acc += field
            elif agg_method == "max":
                np.maximum(acc, field, out=acc)
            else:
                np.minimum(acc, field, out=acc)
    if cur is not None:
        yield _period_start(cur, agg_time), (acc / count if agg_method == "mean" else acc)


def compute_global_stats(
    store_path: str,
    variable: str,
    model: str,
    crop_region: Optional[Sequence[int]] = None,
    num_workers: int = 8,
) -> Dict[str, float]:
    """Stream a store's daily fields into global statistics; a thread pool
    reads the days, folded in the store's key order."""
    group = zarrlite.open_group(store_path)
    keys = group.keys()
    if not keys:
        raise ValueError(f"Empty store: {store_path}")
    stats = StreamingStats()

    def load(key: str) -> np.ndarray:
        field = extract_2d(group, key, variable)
        field = correct_variable_units(variable, model, field)
        if crop_region is not None:
            x1, x2, y1, y2 = crop_region
            field = field[x1:x2, y1:y2]
        return field

    with cf.ThreadPoolExecutor(max_workers=num_workers) as pool:
        for field in pool.map(load, keys):
            stats.update(field)
    return stats.finalize()


def write_stats_json(
    stats: Mapping[str, float],
    stats_root: str,
    model: str,
    variable: str,
    domain_str: str,
    crop_region_str: str,
    split: str,
) -> str:
    path = T.stats_path(stats_root, model, variable, domain_str, crop_region_str, split)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        json.dump(dict(stats), f, indent=2)
    logger.info("wrote %s", path)
    return path


def run_data_statistics(
    cfg,
    splits: Sequence[str] = ("all",),
    num_workers: Optional[int] = None,
) -> Dict[str, Dict[str, float]]:
    """Compute and write the statistics of the HR variable and every LR
    condition: for each, the full domain and (where cutouts are configured)
    the cutout's crop region, the two crop strings the dataset resolves."""
    num_workers = num_workers or cfg.data_handling.num_workers
    hr, lr = cfg.highres, cfg.lowres
    jobs = [
        (hr.model, hr.variable, tuple(hr.cutout_domains) if hr.cutout_domains else None,
         tuple(hr.full_domain_dims))
    ] + [
        (lr.model, var, tuple(lr.cutout_domains) if lr.cutout_domains else None,
         tuple(lr.full_domain_dims))
        for var in (lr.condition_variables or ())
    ]
    stats_root = cfg.paths.stats_load_dir
    results = {}
    for split in splits:
        for model, var, crop, dims in jobs:
            store = build_data_path(cfg.paths.data_dir, model, var, dims, split)
            domain_str = f"{dims[0]}x{dims[1]}"
            regions = {"full": None}
            if crop is not None:
                regions["_".join(map(str, crop))] = crop
            for crop_str, crop_region in regions.items():
                stats = compute_global_stats(store, var, model, crop_region, num_workers)
                write_stats_json(stats, stats_root, model, var, domain_str, crop_str, split)
                results[f"{model}/{var}/{crop_str}/{split}"] = stats
    return results

"""Extreme-value monitoring of back-transformed precipitation (a numpy copy of
``sbgm_danra_tpu/utils/sentinels.py``): a sample is flagged extreme when its
max exceeds max(5 x per-sample p99.9, cap_mm_day); negative precipitation is
flagged separately.
"""

from __future__ import annotations

import logging
from typing import Dict, List

import numpy as np

logger = logging.getLogger(__name__)


def report_precip_extremes(x_bt: np.ndarray, name: str, cap_mm_day: float = 500.0) -> Dict:
    """x_bt: back-transformed precip, leading batch axis. Returns a flag dict."""
    flat = np.asarray(x_bt).reshape(x_bt.shape[0], -1)
    p999 = np.quantile(flat, 0.999, axis=1)
    mx = flat.max(axis=1)
    extremes: List[float] = []
    below_zero: List[float] = []
    for i, (p, m) in enumerate(zip(p999, mx)):
        if m > max(5.0 * p, cap_mm_day):
            logger.warning(
                "%s sample %d has extreme precipitation: max=%.1f mm/day "
                "> max(5 x p99.9=%.1f, cap=%.1f)", name, i, m, 5.0 * p, cap_mm_day
            )
            extremes.append(float(m))
        if flat[i].min() < 0:
            logger.warning(
                "%s sample %d has negative precipitation: min=%.3g", name, i, flat[i].min()
            )
            below_zero.append(float(flat[i].min()))
    out: Dict = {"has_extreme": bool(extremes)}
    if extremes:
        out.update(n_extreme=len(extremes), extreme_values=extremes)
    if below_zero:
        out.update(has_below_zero=True, n_below_zero=len(below_zero),
                   below_zero_values=below_zero)
    return out


def clamp_extremes(x: np.ndarray, cap: float) -> np.ndarray:
    """Clamp generated extreme values from above at ``cap``."""
    return np.clip(x, None, cap)

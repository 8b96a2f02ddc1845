"""Continuous Ranked Probability Score for ensemble fields (a numpy copy of
``sbgm_danra_tpu/evaluate/crps.py``):

    CRPS(F, y) = E|X - y| - 1/2 E|X - X'|

per pixel over the member axis; the 'fair' variant applies the m/(m-1)
correction to the spread term.
"""

from __future__ import annotations

import numpy as np


def crps_ensemble(members: np.ndarray, obs: np.ndarray, fair: bool = True) -> np.ndarray:
    """members: (M, ...), obs: (...). Returns per-pixel CRPS of obs's shape."""
    members = np.asarray(members, dtype=np.float64)
    obs = np.asarray(obs, dtype=np.float64)
    m = members.shape[0]
    if m < 1:
        raise ValueError("Need at least one ensemble member")
    mae_term = np.abs(members - obs[None]).mean(axis=0)
    if m == 1:
        return mae_term
    # sum over pairs of |xi - xj| = sum_k (2k - m - 1) x_(k) on the sorted
    # members: no M x M difference tensor
    srt = np.sort(members, axis=0)
    idx = np.arange(1, m + 1).reshape((m,) + (1,) * (members.ndim - 1))
    pair_sum = ((2 * idx - m - 1) * srt).sum(axis=0)
    denom = m * (m - 1) if fair else m * m
    spread = pair_sum / denom
    return mae_term - spread


def crps_mean(members: np.ndarray, obs: np.ndarray, fair: bool = True) -> float:
    return float(crps_ensemble(members, obs, fair).mean())

"""Ensemble spread calibration (a numpy copy of
``sbgm_danra_tpu/evaluate/calibration.py``): members are rescaled about their
ensemble mean by one factor alpha,

    x_cal = mean + alpha * (x - mean)

fitted on held-out validation ensembles by one of two rules:

- ``crps``          golden-section minimisation of the mean fair CRPS;
- ``spread_skill``  closed form alpha = RMSE(ensemble mean) / fair spread,
                    which sets the fair spread/skill ratio to 1.

Both work in the space the members are given in; ``SampleGenerator``
applies the factor in normalised space, before the back-transform, so that a
non-linear inverse (the precipitation log transform) does not distort it.
"""

from __future__ import annotations

import numpy as np

from sbgm_danra_tpu_torch.evaluate.crps import crps_ensemble

_GOLDEN = (np.sqrt(5.0) - 1.0) / 2.0


def _as_batched(members: np.ndarray, truth: np.ndarray):
    """(K, H, W) vs (H, W) or (N, K, H, W) vs (N, H, W), told apart by ndim
    (fields are always 2-D); returns the batched pair."""
    members = np.asarray(members, dtype=np.float64)
    truth = np.asarray(truth, dtype=np.float64)
    if members.ndim == 3 and truth.ndim == 2:
        members, truth = members[None], truth[None]
    elif not (members.ndim == 4 and truth.ndim == 3):
        raise ValueError(
            f"members {members.shape} incompatible with truth {truth.shape}; "
            "expected (K, H, W) vs (H, W) or (N, K, H, W) vs (N, H, W)"
        )
    if members.shape[0] != truth.shape[0] or members.shape[2:] != truth.shape[1:]:
        raise ValueError(f"members {members.shape} incompatible with truth {truth.shape}")
    return members, truth


def apply_spread_scale(members: np.ndarray, alpha: float) -> np.ndarray:
    """Rescale members about their per-case ensemble mean: the member axis is
    0 for a (K, H, W) ensemble and 1 for a batched (N, K, H, W) one."""
    members = np.asarray(members)
    axis = 1 if members.ndim >= 4 else 0
    mean = members.mean(axis=axis, keepdims=True)
    return mean + float(alpha) * (members - mean)


def ensemble_spread_skill(members: np.ndarray, truth: np.ndarray) -> tuple:
    """(fair spread, RMSE of ensemble mean) pooled over all cases and pixels."""
    members, truth = _as_batched(members, truth)
    k = members.shape[1]
    mean = members.mean(axis=1)
    rmse = float(np.sqrt(((mean - truth) ** 2).mean()))
    var = ((members - mean[:, None]) ** 2).sum(axis=1).mean() / (k - 1)
    spread = float(np.sqrt(var * (k + 1) / k))  # fair correction
    return spread, rmse


def spread_scale_closed_form(members: np.ndarray, truth: np.ndarray) -> float:
    """alpha = RMSE(mean) / spread: sets the fair spread/skill to 1."""
    spread, rmse = ensemble_spread_skill(members, truth)
    if spread <= 0:
        return 1.0
    return rmse / spread


def _mean_crps(members: np.ndarray, truth: np.ndarray) -> float:
    return float(np.mean([crps_ensemble(members[i], truth[i]).mean()
                          for i in range(members.shape[0])]))


def fit_spread_scale(
    members: np.ndarray,
    truth: np.ndarray,
    rule: str = "crps",
    lo: float = 0.02,
    hi: float = 3.0,
    tol: float = 1e-3,
) -> float:
    """The inflation factor fitted on validation ensembles: members (N, K, H,
    W) (or one (K, H, W) ensemble), truth (N, H, W)."""
    members, truth = _as_batched(members, truth)
    if rule == "spread_skill":
        return spread_scale_closed_form(members, truth)
    if rule != "crps":
        raise ValueError(f"unknown calibration rule {rule!r}")

    def objective(alpha: float) -> float:
        return _mean_crps(apply_spread_scale(members, alpha), truth)

    # golden-section search: the objective is unimodal in alpha for fixed means
    a, b = float(lo), float(hi)
    c = b - _GOLDEN * (b - a)
    d = a + _GOLDEN * (b - a)
    fc, fd = objective(c), objective(d)
    while b - a > tol:
        if fc < fd:
            b, d, fd = d, c, fc
            c = b - _GOLDEN * (b - a)
            fc = objective(c)
        else:
            a, c, fc = c, d, fd
            d = a + _GOLDEN * (b - a)
            fd = objective(d)
    return float((a + b) / 2.0)

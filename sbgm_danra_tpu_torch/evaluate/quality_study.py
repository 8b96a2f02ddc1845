"""Sampler quality study on synthetic regimes with EXACT scores (counterpart of
``sbgm_danra_tpu/evaluate/quality_study.py``).

The score function is analytic, so the study checks the samplers' statistics
against exact truths with no trained model in the way: does a low-NFE EDM or
DPM-Solver++ pass reproduce the target distribution as faithfully as the
1000-step predictor-corrector loop? Three regimes, each with a closed-form
noised score under the VE SDE (x_t = x_0 + sigma(t) z), written in torch:

- ``unimodal``:   iid pixels ~ N(mu, s^2)
- ``bimodal``:    iid pixels ~ 0.5 N(-m, s^2) + 0.5 N(+m, s^2)
- ``correlated``: a stationary periodic Gaussian field with a Gaussian
                  spectral covariance; the score diagonalised by ``torch.fft``

The headline regimes are scaled to the z-scored data contract (pixel std ~
1, well inside sigma_max ~ 9.85); the ``*_prior_stress`` regimes break it on
purpose (the reverse-only samplers inherit the prior's coverage gap there).

Metrics per (regime, sampler), numpy on the host: ensemble CRPS against
held-out truth draws, marginal mean bias and std ratio, spread/skill, and the
rank histogram's largest deviation from uniform, on M-member ensembles.

``run_study`` runs the port's samplers on ``device``: on a CUDA device each
(regime, sampler) call is one replay of its captured graph
(``sampling/graphs.py``; the regime's score has no UNet, so no K1 or K2), on
the CPU the eager loop. One ``torch.Generator`` seeded from ``seed`` draws
the truths and every sampler's noise in turn (ROADMAP F4: the streams differ
from JAX's).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Sequence

import numpy as np
import torch

from sbgm_danra_tpu_torch.capture import use_graphs
from sbgm_danra_tpu_torch.data.device_data import require_device
from sbgm_danra_tpu_torch.evaluate.crps import crps_ensemble
from sbgm_danra_tpu_torch.sampling import graphs
from sbgm_danra_tpu_torch.sampling.samplers import SamplerConfig
from sbgm_danra_tpu_torch.sde import VESDE

# ---------------------------------------------------------------- regimes


@dataclasses.dataclass(frozen=True)
class Regime:
    name: str
    score_fn: Callable  # (x, t, **kw) -> exact noised score, NHWC torch
    sample_truth: Callable  # (generator, shape) -> draws from the target on its device
    mean: float
    std: float


def _sigma(sde, t: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """sigma(t) broadcast over x's trailing axes."""
    return sde.marginal_prob_std(t).reshape((-1,) + (1,) * (x.dim() - 1))


def _randn(gen: torch.Generator, shape) -> torch.Tensor:
    return torch.randn(tuple(shape), generator=gen, device=gen.device)


def gaussian_regime(mu: float = 0.2, s: float = 1.0, sde=VESDE(),
                    name: str = "unimodal") -> Regime:
    def score(x, t, **kw):
        var = s**2 + _sigma(sde, t, x) ** 2
        return -(x - mu) / var

    def truth(gen, shape):
        return mu + s * _randn(gen, shape)

    return Regime(name, score, truth, mu, s)


def bimodal_regime(m: float = 1.0, s: float = 0.5, sde=VESDE()) -> Regime:
    """0.5 N(-m, s^2) + 0.5 N(+m, s^2) per pixel; the noised score follows the
    posterior-weighted component scores (responsibilities via tanh)."""

    def score(x, t, **kw):
        var = s**2 + _sigma(sde, t, x) ** 2
        r = torch.tanh(m * x / var)  # w_+ - w_- for symmetric weights
        return -(x - r * m) / var

    def truth(gen, shape):
        sign = torch.where(torch.rand(tuple(shape), generator=gen, device=gen.device) < 0.5,
                           1.0, -1.0)
        return sign * m + s * _randn(gen, shape)

    std = float(np.sqrt(m**2 + s**2))
    return Regime("bimodal", score, truth, 0.0, std)


def correlated_regime(size: int = 16, ell: float = 0.5, amp: float = 1.0, sde=VESDE(),
                      name: str = "correlated") -> Regime:
    """Stationary periodic Gaussian field: covariance diagonal in Fourier
    space with spectrum S(k) = amp^2 g(k) / mean(g), g a Gaussian bump. The
    noised score is -F^-1[F(x) / (S(k) + sigma_t^2)]."""
    kx = np.fft.fftfreq(size)[:, None]
    ky = np.fft.fftfreq(size)[None, :]
    g = np.exp(-(kx**2 + ky**2) * (ell * size / 2.0) ** 2)
    spec_np = (amp**2 * g / g.mean()).astype(np.float32)  # E[pixel variance] = amp^2
    specs: Dict[torch.device, torch.Tensor] = {}  # made at the first (eager) call per device

    def spec_on(device) -> torch.Tensor:
        if device not in specs:
            specs[device] = torch.from_numpy(spec_np).to(device)
        return specs[device]

    def score(x, t, **kw):
        sig2 = _sigma(sde, t, x) ** 2
        xf = torch.fft.fft2(x[..., 0].to(torch.complex64))
        sf = xf / (spec_on(x.device) + sig2[..., 0])
        return -torch.real(torch.fft.ifft2(sf))[..., None].to(x.dtype)

    def truth(gen, shape):
        z = _randn(gen, shape)
        zf = torch.fft.fft2(z[..., 0].to(torch.complex64))
        xf = zf * torch.sqrt(spec_on(z.device))
        return torch.real(torch.fft.ifft2(xf))[..., None].to(z.dtype)

    return Regime(name, score, truth, 0.0, amp)


# ---------------------------------------------------------------- metrics


def rank_histogram_deviation(members: np.ndarray, truths: np.ndarray) -> float:
    """Max absolute deviation of the rank histogram from uniform, as a
    fraction of the uniform bin mass. members: (M, ...), truths: (K, ...)."""
    m = members.reshape(members.shape[0], -1)  # (M, P)
    t = truths.reshape(truths.shape[0], -1)  # (K, P)
    ranks = (t[:, None, :] > m[None, :, :]).sum(axis=1).ravel()  # 0..M
    hist = np.bincount(ranks, minlength=m.shape[0] + 1).astype(np.float64)
    hist /= hist.sum()
    uniform = 1.0 / (m.shape[0] + 1)
    return float(np.abs(hist - uniform).max() / uniform)


def evaluate_ensemble(members: np.ndarray, truths: np.ndarray, regime: Regime) -> Dict[str, float]:
    """members: (M, H, W, 1) ensemble; truths: (K, H, W, 1) independent draws."""
    crps_vals = [float(crps_ensemble(members, t).mean()) for t in truths]
    ens_mean = members.mean(axis=0)
    rmse = float(np.sqrt(((ens_mean - truths) ** 2).mean()))
    spread = float(members.std(axis=0, ddof=1).mean())
    return {
        "crps": float(np.mean(crps_vals)),
        "mean_bias": float(members.mean() - regime.mean),
        "std_ratio": float(members.std() / regime.std),
        "spread_skill": spread / max(rmse, 1e-12),
        "rank_dev": rank_histogram_deviation(members, truths),
    }


# ---------------------------------------------------------------- study


SAMPLER_GRID: Sequence[Dict] = (
    {"label": "pc_1000", "sampler": "pc_sampler", "num_steps": 1000, "nfe": 2000},
    {"label": "pc_100", "sampler": "pc_sampler", "num_steps": 100, "nfe": 200},
    {"label": "em_1000", "sampler": "em_sampler", "num_steps": 1000, "nfe": 1000},
    {"label": "edm_18", "sampler": "edm_sampler", "num_steps": 18, "nfe": 34},
    {"label": "edm_35", "sampler": "edm_sampler", "num_steps": 35, "nfe": 68},
    {"label": "edm_35_churn", "sampler": "edm_sampler", "num_steps": 35, "nfe": 68,
     "s_churn": 14.0},
    {"label": "edm_50", "sampler": "edm_sampler", "num_steps": 50, "nfe": 98},
    {"label": "dpmpp_25", "sampler": "dpmpp_sampler", "num_steps": 25, "nfe": 24},
    {"label": "dpmpp_35", "sampler": "dpmpp_sampler", "num_steps": 35, "nfe": 34},
)


def default_regimes(size: int = 16, sde=VESDE(), stress: bool = True):
    """The headline regimes, scaled to the z-scored data contract, and the
    deliberate prior-misspecification stress cases."""
    regimes = [
        gaussian_regime(sde=sde),
        bimodal_regime(sde=sde),
        correlated_regime(size=size, sde=sde),
    ]
    if stress:
        regimes += [
            # mean offset sigma_max/10, std 2: visible init-coverage bias
            gaussian_regime(mu=1.0, s=2.0, sde=sde, name="unimodal_prior_stress"),
            # ell=3 puts variance into a mode with std ~ 26 > sigma_max
            correlated_regime(size=size, ell=3.0, amp=2.0, sde=sde,
                              name="correlated_prior_stress"),
        ]
    return tuple(regimes)


def run_study(
    n_members: int = 64,
    size: int = 16,
    n_truths: int = 256,
    seed: int = 0,
    sampler_grid: Sequence[Dict] = SAMPLER_GRID,
    regimes: Sequence[Regime] = (),
    device="cuda",
    capture: Optional[bool] = None,
) -> Dict[str, Dict[str, Dict[str, float]]]:
    """Each regime's truths, then each sampler's ensemble of ``n_members``
    fields of size x size, scored by ``evaluate_ensemble``. ``device``: the
    card unless the caller asks for the CPU; ``capture``: see
    ``capture.use_graphs``."""
    device = require_device(device)
    sde = VESDE()
    regimes = regimes or default_regimes(size=size, sde=sde)
    gen = torch.Generator(device).manual_seed(seed)
    route = use_graphs(capture, device)
    shape = (n_members, size, size, 1)
    out: Dict[str, Dict[str, Dict[str, float]]] = {}
    with torch.no_grad():
        for regime in regimes:
            truths = regime.sample_truth(gen, (n_truths, size, size, 1)).cpu().numpy()
            row: Dict[str, Dict[str, float]] = {}
            for spec in sampler_grid:
                cfg = SamplerConfig(num_steps=spec["num_steps"], s_churn=spec.get("s_churn", 0.0))
                members = graphs.call(spec["sampler"], regime.score_fn, gen, shape, sde, cfg,
                                      graph=route)
                row[spec["label"]] = {
                    **evaluate_ensemble(members.cpu().numpy(), truths, regime),
                    "nfe": spec["nfe"],
                }
            out[regime.name] = row
    return out


def format_table(results: Dict[str, Dict[str, Dict[str, float]]]) -> str:
    lines = []
    for regime, rows in results.items():
        lines.append(f"\n### {regime}")
        lines.append("| sampler | NFE | CRPS | mean bias | std ratio | spread/skill | rank dev |")
        lines.append("|---|---|---|---|---|---|---|")
        for label, m in rows.items():
            lines.append(
                f"| {label} | {int(m['nfe'])} | {m['crps']:.4f} | "
                f"{m['mean_bias']:+.4f} | {m['std_ratio']:.4f} | "
                f"{m['spread_skill']:.3f} | {m['rank_dev']:.3f} |"
            )
    return "\n".join(lines)

"""Reverse-SDE samplers (counterpart of ``sbgm_danra_tpu/sampling/samplers.py``).

``pc_sampler``, ``edm_sampler`` and ``dpmpp_sampler`` with the JAX package's
semantics; each step is a Python loop iteration (the JAX ``lax.scan``), and
the per-node schedule is computed in float32 as in JAX. ``em_sampler`` and
``ode_sampler`` are not ported yet.

Noise comes from ``rng``: one ``torch.Generator`` for the whole batch, or a
sequence of generators, one per batch row, so that a row's draws depend only
on its own generator (what the serving engine needs to co-batch requests).
Noise is drawn on the generator's device. ``torch.Generator`` and
``jax.random`` never give the same numbers (ROADMAP F4): the parity tests
hand both sides the same latent ``z``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Optional, Sequence, Union

import torch

from sbgm_danra_tpu_torch.sampling.guidance import apply_guidance
from sbgm_danra_tpu_torch.sde import VESDE, edm_sigma_schedule

ScoreFn = Callable[..., torch.Tensor]
Rng = Union[torch.Generator, Sequence[torch.Generator]]


@dataclasses.dataclass(frozen=True)
class SamplerConfig:
    """Static sampler hyperparameters (the JAX ``SamplerConfig``'s fields)."""

    num_steps: int = 1000
    eps: float = 1e-3
    snr: float = 0.16
    guidance_scale: Optional[float] = None
    guidance_scale_max: Optional[float] = None
    ode_method: str = "rk4"
    rtol: float = 1e-5
    atol: float = 1e-5
    edm_rho: float = 7.0
    s_churn: float = 0.0


def randn(rng: Rng, shape: Sequence[int]) -> torch.Tensor:
    """Standard normal float32 noise of ``shape``; per-row generators draw their own rows."""
    if isinstance(rng, torch.Generator):
        return torch.randn(tuple(shape), generator=rng, device=rng.device)
    gens = list(rng)
    if len(gens) != shape[0]:
        raise ValueError(f"{len(gens)} generators for a batch of {shape[0]}")
    row = (1, *shape[1:])
    return torch.cat([torch.randn(row, generator=g, device=g.device) for g in gens])


def _bcast(v: torch.Tensor, ndim: int) -> torch.Tensor:
    return v.reshape((-1,) + (1,) * (ndim - 1))


def _prepare(score_fn: ScoreFn, config: SamplerConfig) -> ScoreFn:
    return apply_guidance(score_fn, config.guidance_scale, config.guidance_scale_max)


def _to(x: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    return x.to(device=like.device, dtype=torch.float32)


def pc_sampler(
    score_fn: ScoreFn,
    rng: Rng,
    shape: Sequence[int],
    sde=VESDE(),
    config: SamplerConfig = SamplerConfig(),
    cond: Optional[Dict[str, torch.Tensor]] = None,
    per_member_step: bool = False,
) -> torch.Tensor:
    """Predictor-corrector sampler (Langevin + Euler-Maruyama); two NFE per step.

    The Langevin step size uses the batch-mean score norm, a scalar shared by
    the batch (JAX samplers.py:135-138). ``per_member_step=True`` uses each
    row's own norm instead: what the JAX serving engine computes by vmapping a
    batch-of-one sampler over members (serve.py:86-95).
    """
    cond = cond or {}
    guided = _prepare(score_fn, config)
    x = randn(rng, shape)
    x = x * _to(sde.prior_std(), x)
    b = shape[0]
    noise_norm = math.sqrt(float(math.prod(shape[1:])))
    time_steps = torch.linspace(1.0, config.eps, config.num_steps, dtype=torch.float32).tolist()
    dt = (1.0 - config.eps) / max(config.num_steps - 1, 1)
    x_mean = x
    for t in time_steps:
        bt = torch.full((b,), t, dtype=torch.float32, device=x.device)
        grad = guided(x, bt, **cond)
        norms = torch.linalg.vector_norm(grad.reshape(b, -1), dim=-1)
        grad_norm = norms if per_member_step else norms.mean()
        step = _bcast(2.0 * (config.snr * noise_norm / grad_norm) ** 2, x.dim())
        x = x + step * grad + torch.sqrt(2.0 * step) * randn(rng, shape)

        g = _to(sde.diffusion_coeff(bt), x)
        score = guided(x, bt, **cond)
        x_mean = x + (_bcast(g**2, x.dim()) * score - sde.drift(x, bt)) * dt
        x = x_mean + _bcast(torch.sqrt(g**2 * dt), x.dim()) * randn(rng, shape)
    return x_mean


def _hat_schedule(sde, config: SamplerConfig):
    """shat grid from the prior down to t=eps, its times and mean coefficients (float32, CPU)."""
    def m_of(t):
        return sde.marginal_prob_mean_coeff(t)

    shat_max = sde.prior_std() / m_of(1.0)
    shat_min = sde.marginal_prob_std(config.eps) / m_of(config.eps)
    shats = edm_sigma_schedule(config.num_steps, shat_min, shat_max, config.edm_rho)
    return shat_max, shats, m_of


def edm_sampler(
    score_fn: ScoreFn,
    rng: Rng,
    shape: Sequence[int],
    sde=VESDE(),
    config: SamplerConfig = SamplerConfig(num_steps=35),
    cond: Optional[Dict[str, torch.Tensor]] = None,
    z: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """EDM (Karras et al. 2022): probability-flow Heun over the rho-spaced shat
    grid, optional churn; 2(num_steps - 1) score evaluations. Works in the hat
    coordinates xhat = x / m(t) of the JAX sampler (samplers.py:298-381)."""
    cond = cond or {}
    guided = _prepare(score_fn, config)
    b = shape[0]
    shat_max, shats, m_of = _hat_schedule(sde, config)
    gamma = min(config.s_churn / max(config.num_steps - 1, 1), 2.0**0.5 - 1.0)
    shats_churn = torch.minimum(shats * (1.0 + gamma), shat_max) if gamma > 0 else shats
    ts, ts_churn = sde.inverse_hat_std(shats), sde.inverse_hat_std(shats_churn)
    ms, ms_churn = m_of(ts), m_of(ts_churn)
    ds = (shats[1:] - shats_churn[:-1]).tolist()
    extra = torch.sqrt(torch.clamp(shats_churn**2 - shats**2, min=0.0)).tolist()

    if z is None:
        xhat = randn(rng, shape)
        xhat = xhat * _to(shat_max, xhat)
    else:
        xhat = z / _to(m_of(1.0), z)

    def shat_drift(xhat, t, m, shat):
        bt = torch.full((b,), t, dtype=torch.float32, device=xhat.device)
        return -shat * m * guided((m * xhat).to(xhat.dtype), bt, **cond)

    sh, shc, tn, tc, mn, mc = (a.tolist() for a in (shats, shats_churn, ts, ts_churn, ms, ms_churn))
    for i in range(config.num_steps - 1):
        if gamma > 0.0:
            xhat = xhat + extra[i] * randn(rng, shape)
        k1 = shat_drift(xhat, tc[i], mc[i], shc[i])
        xhat_pred = xhat + ds[i] * k1
        k2 = shat_drift(xhat_pred, tn[i + 1], mn[i + 1], sh[i + 1])
        xhat = xhat + 0.5 * ds[i] * (k1 + k2)
    return mn[-1] * xhat


def dpmpp_sampler(
    score_fn: ScoreFn,
    rng: Rng,
    shape: Sequence[int],
    sde=VESDE(),
    config: SamplerConfig = SamplerConfig(num_steps=25),
    cond: Optional[Dict[str, torch.Tensor]] = None,
    z: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """DPM-Solver++(2M) over the Karras grid in hat coordinates; num_steps - 1
    score evaluations, deterministic given the latent (JAX samplers.py:384-473)."""
    cond = cond or {}
    guided = _prepare(score_fn, config)
    b = shape[0]
    shat_max, shats, m_of = _hat_schedule(sde, config)
    ts = sde.inverse_hat_std(shats)
    ms = m_of(ts)

    if z is None:
        xhat = randn(rng, shape)
        xhat = xhat * _to(shat_max, xhat)
    else:
        xhat = z / _to(m_of(1.0), z)
    if config.num_steps < 2:
        return ms[-1].item() * xhat

    def denoise(xhat, t, m, shat):
        bt = torch.full((b,), t, dtype=torch.float32, device=xhat.device)
        return xhat + shat**2 * m * guided((m * xhat).to(xhat.dtype), bt, **cond)

    lams = -torch.log(shats)
    # guarded as in JAX: a degenerate grid gives a finite no-op step, not 0/0
    hs = torch.clamp(lams[1:] - lams[:-1], min=1e-12)
    ratios = (shats[1:] / shats[:-1]).tolist()
    rs = (hs[:-1] / hs[1:]).tolist()  # r_i = h_{i-1} / h_i
    sh, tn, mn = shats.tolist(), ts.tolist(), ms.tolist()

    d_prev = denoise(xhat, tn[0], mn[0], sh[0])  # first interval: first order
    xhat = ratios[0] * xhat + (1.0 - ratios[0]) * d_prev
    for i in range(1, config.num_steps - 1):
        d = denoise(xhat, tn[i], mn[i], sh[i])
        w = 1.0 / (2.0 * rs[i - 1])
        d_bar = (1.0 + w) * d - w * d_prev
        xhat = ratios[i] * xhat + (1.0 - ratios[i]) * d_bar
        d_prev = d
    return mn[-1] * xhat


_PORTED = {
    "pc_sampler": pc_sampler,
    "edm_sampler": edm_sampler,
    "edm": edm_sampler,
    "dpmpp_sampler": dpmpp_sampler,
    "dpmpp_2m": dpmpp_sampler,
}
_NOT_YET = ("em_sampler", "euler_maruyama", "ode_sampler")


def get_sampler(name: str):
    """Sampler registry keyed by the JAX package's config names."""
    if name in _NOT_YET:
        raise NotImplementedError(
            f"sampler '{name}' is not yet ported to the torch package (ROADMAP queue 1)"
        )
    if name not in _PORTED:
        raise ValueError(f"Unknown sampler '{name}'; options: {sorted([*_PORTED, *_NOT_YET])}")
    return _PORTED[name]

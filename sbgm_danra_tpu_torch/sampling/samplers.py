"""Reverse-SDE samplers (counterpart of ``sbgm_danra_tpu/sampling/samplers.py``).

``em_sampler``, ``pc_sampler``, ``ode_sampler`` (rk4, heun, adaptive rk45),
``edm_sampler`` and ``dpmpp_sampler`` with the JAX package's semantics; each
step is a Python loop iteration (the JAX ``lax.scan`` / ``while_loop``), and
times and schedules are computed in float32 as in JAX.

Noise comes from ``rng``: one ``torch.Generator`` for the whole batch, or a
sequence of generators, one per batch row, so that a row's draws depend only
on its own generator (what the serving engine needs to co-batch requests).
Noise is drawn on the generator's device. ``torch.Generator`` and
``jax.random`` never give the same numbers (ROADMAP F4): the parity tests
hand both sides the same latent ``z``.
"""

from __future__ import annotations

import dataclasses
import logging
import math
from typing import Callable, Dict, Optional, Sequence, Union

import torch

from sbgm_danra_tpu_torch.sampling.guidance import apply_guidance
from sbgm_danra_tpu_torch.sde import VESDE, edm_sigma_schedule

logger = logging.getLogger(__name__)

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


def em_sampler(
    score_fn: ScoreFn,
    rng: Rng,
    shape: Sequence[int],
    sde=VESDE(),
    config: SamplerConfig = SamplerConfig(),
    cond: Optional[Dict[str, torch.Tensor]] = None,
) -> torch.Tensor:
    """Euler-Maruyama reverse-SDE sampler; one NFE per step. Returns the last
    step's noiseless mean, and carries the SDE's drift (VP), as the JAX
    sampler does (samplers.py:69-102)."""
    cond = cond or {}
    guided = _prepare(score_fn, config)
    x = randn(rng, shape)
    x = x * _to(sde.prior_std(), x)
    b = shape[0]
    time_steps = torch.linspace(1.0, config.eps, config.num_steps, dtype=torch.float32).tolist()
    dt = (1.0 - config.eps) / max(config.num_steps - 1, 1)
    mean_x = x
    for t in time_steps:
        bt = torch.full((b,), t, dtype=torch.float32, device=x.device)
        g = _bcast(_to(sde.diffusion_coeff(bt), x), x.dim())
        mean_x = x + (g**2 * guided(x, bt, **cond) - sde.drift(x, bt)) * dt
        x = mean_x + math.sqrt(dt) * g * randn(rng, shape)
    return mean_x


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


def _ode_drift(guided, sde, cond, x: torch.Tensor, t: float) -> torch.Tensor:
    """Probability-flow drift f(x, t) - 1/2 g(t)^2 s(x, t) at the float32 time ``t``."""
    bt = torch.full((x.shape[0],), t, dtype=torch.float32, device=x.device)
    g2 = _bcast(_to(sde.diffusion_coeff(bt), x), x.dim()) ** 2
    return sde.drift(x, bt) - 0.5 * g2 * guided(x, bt, **cond)


def ode_sampler(
    score_fn: ScoreFn,
    rng: Rng,
    shape: Sequence[int],
    sde=VESDE(),
    config: SamplerConfig = SamplerConfig(),
    cond: Optional[Dict[str, torch.Tensor]] = None,
    z: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Probability-flow ODE from t=1 to eps with conditioning on every
    evaluation, deterministic given the latent ``z`` (JAX samplers.py:158-295).
    ``config.ode_method``: fixed-step 'rk4' (4 NFE per step) or 'heun' (2 NFE
    per step) over ``num_steps - 1`` intervals, or adaptive Dormand-Prince
    'rk45' (7 NFE per attempted step)."""
    cond = cond or {}
    guided = _prepare(score_fn, config)
    if z is None:
        x = randn(rng, shape)
        x = x * _to(sde.prior_std(), x)
    else:
        x = z

    def drift(x, t):
        return _ode_drift(guided, sde, cond, x, t)

    if config.ode_method == "rk45":
        x, converged = _rk45_adaptive(drift, x, 1.0, config.eps, config.rtol, config.atol)
        if not converged:
            logger.warning("ode_sampler(rk45): iteration cap reached before t=eps; "
                           "sample is UNCONVERGED")
        return x
    if config.ode_method not in ("rk4", "heun"):
        raise ValueError(f"Unknown ode_method: {config.ode_method}")

    ts = torch.linspace(1.0, config.eps, config.num_steps, dtype=torch.float32)[:-1]
    dt = -(1.0 - config.eps) / max(config.num_steps - 1, 1)
    # node times as the JAX scan forms them: float32 t plus a float32 offset
    t0s, t_half, t_end = ts.tolist(), (ts + 0.5 * dt).tolist(), (ts + dt).tolist()
    for i in range(len(t0s)):
        k1 = drift(x, t0s[i])
        if config.ode_method == "heun":
            k2 = drift(x + dt * k1, t_end[i])
            x = x + 0.5 * dt * (k1 + k2)
        else:
            k2 = drift(x + 0.5 * dt * k1, t_half[i])
            k3 = drift(x + 0.5 * dt * k2, t_half[i])
            k4 = drift(x + dt * k3, t_end[i])
            x = x + (dt / 6.0) * (k1 + 2 * k2 + 2 * k3 + k4)
    return x


# Dormand-Prince RK45 Butcher tableau.
_DP_C = (0.0, 1 / 5, 3 / 10, 4 / 5, 8 / 9, 1.0, 1.0)
_DP_A = (
    (),
    (1 / 5,),
    (3 / 40, 9 / 40),
    (44 / 45, -56 / 15, 32 / 9),
    (19372 / 6561, -25360 / 2187, 64448 / 6561, -212 / 729),
    (9017 / 3168, -355 / 33, 46732 / 5247, 49 / 176, -5103 / 18656),
    (35 / 384, 0.0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84),
)
_DP_B5 = (35 / 384, 0.0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84, 0.0)
_DP_B4 = (5179 / 57600, 0.0, 7571 / 16695, 393 / 640, -92097 / 339200, 187 / 2100, 1 / 40)
_RK45_MAX_ITERS = 10_000


def _rk45_adaptive(drift, x: torch.Tensor, t0: float, t1: float, rtol: float, atol: float):
    """Adaptive Dormand-Prince from t0 down to t1 < t0, as the JAX
    ``lax.while_loop`` runs it (samplers.py:253-295): t, h and the error
    control are float32 tensors with the JAX arithmetic, so the two accept the
    same steps until an error norm made mostly of float32 rounding parts their
    step sizes by an ulp. The host reads the error norm once per attempted
    step. Returns (x, converged)."""
    f32 = torch.float32
    t = torch.tensor(t0, dtype=f32)
    h = torch.tensor((t1 - t0) / 100.0, dtype=f32)
    t_stop = torch.tensor(t1 + 1e-9, dtype=f32)
    t_end = torch.tensor(t1, dtype=f32)
    h_max = torch.tensor(-1e-5, dtype=f32)
    n = 0
    while bool(t > t_stop) and n < _RK45_MAX_ITERS:
        # integrating downward: h stays negative; clamp its magnitude only
        h = torch.minimum(h, h_max)
        if bool(t + h < t_end):  # don't overshoot t1
            h = t_end - t
        ks = []
        for i in range(7):
            xi = x
            for j, a in enumerate(_DP_A[i]):
                xi = xi + h * a * ks[j]
            ks.append(drift(xi, (t + _DP_C[i] * h).item()))
        x5, x4 = x, x
        for k, b5, b4 in zip(ks, _DP_B5, _DP_B4):
            x5 = x5 + h * b5 * k
            x4 = x4 + h * b4 * k
        scale = atol + rtol * torch.maximum(x.abs(), x5.abs())
        err = ((x5 - x4).abs() / scale).max().cpu()
        if bool(err <= 1.0):
            x, t = x5, t + h
        h = h * torch.clamp(0.9 * err ** (-0.2), 0.2, 5.0)
        n += 1
    return x, bool(t <= t_stop)


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


_SAMPLERS = {
    "em_sampler": em_sampler,
    "euler_maruyama": em_sampler,
    "pc_sampler": pc_sampler,
    "ode_sampler": ode_sampler,
    "edm_sampler": edm_sampler,
    "edm": edm_sampler,
    "dpmpp_sampler": dpmpp_sampler,
    "dpmpp_2m": dpmpp_sampler,
}


def get_sampler(name: str):
    """Sampler registry keyed by the JAX package's config names."""
    if name not in _SAMPLERS:
        raise ValueError(f"Unknown sampler '{name}'; options: {sorted(_SAMPLERS)}")
    return _SAMPLERS[name]

"""Reverse-SDE samplers (counterpart of ``sbgm_danra_tpu/sampling/samplers.py``).

``em_sampler``, ``pc_sampler``, ``ode_sampler`` (rk4, heun, adaptive rk45),
``edm_sampler`` and ``dpmpp_sampler`` with the JAX package's semantics, each
written as its loop of score evaluations, with times and schedules in float32
as in JAX. The schedules are host constants made once per (SDE, config)
(``_schedule``), and nothing inside a loop reads a device value on the host,
so one function serves two routes: the loop runs eagerly (the CPU's route,
and the card's when the caller asks for it), or it is captured whole into one
CUDA graph and replayed (``sampling/graphs.py``, the card's default): the
counterpart of the JAX sampler's single XLA program (``lax.scan`` /
``lax.while_loop``). rk45 is the exception: its host loop reads the step's
outcome after every Dormand-Prince attempt, and one attempt
(``dp_attempt``, accept or reject selected on the device) is the graph.

Noise comes from ``rng``: one ``torch.Generator`` for the whole batch, or a
sequence of generators, one per batch row, so that a row's draws depend only
on its own generator (what the serving engine needs to co-batch requests).
Noise is drawn on the generator's device. Or it comes from ``draws``, a
buffer ``[n_draws(sampler, config), *shape]`` of the same draws made
beforehand in the loop's order (``draw_noise``): given the same generator
the two routes take the same numbers, and a graph takes its noise so.
``torch.Generator`` and ``jax.random`` never give the same numbers (ROADMAP
F4): the parity tests hand both sides the same latent ``z``.
"""

from __future__ import annotations

import dataclasses
import functools
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


def config_from_run(cfg, num_steps: int) -> SamplerConfig:
    """A run config's sampler settings (``sampler``, ``classifier_free_guidance``)
    at ``num_steps``, as the JAX package's generator, previews and serving
    engine build them."""
    g = cfg.classifier_free_guidance
    return SamplerConfig(
        num_steps=num_steps,
        snr=cfg.sampler.snr,
        eps=cfg.sampler.t_eps,
        guidance_scale=g.guidance_scale if g.enabled else None,
        guidance_scale_max=g.guidance_scale_max,
        edm_rho=cfg.sampler.edm_rho,
        s_churn=cfg.sampler.s_churn,
    )


def randn(rng: Rng, shape: Sequence[int]) -> torch.Tensor:
    """Standard normal float32 noise of ``shape``; per-row generators draw their own rows."""
    if isinstance(rng, torch.Generator):
        return torch.randn(tuple(shape), generator=rng, device=rng.device)
    gens = list(rng)
    if len(gens) != shape[0]:
        raise ValueError(f"{len(gens)} generators for a batch of {shape[0]}")
    row = (1, *shape[1:])
    return torch.cat([torch.randn(row, generator=g, device=g.device) for g in gens])


def draw_noise(rng: Rng, shape: Sequence[int], n: int,
               out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``n`` successive ``randn(rng, shape)`` draws as one ``[n, *shape]``
    float32 buffer (``out`` when given): per-row generators draw each row of
    each draw in turn, as ``randn`` does."""
    shape = tuple(shape)
    gens = [rng] if isinstance(rng, torch.Generator) else list(rng)
    if len(gens) > 1 and len(gens) != shape[0]:
        raise ValueError(f"{len(gens)} generators for a batch of {shape[0]}")
    if out is None:
        out = torch.empty((n, *shape), dtype=torch.float32, device=gens[0].device)
    for i in range(n):
        if isinstance(rng, torch.Generator):
            torch.randn(shape, generator=rng, out=out[i])
        else:
            for r, g in enumerate(gens):
                torch.randn((1, *shape[1:]), generator=g, out=out[i, r:r + 1])
    return out


class _Noise:
    """The sampler's next standard normal draw of its shape: from ``rng``, or
    the next entry of ``draws``."""

    def __init__(self, rng: Optional[Rng], shape: Sequence[int],
                 draws: Optional[torch.Tensor]):
        if rng is None and draws is None:
            raise ValueError("a sampler needs rng or draws")
        self.rng, self.shape, self.draws, self.used = rng, tuple(shape), draws, 0

    def __call__(self) -> torch.Tensor:
        if self.draws is None:
            return randn(self.rng, self.shape)
        if self.used >= self.draws.shape[0]:
            raise ValueError(f"draws hold {self.draws.shape[0]} draws; the sampler needs more")
        self.used += 1
        return self.draws[self.used - 1]


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
    draws: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Euler-Maruyama reverse-SDE sampler; one NFE per step. Returns the last
    step's noiseless mean, and carries the SDE's drift (VP), as the JAX
    sampler does (samplers.py:69-102)."""
    cond = cond or {}
    guided = _prepare(score_fn, config)
    noise = _Noise(rng, shape, draws)
    time_steps, dt, prior_std = _schedule("em", sde, config)
    x = noise() * prior_std
    b = shape[0]
    mean_x = x
    for t in time_steps:
        bt = torch.full((b,), t, dtype=torch.float32, device=x.device)
        g = _bcast(_to(sde.diffusion_coeff(bt), x), x.dim())
        mean_x = x + (g**2 * guided(x, bt, **cond) - sde.drift(x, bt)) * dt
        x = mean_x + math.sqrt(dt) * g * noise()
    return mean_x


def pc_sampler(
    score_fn: ScoreFn,
    rng: Rng,
    shape: Sequence[int],
    sde=VESDE(),
    config: SamplerConfig = SamplerConfig(),
    cond: Optional[Dict[str, torch.Tensor]] = None,
    per_member_step: bool = False,
    draws: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Predictor-corrector sampler (Langevin + Euler-Maruyama); two NFE per step.

    The Langevin step size uses the batch-mean score norm, a scalar shared by
    the batch (JAX samplers.py:135-138). ``per_member_step=True`` uses each
    row's own norm instead: what the JAX serving engine computes by vmapping a
    batch-of-one sampler over members (serve.py:86-95).
    """
    cond = cond or {}
    guided = _prepare(score_fn, config)
    noise = _Noise(rng, shape, draws)
    time_steps, dt, prior_std = _schedule("em", sde, config)
    x = noise() * prior_std
    b = shape[0]
    noise_norm = math.sqrt(float(math.prod(shape[1:])))
    x_mean = x
    for t in time_steps:
        bt = torch.full((b,), t, dtype=torch.float32, device=x.device)
        grad = guided(x, bt, **cond)
        norms = torch.linalg.vector_norm(grad.reshape(b, -1), dim=-1)
        grad_norm = norms if per_member_step else norms.mean()
        step = _bcast(2.0 * (config.snr * noise_norm / grad_norm) ** 2, x.dim())
        x = x + step * grad + torch.sqrt(2.0 * step) * noise()

        g = _to(sde.diffusion_coeff(bt), x)
        score = guided(x, bt, **cond)
        x_mean = x + (_bcast(g**2, x.dim()) * score - sde.drift(x, bt)) * dt
        x = x_mean + _bcast(torch.sqrt(g**2 * dt), x.dim()) * noise()
    return x_mean


def _ode_drift(guided, sde, cond, x: torch.Tensor, t) -> torch.Tensor:
    """Probability-flow drift f(x, t) - 1/2 g(t)^2 s(x, t) at the float32 time
    ``t`` (a host float, or a 0-d float32 tensor on x's device)."""
    if isinstance(t, torch.Tensor):
        bt = t.reshape(1).expand(x.shape[0]).contiguous()
    else:
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
    draws: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Probability-flow ODE from t=1 to eps with conditioning on every
    evaluation, deterministic given the latent ``z`` (JAX samplers.py:158-295).
    ``config.ode_method``: fixed-step 'rk4' (4 NFE per step) or 'heun' (2 NFE
    per step) over ``num_steps - 1`` intervals, or adaptive Dormand-Prince
    'rk45' (7 NFE per attempted step)."""
    cond = cond or {}
    guided = _prepare(score_fn, config)
    x = _Noise(rng, shape, draws)() * _schedule("prior", sde, config) if z is None else z

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

    t0s, t_half, t_end, dt = _schedule("ode", sde, config)
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


def rk45_start(x: torch.Tensor, t0: float, t1: float) -> tuple:
    """The adaptive loop's float32 state on x's device: (t, h, t_stop, t_end, h_max)."""
    def f32(v):
        return torch.tensor(v, dtype=torch.float32, device=x.device)

    return f32(t0), f32((t1 - t0) / 100.0), f32(t1 + 1e-9), f32(t1), f32(-1e-5)


def dp_attempt(drift, x: torch.Tensor, t: torch.Tensor, h: torch.Tensor, t_end: torch.Tensor,
               h_max: torch.Tensor, rtol: float, atol: float) -> tuple:
    """One Dormand-Prince attempt from (x, t) with step h, integrating down to
    ``t_end``, all on x's device: the step is clamped (|h| at least 1e-5, no
    overshoot), taken, accepted where its error norm is at most 1 (x and t
    move) and rejected elsewhere, and h rescaled; returns (x, t, h)."""
    # integrating downward: h stays negative; clamp its magnitude only
    h = torch.minimum(h, h_max)
    h = torch.where(t + h < t_end, t_end - t, h)  # don't overshoot t1
    ks = []
    for i in range(7):
        xi = x
        for j, a in enumerate(_DP_A[i]):
            xi = xi + h * a * ks[j]
        ks.append(drift(xi, t + _DP_C[i] * h))
    x5, x4 = x, x
    for k, b5, b4 in zip(ks, _DP_B5, _DP_B4):
        x5 = x5 + h * b5 * k
        x4 = x4 + h * b4 * k
    scale = atol + rtol * torch.maximum(x.abs(), x5.abs())
    err = ((x5 - x4).abs() / scale).max()
    accept = err <= 1.0
    x, t = torch.where(accept, x5, x), torch.where(accept, t + h, t)
    return x, t, h * torch.clamp(0.9 * err ** (-0.2), 0.2, 5.0)


def _rk45_adaptive(drift, x: torch.Tensor, t0: float, t1: float, rtol: float, atol: float,
                   attempt=None):
    """Adaptive Dormand-Prince from t0 down to t1 < t0, as the JAX
    ``lax.while_loop`` runs it (samplers.py:253-295): t, h and the error
    control are float32 tensors with the JAX arithmetic, so the two accept the
    same steps until an error norm made mostly of float32 rounding parts their
    step sizes by an ulp. Each attempt is ``dp_attempt`` (or ``attempt(x, t,
    h)``, the captured one); the host reads t once per attempt to stop the
    loop. Returns (x, converged)."""
    t, h, t_stop, t_end, h_max = rk45_start(x, t0, t1)
    if attempt is None:
        def attempt(x, t, h):
            return dp_attempt(drift, x, t, h, t_end, h_max, rtol, atol)
    n = 0
    while bool(t > t_stop) and n < _RK45_MAX_ITERS:
        x, t, h = attempt(x, t, h)
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


def _churn_gamma(config: SamplerConfig) -> float:
    return min(config.s_churn / max(config.num_steps - 1, 1), 2.0**0.5 - 1.0)


@functools.lru_cache(maxsize=128)
def _schedule(kind: str, sde, config: SamplerConfig):
    """A sampler's host constants for (``sde``, ``config``), made once on the
    CPU in float32 as the JAX samplers make them:

    - "prior": the prior's std as a float;
    - "em" (em and pc): (the times t, dt, the prior's std);
    - "ode" (rk4, heun): (the node times t, t + dt/2, t + dt, dt);
    - "edm": (shat, churned shat, t at each, m at each, Heun steps, churn
      noise scales, shat_max, m(1));
    - "dpmpp": (shat, t, m, the step ratios, r_i = h_{i-1} / h_i, shat_max, m(1)).
    """
    if kind == "prior":
        return float(sde.prior_std())
    if kind == "em":
        times = torch.linspace(1.0, config.eps, config.num_steps, dtype=torch.float32).tolist()
        return times, (1.0 - config.eps) / max(config.num_steps - 1, 1), float(sde.prior_std())
    if kind == "ode":
        ts = torch.linspace(1.0, config.eps, config.num_steps, dtype=torch.float32)[:-1]
        dt = -(1.0 - config.eps) / max(config.num_steps - 1, 1)
        # node times as the JAX scan forms them: float32 t plus a float32 offset
        return ts.tolist(), (ts + 0.5 * dt).tolist(), (ts + dt).tolist(), dt
    shat_max, shats, m_of = _hat_schedule(sde, config)
    m1 = float(m_of(1.0))
    if kind == "edm":
        gamma = _churn_gamma(config)
        shats_churn = torch.minimum(shats * (1.0 + gamma), shat_max) if gamma > 0 else shats
        ts, ts_churn = sde.inverse_hat_std(shats), sde.inverse_hat_std(shats_churn)
        ms, ms_churn = m_of(ts), m_of(ts_churn)
        ds = (shats[1:] - shats_churn[:-1]).tolist()
        extra = torch.sqrt(torch.clamp(shats_churn**2 - shats**2, min=0.0)).tolist()
        lists = tuple(a.tolist() for a in (shats, shats_churn, ts, ts_churn, ms, ms_churn))
        return (*lists, ds, extra, float(shat_max), m1)
    if kind == "dpmpp":
        ts = sde.inverse_hat_std(shats)
        ms = m_of(ts)
        lams = -torch.log(shats)
        # guarded as in JAX: a degenerate grid gives a finite no-op step, not 0/0
        hs = torch.clamp(lams[1:] - lams[:-1], min=1e-12)
        ratios = (shats[1:] / shats[:-1]).tolist()
        rs = (hs[:-1] / hs[1:]).tolist()  # r_i = h_{i-1} / h_i
        return shats.tolist(), ts.tolist(), ms.tolist(), ratios, rs, float(shat_max), m1
    raise ValueError(f"unknown schedule {kind}")


def edm_sampler(
    score_fn: ScoreFn,
    rng: Rng,
    shape: Sequence[int],
    sde=VESDE(),
    config: SamplerConfig = SamplerConfig(num_steps=35),
    cond: Optional[Dict[str, torch.Tensor]] = None,
    z: Optional[torch.Tensor] = None,
    draws: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """EDM (Karras et al. 2022): probability-flow Heun over the rho-spaced shat
    grid, optional churn; 2(num_steps - 1) score evaluations. Works in the hat
    coordinates xhat = x / m(t) of the JAX sampler (samplers.py:298-381)."""
    cond = cond or {}
    guided = _prepare(score_fn, config)
    b = shape[0]
    sh, shc, tn, tc, mn, mc, ds, extra, shat_max, m1 = _schedule("edm", sde, config)
    churn = _churn_gamma(config) > 0.0
    noise = _Noise(rng, shape, draws) if z is None or churn else None
    xhat = noise() * shat_max if z is None else z / m1

    def shat_drift(xhat, t, m, shat):
        bt = torch.full((b,), t, dtype=torch.float32, device=xhat.device)
        return -shat * m * guided((m * xhat).to(xhat.dtype), bt, **cond)

    for i in range(config.num_steps - 1):
        if churn:
            xhat = xhat + extra[i] * noise()
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
    draws: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """DPM-Solver++(2M) over the Karras grid in hat coordinates; num_steps - 1
    score evaluations, deterministic given the latent (JAX samplers.py:384-473)."""
    cond = cond or {}
    guided = _prepare(score_fn, config)
    b = shape[0]
    sh, tn, mn, ratios, rs, shat_max, m1 = _schedule("dpmpp", sde, config)
    xhat = _Noise(rng, shape, draws)() * shat_max if z is None else z / m1
    if config.num_steps < 2:
        return mn[-1] * xhat

    def denoise(xhat, t, m, shat):
        bt = torch.full((b,), t, dtype=torch.float32, device=xhat.device)
        return xhat + shat**2 * m * guided((m * xhat).to(xhat.dtype), bt, **cond)

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


def n_draws(sampler, config: SamplerConfig) -> int:
    """How many draws of the sample's shape the sampler (a function or a
    registry name) takes from its noise: the latent, then one per em step,
    two per pc step, one per edm step with churn."""
    fn = get_sampler(sampler) if isinstance(sampler, str) else sampler
    if fn is em_sampler:
        return 1 + config.num_steps
    if fn is pc_sampler:
        return 1 + 2 * config.num_steps
    if fn is edm_sampler and _churn_gamma(config) > 0.0:
        return config.num_steps
    return 1

"""Torch port: what the samplers' CUDA graphs rest on, checked on the CPU.

A graph takes its noise from a buffer of draws made before the replay, in
the eager loop's order (``samplers.draw_noise``); each sampler, given the
same generator, computes the same sample bit for bit from that buffer as from
the generator, and consumes exactly ``n_draws`` draws. rk45's captured unit
is one Dormand-Prince attempt (``dp_attempt``) whose accept or reject is a
select on the device: it equals the attempt that reads its error norm on the
host. The route rule (``capture.use_graphs``): graphs on a CUDA device unless
the caller asks for the eager loop, the eager loop on the CPU, where asking
for graphs raises. The replays themselves run on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``).
"""

import pytest
import torch

from sbgm_danra_tpu_torch import sde
from sbgm_danra_tpu_torch.capture import use_graphs
from sbgm_danra_tpu_torch.evaluate.full_domain import sample_full_domain
from sbgm_danra_tpu_torch.sampling import samplers as S

SHAPE = (3, 8, 8, 1)


def _gaussian_score(the_sde, mu=1.0, s0=2.0):
    """The exact score of N(mu, s0^2) diffused by ``the_sde``; conditioning
    shifts it, so that a guided score differs from the plain one."""
    def score(x, t, cond_img=None, **_):
        m = the_sde.marginal_prob_mean_coeff(t).reshape(-1, 1, 1, 1)
        var = m**2 * s0**2 + the_sde.marginal_prob_std(t).reshape(-1, 1, 1, 1) ** 2
        shift = 0.0 if cond_img is None else 0.1 * cond_img[..., :1]
        return -(x - m * mu) / var + shift
    return score


def _rng(per_row: bool, seed: int):
    if per_row:
        return [torch.Generator().manual_seed(seed + r) for r in range(SHAPE[0])]
    return torch.Generator().manual_seed(seed)


CASES = {  # name: (sampler, config, SDE, keyword options, per-row generators, conditioning)
    "em": (S.em_sampler, S.SamplerConfig(num_steps=6), sde.VESDE(), {}, False, False),
    "em_vp_cfg": (S.em_sampler, S.SamplerConfig(num_steps=5, guidance_scale=2.0), sde.VPSDE(),
                  {}, False, True),
    "pc": (S.pc_sampler, S.SamplerConfig(num_steps=5), sde.VESDE(), {}, False, False),
    "pc_per_member": (S.pc_sampler, S.SamplerConfig(num_steps=5), sde.VESDE(),
                      {"per_member_step": True}, False, False),
    "pc_per_row_generators": (S.pc_sampler, S.SamplerConfig(num_steps=5, guidance_scale=3.0),
                              sde.VESDE(), {"per_member_step": True}, True, True),
    "ode_rk4": (S.ode_sampler, S.SamplerConfig(num_steps=5, ode_method="rk4"), sde.VESDE(), {},
                False, False),
    "ode_heun": (S.ode_sampler, S.SamplerConfig(num_steps=5, ode_method="heun"), sde.VESDE(),
                 {}, True, False),
    "ode_rk45": (S.ode_sampler, S.SamplerConfig(ode_method="rk45", rtol=1e-3, atol=1e-3),
                 sde.VESDE(), {}, False, False),
    "edm_churn_0": (S.edm_sampler, S.SamplerConfig(num_steps=6), sde.VESDE(), {}, False, True),
    "edm_churn": (S.edm_sampler, S.SamplerConfig(num_steps=6, s_churn=2.0), sde.VESDE(), {},
                  True, False),
    "dpmpp": (S.dpmpp_sampler, S.SamplerConfig(num_steps=6, guidance_scale=3.0), sde.VESDE(),
              {}, False, True),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_draw_buffer_route_equals_generator_route(case):
    """The same generator: the sample from ``draws`` equals the sample from
    ``rng`` bit for bit, and ``draw_noise`` of ``n_draws`` leaves the
    generator where the sampler's own draws leave it."""
    fn, config, the_sde, kw, per_row, with_cond = CASES[case]
    score = _gaussian_score(the_sde)
    cond = ({"cond_img": torch.randn(SHAPE[:3] + (2,), generator=torch.Generator().manual_seed(9))}
            if with_cond else None)
    rng_a, rng_b = _rng(per_row, 5), _rng(per_row, 5)
    want = fn(score, rng_a, SHAPE, the_sde, config, cond=cond, **kw)
    n = S.n_draws(fn, config)
    draws = S.draw_noise(rng_b, SHAPE, n)
    assert draws.shape == (n, *SHAPE)
    got = fn(score, None, SHAPE, the_sde, config, cond=cond, draws=draws, **kw)
    assert torch.equal(got, want)
    for a, b in zip(*(g if isinstance(g, list) else [g] for g in (rng_a, rng_b))):
        assert torch.equal(a.get_state(), b.get_state())
    with pytest.raises(ValueError, match="needs more"):
        fn(score, None, SHAPE, the_sde, config, cond=cond, draws=draws[:n - 1], **kw) \
            if n > 1 else fn(score, None, SHAPE, the_sde, config, draws=draws[:0], **kw)


def _host_attempt(drift, x, t, h, t_end, h_max, rtol, atol):
    """One Dormand-Prince attempt as the eager loop took it before: clamps,
    stage times and accept read on the host."""
    h = torch.minimum(h, h_max)
    if bool(t + h < t_end):
        h = t_end - t
    ks = []
    for i in range(7):
        xi = x
        for j, a in enumerate(S._DP_A[i]):
            xi = xi + h * a * ks[j]
        ks.append(drift(xi, (t + S._DP_C[i] * h).item()))
    x5, x4 = x, x
    for k, b5, b4 in zip(ks, S._DP_B5, S._DP_B4):
        x5 = x5 + h * b5 * k
        x4 = x4 + h * b4 * k
    scale = atol + rtol * torch.maximum(x.abs(), x5.abs())
    err = ((x5 - x4).abs() / scale).max()
    if bool(err <= 1.0):
        x, t = x5, t + h
    return x, t, h * torch.clamp(0.9 * err ** (-0.2), 0.2, 5.0)


@pytest.mark.parametrize("t0, h0, tol, accepted", [
    (1.0, -0.01, 1e-3, True),  # accepted
    (1.0, -0.9, 1e-9, False),  # rejected
    (0.004, -0.01, 1e-2, True),  # clamped at t_end, accepted
])
def test_dp_attempt_equals_the_host_attempt(t0, h0, tol, accepted):
    """The device-side select of ``dp_attempt`` takes the same step as the
    host branch, bit for bit, accepted or rejected."""
    the_sde = sde.VESDE()
    score = _gaussian_score(the_sde)
    x = torch.randn(SHAPE, generator=torch.Generator().manual_seed(3)) * 20.0

    def drift(xi, ti):
        return S._ode_drift(score, the_sde, {}, xi, ti)

    _, _, _, t_end, h_max = S.rk45_start(x, 1.0, 1e-3)
    t, h = torch.tensor(t0), torch.tensor(h0)
    got = S.dp_attempt(drift, x, t, h, t_end, h_max, tol, tol)
    want = _host_attempt(drift, x, t, h, t_end, h_max, tol, tol)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert bool(got[1] != t) == accepted


@pytest.mark.parametrize("capture, device, expected", [
    (None, "cpu", False), (False, "cpu", False), (True, "cpu", ValueError),
    (None, "cuda", True), (True, "cuda:0", True), (False, "cuda", False),
])
def test_route_rule(capture, device, expected):
    if expected is ValueError:
        with pytest.raises(ValueError, match="CUDA device"):
            use_graphs(capture, device)
    else:
        assert use_graphs(capture, device) is expected


def test_asking_for_graphs_on_the_cpu_raises():
    """An entry point given CPU tensors and ``capture=True`` raises rather
    than running the eager loop; with the default it runs the eager loop."""
    score = _gaussian_score(sde.VESDE())
    cond = {"cond_img": torch.zeros(1, 20, 30, 2)}
    config = S.SamplerConfig(num_steps=3)
    with pytest.raises(ValueError, match="CUDA device"):
        sample_full_domain(score, torch.Generator().manual_seed(0), cond, domain_hw=(20, 30),
                           config=config, sampler="dpmpp_sampler", capture=True)
    out = sample_full_domain(score, torch.Generator().manual_seed(0), cond, domain_hw=(20, 30),
                             config=config, sampler="dpmpp_sampler")
    assert out.shape == (1, 20, 30)

"""Torch port: SDEs, guidance and samplers against the JAX package."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sbgm_danra_tpu import sde as jax_sde
from sbgm_danra_tpu.sampling import guidance as jax_guidance
from sbgm_danra_tpu.sampling import samplers as jax_samplers
from sbgm_danra_tpu_torch import sde
from sbgm_danra_tpu_torch.sampling import guidance
from sbgm_danra_tpu_torch.sampling.samplers import (
    SamplerConfig,
    dpmpp_sampler,
    edm_sampler,
    em_sampler,
    get_sampler,
    ode_sampler,
    pc_sampler,
)
from tests.torch_parity import (  # noqa: F401 (one_thread: a module fixture)
    TINY,
    jax_model_and_variables,
    model_inputs,
    one_thread,
    rel_err,
    torch_inputs,
    torch_model,
)


class TestSDE:
    @pytest.mark.parametrize("kind", ["VESDE", "VPSDE"])
    def test_matches_jax(self, kind):
        """float32 closed forms with the same order of operations: 1e-6."""
        js, ts = getattr(jax_sde, kind)(), getattr(sde, kind)()
        t = np.linspace(1e-3, 1.0, 17).astype(np.float32)
        tt, jt = torch.from_numpy(t), jnp.asarray(t)
        for name in ("marginal_prob_std", "marginal_prob_mean_coeff", "diffusion_coeff"):
            np.testing.assert_allclose(getattr(ts, name)(tt).numpy(),
                                       np.asarray(getattr(js, name)(jt)), rtol=1e-6, atol=1e-7)
        std = np.array(js.marginal_prob_std(jt))
        hat = std / np.asarray(js.marginal_prob_mean_coeff(jt))
        np.testing.assert_allclose(ts.inverse_std(torch.from_numpy(std)).numpy(),
                                   np.asarray(js.inverse_std(jnp.asarray(std))), rtol=1e-5)
        np.testing.assert_allclose(ts.inverse_hat_std(torch.from_numpy(hat)).numpy(),
                                   np.asarray(js.inverse_hat_std(jnp.asarray(hat))), rtol=1e-5)
        assert float(ts.prior_std()) == pytest.approx(float(js.prior_std()), rel=1e-6)
        x = np.ones((17, 2, 2, 1), np.float32)
        np.testing.assert_allclose(ts.drift(torch.from_numpy(x), tt).numpy(),
                                   np.asarray(js.drift(jnp.asarray(x), jt)), rtol=1e-6)

    def test_edm_schedule_matches_jax(self):
        got = sde.edm_sigma_schedule(25, 0.01, 80.0, 7.0).numpy()
        np.testing.assert_allclose(got, np.asarray(jax_sde.edm_sigma_schedule(25, 0.01, 80.0, 7.0)),
                                   rtol=1e-5)


def _toy_score(lib):
    """A score that reads every conditioning input, so the null protocol shows."""
    def score(x, t, y=None, cond_img=None, lsm_cond=None, topo_cond=None):
        label = y.reshape(-1, 1, 1, 1)
        label = label.astype(x.dtype) if lib is jnp else label.to(x.dtype)
        return (x * 0.5 + t.reshape(-1, 1, 1, 1) + cond_img.sum(-1, keepdims=True)
                + lsm_cond[..., :1] - 2 * lsm_cond[..., 1:] + 3 * topo_cond[..., 1:] + label)
    return score


class TestGuidance:
    def test_null_protocol_and_guided_score_match_jax(self):
        inputs = model_inputs(batch=3, hw=(4, 5), seed=7)
        cond = {k: inputs[k] for k in ("y", "cond_img", "lsm_cond", "topo_cond")}
        got_null = guidance.null_conditioning(torch_inputs(cond))
        want_null = jax_guidance.null_conditioning({k: jnp.asarray(v) for k, v in cond.items()})
        for key in cond:
            np.testing.assert_array_equal(got_null[key].numpy(), np.asarray(want_null[key]))
        assert float(got_null["lsm_cond"][..., 0].sub(torch.from_numpy(cond["lsm_cond"][..., 0]))
                     .abs().max()) == 0.0  # the value channel stays
        got = guidance.apply_guidance(_toy_score(torch), 3.0, 2.5)(
            torch.from_numpy(inputs["x"]), torch.from_numpy(inputs["t"]), **torch_inputs(cond))
        want = jax_guidance.apply_guidance(_toy_score(jnp), 3.0, 2.5)(
            jnp.asarray(inputs["x"]), jnp.asarray(inputs["t"]),
            **{k: jnp.asarray(v) for k, v in cond.items()})
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-5)

    def test_no_scale_is_identity(self):
        fn = _toy_score(torch)
        assert guidance.apply_guidance(fn, None) is fn


@pytest.fixture(scope="module")
def tiny_pair():
    inputs = model_inputs(batch=2, seed=8)
    model, variables = jax_model_and_variables(TINY, inputs, seed=9)
    cond = {k: inputs[k] for k in ("y", "cond_img", "lsm_cond", "topo_cond")}
    z = (np.random.default_rng(10).normal(size=inputs["x"].shape) * 300).astype(np.float32)
    return model, variables, torch_model(TINY, variables), cond, z


class TestModelSamplers:
    @pytest.mark.parametrize("name", ["dpmpp_sampler", "edm_sampler"])
    def test_same_latent_matches_jax(self, tiny_pair, name):
        """Same latent z, tiny model, CFG w=3, churn 0, fp32: the schedules
        are computed in float32 on both sides and the model agrees to ~1e-6,
        so the samples agree within 1e-4 of their scale (measured ~1e-6)."""
        model, variables, tm, cond, z = tiny_pair
        config = dict(num_steps=5, guidance_scale=3.0, s_churn=0.0)
        jfn = getattr(jax_samplers, name)
        run = jax.jit(lambda zz, c: jfn(
            lambda x, t, **kw: model.apply(variables, x, t, **kw, train=False),
            jax.random.PRNGKey(0), z.shape, config=jax_samplers.SamplerConfig(**config),
            cond=c, z=zz))
        want = np.asarray(run(jnp.asarray(z), {k: jnp.asarray(v) for k, v in cond.items()}))
        with torch.no_grad():
            got = get_sampler(name)(
                lambda x, t, **kw: tm(x, t, **kw), torch.Generator().manual_seed(0), z.shape,
                config=SamplerConfig(**config), cond=torch_inputs(cond), z=torch.from_numpy(z),
            ).numpy()
        assert rel_err(got, want) <= 1e-4

    @pytest.mark.parametrize("method", ["rk4", "heun", "rk45"])
    def test_ode_same_latent_matches_jax(self, tiny_pair, method):
        """ode_sampler from the same latent z, tiny model, CFG w=3, fp32, as
        for dpmpp/edm: within 1e-4 of the sample's scale (measured ~2e-6).
        rk45 runs its float32 step control as the JAX while_loop does, at the
        default tolerances 1e-5. Where an error norm is mostly float32
        rounding, the two sides' step sizes part by an ulp and their step
        sequences drift apart; at 1e-5 both stay that close to the ODE's
        solution, which a tolerance of 1e-3 does not (2.3e-4 measured)."""
        model, variables, tm, cond, z = tiny_pair
        config = dict(num_steps=4, guidance_scale=3.0, ode_method=method)
        run = jax.jit(lambda zz, c: jax_samplers.ode_sampler(
            lambda x, t, **kw: model.apply(variables, x, t, **kw, train=False),
            jax.random.PRNGKey(0), z.shape, config=jax_samplers.SamplerConfig(**config),
            cond=c, z=zz))
        want = np.asarray(run(jnp.asarray(z), {k: jnp.asarray(v) for k, v in cond.items()}))
        with torch.no_grad():
            got = ode_sampler(
                lambda x, t, **kw: tm(x, t, **kw), torch.Generator().manual_seed(0), z.shape,
                config=SamplerConfig(**config), cond=torch_inputs(cond), z=torch.from_numpy(z),
            ).numpy()
        assert np.isfinite(got).all()
        assert rel_err(got, want) <= 1e-4


MU, S0 = 1.0, 2.0


def _gaussian_score(the_sde):
    """The exact score of N(MU, S0^2) diffused by ``the_sde``: the marginal at
    t is N(m MU, m^2 S0^2 + std^2) (m = 1 for VE)."""
    def score(x, t, **kw):
        m = the_sde.marginal_prob_mean_coeff(t).reshape(-1, 1, 1, 1)
        var = m**2 * S0**2 + the_sde.marginal_prob_std(t).reshape(-1, 1, 1, 1) ** 2
        return -(x - m * MU) / var
    return score


class TestExactGaussian:
    def test_pc_sampler_moments_match_jax(self):
        """pc_sampler with the exact score of N(1, 2^2): the RNGs differ, so
        both sides are held to the target's moments and to each other's
        (3072 draws: mean within 0.2, std within 10%)."""
        shape = (3, 32, 32, 1)
        config = dict(num_steps=150)
        jax_out = np.asarray(jax.jit(lambda key: jax_samplers.pc_sampler(
            _gaussian_score(jax_sde.VESDE()), key, shape,
            config=jax_samplers.SamplerConfig(**config)))(jax.random.PRNGKey(0)))
        got = pc_sampler(_gaussian_score(sde.VESDE()), torch.Generator().manual_seed(0),
                         shape, config=SamplerConfig(**config)).numpy()
        for out in (got, jax_out):
            assert out.mean() == pytest.approx(MU, abs=0.2)
            assert out.std() == pytest.approx(S0, rel=0.1)
        assert got.mean() == pytest.approx(jax_out.mean(), abs=0.2)
        assert got.std() == pytest.approx(jax_out.std(), rel=0.1)

    @pytest.mark.parametrize("kind", ["VESDE", "VPSDE"])
    def test_em_sampler_moments_match_jax(self, kind):
        """em_sampler with the exact score of N(1, 2^2) under VE and under VP
        (whose drift EM carries): as for pc, both sides are held to the
        target's moments and to each other's (3072 draws: mean within 0.2,
        std within 10%)."""
        shape = (3, 32, 32, 1)
        config = dict(num_steps=200)
        jax_out = np.asarray(jax.jit(lambda key: jax_samplers.em_sampler(
            _gaussian_score(getattr(jax_sde, kind)()), key, shape, getattr(jax_sde, kind)(),
            config=jax_samplers.SamplerConfig(**config)))(jax.random.PRNGKey(0)))
        the_sde = getattr(sde, kind)()
        got = em_sampler(_gaussian_score(the_sde), torch.Generator().manual_seed(0), shape,
                         the_sde, config=SamplerConfig(**config)).numpy()
        for out in (got, jax_out):
            assert out.mean() == pytest.approx(MU, abs=0.2)
            assert out.std() == pytest.approx(S0, rel=0.1)
        assert got.mean() == pytest.approx(jax_out.mean(), abs=0.2)
        assert got.std() == pytest.approx(jax_out.std(), rel=0.1)

    def test_edm_moments(self):
        out = edm_sampler(_gaussian_score(sde.VESDE()), torch.Generator().manual_seed(1),
                          (2, 32, 32, 1), config=SamplerConfig(num_steps=30)).numpy()
        assert out.mean() == pytest.approx(MU, abs=0.2)
        assert out.std() == pytest.approx(S0, rel=0.1)

    def test_per_member_generators_and_step(self):
        """With one generator per row and the per-member Langevin step, a row
        comes out the same whether it ran alone or in a batch; with the
        batch-mean step it does not."""
        gens = lambda seeds: [torch.Generator().manual_seed(s) for s in seeds]  # noqa: E731
        score = _gaussian_score(sde.VESDE())
        config = SamplerConfig(num_steps=20)
        batch = pc_sampler(score, gens([4, 5, 6]), (3, 8, 8, 1), config=config,
                           per_member_step=True)
        alone = pc_sampler(score, gens([5]), (1, 8, 8, 1), config=config, per_member_step=True)
        torch.testing.assert_close(batch[1:2], alone, rtol=1e-6, atol=1e-6)
        coupled = pc_sampler(score, gens([4, 5, 6]), (3, 8, 8, 1), config=config)
        assert not torch.allclose(coupled[1:2], alone, rtol=1e-3, atol=1e-3)

    def test_dpmpp_deterministic_given_latent(self):
        score = _gaussian_score(sde.VESDE())
        z = torch.randn(1, 8, 8, 1, generator=torch.Generator().manual_seed(2)) * 300
        a = dpmpp_sampler(score, torch.Generator().manual_seed(0), z.shape, z=z)
        b = dpmpp_sampler(score, torch.Generator().manual_seed(99), z.shape, z=z)
        torch.testing.assert_close(a, b, rtol=0, atol=0)


class TestRegistry:
    def test_unknown(self):
        with pytest.raises(ValueError, match="Unknown sampler"):
            get_sampler("nope")

    @pytest.mark.parametrize("name, fn", [("dpmpp_2m", dpmpp_sampler), ("edm", edm_sampler),
                                          ("pc_sampler", pc_sampler), ("em_sampler", em_sampler),
                                          ("euler_maruyama", em_sampler),
                                          ("ode_sampler", ode_sampler)])
    def test_aliases(self, name, fn):
        assert get_sampler(name) is fn

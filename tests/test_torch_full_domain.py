"""Torch port: full-domain padding and sampling against the JAX package."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sbgm_danra_tpu.evaluate import full_domain as jax_fd
from sbgm_danra_tpu_torch.evaluate.full_domain import (
    pad_conditioning,
    pad_field,
    padded_dims,
    sample_full_domain,
)
from sbgm_danra_tpu_torch.sampling.samplers import SamplerConfig
from sbgm_danra_tpu_torch.sde import VESDE


class TestPadding:
    @pytest.mark.parametrize("hw", [(589, 789), (640, 832), (128, 128), (37, 45)])
    def test_padded_dims_match_jax(self, hw):
        assert padded_dims(*hw) == jax_fd.padded_dims(*hw)

    def test_full_domain_dims(self):
        assert padded_dims(589, 789) == (608, 800)

    @pytest.mark.parametrize("mode", ["edge", "constant"])
    @pytest.mark.parametrize("ndim", [3, 4])
    def test_pad_field_matches_jax(self, mode, ndim):
        shape = (2, 5, 7, 3)[:ndim]
        x = np.random.default_rng(0).normal(size=shape).astype(np.float32)
        got = pad_field(torch.from_numpy(x), (8, 9), mode).numpy()
        want = jax_fd.pad_field(jnp.asarray(x), (8, 9), mode)
        np.testing.assert_array_equal(got, np.asarray(want))

    def test_pad_too_small_raises(self):
        with pytest.raises(ValueError):
            pad_field(torch.zeros(1, 8, 8, 1), (4, 4))

    def test_pad_conditioning_matches_jax(self):
        """Geo value channels edge-padded, mask channels zero-padded, the LR
        image edge-padded, labels untouched: equal to the JAX function."""
        rng = np.random.default_rng(1)
        cond = {
            "lsm_cond": rng.normal(size=(2, 5, 6, 2)).astype(np.float32),
            "topo_cond": rng.normal(size=(2, 5, 6, 2)).astype(np.float32),
            "cond_img": rng.normal(size=(2, 5, 6, 3)).astype(np.float32),
            "y": np.array([1, 2], np.int32),
        }
        got = pad_conditioning({k: torch.from_numpy(v) for k, v in cond.items()}, (8, 8))
        want = jax_fd.pad_conditioning({k: jnp.asarray(v) for k, v in cond.items()}, (8, 8))
        for key in cond:
            np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]))
        assert float(got["lsm_cond"][0, 7, 7, 1]) == 0.0


class TestFullDomainSampling:
    @pytest.mark.parametrize("sampler, steps", [("edm_sampler", 30), ("pc_sampler", 100)])
    def test_nondivisible_domain_exact_score(self, sampler, steps):
        """A 37x45 'full domain' (padded to 64x64) with the exact score of
        N(1, 2^2); the output is cropped back and has the target's moments,
        as tests/test_full_domain.py holds the JAX function to."""
        mu, s0 = 1.0, 2.0
        sde = VESDE()

        def score(x, t, **kw):
            var = s0**2 + sde.marginal_prob_std(t).reshape(-1, 1, 1, 1) ** 2
            return -(x - mu) / var

        cond = {"cond_img": torch.zeros(2, 37, 45, 1)}
        out = sample_full_domain(score, torch.Generator().manual_seed(0), cond,
                                 domain_hw=(37, 45), batch=2,
                                 config=SamplerConfig(num_steps=steps), sampler=sampler)
        assert isinstance(out, np.ndarray) and out.shape == (2, 37, 45)
        assert out.mean() == pytest.approx(mu, abs=0.4)
        assert out.std() == pytest.approx(s0, rel=0.2)

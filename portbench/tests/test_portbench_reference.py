"""The benchmark's plain reference held against the port at tiny sizes on the
CPU: the UNet's parameters and forward, the EDM and DPM-Solver++ samplers
with CFG, the full-domain padding and the serving API's member seeds."""

import numpy as np
import pytest
import torch

from portbench import inputs, program
from portbench.reference import sampling as ref_sampling
from portbench.reference.unet import UNet, param_shapes
from portbench.tests.tiny import SEED, tiny_config
from portbench import harness

CONFIGS = ("flagship-128", "flagship-domain")


@pytest.mark.parametrize("name", CONFIGS)
def test_parameters_are_the_ports(name):
    """Every parameter and buffer of the port's UNet, by name and shape, at the
    configuration's own widths."""
    from sbgm_danra_tpu_torch.models.unet import build_score_model

    cfg = harness.load_json(harness.PACKAGE / "configs" / f"{name}.json")
    net = build_score_model(program.spec(cfg))
    assert {k: tuple(v.shape) for k, v in net.state_dict().items()} == param_shapes(cfg)
    assert sum(int(np.prod(s)) for s in param_shapes(cfg).values()) > 19_000_000


def _inputs(cfg, b=2):
    h, w = 64, 96
    cond = inputs.make_conditions(SEED, b, h, w, cfg["lr_channels"],
                                  cfg["model"]["num_classes"], "cpu")
    x = torch.randn(b, h, w, 1, generator=torch.Generator().manual_seed(1))
    return x, torch.tensor([0.3, 0.8][:b]), cond


@pytest.mark.parametrize("name", CONFIGS)
def test_unet_forward_matches_port(name):
    cfg = tiny_config(name)
    weights = inputs.make_weights(cfg, SEED, "cpu")
    x, t, cond = _inputs(cfg)
    with torch.no_grad():
        got = program.model(cfg, weights, "cpu")(x, t, **cond)
        want = UNet(weights, cfg)(x, t, **cond)
    assert torch.allclose(got, want, rtol=1e-4, atol=1e-4 * want.abs().max().item())


@pytest.mark.parametrize("sampler", ("edm_sampler", "dpmpp_sampler"))
def test_samplers_match_port(sampler):
    from sbgm_danra_tpu_torch.sampling import samplers as S

    cfg = tiny_config("flagship-128")
    cfg["sampler"].update(name=sampler, num_steps=5)
    weights = inputs.make_weights(cfg, SEED, "cpu")
    z, _, cond = _inputs(cfg)
    net = program.model(cfg, weights, "cpu")
    with torch.no_grad():
        got = S.get_sampler(sampler)(net, None, tuple(z.shape), program.sde(cfg),
                                     program.sampler_config(cfg), cond=cond, draws=z[None])
        want = ref_sampling.SAMPLERS[sampler](UNet(weights, cfg), z, cond, cfg["sampler"],
                                              cfg["sde"]["sigma"])
    assert torch.allclose(got, want, rtol=1e-4, atol=1e-4 * want.abs().max().item())


def test_padding_matches_port():
    from sbgm_danra_tpu_torch.evaluate.full_domain import pad_conditioning, padded_dims

    cond = inputs.make_conditions(SEED, 2, 37, 45, 2, 4, "cpu")
    hw = padded_dims(37, 45)
    assert hw == ref_sampling.padded_hw(37, 45) == (64, 64)
    got, want = pad_conditioning(cond, hw), ref_sampling.pad_conditioning(cond, hw)
    assert set(got) == set(want)
    for k in got:
        assert torch.equal(got[k], want[k]), k


def test_member_seeds_match_serving_api():
    from sbgm_danra_tpu_torch.serve import member_seed

    for seed in (0, 7, 2**31 + 5, 2**62 + 1):
        for m in range(8):
            assert ref_sampling.member_seed(seed, m) == member_seed(seed, m)


def test_control_rounds_to_fp8():
    from portbench.reference.unet import fake_fp8

    t = torch.randn(1000, generator=torch.Generator().manual_seed(0))
    q = fake_fp8(t)
    rel = ((q - t).abs() / t.abs().clamp(min=1e-3)).median()
    assert 0.005 < rel < 0.1  # three mantissa bits: a half-ulp of 1/16 at most

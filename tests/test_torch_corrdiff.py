"""Torch port: CorrDiff (``models/songunet.py``, ``evaluate/corrdiff.py``,
``sde.EDMSDE``) and K1's per-sample bias and SiLU, on the CPU.

The port is held against the benchmark's plain reference
(``portbench/reference/corrdiff.py``: plain torch, fp32, written from
NVlabs/edm's SongUNet and PhysicsNeMo's EDMPrecondSR, importing nothing of
the port) on one tiny SongUNet with seeded weights: 16 model channels,
channel_mult [1, 2], one block a level, attention at 8, 16x16. No JAX: the
JAX package has no CorrDiff. One torch thread, oneDNN off (the suite's
workers share the cores; this CPU build's oneDNN computes some small bf16
convolutions wrongly, ``tests/test_torch_model.py``).
"""

import copy
import json
import math
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch.profiler import ProfilerActivity, profile

from portbench.reference import corrdiff as ref
from portbench.reference.unet import fake_bf16
from sbgm_danra_tpu_torch.config import from_dict
from sbgm_danra_tpu_torch.evaluate.corrdiff import SAMPLER, generate
from sbgm_danra_tpu_torch.models.songunet import (
    CorrDiff,
    SongUNetSpec,
    build_corrdiff,
    spec_from_config,
)
from sbgm_danra_tpu_torch.ops import fused_conv_gn as k1
from sbgm_danra_tpu_torch.sampling import samplers as S
from sbgm_danra_tpu_torch.sde import EDMSDE
from sbgm_danra_tpu_torch.utils import profiling
from tests.torch_parity import one_thread  # noqa: F401 (a module fixture)

FULL = json.loads((Path(__file__).resolve().parents[1] / "portbench" / "configs"
                   / "corrdiff-448.json").read_text())
SEED = 2**31 + 19
HW = 16


def tiny_config(dtype: str = "float32") -> dict:
    cfg = copy.deepcopy(FULL)
    cfg["model"].update(img_resolution=HW, model_channels=16, channel_mult=[1, 2],
                        num_blocks=1, attn_resolutions=[8], compute_dtype=dtype)
    return cfg


def spec_of(cfg: dict) -> SongUNetSpec:
    m = cfg["model"]
    return SongUNetSpec(
        cond_channels=m["cond_channels"], img_resolution=m["img_resolution"],
        model_channels=m["model_channels"], channel_mult=tuple(m["channel_mult"]),
        num_blocks=m["num_blocks"], attn_resolutions=tuple(m["attn_resolutions"]),
        compute_dtype=m["compute_dtype"])


@pytest.fixture(autouse=True)
def _onednn_off():
    with torch.backends.mkldnn.flags(enabled=False):
        yield


@pytest.fixture(scope="module")
def weights():
    return ref.make_weights(tiny_config(), SEED, "cpu")


def port(weights, dtype: str = "float32") -> CorrDiff:
    net = build_corrdiff(spec_of(tiny_config(dtype)))
    net.load_state_dict(weights)
    return net


def conditions(b: int = 2, seed: int = 1) -> dict:
    g = torch.Generator().manual_seed(seed)
    lsm = torch.cat([(torch.randn(b, HW, HW, 1, generator=g) > 0).float(),
                     torch.ones(b, HW, HW, 1)], dim=-1)
    topo = torch.cat([torch.randn(b, HW, HW, 1, generator=g).relu(),
                      torch.ones(b, HW, HW, 1)], dim=-1)
    return dict(cond_img=torch.randn(b, HW, HW, 2, generator=g), lsm_cond=lsm, topo_cond=topo)


def close(got, want, rtol):
    """Every element within ``rtol`` of the reference's largest magnitude."""
    err = (got.float() - want.float()).abs().max().item()
    assert err <= rtol * want.abs().max().item(), (err, want.abs().max().item())


def test_parameters_are_the_references():
    """Both nets' parameters, by name and shape, at the tiny size; at the
    published widths on the meta device (no storage): about 80M a net."""
    assert ({k: tuple(v.shape) for k, v in CorrDiff(spec_of(tiny_config())).state_dict().items()}
            == ref.param_shapes(tiny_config()))
    with torch.device("meta"):
        full = CorrDiff(spec_of(FULL))
    assert {k: tuple(v.shape) for k, v in full.state_dict().items()} == ref.param_shapes(FULL)
    for net in (full.regression, full.residual):
        assert 79e6 < sum(p.numel() for p in net.parameters()) < 81e6


# fp32, both nets: the port's K1 route on the CPU is the plain chain, whose
# GroupNorm takes the one-pass variance E[v^2] - mean^2; F.group_norm's two
# passes differ from it by float32 rounding, a few 1e-7 of the largest value
@pytest.mark.parametrize("net", ["regression", "residual"])
def test_each_net_matches_reference_fp32(weights, net):
    cfg, model, cond = tiny_config(), port(weights), conditions()
    x = torch.randn(2, HW, HW, 1, generator=torch.Generator().manual_seed(2)) * 3.0
    sigma = torch.tensor([17.0, 0.03])
    with torch.no_grad():
        if net == "regression":
            got, want = model.mean(**cond), ref.mean(weights, cfg, cond)
        else:
            got = model.denoise(x, sigma, **cond)
            residual = ref.SongUNet(weights, "residual", cfg)
            want = torch.cat([ref.denoise(residual, x[i:i + 1], float(s), ref_row(cond, i))
                              for i, s in enumerate(sigma)])
    close(got, want, 1e-5)


def ref_row(cond, i):
    return {k: v[i:i + 1] for k, v in cond.items()}


def test_score_is_the_preconditioned_denoisers(weights):
    """The samplers' score (D - x) / sigma^2 at sigmas from the top of the
    grid to its bottom, against the reference's D."""
    cfg, model, cond = tiny_config(), port(weights), conditions(3)
    sigma = torch.tensor([800.0, 1.5, 0.002])
    x = torch.randn(3, HW, HW, 1, generator=torch.Generator().manual_seed(3)) * sigma[:, None,
                                                                                       None, None]
    residual = ref.SongUNet(weights, "residual", cfg)
    with torch.no_grad():
        got = model(x, sigma, **cond)
        for i, s in enumerate(sigma.tolist()):
            want = (ref.denoise(residual, x[i:i + 1], s, ref_row(cond, i)) - x[i:i + 1]) / s**2
            close(got[i:i + 1], want, 1e-5)


def test_bf16_route_within_its_rounding(weights):
    """The bf16 route (bf16 convs, linears and sums, fp32 norm statistics and
    preconditioning) against the fp32 reference: bf16 keeps 8 bits, so each
    rounding moves a value by up to 2^-9 of it; some 30 layers of them over
    two nets leave the mean and D a few per cent off in relative L2 (the
    bf16-emulating reference reads as far)."""
    cfg, model, cond = tiny_config(), port(weights, "bfloat16"), conditions()
    x = torch.randn(2, HW, HW, 1, generator=torch.Generator().manual_seed(4))
    sigma = torch.tensor([2.0, 0.1])
    residual = ref.SongUNet(weights, "residual", cfg)
    emulated = ref.SongUNet(weights, "residual", cfg, fake_bf16)
    with torch.no_grad():
        pairs = [(model.mean(**cond), ref.mean(weights, cfg, cond),
                  ref.mean(weights, cfg, cond, fake_bf16))]
        for i, s in enumerate(sigma.tolist()):
            row = ref_row(cond, i)
            pairs.append((model.denoise(x[i:i + 1], sigma[i:i + 1], **row),
                          ref.denoise(residual, x[i:i + 1], s, row),
                          ref.denoise(emulated, x[i:i + 1], s, row)))
    for got, want, bf16 in pairs:
        gap = ((got - want).norm() / want.norm()).item()
        assert gap < 0.03, gap
        assert gap < 3 * ((bf16 - want).norm() / want.norm()).item() + 1e-3


def test_two_stage_sample_matches_reference(weights):
    """``generate`` (the regression's mean plus ``edm_sampler`` on the
    residual's score under EDMSDE, 18 points from 800 to 0.002) against the
    reference's mean plus its Heun loop, on the same latent draw."""
    cfg, model = tiny_config(), port(weights)
    cond = conditions(1)
    members, seed = 2, 5
    with torch.no_grad():
        got = generate(model, cond, members, torch.Generator().manual_seed(seed))
        z = torch.randn((members, HW, HW, 1), generator=torch.Generator().manual_seed(seed))
        rows = {k: v.repeat_interleave(members, 0) for k, v in cond.items()}
        want = ref.sample(weights, cfg, z, rows)
    assert got.shape == (members, HW, HW)
    close(torch.from_numpy(got), want, 2e-5)


def test_edm_sde_grid_is_edms():
    """EDMSDE's hat grid in the samplers: EDM's rho-schedule (smax^(1/rho) +
    i/(n-1) (smin^(1/rho) - smax^(1/rho)))^rho from 800 to 0.002, t = sigma,
    mean coefficient 1, so edm_sampler's Heun steps are EDM's."""
    sde = EDMSDE()
    sh, shc, tn, tc, mn, mc, ds, extra, shat_max, m1 = S._schedule("edm", sde, SAMPLER)
    i = np.arange(18) / 17
    want = (800 ** (1 / 7) + i * (0.002 ** (1 / 7) - 800 ** (1 / 7))) ** 7
    # the port's grid is float32, as the JAX package's: the base's rounding, a few
    # float32 ulps (6e-8), grows rho-fold in the 7th power
    np.testing.assert_allclose(sh, want, rtol=5e-6)
    assert sh == shc == tn == tc and set(mn) == set(mc) == {1.0} and set(extra) == {0.0}
    assert (shat_max, m1) == (800.0, 1.0)
    np.testing.assert_allclose(ds, np.diff(sh), rtol=1e-6)
    assert S.n_draws("edm_sampler", SAMPLER) == 1
    t = torch.tensor([0.002, 3.0, 800.0])
    assert torch.equal(sde.marginal_prob_std(t), t) and torch.equal(sde.inverse_hat_std(t), t)


def test_builds_from_the_port_config():
    """``model.arch: corrdiff`` and the SongUNet keys through the config
    reader -> spec_from_config -> build_corrdiff; a flagship config refuses."""
    m = tiny_config()["model"]
    cfg = from_dict({"model": {**{k: m[k] for k in (
        "arch", "img_resolution", "model_channels", "channel_mult", "num_blocks",
        "attn_resolutions", "compute_dtype")}, "sigma_max": 640.0},
        "lowres": {"condition_variables": ["temp", "prcp"]}})
    spec = spec_from_config(cfg)
    assert spec == spec_of(tiny_config()) and cfg.model.sigma_max == 640.0
    assert sum(p.numel() for p in build_corrdiff(spec).parameters()) > 0
    with pytest.raises(ValueError, match="corrdiff"):
        spec_from_config(from_dict({}))


def test_generate_records_its_spans(weights):
    """``corrdiff.call`` holding ``corrdiff.regression``, ``corrdiff.sync``
    and ``corrdiff.fetch``, in that order (the eager loop on the CPU: no
    ``sample.*``, which a graph's replay records); the fields unchanged."""
    model, cond = port(weights), conditions(1)
    with torch.no_grad():
        plain = generate(model, cond, 1, torch.Generator().manual_seed(6),
                         config=steps(3))
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            traced = generate(model, cond, 1, torch.Generator().manual_seed(6),
                              config=steps(3))
    np.testing.assert_array_equal(plain, traced)
    names = [e.name()[len(profiling.SPAN_PREFIX):] for e in
             sorted(prof.profiler.kineto_results.events(), key=lambda e: e.start_ns())
             if e.name().startswith(profiling.SPAN_PREFIX)]
    assert names == ["corrdiff.call", "corrdiff.regression", "corrdiff.sync", "corrdiff.fetch"]


def steps(n: int) -> S.SamplerConfig:
    return S.SamplerConfig(num_steps=n, eps=0.002, edm_rho=7.0)


# the plain chain's arithmetic is the unfused ops' in fp32: one-pass against
# two-pass variance and another summation order, float32 rounding
@pytest.mark.parametrize("activation", ["silu", True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k1_plain_versions_with_sample_bias(activation, dtype):
    g = torch.Generator().manual_seed(7)
    n, h, w, cin, cout, groups = 3, 7, 9, 24, 32, 8
    x = torch.randn(n, h, w, cin, generator=g).to(dtype)
    kernel = torch.randn(3, 3, cin, cout, generator=g) / math.sqrt(9 * cin)
    bias, gamma, beta = (torch.randn(cout, generator=g) for _ in range(3))
    sample_bias = torch.randn(n, cout, generator=g) * 2.0
    conv = F.conv2d(x.float().permute(0, 3, 1, 2), kernel.to(dtype).float().permute(3, 2, 0, 1),
                    bias.to(dtype).float(), padding=1) + sample_bias[:, :, None, None]
    grouped = conv.reshape(n, groups, -1)

    def per_channel(v):
        return v.repeat_interleave(cout // groups, 1)[:, :, None, None]

    # the statistics are the fp32 conv's; the normalised values the conv rounded to x's dtype
    rstd = (grouped.var(-1, unbiased=False) + 1e-6).rsqrt()
    want = ((conv.to(dtype).float() - per_channel(grouped.mean(-1))) * per_channel(rstd)
            * gamma[:, None, None] + beta[:, None, None])
    want = {"silu": F.silu, True: F.relu, False: lambda t: t}[activation](want)
    got_conv, stats = k1.plain_conv3x3_stats(x, kernel, bias, groups, sample_bias)
    assert torch.equal(got_conv, conv.to(dtype).permute(0, 2, 3, 1))
    close(stats[..., 0], grouped.sum(-1), 1e-5)
    got = k1.reference_chain(x, kernel, bias, gamma, beta, groups, 1e-6, activation,
                             out_dtype=torch.float32, sample_bias=sample_bias)
    close(got.permute(0, 3, 1, 2), want, 2e-5)
    assert torch.equal(k1.conv3x3_gn_relu(x, kernel, bias, gamma, beta, groups, 1e-6,
                                          activation, sample_bias=sample_bias),
                       k1.reference_chain(x, kernel, bias, gamma, beta, groups, 1e-6,
                                          activation, sample_bias=sample_bias))


def test_k1_refuses_a_bad_sample_bias_or_activation():
    x, kernel = torch.zeros(2, 4, 4, 8), torch.zeros(3, 3, 8, 16)
    vec = torch.zeros(16)
    with pytest.raises(ValueError, match="sample_bias"):
        k1.reference_chain(x, kernel, vec, vec, vec, 4, sample_bias=torch.zeros(16))
    with pytest.raises(ValueError, match="activation"):
        k1.reference_chain(x, kernel, vec, vec, vec, 4, activation="gelu")



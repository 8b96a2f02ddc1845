"""CorrDiff ensemble generation: a closed loop of the port's
``evaluate/corrdiff.generate``, each call ``dates`` dates x ``members``
members at the configuration's size (the regression once a date, the
residual's EDM sample on its captured graph, the sum copied to the host).

The program is built from the port's own configuration reader
(``config.from_dict`` with ``model.arch: corrdiff``) and model build
(``models/songunet.build_corrdiff``), with the weights of
``portbench/reference/corrdiff.make_weights``; ``correct`` compares sampled
fields with ``portbench/reference/corrdiff.sample`` (fp32, TF32 off) on the
same weights, conditioning and latent noise: the relative L2 gap of the
fields taken together, as ``portbench/checks.py`` takes the flagship's.
With ``control`` the reference also runs with every product's operands
rounded to fp8 e4m3 in the program's place (the control), and rounded to
bf16 (a check of the emulation).

Workload parameters: ``dates``, ``members``, ``pools`` (sets of dates cycled
through, one a call), ``check_calls`` (calls that the check samples),
``check_members`` (members of every date that it samples in each),
``limit``, ``trace_seconds``.
"""

from __future__ import annotations

import time
from typing import Dict, List

import numpy as np
import torch

from portbench import checks, inputs, program
from portbench.harness import Result
from portbench.reference import corrdiff as ref
from portbench.reference.unet import exact, fake_bf16, fake_fp8, identity
from portbench.trace import span

_MODEL_KEYS = ("arch", "img_resolution", "model_channels", "channel_mult", "channel_mult_emb",
               "channel_mult_noise", "num_blocks", "attn_resolutions", "dropout",
               "sigma_data", "compute_dtype")


def port_config(cfg: dict):
    """The configuration as the port's own reader takes a run config."""
    from sbgm_danra_tpu_torch.config import from_dict

    m, s = cfg["model"], cfg["sampler"]
    out = from_dict({
        "model": {**{k: m[k] for k in _MODEL_KEYS}, "sigma_max": cfg["sde"]["sigma_max"]},
        "lowres": {"condition_variables": ["temp", "prcp"][: cfg["lr_channels"]]},
        "stationary_conditions": {"geographic_conditions": {"sample_w_geo": True,
                                                            "geo_variables": ["lsm", "topo"]}},
        "sampler": {"sampler_type": s["name"], "n_timesteps": s["num_steps"],
                    "t_eps": s["sigma_min"], "edm_rho": s["edm_rho"], "s_churn": s["s_churn"]},
        "classifier_free_guidance": {"enabled": s["guidance_scale"] is not None},
    })
    if out.in_channels() != m["cond_channels"]:
        raise ValueError(f"the port reads {out.in_channels()} conditioning channels; the "
                         f"configuration states {m['cond_channels']}")
    return out


def build(cfg: dict, weights: Dict[str, torch.Tensor], dev: torch.device):
    """(model, SDE, sampler config) through the port's public entries."""
    from sbgm_danra_tpu_torch.models.songunet import build_corrdiff, spec_from_config
    from sbgm_danra_tpu_torch.sampling.samplers import config_from_run
    from sbgm_danra_tpu_torch.sde import EDMSDE

    pcfg = port_config(cfg)
    with torch.device(dev):
        net = build_corrdiff(spec_from_config(pcfg), generator=torch.Generator(dev).manual_seed(0))
    net.load_state_dict(weights)
    return net.eval(), EDMSDE(pcfg.model.sigma_max), config_from_run(pcfg, pcfg.sampler.n_timesteps)


def field_check(cfg: dict, weights, items: List[dict], limit: float,
                control: bool) -> Dict[str, dict]:
    """The relative L2 gap of the items' ``got`` fields [b, h, w] against the
    reference from their latent ``z`` and ``cond``, all rows in one pass of
    ``ref.sample``; with ``control`` also the fp8 and bf16 references'."""
    got = np.concatenate([it["got"] for it in items])
    z = torch.cat([it["z"] for it in items])
    cond = {k: torch.cat([it["cond"][k] for it in items]) for k in items[0]["cond"]}
    quants = {"": identity, **({"control": fake_fp8, "emulated_bf16": fake_bf16}
                               if control else {})}
    with exact():
        want = ref.sample(weights, cfg, z, cond)
        out = {}
        for name, quant in quants.items():
            other = got if quant is identity else ref.sample(weights, cfg, z, cond,
                                                              quant).cpu().numpy()
            diff, norm = checks.sq_norms(other, want)
            out[(f"{name}_" if name else "") + "fields_rel_l2"] = {
                "value": float(np.sqrt(diff / norm)), "limit": limit}
    return out


def run(ctx) -> Result:
    from sbgm_danra_tpu_torch.evaluate.corrdiff import generate

    cfg, p, dev = ctx.cfg, ctx.params, torch.device(ctx.device)
    h, w = cfg["image_hw"]
    nd, k = p["dates"], p["members"]
    shape = (nd * k, h, w, cfg["model"]["out_channels"])
    weights = ref.make_weights(cfg, ctx.seed, dev)
    net, sde, scfg = build(cfg, weights, dev)
    days = inputs.make_conditions(ctx.seed, p["pools"] * nd, h, w, cfg["lr_channels"], 4, dev)
    del days["y"]  # CorrDiff takes no season class
    pools = [inputs.take(days, torch.arange(j * nd, (j + 1) * nd, device=dev))
             for j in range(p["pools"])]

    def call(i, seed):
        rng = torch.Generator(dev).manual_seed(seed)
        return generate(net, pools[i % p["pools"]], k, rng, sde, scfg)

    call(0, inputs.sub_seed(ctx.seed, 3, 0))  # warm-up: the capture
    picks = np.random.default_rng(inputs.sub_seed(ctx.seed, 5))
    kept, seeds = [], []
    t0 = ctx.window_opened()
    while True:
        i = len(kept)
        seed = inputs.sub_seed(ctx.seed, 4, i)
        ctx.tracer.begin_call()
        with span("call"):
            out = call(i, seed)
        ctx.tracer.end_call()
        rows = np.concatenate([d * k + np.sort(picks.choice(k, p["check_members"],
                                                             replace=False)) for d in range(nd)])
        kept.append((rows, out[rows]))
        seeds.append(seed)
        if ctx.window_closed(t0):
            break
    elapsed = time.perf_counter() - t0
    ctx.tracer.stop()
    peak = program.memory_peak(dev)
    calls = len(kept)
    del net
    checks.free_program()

    items = []
    check = np.random.default_rng(inputs.sub_seed(ctx.seed, 6))
    for i in sorted(check.choice(calls, size=min(p["check_calls"], calls), replace=False)):
        rows, got = kept[i]
        gen = torch.Generator(dev).manual_seed(seeds[i])
        at = torch.as_tensor(rows, device=dev)
        z = torch.randn(shape, generator=gen, device=dev)[at]
        cond = inputs.take(pools[i % p["pools"]], at // k)
        items.append(dict(got=got, z=z, cond=cond))
    result = field_check(cfg, weights, items, p["limit"], ctx.control)
    return Result(
        e2e={"gen_fields_per_s": calls * shape[0] / elapsed},
        attempted=calls * shape[0], failed=0, checks=result, memory_peak_bytes=peak,
        counts=dict(hw=(h, w), dates=nd, members=k, traced_calls=ctx.tracer.calls))

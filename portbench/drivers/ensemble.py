"""Ensemble generation: a closed loop of the port's ``sampling/graphs.call``
with the configuration's sampler on the model's score function, each call
``dates`` dates x ``members`` members at the configuration's size, the
fields copied to the host as the port's quality scripts take them.

Workload parameters: ``dates``, ``members``, ``pools`` (sets of dates
cycled through, one a call), ``check_calls`` (calls that the check samples)
and ``check_members`` (members of every date that it samples in each of
them, so that a fault confined to one date's members or to one block of the
batch shows), ``limit``, ``trace_seconds``.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from portbench import checks, inputs, program, work
from portbench.harness import Result
from portbench.trace import span


def run(ctx) -> Result:
    from sbgm_danra_tpu_torch.capture import use_graphs
    from sbgm_danra_tpu_torch.sampling import graphs

    cfg, p, dev = ctx.cfg, ctx.params, torch.device(ctx.device)
    h, w = cfg["image_hw"]
    nd, k = p["dates"], p["members"]
    shape = (nd * k, h, w, 1)
    weights = inputs.make_weights(cfg, ctx.seed, dev)
    net = program.model(cfg, weights, dev)
    dates = inputs.make_conditions(ctx.seed, p["pools"] * nd, h, w, cfg["lr_channels"],
                                   cfg["model"]["num_classes"], dev)
    pools = [inputs.take(dates, torch.arange(j * nd, (j + 1) * nd, device=dev)
                         .repeat_interleave(k)) for j in range(p["pools"])]
    sde, scfg = program.sde(cfg), program.sampler_config(cfg)
    graph = use_graphs(None, dev)

    def call(i, seed):
        rng = torch.Generator(dev).manual_seed(seed)
        with torch.no_grad():
            out = graphs.call(cfg["sampler"]["name"], net, rng, shape, sde, scfg,
                              cond=pools[i % p["pools"]], graph=graph)
            return out[..., 0].float().cpu().numpy()

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
        z = torch.randn(shape, generator=gen, device=dev)[torch.as_tensor(rows, device=dev)]
        cond = inputs.take(pools[i % p["pools"]], torch.as_tensor(rows, device=dev))
        items.append(dict(got=got, z=z, cond=cond))
    result = checks.field_check(cfg, weights, items, p["limit"], ctx.control)
    evals = work.evals_per_call(cfg["sampler"])
    rows_per_eval = work.cfg_rows(cfg["sampler"], shape[0])
    return Result(
        e2e={"gen_fields_per_s": calls * shape[0] / elapsed},
        attempted=calls * shape[0], failed=0, checks=result, memory_peak_bytes=peak,
        counts=dict(hw=(h, w), rows_per_eval=rows_per_eval,
                    traced_evals=ctx.tracer.calls * evals))

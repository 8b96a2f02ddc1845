"""Full-domain generation: a closed loop of the port's ``sample_full_domain``
(the path of ``SampleGenerator.generate_full_domain``), one field a call,
each with the next date's conditioning and a seed of its own.

Workload parameters: ``dates`` (the pool of dates cycled through),
``batch`` (fields a call), ``check_fields`` (fields the check samples),
``limit`` (of the worst relative L2 gap), ``trace_seconds``.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from portbench import checks, inputs, program, work
from portbench.harness import Result
from portbench.reference.sampling import padded_hw
from portbench.trace import span


def run(ctx) -> Result:
    from sbgm_danra_tpu_torch.evaluate.full_domain import sample_full_domain

    cfg, p, dev = ctx.cfg, ctx.params, torch.device(ctx.device)
    h, w = cfg["image_hw"]
    batch = p["batch"]
    weights = inputs.make_weights(cfg, ctx.seed, dev)
    net = program.model(cfg, weights, dev)
    dates = inputs.make_conditions(ctx.seed, p["dates"], h, w, cfg["lr_channels"],
                                   cfg["model"]["num_classes"], dev)
    sde, scfg = program.sde(cfg), program.sampler_config(cfg)
    shape = (batch, *padded_hw(h, w), 1)  # the latent, drawn at the padded size

    def rows(i):
        return [(i * batch + r) % p["dates"] for r in range(batch)]

    def field(i, seed):
        rng = torch.Generator(dev).manual_seed(seed)
        return sample_full_domain(net, rng, inputs.take(dates, rows(i)), domain_hw=(h, w),
                                  batch=batch, sde=sde, config=scfg,
                                  sampler=cfg["sampler"]["name"],
                                  compute_dtype=cfg["model"]["compute_dtype"])

    field(0, inputs.sub_seed(ctx.seed, 3, 0))  # warm-up: the capture
    outs, seeds = [], []
    t0 = ctx.window_opened()
    while True:
        i = len(outs)
        seed = inputs.sub_seed(ctx.seed, 4, i)
        ctx.tracer.begin_call()
        with span("call"):
            outs.append(field(i, seed))
        ctx.tracer.end_call()
        seeds.append(seed)
        if ctx.window_closed(t0):
            break
    elapsed = time.perf_counter() - t0
    ctx.tracer.stop()
    peak = program.memory_peak(dev)
    calls = len(outs)
    del net
    checks.free_program()

    pick = np.random.default_rng(inputs.sub_seed(ctx.seed, 5)).choice(
        calls, size=min(p["check_fields"], calls), replace=False)
    items = []
    for i in sorted(pick):
        gen = torch.Generator(dev).manual_seed(seeds[i])
        z = torch.randn(shape, generator=gen, device=dev)
        items.append(dict(got=outs[i], z=z, cond=inputs.take(dates, rows(i))))
    result = checks.field_check(cfg, weights, items, p["limit"], ctx.control, domain_hw=(h, w))
    return Result(
        e2e={"domain_s_per_field": elapsed / (calls * batch)},
        attempted=calls * batch, failed=0, checks=result, memory_peak_bytes=peak,
        counts=dict(hw=shape[1:3], rows_per_eval=work.cfg_rows(cfg["sampler"], batch),
                    traced_evals=ctx.tracer.calls * work.evals_per_call(cfg["sampler"])))


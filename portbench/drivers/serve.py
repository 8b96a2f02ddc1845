"""Serving under load: an open loop of requests into the port's
``InferenceEngine.generate`` from client threads, each request one date's
conditions and a number of members, due at its arrival time whether or not
the ones before it have returned.

A request's latency runs from when it was due to when its fields return;
``serve_p95_ms`` is the 95th percentile over every request due in the
window. The benchmark wraps the engine's dispatch in a span of its own, to
time the dispatches (the ``mfu.serve`` reader's elapsed time) and to bound
the traced window by whole dispatches.

Workload parameters: ``rate_per_s`` (arrivals, Poisson), ``members`` (the
member counts, in equal shares), ``schedule_seed`` (the one schedule of
arrivals and sizes, which each run's seed rotates: ``inputs.open_loop``),
``max_members`` (the engine's capacity),
``dates``, ``clients`` (client threads), ``check_requests`` (requests the
check samples, half of them among the largest), ``limit``, ``trace_seconds``.
"""

from __future__ import annotations

import concurrent.futures
import math
import sys
import time

import numpy as np
import torch

from portbench import checks, inputs, program, work
from portbench.harness import Result
from portbench.reference.sampling import member_seed
from portbench.trace import span

DRAIN_S = 60.0  # how long past the window's close a request may still return


def settings(cfg: dict):
    from sbgm_danra_tpu_torch.serve import ServeSettings

    return ServeSettings(spec=program.spec(cfg), sampler_type=cfg["sampler"]["name"],
                         sampler=program.sampler_config(cfg), sample_hw=tuple(cfg["image_hw"]),
                         n_lr=cfg["lr_channels"], model_string=cfg["name"])


def run(ctx) -> Result:
    from sbgm_danra_tpu_torch.serve import InferenceEngine

    cfg, p, dev = ctx.cfg, ctx.params, torch.device(ctx.device)
    h, w = cfg["image_hw"]
    weights = inputs.make_weights(cfg, ctx.seed, dev)
    dates = inputs.make_conditions(ctx.seed, p["dates"], h, w, cfg["lr_channels"],
                                   cfg["model"]["num_classes"], dev)
    host_dates = [{"y": dates["y"][d].cpu().numpy(),
                   **{k: dates[k][d].cpu().numpy() for k in ("cond_img", "lsm_cond", "topo_cond")}}
                  for d in range(p["dates"])]
    n = int(round(p["rate_per_s"] * ctx.seconds))
    due, members = inputs.open_loop(n, p["rate_per_s"], p["members"], p["schedule_seed"],
                                    ctx.seed)
    date_of = np.random.default_rng(inputs.sub_seed(ctx.seed, 8)).integers(0, p["dates"], n)
    req_seeds = [inputs.sub_seed(ctx.seed, 9, i) for i in range(n)]

    engine = InferenceEngine(settings(cfg), weights, dev, max_members=p["max_members"])
    engine.warmup()
    spans, dispatch = [], engine._dispatch

    def timed_dispatch(tickets):
        ctx.tracer.begin_call()
        t0 = time.perf_counter()
        with span("call"):
            dispatch(tickets)
        # the span, and the engine's own counters after it
        spans.append((t0, time.perf_counter(), engine.n_rows, engine.n_dispatches))
        ctx.tracer.end_call()

    engine._dispatch = timed_dispatch
    done = [math.inf] * n
    outs = [None] * n
    errors = []

    def client(i):
        try:
            outs[i] = engine.generate(host_dates[date_of[i]], n_members=int(members[i]),
                                      seed=req_seeds[i])
            done[i] = time.perf_counter()
        except Exception as e:  # a failed request counts as missing its limit
            errors.append(f"request {i}: {type(e).__name__}: {e}")

    lateness = 0.0
    pool = concurrent.futures.ThreadPoolExecutor(p["clients"], thread_name_prefix="client")
    t0 = ctx.window_opened()
    futures = []
    for i in range(n):
        wait = t0 + due[i] - time.perf_counter()
        if wait > 0:
            time.sleep(wait)
        lateness = max(lateness, time.perf_counter() - (t0 + due[i]))
        futures.append(pool.submit(client, i))
    concurrent.futures.wait(futures, timeout=max(0.0, t0 + ctx.seconds + DRAIN_S
                                                 - time.perf_counter()))
    elapsed = time.perf_counter() - t0
    ctx.tracer.stop()
    pool.shutdown(wait=False, cancel_futures=True)
    peak = program.memory_peak(dev)
    n_rows, n_dispatches = engine.n_rows, engine.n_dispatches
    engine.close()
    del engine
    checks.free_program()

    lat = np.array([done[i] - (t0 + due[i]) for i in range(n)])
    failed = int(np.sum(~np.isfinite(lat)))
    lat[~np.isfinite(lat)] = ctx.seconds + DRAIN_S  # a request that never came waited so long
    for line in errors[:5]:
        print(line, file=sys.stderr, flush=True)
    mean_ms = 1e3 * float(np.mean([s[1] - s[0] for s in spans])) if spans else math.nan
    print(f"serve: {n} requests, {failed} failed, generator at most {lateness * 1e3:.1f} ms "
          f"late, {n_dispatches} dispatches ({mean_ms:.2f} ms each on average), {n_rows} rows",
          file=sys.stderr, flush=True)
    if failed == 0 and len(spans) != n_dispatches:
        # the span wraps a private method of the engine: if the engine stops
        # calling it, the dispatch spans and mfu.serve would read nothing
        raise RuntimeError(f"the benchmark's dispatch span saw {len(spans)} dispatches, the "
                           f"engine counted {n_dispatches}: InferenceEngine._dispatch changed")

    served = [i for i in range(n) if outs[i] is not None]
    rng = np.random.default_rng(inputs.sub_seed(ctx.seed, 10))
    largest = [i for i in served if members[i] == max(p["members"])]
    rest = [i for i in served if members[i] != max(p["members"])]
    half = p["check_requests"] // 2
    pick = list(rng.choice(largest, min(half, len(largest)), replace=False)) + \
        list(rng.choice(rest, min(p["check_requests"] - half, len(rest)), replace=False))
    items = []
    for i in sorted(pick):
        z = torch.cat([torch.randn((1, h, w, 1), device=dev, generator=torch.Generator(dev)
                                   .manual_seed(member_seed(req_seeds[i], j)))
                       for j in range(members[i])])
        cond = inputs.take(dates, torch.full((int(members[i]),), int(date_of[i]), device=dev))
        items.append(dict(got=outs[i], z=z, cond=cond))
    result = checks.field_check(cfg, weights, items, p["limit"], ctx.control)
    evals = work.evals_per_call(cfg["sampler"])
    traced = spans[: ctx.tracer.calls]
    return Result(
        e2e={"serve_p95_ms": 1e3 * float(np.percentile(lat, 95))},
        attempted=n, failed=failed, checks=result, memory_peak_bytes=peak,
        counts=dict(hw=(h, w), rows_per_eval=work.cfg_rows(cfg["sampler"], p["max_members"]),
                    n_rows=n_rows, n_dispatches=n_dispatches, window_s=elapsed,
                    evals_per_dispatch=evals, traced_evals=len(traced) * evals,
                    traced_rows=traced[-1][2] if traced else 0,
                    traced_dispatches=traced[-1][3] if traced else 0,
                    traced_dispatch_s=sum(s[1] - s[0] for s in traced), latency_s=lat))

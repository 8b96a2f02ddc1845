"""Samplers as CUDA graphs: the port's counterpart of the JAX package's one
compiled program per sampler (``sbgm_danra_tpu/sampling/samplers.py:19-22``).

``sample(sampler, score_fn, rng, shape, sde, config, cond, **kw)`` computes
what ``get_sampler(sampler)(score_fn, rng, shape, sde, config, cond=cond,
**kw)`` computes, given the same generators, as one replay of a captured
graph of the sampler's whole loop:

1. the noise: ``n_draws(sampler, config)`` draws of the sample's shape, made
   from ``rng`` in the eager loop's order (``draw_noise``, per-row
   generators row by row) into the graph's static draws buffer;
2. the conditioning copied into the graph's static buffers;
3. one replay; the output is cloned out of the graph's pool.

Once captured, a call records the spans (``utils/profiling.span``)
``sample.inputs`` (steps 1 and 2) and ``sample.replay`` (step 3; rk45's
host loop of attempts).

One graph per (sampler, config, shape, SDE, conditioning keys with shapes and
dtypes, keyword options, the flags ``capture.flags`` lists, inference mode)
and score function, kept while the score function lives (a bound method
counts as its object): pass the same callable, e.g. the model itself, to
replay. The graph is captured at the first call, inside the caller's
contexts (``precision.exact_fp32``, ``torch.inference_mode``), after
``capture.WARMUP_CALLS`` eager calls on a side stream that take the same
inputs (cuDNN's choices, K1's weight packs). It reads the score function's
tensors where they were at capture; in-place updates are seen, K1's cached
packs are checked on every call (a stale one makes a new capture), and a
score function that swaps its tensors for others needs a new callable.

rk45 (``config.ode_method``) adapts its step on the host: its graph is one
Dormand-Prince attempt (``samplers.dp_attempt``: the accept or reject is a
select on the device), replayed by the host loop, which reads t once per
attempt. JAX runs the whole ``lax.while_loop`` as one program.

A capture that fails raises ``capture.CaptureError``; nothing falls back to
the eager loop. Callers choose the route with ``capture.use_graphs`` and
``call`` takes it.
"""

from __future__ import annotations

import logging
import weakref
from typing import Dict, Optional, Sequence

import torch

from sbgm_danra_tpu_torch import capture
from sbgm_danra_tpu_torch.sampling import samplers as S
from sbgm_danra_tpu_torch.sde import VESDE
from sbgm_danra_tpu_torch.utils.profiling import span

logger = logging.getLogger(__name__)

_caches = weakref.WeakKeyDictionary()  # score function's owner -> {key: _Entry}


def _cache_for(score_fn):
    """The graph cache of ``score_fn`` and its key part: a bound method's
    object holds the cache, keyed by the function's identity."""
    owner = getattr(score_fn, "__self__", score_fn)
    return _caches.setdefault(owner, {}), id(getattr(score_fn, "__func__", score_fn))


class _Entry:
    """A captured sampler call: its static inputs and graph."""

    def __init__(self, graph: capture.Graph, draws: torch.Tensor, cond: Dict[str, torch.Tensor],
                 extra: Sequence[torch.Tensor] = ()):
        self.graph, self.draws, self.cond, self.extra = graph, draws, cond, list(extra)


def _name(fn, config, shape) -> str:
    method = f"/{config.ode_method}" if fn is S.ode_sampler else ""
    return f"{fn.__name__}{method} {'x'.join(map(str, shape))}"


def sample(sampler, score_fn, rng: S.Rng, shape: Sequence[int], sde=VESDE(),
           config: S.SamplerConfig = S.SamplerConfig(),
           cond: Optional[Dict[str, Optional[torch.Tensor]]] = None,
           draws: Optional[torch.Tensor] = None, **kw) -> torch.Tensor:
    """The sampler's call (``sampler``: a registry name or a sampler function)
    as a replay of its captured graph; see the module's notes. ``draws``: the
    call's noise made already (``[n_draws, *shape]``, e.g. a rank's rows of an
    ensemble's noise, ``parallel/ensemble.py``) in place of drawing it from
    ``rng``."""
    fn = S.get_sampler(sampler) if isinstance(sampler, str) else sampler
    shape = tuple(shape)
    cond = {k: v for k, v in (cond or {}).items()}
    present = sorted(k for k, v in cond.items() if v is not None)
    key = (fn, config, shape, sde, capture.tensor_signature(cond[k] for k in present),
           tuple(present), tuple(sorted(k for k, v in cond.items() if v is None)),
           tuple(sorted(kw.items())), capture.flags(), torch.is_inference_mode_enabled())
    cache, fkey = _cache_for(score_fn)
    entry = cache.get((fkey, key))
    if entry is not None and not entry.graph.valid():
        logger.info("%s: the score function's weights changed since the capture; capturing "
                    "again", entry.graph.name)
        del cache[(fkey, key)]
        entry = None
    rk45 = fn is S.ode_sampler and config.ode_method == "rk45"
    n = 1 if rk45 else S.n_draws(fn, config)
    if draws is not None and (draws.shape[0] != n or tuple(draws.shape[1:]) != shape):
        raise ValueError(f"draws of shape {tuple(draws.shape)}; the sampler takes "
                         f"{(n, *shape)}")
    if entry is None:
        draws = S.draw_noise(rng, shape, n) if draws is None else draws.clone()
        static = {k: capture.static_like(cond[k]) for k in present}
        for k in present:
            static[k].copy_(cond[k])
        nulls = {k: None for k, v in cond.items() if v is None}
        if rk45:
            entry = _capture_rk45(fn, score_fn, shape, sde, config, draws, static, nulls)
        else:
            def call(draws, *values):
                c = dict(zip(present, values), **nulls)
                return fn(score_fn, None, shape, sde, config, cond=c, draws=draws, **kw)

            graph = capture.Graph(_name(fn, config, shape), call,
                                  [draws, *(static[k] for k in present)])
            entry = _Entry(graph, draws, static)
        cache[(fkey, key)] = entry
    else:
        with span("sample.inputs"):
            if draws is not None:
                entry.draws.copy_(draws)
            else:
                S.draw_noise(rng, shape, n, out=entry.draws)
            for k in present:
                entry.cond[k].copy_(cond[k])
    with span("sample.replay"):
        if rk45:
            return _run_rk45(entry, sde, config)
        return entry.graph.replay().clone()


def call(sampler, score_fn, rng: S.Rng, shape: Sequence[int], sde=VESDE(),
         config: S.SamplerConfig = S.SamplerConfig(),
         cond: Optional[Dict[str, Optional[torch.Tensor]]] = None, graph: bool = True,
         draws: Optional[torch.Tensor] = None, **kw) -> torch.Tensor:
    """``sample`` when ``graph`` (an entry point's ``capture.use_graphs``
    route), else the sampler's eager loop on the same arguments."""
    if graph:
        return sample(sampler, score_fn, rng, shape, sde, config, cond, draws=draws, **kw)
    fn = S.get_sampler(sampler) if isinstance(sampler, str) else sampler
    return fn(score_fn, rng, tuple(shape), sde, config, cond=cond, draws=draws, **kw)


def _capture_rk45(fn, score_fn, shape, sde, config, draws, static, nulls) -> _Entry:
    """The graph of one Dormand-Prince attempt from static (x, t, h)."""
    present = list(static)
    x = draws[0] * S._schedule("prior", sde, config)
    t, h, _, t_end, h_max = S.rk45_start(x, 1.0, config.eps)
    guided = S._prepare(score_fn, config)

    def attempt(x, t, h, t_end, h_max, *values):
        c = dict(zip(present, values), **nulls)
        return S.dp_attempt(lambda xi, ti: S._ode_drift(guided, sde, c, xi, ti), x, t, h,
                            t_end, h_max, config.rtol, config.atol)

    # t_end and h_max are inputs too: the graph keeps every tensor it reads alive
    graph = capture.Graph(_name(fn, config, shape), attempt,
                          [x, t, h, t_end, h_max, *(static[k] for k in present)])
    return _Entry(graph, draws, static, extra=(x, t, h))


def _run_rk45(entry: _Entry, sde, config) -> torch.Tensor:
    x_s, t_s, h_s = entry.extra
    x0 = entry.draws[0] * S._schedule("prior", sde, config)

    def attempt(x, t, h):
        for dst, src in ((x_s, x), (t_s, t), (h_s, h)):
            dst.copy_(src)
        return entry.graph.replay()

    x, converged = S._rk45_adaptive(None, x0, 1.0, config.eps, config.rtol, config.atol,
                                    attempt=attempt)
    if not converged:
        logger.warning("ode_sampler(rk45): iteration cap reached before t=eps; "
                       "sample is UNCONVERGED")
    return x.clone()


def captured(score_fn) -> list:
    """The graphs held for ``score_fn`` (``capture.Graph``: launches, replays,
    capture and instantiate seconds, pool bytes)."""
    owner = getattr(score_fn, "__self__", score_fn)
    fkey = id(getattr(score_fn, "__func__", score_fn))
    return [entry.graph for (f, _), entry in _caches.get(owner, {}).items() if f == fkey]


def clear() -> None:
    """Drop every cached sampler graph (and its memory pool)."""
    _caches.clear()

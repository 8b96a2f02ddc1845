"""K train steps per dispatch, each drawing its batch on the card
(counterpart of ``sbgm_danra_tpu/training/fused.py``).

JAX runs K steps of (batch sampler, train step) as one ``lax.scan`` program.
``make_fused_train_step`` returns ``fused(state, draws, step_draws, stacks)
-> (state, {"loss": [K], "finite": [K]})``: for each step i, the batch of
``sample_fn`` (``DeviceDataLoader.sample_fn``: one gather from the resident
stacks, the jump-flood SDF, CFG dropout) at the draws ``draws[.][i]``
(day, ox, oy, keep, each [K, B]), then the train step with the DSM draws
``step_draws[.][i]`` (t [K, B], z [K, B, H, W, 1]). The draws come first,
from the same streams as K eager steps (``DeviceDataLoader.iter_chunks``,
``step_draws``), so a chunk trains what K eager steps train. ``finite`` is
the step's flag of the loss and gradients with ``track_finite``, else the
loss's.

On the card (``capture=True``) one graph of one step (sampler and train
step) is replayed K times from a host loop that copies each step's draws
into its inputs. One graph of all K steps ran no faster a step and took K
times as long to capture (``PERF.md``). The graph reads the stacks by
address, so it is kept per set of stacks (their ``data_ptr``), at most
``DATA_SLOTS`` of them: the resident loader has one, the windowed loader
(``data/windowed_data.py``) two card slots used in turn, so its swaps never
capture again after each slot's first chunk. On the CPU the K steps run
eagerly on the same draws.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence, Tuple

import torch

from sbgm_danra_tpu_torch.sde import dsm_draws
from sbgm_danra_tpu_torch.training.state import TrainState
from sbgm_danra_tpu_torch.training.train_step import StateGraphs, make_train_step

MODEL_KEYS = ("x", "y", "cond_img", "lsm_cond", "topo_cond", "sdf")
DATA_SLOTS = 2  # sets of stacks with a graph each: the windowed loader's two card slots


def step_draws(generator: Optional[torch.Generator], x_shape: Sequence[int], k: int,
               dtype: torch.dtype = torch.float32, device=None,
               t_eps: float = 1e-3) -> Tuple[torch.Tensor, torch.Tensor]:
    """K steps' DSM draws (t [K, B], z [K, *x_shape]) from ``generator``,
    in the order K eager steps draw them (t, then z, per step)."""
    like = torch.empty(tuple(x_shape), dtype=dtype, device=device)
    ts, zs = zip(*(dsm_draws(like, generator, t_eps) for _ in range(k)))
    return torch.stack(ts), torch.stack(zs)


def make_fused_train_step(model, sde, sample_fn: Callable, t_eps: float = 1e-3,
                          use_sdf_weights: bool = True, remat: bool = False,
                          skip_nonfinite_updates: bool = False, track_finite: bool = False,
                          capture: bool = False) -> Callable:
    """Build ``fused(state, draws, step_draws, stacks)``; see the module's notes."""
    step = make_train_step(model, sde, t_eps=t_eps, use_sdf_weights=use_sdf_weights,
                           detect_anomaly=track_finite, remat=remat,
                           skip_nonfinite_updates=skip_nonfinite_updates)

    def one(state, day, ox, oy, keep, t, z, stacks) -> Dict[str, torch.Tensor]:
        batch = sample_fn(day, ox, oy, keep, *stacks)
        metrics = step(state, {k: batch[k] for k in MODEL_KEYS if k in batch}, t=t, z=z)
        return {"loss": metrics["loss"],
                "finite": metrics.get("finite", torch.isfinite(metrics["loss"]))}

    caches: Dict[tuple, StateGraphs] = {}  # by the stacks' addresses, oldest first

    def fused(state: TrainState, draws: Sequence[torch.Tensor], sdraws: Sequence[torch.Tensor],
              stacks: Sequence[torch.Tensor]) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        k = draws[0].shape[0]
        if not capture:
            out = [one(state, *(d[i] for d in draws), *(s[i] for s in sdraws), stacks)
                   for i in range(k)]
            return state, {key: torch.stack([o[key] for o in out]) for key in ("loss", "finite")}
        extra = tuple(s.data_ptr() for s in stacks)
        cache = caches.get(extra)
        if cache is None:
            if len(caches) >= DATA_SLOTS:  # the oldest stacks' graph and pool go first
                caches.pop(next(iter(caches)))
            cache = caches[extra] = StateGraphs()
        out = {"loss": torch.empty(k, device=draws[0].device),
               "finite": torch.empty(k, dtype=torch.bool, device=draws[0].device)}
        graph, static = cache.entry("fused step", lambda *v: one(state, *v, stacks), state,
                                    [*(d[0] for d in draws), *(s[0] for s in sdraws)], extra)
        for i in range(k):
            if i:
                for dst, src in zip(static, [*(d[i] for d in draws), *(s[i] for s in sdraws)]):
                    dst.copy_(src)
            result = graph.replay()
            out["loss"][i].copy_(result["loss"])
            out["finite"][i].copy_(result["finite"])
        return state, out

    return fused

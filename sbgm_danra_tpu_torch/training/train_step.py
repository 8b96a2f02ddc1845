"""Train and eval steps: DSM loss, gradients, EMA, BatchNorm statistics,
finiteness flags (counterpart of ``sbgm_danra_tpu/training/train_step.py``).

A train step is the JAX step's program: the training forward
(``ScoreUNet.forward(train=True)``), the DSM loss, the backward, the
optimizer step, the EMA update and the BatchNorm running-statistics update,
in place on the ``TrainState``. It reads nothing of the device on the host,
so it runs two ways: eagerly (the CPU's route), or captured into one CUDA
graph per batch signature and replayed (``CapturedStep``, the trainer's
route on the card, as JAX runs its step as one program).

- ``remat``: the score function runs under ``torch.utils.checkpoint``
  (``use_reentrant=False``), which keeps only its inputs and recomputes the
  forward during the backward, as ``jax.checkpoint``. The model draws no
  random numbers, so the recompute keeps no RNG state
  (``preserve_rng_state=False``, which a capture needs). BatchNorm only
  records its batch statistics in the forward, and the step folds them in
  once after the backward, so the recompute updates nothing twice; the model
  routes on its explicit ``train`` flag, so the recompute takes the
  forward's route.
- ``detect_anomaly`` / ``skip_nonfinite_updates``: the finiteness of the loss
  and of every gradient, returned as ``metrics["finite"]`` (a device tensor).
  With ``skip_nonfinite_updates`` the step applies the update and then, on
  the device, keeps the old value of every tensor it wrote where the flag
  is False (parameters, optimizer state, EMA, BatchNorm statistics and the
  step counter), as the JAX step selects its old state.

- ``reduce(loss, params)`` (data parallelism, ``parallel/train.py``): called
  after the backward on the detached loss and the parameters that have a
  gradient; it brings the loss and the gradients to their global means (one
  all-reduce) and returns the loss. The zero-gradient fill-in, the finite
  flag and the optimizer come after it, so every rank keeps or drops the
  same update.

``t`` and ``z`` of the DSM loss may be given (the parity tests hand both
packages the same draws); otherwise they are drawn on ``generator``
(``sde.dsm_draws``; a captured step draws them before its replay).
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch
from torch.utils.checkpoint import checkpoint

from sbgm_danra_tpu_torch import capture as cap
from sbgm_danra_tpu_torch.sde import dsm_draws, dsm_loss
from sbgm_danra_tpu_torch.training.state import TrainState, batch_norms

_COND_KEYS = ("y", "cond_img", "lsm_cond", "topo_cond")
Batch = Dict[str, torch.Tensor]


def _cond_kwargs(batch: Batch) -> Dict[str, Optional[torch.Tensor]]:
    return {k: batch.get(k) for k in _COND_KEYS}


def make_train_step(
    model,
    sde,
    t_eps: float = 1e-3,
    use_sdf_weights: bool = True,
    detect_anomaly: bool = False,
    remat: bool = False,
    skip_nonfinite_updates: bool = False,
    reduce: Optional[Callable] = None,
) -> Callable[..., Dict[str, torch.Tensor]]:
    """``train_step(state, batch, generator=None, t=None, z=None) -> metrics``
    (``CapturedStep(train_step, t_eps, name)`` replays it as a CUDA graph)."""

    def raw_score_fn(x_t, t, *cond_values):
        return model(x_t, t, **dict(zip(_COND_KEYS, cond_values)), train=True)

    def score_fn(x_t, t, **cond):
        values = tuple(cond.get(k) for k in _COND_KEYS)
        if remat:
            return checkpoint(raw_score_fn, x_t, t, *values, use_reentrant=False,
                              preserve_rng_state=False)
        return raw_score_fn(x_t, t, *values)

    def train_step(state: TrainState, batch: Batch, generator: Optional[torch.Generator] = None,
                   t: Optional[torch.Tensor] = None, z: Optional[torch.Tensor] = None):
        state.optimizer.zero_grad(set_to_none=True)
        loss = dsm_loss(score_fn, batch["x"], t=t, z=z, generator=generator, sde=sde,
                        t_eps=t_eps, sdf=batch.get("sdf") if use_sdf_weights else None,
                        **_cond_kwargs(batch))
        loss.backward()
        loss = loss.detach()
        if reduce is not None:
            loss = reduce(loss, [p for p in model.parameters() if p.grad is not None])
        for p in model.parameters():
            # a parameter the loss never reads (the final block's time
            # projection) has gradient 0 in JAX, and its weight decay still
            # moves it; torch's optimizers skip a None gradient
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        metrics = {"loss": loss}
        if detect_anomaly or skip_nonfinite_updates:
            finite = torch.isfinite(loss)
            for g in (p.grad for p in model.parameters()):
                finite = finite & torch.isfinite(g).all()
            metrics["finite"] = finite
        kept = ([(v, v.detach().clone()) for v in state.update_tensors()]
                if skip_nonfinite_updates else ())
        state.optimizer.step()
        state.update_ema()
        for bn in batch_norms(model):
            bn.update_running_stats()
        state.step_count += 1
        if skip_nonfinite_updates:
            _keep_where_not(metrics["finite"], state, kept)
        return metrics

    return train_step


@torch.no_grad()
def _keep_where_not(finite: torch.Tensor, state: TrainState, kept) -> None:
    """Every tensor the step wrote back to its value in ``kept`` where
    ``finite`` is False, on the device. A tensor the optimizer made in this
    step (its first) goes back to zeros, the state it starts from."""
    old = {id(v): before for v, before in kept}
    for v in state.update_tensors():
        before = old.get(id(v))
        v.copy_(torch.where(finite, v, torch.zeros_like(v) if before is None else before))


def _state_reset(state: TrainState) -> Callable[[], None]:
    """A function that puts every tensor a step writes back to its value now
    (a tensor made later, e.g. the optimizer's state at its first step, to
    zeros): what a capture's warm-up steps changed is undone so."""
    # detached: a clone of a parameter would make (and keep) its gradient
    # accumulator on the current stream, outside the capture's
    kept = [(v, v.detach().clone()) for v in state.update_tensors()]
    return lambda: _keep_where_not(torch.zeros((), dtype=torch.bool, device=kept[-1][0].device),
                                   state, kept)


class StateGraphs:
    """Captured calls of ``fn(*inputs)`` that read (and, with
    ``updates_state``, write) a ``TrainState``: one ``capture.Graph`` per
    (name, input shapes and dtypes, the state's float learning rate, the
    capture flags). A graph is captured again once ``TrainState.signature``
    (with ``extra``, e.g. the addresses of resident data) changes or a K1
    pack it reads goes stale. The warm-up calls of a capture that updates the
    state are undone before the capture, so a capture trains nothing; each
    replay of such a graph advances the version counters of the state's
    tensors, so that K1 packs made from them before it go stale."""

    def __init__(self, updates_state: bool = True):
        self.updates_state = updates_state
        self._entries: Dict[tuple, tuple] = {}

    def entry(self, name: str, fn: Callable, state: TrainState, inputs, extra: tuple = ()):
        """(graph, static inputs) for this call, with ``inputs`` copied in:
        the cached graph, or a new capture of ``fn`` on copies of them."""
        key = (name, cap.tensor_signature(inputs), state.lr_key(), cap.flags(),
               torch.is_inference_mode_enabled())
        found = self._entries.get(key)
        if found is not None and found[0].valid(state.signature() + extra):
            for dst, src in zip(found[1], inputs):
                dst.copy_(src)
            return found
        self._entries.pop(key, None)  # the stale graph's pool goes before the new one is made
        static = [cap.static_like(v).copy_(v) for v in inputs]
        graph = cap.Graph(name, fn, static,
                          reset=_state_reset(state) if self.updates_state else None)
        graph.signature = state.signature() + extra
        if self.updates_state:  # the optimizer's state exists now, made by the warm-up
            graph.writes = state.update_tensors()
        self._entries[key] = (graph, static)
        return graph, static


class CapturedStep:
    """A train or eval step as a replay of its CUDA graph: ``step(state,
    batch, generator=None, t=None, z=None) -> metrics`` as the eager step it
    wraps, with t and z drawn first (``sde.dsm_draws``) and the metrics cloned
    out of the graph's pool."""

    def __init__(self, step: Callable, t_eps: float, name: str, updates_state: bool = True):
        self.step, self.t_eps, self.name = step, t_eps, name
        self.cache = StateGraphs(updates_state)

    def __call__(self, state: TrainState, batch: Batch,
                 generator: Optional[torch.Generator] = None, t: Optional[torch.Tensor] = None,
                 z: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
        t, z = dsm_draws(batch["x"], generator, self.t_eps, t, z)
        keys = sorted(batch)
        step = self.step

        def call(*values):
            return step(state, dict(zip(keys, values)), t=values[-2], z=values[-1])

        graph, _ = self.cache.entry(self.name, call, state, [batch[k] for k in keys] + [t, z])
        return {k: v.clone() for k, v in graph.replay().items()}


def _params_of(state: TrainState, use_ema: bool) -> Optional[Dict[str, torch.Tensor]]:
    return dict(state.ema_params) if use_ema else None


def _apply(model, params, x, t, **cond):
    """The model on its own parameters, or on ``params`` (the EMA tensors, by
    name) with its buffers: ``torch.func.functional_call``, no copy."""
    if params is None:
        return model(x, t, **cond, train=False)
    return torch.func.functional_call(model, params, (x, t), {**cond, "train": False},
                                      strict=False)


def make_eval_step(model, sde, t_eps: float = 1e-3, use_sdf_weights: bool = True,
                   use_ema: bool = False, capture: bool = False,
                   reduce: Optional[Callable] = None
                   ) -> Callable[..., Dict[str, torch.Tensor]]:
    """Validation loss (``train=False``: running statistics, K1 on the card) on
    the parameters or the EMA: ``eval_step(state, batch, generator=None, t=None,
    z=None) -> {"loss"}``; with ``capture`` a ``CapturedStep`` of it.
    ``reduce(loss)``: the global mean of the ranks' losses (data parallelism)."""

    @torch.no_grad()
    def eval_step(state: TrainState, batch: Batch, generator: Optional[torch.Generator] = None,
                  t: Optional[torch.Tensor] = None, z: Optional[torch.Tensor] = None):
        params = _params_of(state, use_ema)

        def score_fn(x_t, t_, **cond):
            return _apply(model, params, x_t, t_, **cond)

        loss = dsm_loss(score_fn, batch["x"], t=t, z=z, generator=generator, sde=sde,
                        t_eps=t_eps, sdf=batch.get("sdf") if use_sdf_weights else None,
                        **_cond_kwargs(batch))
        return {"loss": loss if reduce is None else reduce(loss)}

    if capture:
        return CapturedStep(eval_step, t_eps, "eval step", updates_state=False)
    return eval_step


def make_score_fn(model, state: TrainState, use_ema: bool = True) -> Callable:
    """Closure for the samplers: ``score_fn(x, t, **cond)`` on the (EMA) weights, ``train=False``."""
    params = _params_of(state, use_ema)

    def score_fn(x, t, **cond):
        return _apply(model, params, x, t, **cond)

    return score_fn

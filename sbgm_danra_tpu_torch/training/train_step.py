"""Train and eval steps: DSM loss, gradients, EMA, BatchNorm statistics,
finiteness flags (counterpart of ``sbgm_danra_tpu/training/train_step.py``).

One call of a train step is the JAX step's program run eagerly: the training
forward (``ScoreUNet.forward(train=True)``), the DSM loss, the backward, the
optimizer step, the EMA update and the BatchNorm running-statistics update,
in place on the ``TrainState``.

- ``remat``: the score function runs under ``torch.utils.checkpoint``
  (``use_reentrant=False``), which keeps only its inputs and recomputes the
  forward during the backward, as ``jax.checkpoint``. BatchNorm only records
  its batch statistics in the forward, and the step folds them in once after
  the backward, so the recompute updates nothing twice; the model routes on
  its explicit ``train`` flag, so the recompute takes the forward's route.
- ``detect_anomaly`` / ``skip_nonfinite_updates``: the finiteness of the loss
  and of every gradient, returned as ``metrics["finite"]`` (a device tensor).
  With ``skip_nonfinite_updates`` the step reads it on the host and, where it
  is False, leaves the parameters, the optimizer state, the EMA, the
  BatchNorm statistics and the step counter as they were.

``t`` and ``z`` of the DSM loss may be given (the parity tests hand both
packages the same draws); otherwise they are drawn on ``generator``.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch
from torch.utils.checkpoint import checkpoint

from sbgm_danra_tpu_torch.sde import dsm_loss
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
) -> Callable[..., Dict[str, torch.Tensor]]:
    """``train_step(state, batch, generator=None, t=None, z=None) -> metrics``."""

    def raw_score_fn(x_t, t, *cond_values):
        return model(x_t, t, **dict(zip(_COND_KEYS, cond_values)), train=True)

    def score_fn(x_t, t, **cond):
        values = tuple(cond.get(k) for k in _COND_KEYS)
        if remat:
            return checkpoint(raw_score_fn, x_t, t, *values, use_reentrant=False)
        return raw_score_fn(x_t, t, *values)

    def train_step(state: TrainState, batch: Batch, generator: Optional[torch.Generator] = None,
                   t: Optional[torch.Tensor] = None, z: Optional[torch.Tensor] = None):
        state.optimizer.zero_grad(set_to_none=True)
        loss = dsm_loss(score_fn, batch["x"], t=t, z=z, generator=generator, sde=sde,
                        t_eps=t_eps, sdf=batch.get("sdf") if use_sdf_weights else None,
                        **_cond_kwargs(batch))
        loss.backward()
        for p in model.parameters():
            # a parameter the loss never reads (the final block's time
            # projection) has gradient 0 in JAX, and its weight decay still
            # moves it; torch's optimizers skip a None gradient
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        metrics = {"loss": loss.detach()}
        norms = batch_norms(model)
        if detect_anomaly or skip_nonfinite_updates:
            finite = torch.isfinite(loss.detach())
            for g in (p.grad for p in model.parameters()):
                finite = finite & torch.isfinite(g).all()
            metrics["finite"] = finite
            if skip_nonfinite_updates and not bool(finite):
                for bn in norms:  # the recorded statistics are dropped, not folded in
                    bn.batch_stats = None
                state.optimizer.zero_grad(set_to_none=True)
                return metrics
        state.optimizer.step()
        state.update_ema()
        for bn in norms:
            bn.update_running_stats()
        state.step += 1
        return metrics

    return train_step


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
                   use_ema: bool = False) -> Callable[..., Dict[str, torch.Tensor]]:
    """Validation loss (``train=False``: running statistics, K1 on the card) on
    the parameters or the EMA: ``eval_step(state, batch, generator=None, t=None,
    z=None) -> {"loss"}``."""

    @torch.no_grad()
    def eval_step(state: TrainState, batch: Batch, generator: Optional[torch.Generator] = None,
                  t: Optional[torch.Tensor] = None, z: Optional[torch.Tensor] = None):
        params = _params_of(state, use_ema)

        def score_fn(x_t, t_, **cond):
            return _apply(model, params, x_t, t_, **cond)

        loss = dsm_loss(score_fn, batch["x"], t=t, z=z, generator=generator, sde=sde,
                        t_eps=t_eps, sdf=batch.get("sdf") if use_sdf_weights else None,
                        **_cond_kwargs(batch))
        return {"loss": loss}

    return eval_step


def make_score_fn(model, state: TrainState, use_ema: bool = True) -> Callable:
    """Closure for the samplers: ``score_fn(x, t, **cond)`` on the (EMA) weights, ``train=False``."""
    params = _params_of(state, use_ema)

    def score_fn(x, t, **cond):
        return _apply(model, params, x, t, **cond)

    return score_fn

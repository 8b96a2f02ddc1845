"""Data-parallel train and eval steps over a mesh of ranks (counterpart of
``sbgm_danra_tpu/parallel/train.py``).

JAX jits the single-device step with the state replicated and the batch
sharded on ``data``, and XLA computes exactly what one device computes on the
global batch. Here each rank runs the port's step (``training/train_step.py``)
on its own rows, and the step is made to compute the same:

- the state is replicated: broadcast from rank 0 (``mesh.replicate``);
- every BatchNorm takes the global batch's statistics (``layers.BatchNorm``'s
  ``group``, the ``data`` group), with the biased running variance (F2);
- after the backward the loss and the gradients go to their global means as
  one flat bucket a dtype (``collectives.flat_all_reduce_mean`` over the
  whole mesh: ranks of one ``model`` group hold the same rows, so the mean
  over the mesh is the mean over the data shards; a tensor-parallel part's
  gradient over the ``data`` group only), before the zero-gradient
  fill-in, the finite flag (``skip_nonfinite_updates``: every rank keeps or
  drops the same update) and the optimizer;
- the DSM draws: each rank draws the GLOBAL t and z from the same seeded
  generator and takes its rows, so the step trains what one device trains on
  the global batch with that generator (one global batch of noise a rank).

The route: on the card with NCCL the steps replay their CUDA graphs
(``train_step.CapturedStep``; every group's communicator made first, the
all-reduce captured); over gloo (two ranks sharing one card, or the CPU)
nothing can be captured, so the steps run eagerly. The choice is made from
the group's backend and logged (``route``), never by catching an error.

``tp=True``: the large kernels and their Adam moments and EMA copies sharded
on the ``model`` axis (``shard_state_tp``, ``parallel/tp.py``).
"""

from __future__ import annotations

import functools
import logging
from typing import Optional

import torch

from sbgm_danra_tpu_torch.capture import use_graphs
from sbgm_danra_tpu_torch.parallel import collectives as C
from sbgm_danra_tpu_torch.parallel import tp as tp_rules
from sbgm_danra_tpu_torch.parallel.mesh import DATA_AXIS, MODEL_AXIS, Mesh, replicate, shard_batch
from sbgm_danra_tpu_torch.precision import exact_fp32
from sbgm_danra_tpu_torch.sde import dsm_draws
from sbgm_danra_tpu_torch.training.state import TrainState, batch_norms
from sbgm_danra_tpu_torch.training.train_step import CapturedStep, make_eval_step, make_train_step

logger = logging.getLogger(__name__)


def replicate_state(state: TrainState, mesh: Mesh) -> TrainState:
    """Parameters, BatchNorm buffers, optimizer state, EMA and step counter
    broadcast from rank 0 (in place)."""
    replicate(mesh, state.update_tensors() + [b for _, b in state.model.named_buffers()
                                               if not _is_stat(_)])
    return state


def _is_stat(name: str) -> bool:
    return name.endswith(("running_mean", "running_var"))


def set_batch_norm_group(model, group) -> None:
    """Global-batch statistics over ``group`` in every BatchNorm of ``model``."""
    for bn in batch_norms(model):
        bn.group = group


def shard_state_tp(state: TrainState, mesh: Mesh) -> TrainState:
    """The state with tensor-parallel parameter sharding on ``mesh``: the
    state replicated first, then the rules' parameters cut to this rank's
    part (``tp.shard_params``), their EMA copies and optimizer moments cut the
    same way, the optimizer rebuilt over the parts with its hyperparameters.
    Everything else stays replicated."""
    replicate_state(state, mesh)
    model = state.model
    before = dict(model.named_parameters())
    old_opt = state.optimizer
    applied = tp_rules.shard_params(model, mesh)
    n, index = mesh.axis_size(MODEL_AXIS), mesh.axis_index(MODEL_AXIS)

    def part(value, spec):
        if not spec or value.dim() != len(spec):
            return value.detach().clone()
        return value.detach().chunk(n, spec.index(MODEL_AXIS))[index].clone()

    after = dict(model.named_parameters())
    renamed = {name: (tp_rules.sharded_name(name) if spec else name)
               for name, spec in applied.items()}
    new_opt = type(old_opt)(list(model.parameters()), **old_opt.defaults)
    for group_new, group_old in zip(new_opt.param_groups, old_opt.param_groups):
        group_new["lr"] = group_old["lr"]
    for name, old in before.items():
        spec = applied[name]
        for key, value in old_opt.state.get(old, {}).items():
            shaped = isinstance(value, torch.Tensor) and value.shape == old.shape
            new_opt.state[after[renamed[name]]][key] = (
                part(value, spec) if shaped else
                value.detach().clone() if isinstance(value, torch.Tensor) else value)
    state.optimizer = new_opt
    # in the parameters' new order: update_ema pairs the two by position
    original = {new: old for old, new in renamed.items()}
    state.ema_params = {name: part(state.ema_params[original[name]], applied[original[name]])
                        for name in after}
    return state


def route(mesh: Mesh, capture: Optional[bool] = None) -> dict:
    """The steps' route on ``mesh``: the collectives' route (nccl, gloo,
    gloo-host-staged, local) and whether the steps replay CUDA graphs
    (NCCL's collectives capture, gloo's do not)."""
    coll = mesh.route(None)
    graphs = use_graphs(capture, mesh.device) and coll in (C.NCCL, C.LOCAL)
    if capture and not graphs:
        raise ValueError(f"capture=True, but collectives over {coll} cannot be captured")
    return {"collectives": coll, "graphs": graphs}


def global_draws(x_local: torch.Tensor, mesh: Mesh, generator=None, t_eps: float = 1e-3,
                 t: Optional[torch.Tensor] = None, z: Optional[torch.Tensor] = None):
    """This rank's rows of the global DSM draws: given ``t`` / ``z`` of the
    global batch, or drawn for it on ``generator`` (t first, as one device
    draws them)."""
    n, i = mesh.axis_size(DATA_AXIS), mesh.axis_index(DATA_AXIS)
    b = x_local.shape[0]
    shape = (n * b, *x_local.shape[1:])
    if t is None or z is None:
        like = torch.empty(shape, dtype=x_local.dtype, device=x_local.device)
        t, z = dsm_draws(like, generator, t_eps, t, z)
    if t.shape[0] != n * b or tuple(z.shape) != shape:
        raise ValueError(f"t {tuple(t.shape)} / z {tuple(z.shape)} are not the global "
                         f"batch's draws {shape}")
    return t[i * b:(i + 1) * b].to(x_local.device), z[i * b:(i + 1) * b].to(x_local.device)


def make_parallel_steps(model, sde, cfg, state: TrainState, mesh: Mesh, tp: bool = False,
                        capture: Optional[bool] = None):
    """Returns ``(train_step, eval_step, placed_state, batch_sharding)``.

    ``train_step(state, batch, generator=None, t=None, z=None)`` and
    ``eval_step`` take this rank's rows of the global batch (``batch_sharding``:
    a global batch dict -> this rank's rows) and, optionally, the GLOBAL t
    and z; their metrics are global means. ``tp=False``: pure data
    parallelism, the state replicated. ``tp=True``: the ``model``-axis
    sharding of ``shard_state_tp``. ``capture``: see ``route``.
    """
    if tp:
        state = shard_state_tp(state, mesh)
    else:
        replicate_state(state, mesh)
    set_batch_norm_group(model, mesh.group(DATA_AXIS))
    how = route(mesh, capture)
    logger.info("data-parallel steps on %s: collectives %s, %s", mesh, how["collectives"],
                "CUDA graphs" if how["graphs"] else "eager")
    world, data = mesh.group(None), mesh.group(DATA_AXIS)
    parts = {id(p) for p in tp_rules.sharded_parts(model)}

    def reduce_train(loss, params):
        # a sharded weight's part (its gradient already the model group's mean,
        # GatherShard's reduce-scatter) is averaged over the data ranks only: the
        # model ranks hold other parts
        C.flat_all_reduce_mean([loss.reshape(1)] + [p.grad for p in params
                                                    if id(p) not in parts], world)
        C.flat_all_reduce_mean([p.grad for p in params if id(p) in parts], data)
        return loss

    def reduce_eval(loss):
        return C.all_reduce_(loss.detach().clone(), world, "mean")

    t = cfg.training
    eps = cfg.sampler.t_eps
    step = make_train_step(model, sde, t_eps=eps, use_sdf_weights=t.sdf_weighted_loss,
                           detect_anomaly=t.detect_anomaly, remat=t.remat,
                           skip_nonfinite_updates=t.skip_nonfinite_updates, reduce=reduce_train)
    evaluate = make_eval_step(model, sde, t_eps=eps, use_sdf_weights=t.sdf_weighted_loss,
                              reduce=reduce_eval)
    if how["graphs"]:
        C.warm([world, *mesh.groups.values()])
        state.make_capturable()
        step = CapturedStep(step, eps, "dp train step")
        evaluate = CapturedStep(evaluate, eps, "dp eval step", updates_state=False)
    precision = exact_fp32(model.encoder.dtype)

    def wrap(inner):
        inner = precision(inner)

        def call(state, batch, generator=None, t=None, z=None):
            t, z = global_draws(batch["x"], mesh, generator, eps, t, z)
            return inner(state, batch, t=t, z=z)

        return call

    train_step, eval_step = wrap(step), wrap(evaluate)
    train_step.route = eval_step.route = how
    return train_step, eval_step, state, functools.partial(shard_batch, mesh)

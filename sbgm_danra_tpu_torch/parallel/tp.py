"""Tensor-parallel parameter sharding hooks (counterpart of
``sbgm_danra_tpu/parallel/tp.py``).

JAX's rules place the output-channel axis of large conv / dense kernels and
embeddings on the ``model`` axis and keep everything small replicated; they
are written on Flax's names and layouts (HWIO conv kernels, ``(in, out)``
dense kernels). The same rules on the port's layouts, leaf for leaf through
the bridge's name map (``convert.py``):

- a conv weight ``[out, in, kh, kw]`` -> dim 0 (a transposed conv's
  ``[in, out, kh, kw]`` -> dim 1, its output channels as in Flax);
- a linear weight ``[out, in]`` -> dim 0;
- an embedding ``[n, dim]`` -> dim 1;

each only where that dimension is at least ``MIN_SHARD_CHANNELS``. A spec is
a tuple of axis names or None per dimension, ``()`` for replicated (JAX's
``PartitionSpec``).

Torch has no GSPMD. ``shard_params`` keeps only this rank's part of a
sharded parameter (a ``torch.nn.utils.parametrize`` parametrization whose
``original`` is the part): at use the whole weight is all-gathered over the
``model`` group into one persistent buffer, and its gradient goes back to
each rank's part by a reduce-scatter (``collectives.GatherShard``): the
weight all-gather / gradient reduce-scatter that XLA inserts for JAX's
``tp=True`` step. A parameter whose sharded dimension does not divide the
``model`` axis stays replicated, as in JAX.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
from torch import nn
from torch.nn.utils import parametrize

from sbgm_danra_tpu_torch.parallel.collectives import GatherShard
from sbgm_danra_tpu_torch.parallel.mesh import MODEL_AXIS, Mesh

# Only kernels of at least this many output channels are worth sharding; below
# it the all-gather costs more than the memory/compute saved.
MIN_SHARD_CHANNELS = 128

Spec = Tuple


def _sharded_dim(module: nn.Module, leaf: str, param: torch.Tensor):
    """The dimension of ``module.<leaf>`` that the rules shard, or None."""
    if leaf != "weight":
        return None
    if isinstance(module, nn.ConvTranspose2d) and param.dim() == 4:
        dim = 1
    elif isinstance(module, nn.Conv2d) and param.dim() == 4:
        dim = 0
    elif isinstance(module, nn.Linear) and param.dim() == 2:
        dim = 0
    elif isinstance(module, nn.Embedding) and param.dim() == 2:
        dim = 1
    else:
        return None
    return dim if param.shape[dim] >= MIN_SHARD_CHANNELS else None


def param_partition_spec(module: nn.Module, leaf: str, param: torch.Tensor) -> Spec:
    """The spec of one parameter, ``leaf`` of ``module``."""
    dim = _sharded_dim(module, leaf, param)
    if dim is None:
        return ()
    return tuple(MODEL_AXIS if i == dim else None for i in range(param.dim()))


def partition_specs(model: nn.Module) -> Dict[str, Spec]:
    """``{parameter name: spec}`` over ``model``'s (unsharded) parameters."""
    out = {}
    for mname, module in model.named_modules():
        for leaf, p in module.named_parameters(recurse=False):
            out[f"{mname}.{leaf}" if mname else leaf] = param_partition_spec(module, leaf, p)
    return out


class _Gathered(nn.Module):
    """The parametrization of a sharded weight: this rank's part in, the whole
    weight out (gathered into ``full``)."""

    def __init__(self, group, dim: int, n: int, index: int, full: torch.Tensor):
        super().__init__()
        self.group, self.dim, self.n, self.index = group, dim, n, index
        self.full = full

    def forward(self, part: torch.Tensor) -> torch.Tensor:
        if self.full.device != part.device:  # the module moved
            self.full = torch.empty(self.full.shape, dtype=part.dtype, device=part.device)
        return GatherShard.apply(part, self.group, self.dim, self.full)

    def right_inverse(self, whole: torch.Tensor) -> torch.Tensor:
        return whole.chunk(self.n, self.dim)[self.index].clone()


def shard_params(model: nn.Module, mesh: Mesh) -> Dict[str, Spec]:
    """Shard ``model``'s parameters in place by the rules; returns the spec
    each parameter got (``()`` where the rule said replicated or the
    dimension does not divide the ``model`` axis). Call it on every rank, on
    weights that are alike on every rank (``mesh.replicate``)."""
    n, index = mesh.axis_size(MODEL_AXIS), mesh.axis_index(MODEL_AXIS)
    group = mesh.group(MODEL_AXIS)
    applied = {}
    for name, spec in partition_specs(model).items():
        if not spec or n == 1:
            applied[name] = ()
            continue
        dim = spec.index(MODEL_AXIS)
        mname, _, leaf = name.rpartition(".")
        module = model.get_submodule(mname)
        weight = getattr(module, leaf)
        if weight.shape[dim] % n:
            applied[name] = ()  # the divisibility fallback
            continue
        full = torch.empty(weight.shape, dtype=weight.dtype, device=weight.device)
        parametrize.register_parametrization(module, leaf, _Gathered(group, dim, n, index, full),
                                             unsafe=True)
        applied[name] = spec
    return applied


def sharded_parts(model: nn.Module):
    """The parameters that hold a rank's part of a sharded weight."""
    return [module.parametrizations[leaf].original for module in model.modules()
            if parametrize.is_parametrized(module)
            for leaf, plist in module.parametrizations.items()
            if any(isinstance(p, _Gathered) for p in plist)]


def sharded_name(name: str) -> str:
    """The parameter name of ``name``'s part once it is sharded."""
    mname, _, leaf = name.rpartition(".")
    return f"{mname}.parametrizations.{leaf}.original" if mname else \
        f"parametrizations.{leaf}.original"


def sharded_param_fraction(model: nn.Module) -> float:
    """Fraction of parameter elements the rules shard (diagnostics; JAX's
    number for the same model, by spec and before the divisibility check)."""
    specs = partition_specs(model)
    params = dict(model.named_parameters())
    total = sharded = 0
    for name, spec in specs.items():
        n = params[name].numel()
        total += n
        if spec:
            sharded += n
    return sharded / max(total, 1)

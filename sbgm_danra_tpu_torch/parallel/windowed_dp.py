"""Data-parallel card-resident sampling: day-sharded stacks, no collective on
the input path (counterpart of ``sbgm_danra_tpu/parallel/windowed_dp.py``).

When training data parallel, the card-resident stacks (``data/device_data.py``)
and the rotating windows (``data/windowed_data.py``) are split on the DAY
axis: each rank keeps 1/n of the days (the window's static maps on every
rank), so n cards hold an n times larger window or archive than one.

The port's loaders hand out ``(fields, statics, classifier)``
(``buffers()``: fields ``[D, H, W, 1 + C]``, statics ``[H, W, 2]``,
classifier ``[D]``), not JAX's five buffers. Each rank draws its ``batch /
n`` rows from its OWN days, with a generator seeded by (seed, epoch, step,
rank) in place of JAX's ``fold_in(axis_index)``, and builds them with the
ordinary batch function (``make_sample_fn``) at local dimensions: the rows
are already this rank's part of the global batch, as
``parallel/train.make_parallel_steps`` takes them. Nothing crosses ranks.

Distribution note (as JAX's): the global batch is a STRATIFIED sample, a
fixed quota of ``batch / n`` per day shard instead of one i.i.d. draw over
all days. With days assigned to shards by position and the windowed loader's
"strided" layout, per-shard quotas are uniform over the archive;
stratification only lowers the variance of a batch's day distribution, it
never biases it.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch

from sbgm_danra_tpu_torch.data.device_data import (DeviceStacks, draw, make_sample_fn,
                                                    step_generator)
from sbgm_danra_tpu_torch.parallel.mesh import DATA_AXIS, Mesh

Buffers = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def day_sharded_buffers(buffers: Buffers, mesh: Mesh, axis: str = DATA_AXIS) -> Buffers:
    """This rank's part of a loader's ``buffers()``: its block of days of the
    day-indexed fields and classifier (a copy of its own; days assigned by
    position), the static maps as they are. A day count that does not divide
    the axis is trimmed to the largest multiple (a remainder of fewer than n
    days is noise); fewer days than ranks raise."""
    fields, statics, classifier = buffers
    n, i = mesh.axis_size(axis), mesh.axis_index(axis)
    d = (fields.shape[0] // n) * n
    if d == 0:
        raise ValueError(f"need at least {n} days to shard over {n} '{axis}' devices, "
                         f"got {fields.shape[0]}")
    per = d // n
    return (fields[i * per:(i + 1) * per].clone(), statics,
            classifier[i * per:(i + 1) * per].clone())


class DpBatchSampler:
    """This rank's rows of a global batch over day-sharded stacks:
    ``sampler(epoch, step, fields, statics, classifier) -> batch`` (the local
    rows, model kwargs), ``draws(epoch, step, device)`` the local draws (days
    in local coordinates) and ``sample_fn`` the batch function of draws."""

    def __init__(self, mesh: Mesh, n_days: int, full_hw: Tuple[int, int],
                 crop_hw: Tuple[int, int], cutout_domains: Optional[Sequence[int]],
                 batch_size: int, cfg_dropout_prob: float = 0.0, with_sdf: bool = True,
                 axis: str = DATA_AXIS, seed: int = 0):
        n = mesh.axis_size(axis)
        if batch_size % n:
            raise ValueError(f"batch_size {batch_size} % {n} devices != 0")
        if n_days % n:
            raise ValueError(f"n_days {n_days} % {n} != 0 (trim via day_sharded_buffers)")
        self.rank = mesh.axis_index(axis)
        self.local_days, self.local_batch = n_days // n, batch_size // n
        self.full_hw, self.crop_hw = tuple(full_hw), tuple(crop_hw)
        self.cutout_domains = cutout_domains
        self.cfg_dropout_prob, self.seed = cfg_dropout_prob, seed
        self.sample_fn = make_sample_fn(self.crop_hw, with_sdf=with_sdf)

    def draws(self, epoch: int, step: int, device):
        g = step_generator(device, self.seed, epoch, step, self.rank)
        return draw(g, self.local_days, self.full_hw, self.crop_hw, self.cutout_domains,
                    self.local_batch, self.cfg_dropout_prob)

    def __call__(self, epoch: int, step: int, fields: torch.Tensor, statics: torch.Tensor,
                 classifier: torch.Tensor) -> Dict[str, torch.Tensor]:
        if fields.shape[0] != self.local_days:
            raise ValueError(f"{fields.shape[0]} local days; the sampler was built for "
                             f"{self.local_days}")
        return self.sample_fn(*self.draws(epoch, step, fields.device), fields, statics,
                              classifier)


def make_dp_batch_sampler(mesh: Mesh, n_days: int, full_hw: Tuple[int, int],
                          crop_hw: Tuple[int, int], cutout_domains: Optional[Sequence[int]],
                          batch_size: int, cfg_dropout_prob: float = 0.0,
                          with_sdf: bool = True, axis: str = DATA_AXIS,
                          seed: int = 0) -> DpBatchSampler:
    """The rank's sampler over day-sharded stacks (``DpBatchSampler``).

    ``n_days`` is the GLOBAL (post-trim) day count and ``batch_size`` the
    global batch; both must divide by the axis size."""
    return DpBatchSampler(mesh, n_days, full_hw, crop_hw, cutout_domains, batch_size,
                          cfg_dropout_prob, with_sdf, axis, seed)


def stacks_buffers(stacks: DeviceStacks) -> Buffers:
    """DeviceStacks -> the (fields, statics, classifier) buffer tuple."""
    return stacks.fields, stacks.statics, stacks.classifier

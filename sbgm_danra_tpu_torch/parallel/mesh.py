"""Process-group meshes and sharding helpers (counterpart of
``sbgm_danra_tpu/parallel/mesh.py``).

Conventions, as in JAX:
- axis ``data``: batch / ensemble-member parallelism;
- axis ``model``: tensor-parallel parameter sharding (``parallel/tp.py``;
  the default mesh is 1 on this axis).

A JAX mesh is an array of devices inside one program. Here each rank is a
process with one device, and a ``Mesh`` is this rank's view of the ranks
laid out row-major over the mesh's shape: its coordinate on each axis and
the process group of the ranks it shares every other coordinate with (one
group per axis; the whole world where the axis spans it). Launch the ranks
with ``python -m torch.distributed.run --nproc_per_node N ...`` (or any
launcher that sets ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
``MASTER_ADDR``, ``MASTER_PORT``; JAX's ``COORDINATOR_ADDRESS``,
``NUM_PROCESSES`` and ``PROCESS_ID`` are read too) and call
``initialize_distributed`` before ``make_mesh``. A run that sets none of
them is one process, and ``make_mesh`` gives it a one-rank mesh with no
process group, where every collective is the identity.

The backend is NCCL on the card and gloo on the CPU, or the caller's
``backend``: gloo on CUDA tensors is how two ranks share one card, which
NCCL refuses (``parallel/collectives.py``'s routes). A rank's device is
``cuda:{LOCAL_RANK % device_count}``.
"""

from __future__ import annotations

import logging
import os
from typing import Dict, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from sbgm_danra_tpu_torch.parallel import collectives as C

logger = logging.getLogger(__name__)

DATA_AXIS = "data"
MODEL_AXIS = "model"


def rank_device(device="cuda") -> torch.device:
    """This rank's device: ``cuda:{LOCAL_RANK % device_count}`` when ``device``
    is a CUDA device without an index, else ``device``. A CUDA device on a
    machine without one raises."""
    device = torch.device(device)
    if device.type != "cuda":
        return device
    if not torch.cuda.is_available():
        raise RuntimeError(f"device {device} requested, but torch.cuda.is_available() is False")
    if device.index is None:
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0))
                              % torch.cuda.device_count())
    return device


def default_backend(device) -> str:
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def initialize_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    backend: Optional[str] = None,
    device="cuda",
) -> int:
    """Join the run's process group; returns the process count.

    The rendezvous comes from the arguments, else torchrun's variables
    (``MASTER_ADDR:MASTER_PORT``, ``WORLD_SIZE``, ``RANK``), else JAX's launcher
    contract (``COORDINATOR_ADDRESS``, ``NUM_PROCESSES``, ``PROCESS_ID``). With
    none of them set nothing is initialised and 1 is returned: the same code
    path everywhere. An address with a process count of 1 makes a one-rank
    group (NCCL's route on one card). ``backend`` defaults to NCCL for a CUDA
    ``device`` and gloo for the CPU; the rank's device is made current.
    A second call returns the existing group's size.
    """
    if dist.is_initialized():
        return dist.get_world_size()
    env = os.environ
    if coordinator_address is None:
        if "MASTER_ADDR" in env and "MASTER_PORT" in env:
            coordinator_address = f"{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
        else:
            coordinator_address = env.get("COORDINATOR_ADDRESS")
    if num_processes is None:
        for key in ("WORLD_SIZE", "NUM_PROCESSES"):
            if key in env:
                num_processes = int(env[key])
                break
    if process_id is None:
        for key in ("RANK", "PROCESS_ID"):
            if key in env:
                process_id = int(env[key])
                break
    if coordinator_address is None:
        return 1
    if num_processes is None or process_id is None:
        raise ValueError(f"rendezvous at {coordinator_address} without a process count and "
                         "rank (WORLD_SIZE / RANK or NUM_PROCESSES / PROCESS_ID)")
    device = rank_device(device)
    backend = backend or default_backend(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}",
                            world_size=num_processes, rank=process_id)
    logger.info("process %d of %d joined over %s at %s on %s", process_id, num_processes,
                backend, coordinator_address, device)
    return num_processes


class Mesh:
    """This rank's place in a mesh of ranks (see the module's notes)."""

    def __init__(self, shape: Dict[str, int], device, rank: int = 0,
                 groups: Optional[Dict[str, object]] = None, world=None):
        self.shape = dict(shape)
        self.axis_names = tuple(self.shape)
        self.device = torch.device(device)
        self.rank = rank
        self.size = int(np.prod(list(self.shape.values())))
        self.coords = dict(zip(self.axis_names,
                               (int(c) for c in np.unravel_index(rank, tuple(self.shape.values())))))
        self.groups = groups or {a: None for a in self.axis_names}
        self.world = world

    def axis_size(self, axis: str) -> int:
        return self.shape.get(axis, 1)

    def axis_index(self, axis: str) -> int:
        return self.coords.get(axis, 0)

    def group(self, axis: Optional[str] = None):
        """The process group along ``axis`` (None: the whole mesh); None where
        the axis has one rank and the mesh more (its collectives are the identity)."""
        if axis is None:
            return self.world
        return self.groups.get(axis)

    @property
    def backend(self) -> Optional[str]:
        return C.backend(self.world)

    def route(self, axis: Optional[str] = None) -> str:
        """The route of a collective on ``axis`` for this mesh's tensors."""
        probe = torch.empty(0, device=self.device)
        return C.route(self.group(axis), probe)

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, rank={self.rank}, device={self.device}, backend={self.backend})"


def make_mesh(mesh_shape: Optional[Dict[str, int]] = None, device=None) -> Mesh:
    """This rank's ``Mesh``; default: all ranks on the data axis. The shape's
    product must equal the process count (``ValueError`` otherwise, as JAX's
    check against the devices). Every rank calls it, in the same order: the
    axis groups are made collectively. ``device``: this rank's device
    (``rank_device()`` by default)."""
    world_size = dist.get_world_size() if dist.is_initialized() else 1
    if mesh_shape is None:
        mesh_shape = {DATA_AXIS: world_size, MODEL_AXIS: 1}
    mesh_shape = {str(k): int(v) for k, v in mesh_shape.items()}
    n = int(np.prod(list(mesh_shape.values())))
    if n != world_size:
        raise ValueError(f"Mesh shape {mesh_shape} needs {n} devices, have {world_size}")
    if device is None:
        device = rank_device("cuda" if torch.cuda.is_available() else "cpu")
    if not dist.is_initialized():
        return Mesh(mesh_shape, device)
    rank = dist.get_rank()
    world = dist.group.WORLD
    shape = tuple(mesh_shape.values())
    ranks = np.arange(n).reshape(shape)
    groups = {}
    for ax, name in enumerate(mesh_shape):
        size = shape[ax]
        lines = np.moveaxis(ranks, ax, -1).reshape(-1, size)
        for line in lines:  # every rank makes every group, in one order
            line = [int(r) for r in line]
            if size == n:
                group = world
            elif size == 1:
                group = None
            else:
                group = dist.new_group(line)
            if rank in line:
                groups[name] = group
    return Mesh(mesh_shape, device, rank, groups, world)


def mesh_from_config(cfg, device=None) -> Mesh:
    """``make_mesh(cfg.parallel.mesh_shape)``."""
    shape = cfg.parallel.mesh_shape
    if shape is not None:
        shape = {str(k): int(v) for k, v in shape.items()}
    return make_mesh(shape, device)


def shard_batch(mesh: Mesh, batch: Dict):
    """This rank's rows of every entry of a global batch dict (tensors or
    arrays whose first dimension is the global batch; None kept), split
    evenly over ``data``: the batch-axis sharding."""
    n, i = mesh.axis_size(DATA_AXIS), mesh.axis_index(DATA_AXIS)
    out = {}
    for k, v in batch.items():
        if v is not None and v.shape[0] % n:
            raise ValueError(f"batch of {v.shape[0]} rows does not split over {n} "
                             f"'{DATA_AXIS}' ranks")
        out[k] = None if v is None else v[i * (v.shape[0] // n):(i + 1) * (v.shape[0] // n)]
    return out


def replicate(mesh: Mesh, tensors: Sequence[torch.Tensor]) -> Sequence[torch.Tensor]:
    """Every tensor overwritten with global rank 0's, in place, over the whole
    mesh. Their version counters are advanced, so that a K1 weight pack made
    from one before goes stale (``fused_conv_gn.stale_packs``)."""
    tensors = list(tensors)
    with torch.no_grad():
        for t in tensors:
            C.broadcast_(t.data if isinstance(t, torch.nn.Parameter) else t, 0, mesh.world)
    if tensors:
        torch.autograd.graph.increment_version(tensors)
    return tensors

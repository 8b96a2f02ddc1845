"""The collectives of the parallel layer, one route each by the group's backend.

JAX leaves every collective to XLA (GSPMD inserts the all-reduces and
all-gathers; ``lax.ppermute`` moves the ring's blocks over ICI). Here they are
explicit ``torch.distributed`` calls on a process group, and each helper
takes one of three routes, chosen from the group and the tensor alone and
never by catching an error:

- ``local``: no group, or a group of one rank with no backend to exercise
  (an axis of size 1 inside a larger mesh): the identity;
- ``nccl``: the tensor as it is, on the card, through NCCL (capturable in a
  CUDA graph once the group's communicator exists: ``warm``);
- ``gloo``: a CPU tensor through gloo;
- ``gloo-host-staged``: a CUDA tensor under gloo, copied into pinned host
  memory, reduced / gathered / exchanged there, and copied back. This is a
  transport: the arithmetic around it stays on the card. It is how two
  ranks share one card (NCCL refuses two ranks on one device) and cannot be
  captured.

``route(group, tensor)`` names the route a call takes; every helper follows
it. The autograd functions at the end carry the collectives that sit inside
a differentiated computation: the global-batch BatchNorm's sum, the
tensor-parallel weight all-gather and the ring's token split and gather.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch
import torch.distributed as dist

LOCAL, NCCL, GLOO, GLOO_STAGED = "local", "nccl", "gloo", "gloo-host-staged"


def group_size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def group_rank(group) -> int:
    return 0 if group is None else dist.get_rank(group)


def backend(group) -> Optional[str]:
    return None if group is None else str(dist.get_backend(group))


def route(group, tensor: Optional[torch.Tensor] = None) -> str:
    """The route a collective on ``group`` takes for ``tensor`` (see the
    module's notes)."""
    name = backend(group)
    if name is None:
        return LOCAL
    if name == "nccl":
        return NCCL
    if tensor is not None and tensor.is_cuda:
        return GLOO_STAGED
    return GLOO


def _host(t: torch.Tensor) -> torch.Tensor:
    """A pinned host copy of the CUDA tensor ``t``."""
    out = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    out.copy_(t)
    return out


def all_reduce_(t: torch.Tensor, group, op: str = "sum") -> torch.Tensor:
    """``t`` summed (``op='sum'``) or averaged (``'mean'``) over ``group``, in
    place; returns ``t``."""
    r = route(group, t)
    if r == LOCAL:
        return t
    if r == GLOO_STAGED:
        staged = _host(t)
        dist.all_reduce(staged, group=group)
        t.copy_(staged)
    else:
        dist.all_reduce(t, group=group)
    if op == "mean":
        t.div_(group_size(group))
    elif op != "sum":
        raise ValueError(f"unknown reduction {op!r}")
    return t


def broadcast_(t: torch.Tensor, src: int, group) -> torch.Tensor:
    """``t`` overwritten with global rank ``src``'s values, in place."""
    r = route(group, t)
    if r == LOCAL:
        return t
    if r == GLOO_STAGED:
        staged = _host(t)
        dist.broadcast(staged, src, group=group)
        t.copy_(staged)
    else:
        dist.broadcast(t, src, group=group)
    return t


def all_gather(t: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """Every rank's ``t`` concatenated along ``dim`` in the group's rank order."""
    r = route(group, t)
    if r == LOCAL:
        return t
    n = group_size(group)
    x = t.detach().movedim(dim, 0).contiguous()
    if r == NCCL:
        out = torch.empty((n * x.shape[0], *x.shape[1:]), dtype=x.dtype, device=x.device)
        dist.all_gather_into_tensor(out, x, group=group)
        return out.movedim(0, dim)
    src = _host(x) if r == GLOO_STAGED else x
    parts = [torch.empty_like(src) for _ in range(n)]
    dist.all_gather(parts, src, group=group)
    return torch.cat(parts, 0).to(t.device).movedim(0, dim)


def reduce_scatter_mean(t: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """The mean of ``t`` over ``group``, cut along ``dim`` into equal parts:
    this rank's part. NCCL reduce-scatters; gloo all-reduces on the host and
    keeps the rank's part (the same numbers)."""
    r = route(group, t)
    if r == LOCAL:
        return t
    n, rank = group_size(group), group_rank(group)
    x = t.detach().movedim(dim, 0).contiguous()
    if x.shape[0] % n:
        raise ValueError(f"reduce_scatter: dim {dim} of size {x.shape[0]} over {n} ranks")
    if r == NCCL:
        out = torch.empty((x.shape[0] // n, *x.shape[1:]), dtype=x.dtype, device=x.device)
        dist.reduce_scatter_tensor(out, x, group=group)
    else:
        staged = _host(x) if r == GLOO_STAGED else x.clone()
        dist.all_reduce(staged, group=group)
        out = staged.chunk(n, 0)[rank].to(t.device)
    return out.div_(n).movedim(0, dim)


def ring_shift(t: torch.Tensor, group) -> torch.Tensor:
    """One hop of a ring: ``t`` sent to the next rank of ``group`` and the
    previous rank's tensor returned. NCCL: one ``batch_isend_irecv`` pair on
    the card; gloo: ``isend`` / ``irecv`` of host tensors (a CUDA tensor
    staged through pinned host memory)."""
    r = route(group, t)
    n = group_size(group)
    if r == LOCAL or n == 1:
        return t
    rank = group_rank(group)
    nxt = dist.get_global_rank(group, (rank + 1) % n)
    prv = dist.get_global_rank(group, (rank - 1) % n)
    x = t.detach().contiguous()
    if r == NCCL:
        out = torch.empty_like(x)
        ops = [dist.P2POp(dist.isend, x, nxt, group), dist.P2POp(dist.irecv, out, prv, group)]
        for work in dist.batch_isend_irecv(ops):
            work.wait()
        return out
    src = _host(x) if r == GLOO_STAGED else x
    out = torch.empty_like(src)
    works = [dist.isend(src, nxt, group=group), dist.irecv(out, prv, group=group)]
    for work in works:
        work.wait()
    return out.to(t.device)


def warm(groups: Sequence) -> None:
    """One small all-reduce on each NCCL group: the communicator exists
    before a CUDA graph captures a collective on it."""
    for group in groups:
        if route(group) == NCCL:
            dev = torch.device("cuda", torch.cuda.current_device())
            all_reduce_(torch.zeros(1, device=dev), group)


# -- autograd: collectives inside a differentiated computation ---------------


class GlobalSum(torch.autograd.Function):
    """``x`` summed over ``group``; its gradient summed over ``group`` too (each
    rank's loss reads the sum, so each rank's input moves every rank's loss).
    The global-batch BatchNorm's statistics."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce_(x.detach().clone(), group)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce_(grad.contiguous().clone(), ctx.group), None


class GatherShard(torch.autograd.Function):
    """A tensor-parallel parameter's full value from every rank's shard along
    ``dim``, written into ``buffer`` (persistent, so the same tensor every
    call: K1's weight packs stay keyed on it, and the in-place write moves its
    version counter, so a pack made before goes stale). Backward: the full
    gradient, which every rank of the group computed on the same rows, back
    to each rank's part by a mean reduce-scatter."""

    @staticmethod
    def forward(ctx, shard, group, dim, buffer):
        ctx.group, ctx.dim = group, dim
        with torch.no_grad():
            buffer.copy_(all_gather(shard, group, dim))
        return buffer.view_as(buffer)

    @staticmethod
    def backward(ctx, grad):
        return reduce_scatter_mean(grad, ctx.group, ctx.dim), None, None, None


class ShardTokens(torch.autograd.Function):
    """A tensor that every rank of ``group`` holds alike, cut along ``dim``:
    this rank's part. Backward: the parts' gradients gathered, so every rank
    gets the whole gradient its replicated producer needs."""

    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        n, rank = group_size(group), group_rank(group)
        return x.chunk(n, dim)[rank].contiguous()

    @staticmethod
    def backward(ctx, grad):
        return all_gather(grad.contiguous(), ctx.group, ctx.dim), None, None


class GatherTokens(torch.autograd.Function):
    """Every rank's part along ``dim`` gathered into the whole, which every
    rank then holds alike. Backward: the rank's part of the (alike) gradient."""

    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return all_gather(x, group, dim)

    @staticmethod
    def backward(ctx, grad):
        n, rank = group_size(ctx.group), group_rank(ctx.group)
        return grad.chunk(n, ctx.dim)[rank].contiguous(), None, None


def flat_all_reduce_mean(tensors: List[torch.Tensor], group) -> None:
    """Each tensor of ``tensors`` averaged over ``group`` in place, as one flat
    bucket (one collective) per dtype."""
    if route(group) == LOCAL:
        return
    by_dtype = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for same in by_dtype.values():
        flat = torch.cat([t.reshape(-1) for t in same])
        all_reduce_(flat, group, "mean")
        at = 0
        for t in same:
            t.copy_(flat[at:at + t.numel()].view_as(t))
            at += t.numel()

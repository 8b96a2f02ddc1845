"""Ring attention: exact self-attention with the token axis split over the
ranks of a mesh axis (counterpart of ``sbgm_danra_tpu/parallel/ring_attention.py``).

Each rank keeps its block of queries and its block of keys and values; the
K/V blocks travel one hop round the ring a step (``collectives.ring_shift``:
NCCL's ``batch_isend_irecv`` to rank + 1 from rank - 1, or gloo's
``isend`` / ``irecv`` through pinned host memory), while an online softmax in
fp32 accumulates the rank's output: O(S/n) memory a rank, exact attention.
The block products are ``torch.matmul``, as JAX's are a plain ``einsum``
outside any Pallas kernel.

The backward (``_Ring``, a ``torch.autograd.Function``) runs the ring again:
the K/V blocks travel with their dK/dV accumulators, each rank adds its
queries' part to both and to its own dQ, and after n hops every dK/dV block
is back at its owner (FlashAttention-2's split, from the forward's
log-sum-exp, no S x S held).

Inside a model the ring is ambient, as in JAX: ``ring_context(mesh, axis)``
around the calls, and ``SpatialSelfAttention(backend='ring')`` calls
``ring_attention_inline``. The context is read at call time (there is no
trace here). The layer's q/k/v are alike on every rank of the axis (JAX pins
them replicated around the ring region); each rank takes its token block
(``ShardTokens``, whose backward gathers the gradient) and the blocks' outputs
are gathered back (``GatherTokens``). Without a context, or where the token
count does not divide the axis, the layer runs dense, with JAX's log lines.
"""

from __future__ import annotations

import contextlib
import logging
import math
from typing import List, Optional, Tuple

import torch

from sbgm_danra_tpu_torch.ops.flash_attention import dense_attention
from sbgm_danra_tpu_torch.parallel import collectives as C
from sbgm_danra_tpu_torch.parallel.mesh import DATA_AXIS, Mesh

logger = logging.getLogger(__name__)

_RING_CONTEXT: List[Tuple[Mesh, str]] = []


@contextlib.contextmanager
def ring_context(mesh: Mesh, axis_name: str = DATA_AXIS):
    """Token-shard ring attention over ``mesh``'s ``axis_name`` ranks for the
    model calls made inside this context."""
    _RING_CONTEXT.append((mesh, axis_name))
    try:
        yield
    finally:
        _RING_CONTEXT.pop()


def current_ring_context() -> Optional[Tuple[Mesh, str]]:
    return _RING_CONTEXT[-1] if _RING_CONTEXT else None


def ring_shards(tokens: int, axis_name: str = DATA_AXIS) -> bool:
    """Whether ``ring_attention_inline`` splits ``tokens`` over a ring now (a
    context whose axis has n > 1 ranks, and n divides the token count)."""
    ctx = current_ring_context()
    if ctx is None:
        return False
    mesh, axis = ctx
    n = mesh.axis_size(axis or axis_name)
    return n > 1 and tokens % n == 0


def _block(qt, k_blk, v_blk, scale):
    """Scores of the rank's queries (fp32, [B, H, Sq, D]) against one K/V block."""
    kt = k_blk.transpose(1, 2).float()
    vt = v_blk.transpose(1, 2).float()
    return torch.matmul(qt, kt.transpose(-1, -2)) * scale, kt, vt


def _forward(q, k, v, group):
    """The rank's output block [B, Sq, H, D] and log-sum-exp [B, H, Sq, 1]."""
    n = C.group_size(group)
    b, s, h, d = q.shape
    scale = 1.0 / math.sqrt(d)
    qt = q.transpose(1, 2).float()
    m = torch.full((b, h, s, 1), -1e30, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, h, s, 1), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, h, s, d), dtype=torch.float32, device=q.device)
    kv = torch.stack([k, v])
    for step in range(n):
        scores, _, vt = _block(qt, kv[0], kv[1], scale)
        m_new = torch.maximum(m, scores.amax(dim=-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.exp(scores - m_new)
        l = l * alpha + p.sum(dim=-1, keepdim=True)
        acc = acc * alpha + torch.matmul(p, vt)
        m = m_new
        if step + 1 < n:
            kv = C.ring_shift(kv, group)  # rotate the K/V block one hop
    l = torch.clamp(l, min=1e-30)
    out = (acc / l).transpose(1, 2).to(q.dtype)
    return out, m + torch.log(l)


class _Ring(torch.autograd.Function):
    """Ring attention over the token blocks of ``group``'s ranks."""

    @staticmethod
    def forward(ctx, q, k, v, group):
        out, lse = _forward(q, k, v, group)
        ctx.group = group
        ctx.save_for_backward(q, k, v, out, lse)
        return out

    @staticmethod
    def backward(ctx, grad_out):
        q, k, v, out, lse = ctx.saved_tensors
        group = ctx.group
        n = C.group_size(group)
        d = q.shape[-1]
        scale = 1.0 / math.sqrt(d)
        qt = q.transpose(1, 2).float()
        do = grad_out.transpose(1, 2).float()
        delta = (do * out.transpose(1, 2).float()).sum(dim=-1, keepdim=True)
        dq = torch.zeros_like(qt)
        # the travelling block: K, V and their gradient accumulators, in fp32
        blk = torch.stack([k.float(), v.float(), torch.zeros_like(k, dtype=torch.float32),
                           torch.zeros_like(v, dtype=torch.float32)])
        for step in range(n):
            scores, kt, vt = _block(qt, blk[0], blk[1], scale)
            p = torch.exp(scores - lse)
            dp = torch.matmul(do, vt.transpose(-1, -2))
            ds = p * (dp - delta)
            dq += torch.matmul(ds, kt) * scale
            blk[2] += (torch.matmul(ds.transpose(-1, -2), qt) * scale).transpose(1, 2)
            blk[3] += torch.matmul(p.transpose(-1, -2), do).transpose(1, 2)
            blk = C.ring_shift(blk, group)  # n hops: every block back at its owner
        return (dq.transpose(1, 2).to(q.dtype), blk[2].to(k.dtype), blk[3].to(v.dtype),
                None)


def ring_attention_inline(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          axis_name: str = DATA_AXIS) -> torch.Tensor:
    """Ring attention for use inside a model: reads the ambient
    ``ring_context``; without one (or when the token count does not divide
    the axis) the exact dense path, so ``backend='ring'`` models run
    everywhere. q/k/v: [B, S, H, D], alike on the axis' ranks; returns
    [B, S, H, D], alike on them."""
    ctx = current_ring_context()
    s = q.shape[1]
    if ctx is None:
        logger.info("ring attention: no ring_context at trace time (tokens=%d); "
                    "this layer traces DENSE", s)
        return dense_attention(q, k, v)
    mesh, axis = ctx
    axis = axis or axis_name
    n = mesh.axis_size(axis)
    if n == 1 or s % n != 0:
        if n > 1:
            logger.warning("ring attention: token count %d not divisible by mesh axis "
                           "%r=%d; this layer runs dense", s, axis, n)
        return dense_attention(q, k, v)
    group = mesh.group(axis)
    parts = [C.ShardTokens.apply(t, group, 1) for t in (q, k, v)]
    return C.GatherTokens.apply(_Ring.apply(*parts, group), group, 1)


def shard_tokens(x: torch.Tensor, mesh: Mesh, axis_name: str = DATA_AXIS) -> torch.Tensor:
    """This rank's token block of a [B, S, H, D] tensor held alike on every
    rank; S must divide the axis (``ValueError``, as JAX's check)."""
    n, i = mesh.axis_size(axis_name), mesh.axis_index(axis_name)
    if x.shape[1] % n != 0:
        raise ValueError(f"token count {x.shape[1]} not divisible by mesh axis {axis_name}={n}")
    return x.chunk(n, 1)[i]


def ring_self_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mesh: Mesh,
                        axis_name: str = DATA_AXIS) -> torch.Tensor:
    """Exact attention over [B, S, H, D] with S split over ``axis_name``.

    q, k and v are alike on every rank of the axis; S must divide the axis
    (``ValueError``). Each rank takes its token block (JAX's token-sharded
    placement) and gets its block of the output back: [B, S / n, H, D]."""
    blocks = [shard_tokens(t, mesh, axis_name) for t in (q, k, v)]
    return _Ring.apply(*blocks, mesh.group(axis_name))


def ring_stats(model: torch.nn.Module) -> dict:
    """Per attention layer with backend 'ring': its calls that ran ring-sharded
    and dense, and the token count of its last call, by module name."""
    out = {}
    for name, module in model.named_modules():
        if getattr(module, "backend", None) == "ring" and hasattr(module, "ring_calls"):
            out[name] = {"ring": module.ring_calls, "dense": module.dense_calls,
                         "tokens": module.last_tokens}
    return out


def reset_ring_stats(model: torch.nn.Module) -> None:
    for module in model.modules():
        if hasattr(module, "ring_calls"):
            module.ring_calls = module.dense_calls = 0
            module.last_tokens = None

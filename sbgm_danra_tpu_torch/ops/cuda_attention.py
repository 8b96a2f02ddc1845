"""Hand-written CUDA flash attention (forward and backward) for Hopper, and its plain versions.

Counterpart of ``sbgm_danra_tpu/ops/pallas_attention.py`` (the Pallas TPU
kernel ``pallas_flash_attention`` and its custom VJP). The kernel source is
``sbgm_danra_tpu_torch/csrc/flash_attention.cu``; its comments give the
design and what bounds it on the card. ``ops/_nvcc.py`` compiles it with
``nvcc`` for ``sm_90a`` into a shared library with plain C entry points, at
first use, and loads it with ``ctypes``.

- ``flash_attention_cuda``: the kernel's entry point, differentiable. CUDA
  tensors only; it raises on anything else, and raises if the build or a
  launch fails. A bfloat16 call runs the bf16 tensor-core variant
  (``tc_bf16``), a float32 call the 3xTF32 tensor-core variant (``fp32``),
  which keeps fp32's accuracy. When autograd needs the gradient the forward
  also writes each row's log-sum-exp, and the backward launches the three
  backward kernels on the saved q, k, v, output and log-sum-exp: delta
  (rowwise dO.O), then dk/dv and dq on the tensor cores in the call's dtype
  (bf16 mma.sync, or 3xTF32 mma.sync in fp32): the same gradients as the JAX
  VJP's dense recomputation, without the S x S matrices, and bit-identical
  from call to call.
- ``kernel_layout``: the wrapper's checks as a pure function of shapes,
  strides, dtypes and addresses: the variant, the head dim the kernel is built
  for and the strides it is handed, or an error.
- ``flash_attention_reference``: dense softmax(q k^T / sqrt(D)) v in fp32, the
  plain version the CPU tests and the card comparison use;
  ``attention_lse`` the plain log-sum-exp and ``flash_attention_bwd_reference``
  the plain backward (dense, fp32), which the CPU tests hold against
  ``jax.grad`` of the Pallas kernel and the card holds the kernels against.
- Each forward launch is counted in ``ops/launches.py`` as
  ``flash_attention_fwd_<variant>``, each backward call (the three backward
  kernels of its dtype's variant) as ``flash_attention_bwd_<variant>``.

q, k and v may be strided views, as the chunks of a packed QKV projection
are: the kernels take each one's batch and row strides. They need a unit
stride on D and the heads of a row packed (head stride D); rows must be
16-byte aligned, since the forward copies them 16 bytes at a time. A head dim
that is padded up to a supported one is copied anyway, so any layout is taken
there. The output and the gradients are fresh contiguous [B, S, H, D].
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from sbgm_danra_tpu_torch.ops import _nvcc, launches

SOURCE = _nvcc.CSRC_DIR / "flash_attention.cu"
HEAD_DIMS = (32, 64, 128)
VARIANTS = {torch.bfloat16: "tc_bf16", torch.float32: "fp32"}
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_GRID_Y = 65535  # batch * heads is the grid's y dimension


class KernelLayout(NamedTuple):
    """What the kernel is handed for one call."""

    variant: str       # "tc_bf16" or "fp32"
    head_dim: int      # D of the kernel's instantiation (the input's, padded)
    padded: bool       # True: q, k, v are copied zero-padded to head_dim
    strides: tuple     # ((batch, row) element strides of q, k and v as the kernel reads them)


@functools.lru_cache(maxsize=1)
def build_library() -> _nvcc.BuiltLibrary:
    """Compile (once per source and flags) and load the kernel's library."""
    built = _nvcc.build(SOURCE, "sbgm_flash_attention")
    built.lib.sbgm_flash_attention_fwd.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        *[ctypes.c_longlong] * 6,
        *[ctypes.c_int] * 5, ctypes.c_float, ctypes.c_void_p, ctypes.c_void_p,
    ]
    built.lib.sbgm_flash_attention_fwd.restype = ctypes.c_int
    built.lib.sbgm_flash_attention_bwd.argtypes = [
        *[ctypes.c_void_p] * 10, *[ctypes.c_longlong] * 6,
        *[ctypes.c_int] * 5, ctypes.c_float, ctypes.c_void_p,
    ]
    built.lib.sbgm_flash_attention_bwd.restype = ctypes.c_int
    return built


def _padded_head_dim(d: int) -> int:
    for cand in HEAD_DIMS:
        if d <= cand:
            return cand
    raise ValueError(f"head_dim {d} > {HEAD_DIMS[-1]} is not supported by the CUDA kernel")


def kernel_layout(shapes, strides, dtypes, addresses) -> KernelLayout:
    """Check one call's q, k, v (one entry each in every argument: shape,
    element strides, dtype, byte address) and return what the kernel gets."""
    shape = tuple(shapes[0])
    if any(len(s) != 4 or tuple(s) != shape for s in shapes) or len(set(dtypes)) != 1:
        raise ValueError(
            f"q, k, v must share one [B, S, H, D] shape, dtype and device; got shapes "
            f"{[tuple(s) for s in shapes]} and dtypes {list(dtypes)}"
        )
    dtype = dtypes[0]
    if dtype not in VARIANTS:
        raise TypeError(f"dtype {dtype} not supported (float32 or bfloat16)")
    b, s, h, d = shape
    if b * h > _MAX_GRID_Y:
        raise ValueError(f"batch*heads = {b * h} exceeds the kernel grid limit {_MAX_GRID_Y}")
    dp = _padded_head_dim(d)
    if dp != d:  # the padded copies are contiguous
        return KernelLayout(VARIANTS[dtype], dp, True, ((s * h * dp, h * dp),) * 3)
    item = 2 if dtype == torch.bfloat16 else 4
    for name, st, addr in zip("qkv", strides, addresses):
        if d > 1 and st[3] != 1:
            raise ValueError(f"{name}: the kernel needs a unit stride on D; got strides {st}")
        if h > 1 and st[2] != d:
            raise ValueError(f"{name}: the kernel needs head stride == D = {d}; got strides {st}")
        if addr % 16 or (b > 1 and st[0] * item % 16) or (s > 1 and st[1] * item % 16):
            raise ValueError(
                f"{name}: rows must be 16-byte aligned (address {addr}, strides {st})"
            )
    return KernelLayout(VARIANTS[dtype], d, False, tuple((st[0], st[1]) for st in strides))


def _checked_layout(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> KernelLayout:
    for name, x in (("q", q), ("k", k), ("v", v)):
        if not isinstance(x, torch.Tensor) or x.device.type != "cuda":
            where = x.device if isinstance(x, torch.Tensor) else type(x).__name__
            raise ValueError(
                f"flash_attention_cuda launches a CUDA kernel and needs CUDA tensors; "
                f"{name} is on {where} (use flash_attention_reference off the card)"
            )
        if x.device != q.device:
            raise ValueError(f"q, k, v must share one [B, S, H, D] shape, dtype and device; "
                             f"{name} is on {x.device}, q on {q.device}")
    return kernel_layout(*zip(*((x.shape, x.stride(), x.dtype, x.data_ptr())
                                for x in (q, k, v))))


def _pad_d(tensors, dp: int):
    """Zero columns change no score and give zero output and gradient columns."""
    return [F.pad(x, (0, dp - x.shape[-1])) for x in tensors]


def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, with_lse: bool = False):
    """The forward kernel: (output, lse [B, H, S] fp32 or None)."""
    layout = _checked_layout(q, k, v)
    b, s, h, d = q.shape
    dp = layout.head_dim
    if layout.padded:
        q, k, v = _pad_d((q, k, v), dp)
    out = torch.empty((b, s, h, dp), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, s), dtype=torch.float32, device=q.device) if with_lse else None
    built = build_library()
    with torch.cuda.device(q.device):
        rc = built.lib.sbgm_flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            *(st for pair in layout.strides for st in pair),
            b, s, h, dp, _DTYPE_CODES[q.dtype], ctypes.c_float(1.0 / math.sqrt(d)),
            None if lse is None else lse.data_ptr(),
            ctypes.c_void_p(torch.cuda.current_stream().cuda_stream),
        )
        _nvcc.check_launch(built, rc, "flash attention")
        launches.count(f"flash_attention_fwd_{layout.variant}")
    return (out[..., :d].contiguous() if layout.padded else out), lse


def _launch_bwd(q, k, v, out, dout, lse):
    """The backward kernels: (dq, dk, dv), contiguous [B, S, H, D] in q's dtype."""
    layout = _checked_layout(q, k, v)
    b, s, h, d = q.shape
    for name, x, dtype in (("out", out, q.dtype), ("dout", dout, q.dtype),
                           ("lse", lse, torch.float32)):
        want = (b, h, s) if name == "lse" else (b, s, h, d)
        if (x.device != q.device or x.dtype != dtype or tuple(x.shape) != want
                or not x.is_contiguous()):
            raise ValueError(f"flash attention backward: {name} must be a contiguous {dtype} "
                             f"{list(want)} on {q.device}; got {x.dtype} {list(x.shape)} on "
                             f"{x.device}")
    dp = layout.head_dim
    if layout.padded:
        q, k, v, out, dout = _pad_d((q, k, v, out, dout), dp)
    grads = torch.empty((3, b, s, h, dp), dtype=q.dtype, device=q.device)
    delta = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    built = build_library()
    with torch.cuda.device(q.device):
        rc = built.lib.sbgm_flash_attention_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), dout.data_ptr(),
            lse.data_ptr(), grads[0].data_ptr(), grads[1].data_ptr(), grads[2].data_ptr(),
            delta.data_ptr(), *(st for pair in layout.strides for st in pair),
            b, s, h, dp, _DTYPE_CODES[q.dtype], ctypes.c_float(1.0 / math.sqrt(d)),
            ctypes.c_void_p(torch.cuda.current_stream().cuda_stream),
        )
        _nvcc.check_launch(built, rc, "flash attention backward")
        launches.count(f"flash_attention_bwd_{layout.variant}")
    if layout.padded:
        return tuple(g[..., :d].contiguous() for g in grads)
    return tuple(grads)


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v):
        need_grad = any(ctx.needs_input_grad)
        out, lse = _launch(q, k, v, with_lse=need_grad)
        if need_grad:
            ctx.save_for_backward(q, k, v, out, lse)
        return out

    @staticmethod
    def backward(ctx, grad):
        q, k, v, out, lse = ctx.saved_tensors
        return _launch_bwd(q, k, v, out, grad.contiguous(), lse)


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """softmax(q k^T / sqrt(D)) v on the card for q/k/v [B, S, H, D] (see kernel_layout)."""
    return _FlashAttention.apply(q, k, v)


def flash_attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Dense softmax(q k^T / sqrt(D)) v computed in fp32; returns q's dtype."""
    d = q.shape[-1]
    qf, kf, vf = q.float(), k.float(), v.float()
    scores = torch.einsum("bqhd,bkhd->bhqk", qf * (1.0 / math.sqrt(d)), kf)
    probs = torch.softmax(scores, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", probs, vf).to(q.dtype)


def attention_lse(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """Each row's log-sum-exp log sum_k exp(q.k / sqrt(D)), [B, H, S] fp32:
    the plain version of the forward kernel's lse output."""
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float() * (1.0 / math.sqrt(q.shape[-1])),
                          k.float())
    return torch.logsumexp(scores, dim=-1)


def flash_attention_bwd_reference(q, k, v, out, dout, lse):
    """The plain backward: dense, in fp32, from the saved q, k, v, output and
    lse (as the kernels take them); returns (dq, dk, dv) in q's dtype.

    P = exp(q k^T scale - lse), dV = P^T dO, dP = dO V^T, D = rowsum(dO O),
    dS = P (dP - D), dQ = dS K scale, dK = dS^T Q scale."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    qf, kf, vf, of, gf = (x.float() for x in (q, k, v, out, dout))
    p = torch.exp(torch.einsum("bqhd,bkhd->bhqk", qf * scale, kf) - lse.float()[..., None])
    dv = torch.einsum("bhqk,bqhd->bkhd", p, gf)
    dp = torch.einsum("bqhd,bkhd->bhqk", gf, vf)
    delta = (gf * of).sum(-1).permute(0, 2, 1)[..., None]  # [B, H, S, 1]
    ds = p * (dp - delta)
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kf) * scale
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, qf) * scale
    return dq.to(q.dtype), dk.to(q.dtype), dv.to(q.dtype)

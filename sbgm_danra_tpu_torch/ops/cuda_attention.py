"""Hand-written CUDA flash attention (forward) for Hopper, and its plain version.

Counterpart of ``sbgm_danra_tpu/ops/pallas_attention.py`` (the Pallas TPU
kernel ``pallas_flash_attention``). The kernel source is
``sbgm_danra_tpu_torch/csrc/flash_attention.cu``; its header comment gives the
design and what bounds it on the card. ``ops/_nvcc.py`` compiles it with
``nvcc`` for ``sm_90a`` into a shared library with a plain C entry point, at
first use, and loads it with ``ctypes``.

- ``flash_attention_cuda``: the kernel's entry point. CUDA tensors only; it
  raises on anything else, and raises if the build or the launch fails.
- ``flash_attention_reference``: dense softmax(q k^T / sqrt(D)) v in fp32, the
  plain version the CPU tests and the card comparison use.
- ``launches``: how many times the kernel was launched in this process.

Gradient: not yet. The JAX kernel's VJP recomputes dense attention
(pallas_attention.py:143-146); the port's backward lands with training, and
until then a backward through the kernel raises.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch
import torch.nn.functional as F

from sbgm_danra_tpu_torch.ops import _nvcc

SOURCE = _nvcc.CSRC_DIR / "flash_attention.cu"
HEAD_DIMS = (32, 64, 128)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

launches = 0


@functools.lru_cache(maxsize=1)
def build_library() -> _nvcc.BuiltLibrary:
    """Compile (once per source and flags) and load the kernel's library."""
    built = _nvcc.build(SOURCE, "sbgm_flash_attention")
    built.lib.sbgm_flash_attention_fwd.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_float, ctypes.c_void_p,
    ]
    built.lib.sbgm_flash_attention_fwd.restype = ctypes.c_int
    return built


def _padded_head_dim(d: int) -> int:
    for cand in HEAD_DIMS:
        if d <= cand:
            return cand
    raise ValueError(f"head_dim {d} > {HEAD_DIMS[-1]} is not supported by the CUDA kernel")


def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    global launches
    for name, x in (("q", q), ("k", k), ("v", v)):
        if not isinstance(x, torch.Tensor) or x.device.type != "cuda":
            where = x.device if isinstance(x, torch.Tensor) else type(x).__name__
            raise ValueError(
                f"flash_attention_cuda launches a CUDA kernel and needs CUDA tensors; "
                f"{name} is on {where} (use flash_attention_reference off the card)"
            )
        if x.dtype not in _DTYPE_CODES:
            raise TypeError(f"{name}: dtype {x.dtype} not supported (float32 or bfloat16)")
        if x.dim() != 4 or x.shape != q.shape or x.dtype != q.dtype or x.device != q.device:
            raise ValueError(
                f"q, k, v must share one [B, S, H, D] shape, dtype and device; "
                f"got {tuple(q.shape)}/{q.dtype}/{q.device} and "
                f"{tuple(x.shape)}/{x.dtype}/{x.device} for {name}"
            )
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    b, s, h, d = q.shape
    if b * h > 65535:
        raise ValueError(f"batch*heads = {b * h} exceeds the kernel grid limit 65535")
    dp = _padded_head_dim(d)
    if dp != d:
        # zero columns change no score and give zero output columns
        q, k, v = (F.pad(x, (0, dp - d)) for x in (q, k, v))
    out = torch.empty_like(q)
    built = build_library()
    with torch.cuda.device(q.device):
        rc = built.lib.sbgm_flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            b, s, h, dp, _DTYPE_CODES[q.dtype], ctypes.c_float(1.0 / math.sqrt(d)),
            ctypes.c_void_p(torch.cuda.current_stream().cuda_stream),
        )
    _nvcc.check_launch(built, rc, "flash attention")
    launches += 1
    return out[..., :d] if dp != d else out


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v):
        return _launch(q, k, v)

    @staticmethod
    def backward(ctx, grad):
        raise NotImplementedError(
            "the CUDA flash-attention kernel has no backward yet; it lands with the "
            "training port (ROADMAP queue 2, K2 backward)"
        )


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """softmax(q k^T / sqrt(D)) v on the card for contiguous q/k/v [B, S, H, D]."""
    return _FlashAttention.apply(q, k, v)


def flash_attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Dense softmax(q k^T / sqrt(D)) v computed in fp32; returns q's dtype."""
    d = q.shape[-1]
    qf, kf, vf = q.float(), k.float(), v.float()
    scores = torch.einsum("bqhd,bkhd->bhqk", qf * (1.0 / math.sqrt(d)), kf)
    probs = torch.softmax(scores, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", probs, vf).to(q.dtype)

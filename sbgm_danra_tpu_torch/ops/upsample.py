"""Exact 2x bilinear upsampling (counterpart of ``sbgm_danra_tpu/ops/upsample.py``).

The JAX op is a depthwise conv with the taps [1/4, 3/4, 3/4, 1/4] on the
2x-dilated, edge-replicated input:

    out[2i]   = 1/4 x[i-1] + 3/4 x[i]
    out[2i+1] = 3/4 x[i]   + 1/4 x[i+1]      (edges clamped)

Here the same taps are applied along H, then W, in fp32, with one rounding to
the input dtype at the end, as the conv accumulates in fp32. This equals
``F.interpolate(x, scale_factor=2, mode='bilinear', align_corners=False)``,
whose half-pixel source index clamps at the borders exactly like the edge
replication, up to fp32 rounding (it sums in another order).

- ``upsample2x``: the dispatcher. A tensor on the CPU takes
  ``upsample2x_bilinear``; a CUDA tensor launches the kernel or raises.
- ``upsample2x_bilinear``: the plain PyTorch version (twenty fp32 kernels a
  call on the card), used on the CPU, in training (it is differentiable) and
  held against the kernel on the card.
- ``upsample2x_cuda``: the kernel, ``sbgm_danra_tpu_torch/csrc/upsample2x.cu``
  (one pass; its header gives the design), built by ``ops/_nvcc.py`` at first
  use. It rounds every product and sum as ``upsample2x_bilinear`` does, so the
  two agree bit for bit in bf16 and fp32. It takes any NHWC shape with H, W,
  C >= 1 (a non-contiguous x is copied first) up to 2^30 of the kernel's
  accesses of x (16-byte vectors; single channels where C or x is off 16
  bytes), beyond which the launch raises; it has no backward.
- Each launch is counted in ``ops/launches.py`` as ``upsample2x``.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from sbgm_danra_tpu_torch.ops import _nvcc, launches

SOURCE = _nvcc.CSRC_DIR / "upsample2x.cu"
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def _upsample_axis(x: torch.Tensor, axis: int) -> torch.Tensor:
    n = x.shape[axis]
    lo = torch.cat([x.narrow(axis, 0, 1), x.narrow(axis, 0, n - 1)], dim=axis)  # x[i-1]
    hi = torch.cat([x.narrow(axis, 1, n - 1), x.narrow(axis, n - 1, 1)], dim=axis)  # x[i+1]
    even = 0.25 * lo + 0.75 * x
    odd = 0.75 * x + 0.25 * hi
    out = torch.stack([even, odd], dim=axis + 1)
    shape = list(x.shape)
    shape[axis] = 2 * n
    return out.reshape(shape)


def upsample2x_bilinear(x: torch.Tensor) -> torch.Tensor:
    """NHWC -> N(2H)(2W)C, equal to the JAX package's ``upsample2x_bilinear``."""
    y = _upsample_axis(_upsample_axis(x.float(), 1), 2)
    return y.to(x.dtype)


@functools.lru_cache(maxsize=1)
def build_library() -> _nvcc.BuiltLibrary:
    """Compile (once per source and flags) and load the kernel's library."""
    built = _nvcc.build(SOURCE, "sbgm_upsample2x")
    p, i = ctypes.c_void_p, ctypes.c_int
    built.lib.sbgm_upsample2x.argtypes = [p, p, i, i, i, i, i, p]
    built.lib.sbgm_upsample2x.restype = i
    return built


def _launch(x: torch.Tensor) -> torch.Tensor:
    if not isinstance(x, torch.Tensor) or x.device.type != "cuda":
        where = x.device if isinstance(x, torch.Tensor) else type(x).__name__
        raise ValueError(f"upsample2x_cuda launches a CUDA kernel and needs a CUDA tensor; x is "
                         f"on {where} (use upsample2x_bilinear off the card)")
    if x.dim() != 4 or min(x.shape) < 1:
        raise ValueError(f"x must be [N, H, W, C] with every size >= 1, got {tuple(x.shape)}")
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"x: dtype {x.dtype} not supported (float32 or bfloat16)")
    x = x.contiguous()
    n, h, w, c = x.shape
    out = torch.empty((n, 2 * h, 2 * w, c), dtype=x.dtype, device=x.device)
    built = build_library()
    with torch.cuda.device(x.device):
        rc = built.lib.sbgm_upsample2x(x.data_ptr(), out.data_ptr(), n, h, w, c,
                                       _DTYPE_CODES[x.dtype],
                                       torch._C._cuda_getCurrentRawStream(x.device.index))
        _nvcc.check_launch(built, rc, "upsample2x")
        launches.count("upsample2x")
    return out


class _Upsample2x(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return _launch(x)

    @staticmethod
    def backward(ctx, grad):
        raise NotImplementedError(
            "the CUDA upsample kernel has no backward; training takes upsample2x_bilinear")


def upsample2x_cuda(x: torch.Tensor) -> torch.Tensor:
    """The kernel's entry point: a CUDA NHWC x -> [N, 2H, 2W, C] in x's dtype."""
    return _Upsample2x.apply(x)


def upsample2x(x: torch.Tensor) -> torch.Tensor:
    """2x bilinear upsample of NHWC ``x``: the plain version on the CPU, the
    kernel on the card."""
    if x.device.type == "cpu":
        return upsample2x_bilinear(x)
    return upsample2x_cuda(x)

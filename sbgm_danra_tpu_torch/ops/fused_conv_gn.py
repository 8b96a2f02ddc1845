"""Fused conv3x3 + GroupNorm (+ReLU) on Hopper, and its plain version.

Counterpart of ``sbgm_danra_tpu/ops/fused_conv_gn.py`` (the Pallas TPU kernel
``conv3x3_gn_relu``). The kernel source is
``sbgm_danra_tpu_torch/csrc/conv3x3_gn.cu``, whose header gives the design and
what bounds it on the card: ``conv3x3_stats`` (implicit-GEMM conv with the
GroupNorm partial statistics in its epilogue) and ``gn_apply`` (normalise,
affine, optional ReLU). ``ops/_nvcc.py`` builds it at first use.

What the function computes, in the JAX package's NHWC / HWIO layout: the
SAME 3x3 stride-1 conv of ``x`` with ``kernel`` and ``bias`` (both taken in
x's dtype, as a Flax conv casts its parameters to its compute dtype) with
fp32 accumulation; per-(sample, group) mean and one-pass variance
E[v^2] - mean^2 (clamped at 0) of the fp32 conv output before it is rounded;
then ``(conv - mean) * rsqrt(var + eps) * gamma + beta`` on the conv output
rounded to x's dtype, an optional ReLU, and the result in x's dtype.

- ``conv3x3_gn_relu``: the dispatcher. A tensor on the CPU takes
  ``reference_chain``; a CUDA tensor launches the kernels or raises.
- ``reference_chain``: the plain PyTorch version, used by the CPU tests and
  held against the kernels on the card by ``chip_smoke.py``.
- ``conv3x3_stats`` / ``gn_apply``: each kernel's own entry point, and
  ``plain_conv3x3_stats`` / ``plain_gn_apply`` their plain versions, which
  ``chip_smoke.py`` holds them against one by one.
- ``conv3x3_stats_launches`` / ``gn_apply_launches``: how many times each
  kernel was launched in this process.

Gradient: none. The JAX kernel has no VJP either; the training port decides
how the decoder's chains run under autograd, and until then a backward
through the kernels raises.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional

import torch
import torch.nn.functional as F

from sbgm_danra_tpu_torch.ops import _nvcc

SOURCE = _nvcc.CSRC_DIR / "conv3x3_gn.cu"
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_TILE = 8  # the kernel's spatial tile is 8 x 8 output pixels
_BN = 64  # and its Cout tile 64 channels
_TARGET_BLOCKS = 4 * 132  # conv blocks to aim for: four per SM of an H100
_MAX_CHANNELS = 227 * 1024 // 16  # gn_apply keeps 16 bytes per channel in shared memory

conv3x3_stats_launches = 0
gn_apply_launches = 0


@functools.lru_cache(maxsize=1)
def build_library() -> _nvcc.BuiltLibrary:
    """Compile (once per source and flags) and load the kernels' library."""
    built = _nvcc.build(SOURCE, "sbgm_conv3x3_gn")
    p, i = ctypes.c_void_p, ctypes.c_int
    built.lib.sbgm_conv3x3_stats.argtypes = [p, p, p, p, p, p, p, i, i, i, i, i, i, i, i, p]
    built.lib.sbgm_conv3x3_stats.restype = i
    built.lib.sbgm_gn_apply.argtypes = [p, p, p, p, p, i, ctypes.c_longlong, i, i,
                                        ctypes.c_float, i, i, p]
    built.lib.sbgm_gn_apply.restype = i
    return built


def _check_args(x, kernel, bias, groups, gamma=None, beta=None):
    if x.dim() != 4:
        raise ValueError(f"x must be [N, H, W, Cin], got shape {tuple(x.shape)}")
    cin = x.shape[-1]
    if kernel.shape[:3] != (3, 3, cin):
        raise ValueError(f"kernel must be [3, 3, {cin}, Cout] (HWIO), got {tuple(kernel.shape)}")
    cout = kernel.shape[-1]
    for name, v in (("bias", bias), ("gamma", gamma), ("beta", beta)):
        if v is not None and v.shape != (cout,):
            raise ValueError(f"{name} must be [{cout}], got {tuple(v.shape)}")
    if groups < 1 or cout % groups != 0:
        raise ValueError(f"cout {cout} not divisible by groups {groups}")
    return cin, cout


def plain_conv3x3_stats(x: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor,
                        groups: int) -> tuple:
    """``conv3x3_stats``'s plain version: the conv in x's dtype [N, H, W, Cout]
    and per-(sample, group) [sum, sum of squares] of the fp32 conv [N, G, 2]."""
    dt = x.dtype
    conv = F.conv2d(x.float().permute(0, 3, 1, 2),
                    kernel.to(dt).float().permute(3, 2, 0, 1), bias.to(dt).float(), padding=1)
    grouped = conv.reshape(conv.shape[0], groups, -1)
    stats = torch.stack([grouped.sum(-1), (grouped * grouped).sum(-1)], dim=-1)
    return conv.permute(0, 2, 3, 1).to(dt).contiguous(), stats


def plain_gn_apply(conv: torch.Tensor, stats: torch.Tensor, gamma: torch.Tensor,
                   beta: torch.Tensor, groups: int, eps: float = 1e-5, activation: bool = True,
                   out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """``gn_apply``'s plain version: (conv - mean) * rsqrt(var + eps) * gamma +
    beta (+ ReLU) in fp32 from the statistics, in ``out_dtype`` (default the
    conv's dtype)."""
    n, h, w, c = conv.shape
    cpg = c // groups
    count = h * w * cpg
    mean = stats[..., 0] / count
    var = torch.clamp(stats[..., 1] / count - mean * mean, min=0.0)
    inv = torch.rsqrt(var + eps)
    mean_c = mean.repeat_interleave(cpg, dim=1)[:, None, None, :]
    inv_c = inv.repeat_interleave(cpg, dim=1)[:, None, None, :]
    y = (conv.float() - mean_c) * inv_c * gamma.float() + beta.float()
    if activation:
        y = torch.relu(y)
    return y.to(out_dtype or conv.dtype)


def reference_chain(
    x: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor, gamma: torch.Tensor,
    beta: torch.Tensor, groups: int = 8, eps: float = 1e-5, activation: bool = True,
    out_dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """The plain version of ``conv3x3_gn_relu``: same arithmetic, in fp32 PyTorch ops.

    ``out_dtype`` (default x's dtype) is the dtype of the result; float32 keeps
    the last rounding out, which is how the card's bf16 checks compare.
    """
    _check_args(x, kernel, bias, groups, gamma, beta)
    conv, stats = plain_conv3x3_stats(x, kernel, bias, groups)
    return plain_gn_apply(conv, stats, gamma, beta, groups, eps, activation, out_dtype)


def _require_cuda(what: str, **tensors) -> torch.device:
    device = next(iter(tensors.values())).device
    for name, v in tensors.items():
        if not isinstance(v, torch.Tensor) or v.device != device or v.device.type != "cuda":
            where = v.device if isinstance(v, torch.Tensor) else type(v).__name__
            raise ValueError(
                f"{what} launches a CUDA kernel and needs CUDA tensors on one device; "
                f"{name} is on {where} (use reference_chain off the card)"
            )
    return device


def conv3x3_stats(x: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor,
                  groups: int) -> tuple:
    """The conv kernel: x [N, H, W, Cin], HWIO kernel -> (conv [N, H, W, Cout] in
    x's dtype, stats [N, groups, 2] fp32 sum and sum of squares)."""
    global conv3x3_stats_launches
    dev = _require_cuda("conv3x3_stats", x=x, kernel=kernel, bias=bias)
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"x: dtype {x.dtype} not supported (float32 or bfloat16)")
    cin, cout = _check_args(x, kernel, bias, groups)
    x = x.contiguous()
    n, h, w, _ = x.shape
    # [9, Cout, Cin] in x's dtype: one copy that also casts
    wk = torch.empty((9, cout, cin), dtype=x.dtype, device=dev)
    wk.copy_(kernel.permute(0, 1, 3, 2).reshape(9, cout, cin))
    bias_t = bias.to(x.dtype).contiguous()
    tiles = math.ceil(h / _TILE) * math.ceil(w / _TILE)
    slots = min(tiles, max(1, math.ceil(_TARGET_BLOCKS / (n * math.ceil(cout / _BN)))))
    conv = torch.empty((n, h, w, cout), dtype=x.dtype, device=dev)
    partials = torch.empty((n, slots, cout, 2), dtype=torch.float32, device=dev)
    counters = torch.zeros((n,), dtype=torch.int32, device=dev)
    stats = torch.empty((n, groups, 2), dtype=torch.float32, device=dev)
    built = build_library()
    with torch.cuda.device(dev):
        rc = built.lib.sbgm_conv3x3_stats(
            x.data_ptr(), wk.data_ptr(), bias_t.data_ptr(), conv.data_ptr(),
            partials.data_ptr(), counters.data_ptr(), stats.data_ptr(),
            n, h, w, cin, cout, groups, slots, _DTYPE_CODES[x.dtype],
            torch.cuda.current_stream(dev).cuda_stream,
        )
    _nvcc.check_launch(built, rc, "conv3x3_stats")
    conv3x3_stats_launches += 1
    return conv, stats


def gn_apply(conv: torch.Tensor, stats: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
             groups: int, eps: float = 1e-5, activation: bool = True) -> torch.Tensor:
    """The normalise kernel: conv [N, H, W, C] and its stats -> the GroupNorm
    (+ ReLU) of conv in conv's dtype."""
    global gn_apply_launches
    _require_cuda("gn_apply", conv=conv, stats=stats, gamma=gamma, beta=beta)
    n, h, w, c = conv.shape
    if conv.dtype not in _DTYPE_CODES or not conv.is_contiguous():
        raise ValueError(f"conv must be a contiguous float32 or bfloat16 tensor, not {conv.dtype}")
    if stats.shape != (n, groups, 2) or stats.dtype != torch.float32 or c % groups != 0:
        raise ValueError(f"stats must be float32 [{n}, {groups}, 2], got {tuple(stats.shape)}")
    if c > _MAX_CHANNELS:
        raise ValueError(f"{c} channels > {_MAX_CHANNELS} are not supported by gn_apply")
    gamma_f, beta_f = gamma.float().contiguous(), beta.float().contiguous()
    stats = stats.contiguous()
    out = torch.empty_like(conv)
    built = build_library()
    with torch.cuda.device(conv.device):
        rc = built.lib.sbgm_gn_apply(
            conv.data_ptr(), stats.data_ptr(), gamma_f.data_ptr(), beta_f.data_ptr(),
            out.data_ptr(), n, h * w, c, groups, eps, int(activation),
            _DTYPE_CODES[conv.dtype], torch.cuda.current_stream(conv.device).cuda_stream,
        )
    _nvcc.check_launch(built, rc, "gn_apply")
    gn_apply_launches += 1
    return out


class _Conv3x3GN(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, kernel, bias, gamma, beta, groups, eps, activation):
        _require_cuda("conv3x3_gn_cuda", x=x, gamma=gamma, beta=beta)
        _check_args(x, kernel, bias, groups, gamma, beta)
        conv, stats = conv3x3_stats(x, kernel, bias, groups)
        return gn_apply(conv, stats, gamma, beta, groups, eps, activation)

    @staticmethod
    def backward(ctx, *grads):
        raise NotImplementedError(
            "the CUDA conv3x3 + GroupNorm kernels have no backward; the JAX kernel has no "
            "VJP either, and the training port decides how the decoder runs under autograd"
        )


def conv3x3_gn_cuda(x, kernel, bias, gamma, beta, groups: int = 8, eps: float = 1e-5,
                    activation: bool = True) -> torch.Tensor:
    """The kernels' entry point: CUDA tensors only, NHWC x and HWIO kernel."""
    return _Conv3x3GN.apply(x, kernel, bias, gamma, beta, groups, eps, activation)


def conv3x3_gn_relu(x, kernel, bias, gamma, beta, groups: int = 8, eps: float = 1e-5,
                    activation: bool = True) -> torch.Tensor:
    """SAME conv3x3 + GroupNorm + optional ReLU: x [N, H, W, Cin] -> [N, H, W, Cout]."""
    if x.device.type == "cpu":
        return reference_chain(x, kernel, bias, gamma, beta, groups, eps, activation)
    return conv3x3_gn_cuda(x, kernel, bias, gamma, beta, groups, eps, activation)

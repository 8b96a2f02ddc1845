"""Exact 2x bilinear upsampling (counterpart of ``sbgm_danra_tpu/ops/upsample.py``).

The JAX op is a depthwise conv with the taps [1/4, 3/4, 3/4, 1/4] on the
2x-dilated, edge-replicated input:

    out[2i]   = 1/4 x[i-1] + 3/4 x[i]
    out[2i+1] = 3/4 x[i]   + 1/4 x[i+1]      (edges clamped)

Here the same taps are applied along H, then W, in fp32, with one rounding to
the input dtype at the end, as the conv accumulates in fp32. This equals
``F.interpolate(x, scale_factor=2, mode='bilinear', align_corners=False)``,
whose half-pixel source index clamps at the borders exactly like the edge
replication.
"""

from __future__ import annotations

import torch


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

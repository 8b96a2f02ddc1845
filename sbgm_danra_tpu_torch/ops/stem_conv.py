"""The encoder's 8x8 / stride-2 stem conv (counterpart of ``sbgm_danra_tpu/ops/stem_conv.py``).

torch ``Conv2d(k=8, s=2, p=3, bias=False)`` geometry. The JAX package has two
lowerings of this one map ('direct' and the TPU-friendly space-to-depth
's2d'); both compute the same output, so the port has one.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def conv8x8s2(x: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """x [N, C, H, W] (any memory format), weight OIHW [Cout, C, 8, 8]."""
    return F.conv2d(x, weight, stride=2, padding=3)

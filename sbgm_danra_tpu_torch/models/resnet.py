"""ResNet basic blocks of the encoder (counterpart of ``sbgm_danra_tpu/models/resnet.py``).

NCHW tensors (channels_last in memory inside the UNet). Padding follows the
JAX package, which reproduces torch's geometry: 3x3 convs pad (1, 1) at every
stride, the 1x1 downsample pads nothing. BatchNorm runs on running statistics,
or with ``train=True`` on the batch's (``layers.BatchNorm``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from sbgm_danra_tpu_torch.models.layers import BatchNorm, Conv2d


class BasicBlock(nn.Module):
    """conv3x3 -> BN -> relu -> conv3x3 -> BN, + residual, relu; the residual is a
    1x1 conv + BN when the shape changes."""

    def __init__(self, in_features: int, features: int, stride: int = 1,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv1 = Conv2d(in_features, features, 3, stride, 1, bias=False, compute_dtype=dtype)
        self.bn1 = BatchNorm(features, dtype)
        self.conv2 = Conv2d(features, features, 3, 1, 1, bias=False, compute_dtype=dtype)
        self.bn2 = BatchNorm(features, dtype)
        if stride != 1 or in_features != features:
            self.down_conv = Conv2d(in_features, features, 1, stride, 0, bias=False,
                                    compute_dtype=dtype)
            self.down_bn = BatchNorm(features, dtype)
        else:
            self.down_conv = self.down_bn = None

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        out = F.relu(self.bn1(self.conv1(x), train))
        out = self.bn2(self.conv2(out), train)
        identity = x if self.down_conv is None else self.down_bn(self.down_conv(x), train)
        return F.relu(out + identity)


class ResNetStage(nn.Sequential):
    """``num_blocks`` BasicBlocks named block0, block1, ...; the first carries the stride."""

    def __init__(self, in_features: int, features: int, num_blocks: int, stride: int = 1,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        for i in range(num_blocks):
            self.add_module(
                f"block{i}",
                BasicBlock(in_features if i == 0 else features, features,
                           stride if i == 0 else 1, dtype),
            )

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        for block in self:
            x = block(x, train)
        return x

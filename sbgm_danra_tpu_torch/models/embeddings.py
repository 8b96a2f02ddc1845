"""Gaussian random-Fourier time embedding (counterpart of ``sbgm_danra_tpu/models/embeddings.py``).

The frequencies W ~ N(0, scale^2) are fixed: a registered buffer, as the JAX
package keeps them in its ``buffers`` collection. The embedding is
[sin(2 pi t W), cos(2 pi t W)].
"""

from __future__ import annotations

import math

import torch
from torch import nn


class GaussianFourierEmbedding(nn.Module):
    """t [B] -> [B, embed_dim], float32."""

    def __init__(self, embed_dim: int, scale: float = 30.0):
        super().__init__()
        if embed_dim % 2 != 0:
            raise ValueError(f"Embedding dimension must be even, got {embed_dim}.")
        self.scale = scale
        self.register_buffer("W", torch.zeros(embed_dim // 2))  # drawn by init_like_flax

    def forward(self, t: torch.Tensor) -> torch.Tensor:
        t = t.reshape(-1).float()
        proj = t[:, None] * self.W[None, :] * (2.0 * math.pi)
        return torch.cat([torch.sin(proj), torch.cos(proj)], dim=-1)

"""Spatial self-attention over flattened H*W tokens (counterpart of
``sbgm_danra_tpu/models/attention.py:29-90``).

A pre-LayerNorm transformer block on an NHWC feature map:

    tokens = reshape(x, [B, H*W, C])
    h = tokens + MHA(LN1(tokens))
    y = h + MLP(LN2(h))          # MLP = Dense(C) -> GELU(tanh) -> Dense(C)

The LayerNorms are Flax's: eps 1e-6, computed and returned in fp32. Backends:
'xla' is dense attention (SDPA), 'pallas' goes through the flash dispatcher
(``ops/flash_attention.py``), whose long-sequence path is the CUDA kernel.
"""

from __future__ import annotations

import torch
from torch import nn

from sbgm_danra_tpu_torch.models.layers import LayerNorm, Linear, flax_gelu
from sbgm_danra_tpu_torch.ops.flash_attention import dense_attention, flash_attention

BACKENDS = ("xla", "pallas", "ring")


class SpatialSelfAttention(nn.Module):
    """Pre-LN MHA + MLP block on flattened spatial tokens. NHWC in/out."""

    def __init__(self, channels: int, n_heads: int, backend: str = "xla",
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        if channels % n_heads != 0:
            raise ValueError(f"channels ({channels}) must be divisible by n_heads ({n_heads})")
        if backend not in BACKENDS:
            raise ValueError(f"unknown attention backend {backend!r}; options {BACKENDS}")
        self.n_heads, self.backend = n_heads, backend
        self.ln1 = LayerNorm(channels)
        self.qkv = Linear(channels, 3 * channels, compute_dtype)
        self.out_proj = Linear(channels, channels, compute_dtype)
        self.ln2 = LayerNorm(channels)
        self.ff1 = Linear(channels, channels, compute_dtype)
        self.ff2 = Linear(channels, channels, compute_dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, h, w, c = x.shape
        tokens = x.reshape(b, h * w, c)
        tokens = tokens + self._mha(self.ln1(tokens))
        y = self.ff2(flax_gelu(self.ff1(self.ln2(tokens))))
        tokens = tokens + y
        return tokens.reshape(b, h, w, c).to(x.dtype)

    def _mha(self, tokens: torch.Tensor) -> torch.Tensor:
        b, s, c = tokens.shape
        q, k, v = (t.reshape(b, s, self.n_heads, c // self.n_heads)
                   for t in self.qkv(tokens).chunk(3, dim=-1))
        if self.backend == "pallas":
            out = flash_attention(q, k, v)
        elif self.backend == "ring":
            raise NotImplementedError(
                "attention backend 'ring' (sequence-sharded ring attention) is not ported "
                "yet: ROADMAP queue 1 item 8 (parallel/ on torch.distributed)"
            )
        else:
            out = dense_attention(q, k, v)
        return self.out_proj(out.reshape(b, s, c))

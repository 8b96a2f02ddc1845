"""Self-attention dispatch over [B, S, H, D] tokens.

Counterpart of ``sbgm_danra_tpu/ops/flash_attention.py:31-42``: long token
counts on the card go to the hand-written CUDA flash kernel
(``ops/cuda_attention.py``), shorter ones to dense attention, which JAX leaves
to XLA and the port leaves to PyTorch's ``scaled_dot_product_attention``.
Tensors on the CPU take the kernel's plain version.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from sbgm_danra_tpu_torch.ops.cuda_attention import (
    flash_attention_cuda,
    flash_attention_reference,
)

# Minimum token count before the kernel is used, as in the JAX dispatcher.
_MIN_TOKENS_FOR_KERNEL = 4096

# Test hook: send every CUDA call to the kernel whatever its size (mirrors the
# JAX package's ``_FORCE_PALLAS``; CPU tensors still take the plain version).
_FORCE_KERNEL = False


def dense_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """softmax(q k^T / sqrt(D)) v through SDPA; [B, S, H, D] in and out."""
    out = F.scaled_dot_product_attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2))
    return out.transpose(1, 2)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Self-attention over [B, S, H, D] q/k/v; returns [B, S, H, D]."""
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v)
    if _FORCE_KERNEL or q.shape[1] >= _MIN_TOKENS_FOR_KERNEL:
        return flash_attention_cuda(q.contiguous(), k.contiguous(), v.contiguous())
    return dense_attention(q, k, v)

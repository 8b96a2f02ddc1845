"""Torch port on the card: the CUDA flash-attention kernel against its plain version.

These tests need an NVIDIA GPU and nvcc and skip elsewhere. The card machine
has no JAX, so this file imports none and runs without the repo's conftest:

    python -m pytest tests/test_torch_cuda.py --noconftest -q
"""

import pytest
import torch

from sbgm_danra_tpu_torch.ops import cuda_attention
from sbgm_danra_tpu_torch.ops import flash_attention as fa
from sbgm_danra_tpu_torch.ops.cuda_attention import flash_attention_cuda, flash_attention_reference

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    torch.backends.cuda.matmul.allow_tf32 = False  # full fp32 for the plain version
    return torch.device("cuda")


def _qkv(shape, dtype, cuda, seed=0):
    g = torch.Generator(cuda).manual_seed(seed)
    return [torch.randn(shape, generator=g, device=cuda).to(dtype) for _ in range(3)]


@pytest.mark.parametrize("shape", [(2, 1000, 2, 24), (1, 4096, 4, 64), (2, 300, 4, 128),
                                   (1, 33, 1, 32)])
def test_fp32_matches_plain_version(cuda, shape):
    """2e-5 abs + 2e-5 rel, the JAX kernel's own tolerance: only the fp32
    summation order differs."""
    q, k, v = _qkv(shape, torch.float32, cuda)
    torch.testing.assert_close(flash_attention_cuda(q, k, v), flash_attention_reference(q, k, v),
                               rtol=2e-5, atol=2e-5)


def test_bf16_matches_plain_version(cuda):
    """bf16 output rounding (half an ulp is up to ~8e-3 near 2): 2e-2 abs
    against the fp32 plain version on the same bf16-rounded inputs."""
    q, k, v = _qkv((2, 7600, 4, 32), torch.bfloat16, cuda)
    got = flash_attention_cuda(q, k, v).float()
    want = flash_attention_reference(q.float(), k.float(), v.float())
    assert (got - want).abs().max().item() <= 2e-2


def test_dispatcher_counts_one_launch_per_long_call(cuda):
    q, k, v = _qkv((1, 4096, 2, 32), torch.float32, cuda)
    before = cuda_attention.launches
    fa.flash_attention(q, k, v)
    fa.flash_attention(*(x[:, :100] for x in (q, k, v)))  # short: dense attention
    assert cuda_attention.launches == before + 1


def test_rejects_mixed_dtypes(cuda):
    q, k, v = _qkv((1, 64, 2, 32), torch.float32, cuda)
    with pytest.raises(ValueError, match="share one"):
        flash_attention_cuda(q, k.bfloat16(), v)


def test_backward_raises(cuda):
    q, k, v = (x.requires_grad_() for x in _qkv((1, 64, 2, 32), torch.float32, cuda))
    with pytest.raises(NotImplementedError, match="no backward"):
        flash_attention_cuda(q, k, v).sum().backward()

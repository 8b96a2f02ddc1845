"""Torch port on the card: the CUDA kernels (flash attention, conv3x3 + GroupNorm)
against their plain versions.

These tests need an NVIDIA GPU and nvcc and skip elsewhere. The card machine
has no JAX, so this file imports none and runs without the repo's conftest:

    python -m pytest tests/test_torch_cuda.py --noconftest -q
"""

import pytest
import torch

from sbgm_danra_tpu_torch.ops import cuda_attention
from sbgm_danra_tpu_torch.ops import flash_attention as fa
from sbgm_danra_tpu_torch.ops import fused_conv_gn as k1
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


def _k1_args(n, h, w, cin, cout, dtype, cuda, seed=0):
    g = torch.Generator(cuda).manual_seed(seed)
    x = torch.randn(n, h, w, cin, generator=g, device=cuda)
    kernel = torch.randn(3, 3, cin, cout, generator=g, device=cuda) / (3 * cin**0.5)
    bias = 0.1 * torch.randn(cout, generator=g, device=cuda)
    gamma = 1.0 + 0.1 * torch.randn(cout, generator=g, device=cuda)
    beta = 0.1 * torch.randn(cout, generator=g, device=cuda)
    return x.to(dtype), kernel, bias, gamma, beta


@pytest.mark.parametrize("shape", [(2, 16, 16, 64, 64), (3, 19, 13, 16, 8), (1, 8, 8, 12, 24),
                                   (2, 38, 50, 512, 256)])
@pytest.mark.parametrize("activation", [False, True])
def test_k1_fp32_matches_plain_version(cuda, shape, activation):
    """fp32 with TF32 off on both sides: |err| <= 1e-4 max |ref|; the conv's
    and the statistics' summation orders differ. Ragged tiles, odd channel
    counts (one channel per group at 8 / 8) and a Cin not divisible by 8
    included."""
    torch.backends.cudnn.allow_tf32 = False
    n, h, w, cin, cout = shape
    args = _k1_args(n, h, w, cin, cout, torch.float32, cuda)
    groups = 8 if cout % 8 == 0 else 4
    got = k1.conv3x3_gn_cuda(*args, groups=groups, activation=activation)
    want = k1.reference_chain(*args, groups=groups, activation=activation)
    assert (got - want).abs().max().item() <= 1e-4 * want.abs().max().item()


def test_k1_bf16_matches_plain_version(cuda):
    """bf16, each kernel against its plain version on the same inputs: the
    conv output within one bf16 rounding of the fp32 plain conv (4e-3 |ref| +
    1e-4 max |ref|); gn_apply, on the kernel's own conv and statistics, within
    2e-2 abs of the fp32 plain normalisation (|v| < 8: half a bf16 ulp is at
    most 1.6e-2). The chain against the plain chain: 2e-2 + 2^-7 |ref|, since
    each side rounds its own fp32 conv to bf16 before normalising."""
    torch.backends.cudnn.allow_tf32 = False
    x, kernel, bias, gamma, beta = _k1_args(2, 304, 400, 64, 64, torch.bfloat16, cuda)
    conv, stats = k1.conv3x3_stats(x, kernel, bias, 8)
    plain_conv, _ = k1.plain_conv3x3_stats(x.float(), kernel.bfloat16(), bias.bfloat16(), 8)
    conv_err = (conv.float() - plain_conv).abs()
    assert (conv_err <= 4e-3 * plain_conv.abs() + 1e-4 * plain_conv.abs().max()).all()
    out = k1.gn_apply(conv, stats, gamma, beta, 8, activation=False).float()
    want = k1.plain_gn_apply(conv, stats, gamma, beta, 8, activation=False,
                             out_dtype=torch.float32)
    assert (out - want).abs().max().item() <= 2e-2
    chain = k1.reference_chain(x, kernel, bias, gamma, beta, 8, activation=False,
                               out_dtype=torch.float32)
    assert ((out - chain).abs() <= 2e-2 + 2.0**-7 * chain.abs()).all()


def test_k1_statistics_are_deterministic(cuda):
    args = _k1_args(2, 76, 100, 128, 128, torch.bfloat16, cuda)
    first = k1.conv3x3_gn_cuda(*args, groups=8, activation=False)
    for _ in range(3):
        assert torch.equal(k1.conv3x3_gn_cuda(*args, groups=8, activation=False), first)


def test_cuda_tensors_never_reach_the_plain_version(cuda, monkeypatch):
    """The dispatcher and a decoder block on the card launch the kernels, one
    of each per conv -> norm chain, and never call reference_chain."""
    from sbgm_danra_tpu_torch.models.unet import DecoderBlock

    def refuse(*a, **k):
        raise AssertionError("a CUDA tensor reached reference_chain")

    monkeypatch.setattr(k1, "reference_chain", refuse)
    args = _k1_args(1, 8, 8, 16, 16, torch.float32, cuda)
    before = (k1.conv3x3_stats_launches, k1.gn_apply_launches)
    k1.conv3x3_gn_relu(*args, groups=8)
    block = DecoderBlock(16, 8, time_embedding=16, gn_groups=4).to(cuda)
    with torch.no_grad():
        block(torch.randn(2, 16, 4, 4, device=cuda), torch.randn(2, 8, 8, 8, device=cuda),
              torch.rand(2, device=cuda))
    assert (k1.conv3x3_stats_launches, k1.gn_apply_launches) == (before[0] + 3, before[1] + 3)


def test_k1_rejects_mixed_devices(cuda):
    x, kernel, bias, gamma, beta = _k1_args(1, 8, 8, 8, 8, torch.float32, cuda)
    with pytest.raises(ValueError, match="CUDA tensors"):
        k1.conv3x3_gn_cuda(x, kernel.cpu(), bias, gamma, beta, groups=4)

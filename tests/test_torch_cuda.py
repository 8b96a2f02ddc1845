"""Torch port on the card: the CUDA kernels (flash attention, conv3x3 + GroupNorm,
the 2x bilinear upsample) against their plain versions.

These tests need an NVIDIA GPU and nvcc and skip elsewhere. The card machine
has no JAX, so this file imports none and runs without the repo's conftest:

    python -m pytest tests/test_torch_cuda.py --noconftest -q
"""

import pytest
import torch

from sbgm_danra_tpu_torch.ops import cuda_attention
from sbgm_danra_tpu_torch.ops import flash_attention as fa
from sbgm_danra_tpu_torch.ops import fused_conv_gn as k1
from sbgm_danra_tpu_torch.ops import upsample as up
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
                                   (1, 33, 1, 32), (2, 7600, 4, 32), (1, 7600, 2, 128),
                                   (2, 4100, 2, 64)])
def test_fp32_matches_plain_version(cuda, shape):
    """2e-5 abs + 2e-5 rel, the JAX kernel's own tolerance: 3xTF32 keeps
    fp32's accuracy, and the summation order differs."""
    q, k, v = _qkv(shape, torch.float32, cuda)
    torch.testing.assert_close(flash_attention_cuda(q, k, v), flash_attention_reference(q, k, v),
                               rtol=2e-5, atol=2e-5)


def _bf16_tolerance(want):
    """P is rounded to bf16 as the A operand of P.V, and the output to bf16:
    2^-8 |ref| + 2^-8 max|ref| against the fp32 plain version."""
    return 2.0**-8 * want.abs() + 2.0**-8 * want.abs().max()


@pytest.mark.parametrize("shape", [(2, 7600, 4, 32), (1, 4096, 4, 64), (2, 300, 4, 128),
                                   (1, 33, 1, 32), (2, 1000, 2, 24)])
def test_bf16_matches_plain_version(cuda, shape):
    """The tensor-core variant against the fp32 plain version on the same
    bf16-rounded inputs (tolerance: _bf16_tolerance)."""
    q, k, v = _qkv(shape, torch.bfloat16, cuda)
    before = dict(cuda_attention.launches_by_variant)
    got = flash_attention_cuda(q, k, v).float()
    assert cuda_attention.launches_by_variant == {**before, "tc_bf16": before["tc_bf16"] + 1}
    want = flash_attention_reference(q.float(), k.float(), v.float())
    assert ((got - want).abs() <= _bf16_tolerance(want)).all()


@pytest.mark.parametrize("first_large_key", [4000, 7590])
def test_bf16_late_keys_far_above_the_early_max(cuda, first_large_key):
    """Keys past first_large_key score up to hundreds (in log2 units) above
    the earlier ones, so the running max must move far beyond the first
    tiles' (the kernel's rescale path), in a middle tile and in the ragged
    last one."""
    q, k, v = _qkv((2, 7600, 4, 32), torch.bfloat16, cuda)
    k[:, first_large_key:] *= 40
    got = flash_attention_cuda(q, k, v).float()
    want = flash_attention_reference(q.float(), k.float(), v.float())
    assert torch.isfinite(got).all()
    assert ((got - want).abs() <= _bf16_tolerance(want)).all()


@pytest.mark.parametrize("first_large_key", [4000, 7590])
def test_fp32_late_keys_far_above_the_early_max(cuda, first_large_key):
    """The rescale path in fp32, against the plain version (fp32, TF32 off):
    2e-5 abs + 2e-5 rel. Keys x 8 put the late scores some 40 (log2 units)
    above the early max, past the 32 at which the kernel moves its max. The
    bf16 test's x 40 (scores in the hundreds) is beyond fp32 itself: there one
    fp32 rounding of a score moves p by about 1e-5, half the tolerance
    (tests/test_torch_tf32x3.py), and against dense attention in fp64 the
    plain version misses it as the kernel does (profile_port.py --paths k2
    --dtype float32)."""
    q, k, v = _qkv((2, 7600, 4, 32), torch.float32, cuda)
    k[:, first_large_key:] *= 8
    got = flash_attention_cuda(q, k, v).double()
    want = flash_attention_reference(q, k, v).double()
    assert torch.isfinite(got).all()
    assert ((got - want).abs() <= 2e-5 + 2e-5 * want.abs()).all()


def test_fp32_nan_in_a_key_reaches_its_head(cuda):
    """3xTF32 splits every operand into a TF32 hi and lo; the card's own NaN
    (0x7fffffff, which an integer rounding of hi alone would turn into -0)
    in one key still poisons every output row of its (batch, head), and no
    other."""
    q, k, v = _qkv((2, 4100, 2, 32), torch.float32, cuda)
    k[0, 3000, 1, 5] = torch.zeros((), device=cuda) / 0
    out = flash_attention_cuda(q, k, v)
    assert torch.isnan(out[0, :, 1]).all()
    assert torch.isfinite(out[0, :, 0]).all() and torch.isfinite(out[1]).all()


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", [(2, 7600, 4, 32), (1, 1000, 2, 64), (2, 33, 2, 24)])
def test_packed_qkv_views_bit_identical_to_contiguous(cuda, shape, dtype):
    """q, k, v as chunks of one packed [B, S, 3C] tensor (row stride 3C, as
    the model passes them) give exactly the result of contiguous copies."""
    b, s, h, d = shape
    g = torch.Generator(cuda).manual_seed(1)
    packed = torch.randn(b, s, 3 * h * d, generator=g, device=cuda).to(dtype)
    q, k, v = (t.reshape(shape) for t in packed.chunk(3, dim=-1))
    assert not q.is_contiguous()
    got = flash_attention_cuda(q, k, v)
    assert got.is_contiguous()
    assert torch.equal(got, flash_attention_cuda(q.contiguous(), k.contiguous(), v.contiguous()))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_repeated_calls_bit_identical(cuda, dtype):
    q, k, v = _qkv((2, 7600, 4, 32), dtype, cuda)
    first = flash_attention_cuda(q, k, v)
    for _ in range(3):
        assert torch.equal(flash_attention_cuda(q, k, v), first)


@pytest.mark.parametrize("dtype, variant", [(torch.bfloat16, "tc_bf16"), (torch.float32, "fp32")])
def test_variant_chosen_by_dtype(cuda, dtype, variant):
    q, k, v = _qkv((1, 64, 2, 32), dtype, cuda)
    before = dict(cuda_attention.launches_by_variant)
    flash_attention_cuda(q, k, v)
    assert cuda_attention.launches_by_variant == {**before, variant: before[variant] + 1}


def test_rejects_unaligned_bf16_rows(cuda):
    x = torch.zeros(1, 64, 2 * 32 + 4, device=cuda, dtype=torch.bfloat16)[..., :64]
    q = x.reshape(1, 64, 2, 32)  # row stride 68 elements = 136 bytes
    with pytest.raises(ValueError, match="16-byte aligned"):
        flash_attention_cuda(q, q, q)


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


def test_backward_matches_plain(cuda):
    """A backward through the kernel gives the gradients of autograd through
    the plain version (fp32, 1e-4 of each gradient's max |ref|)."""
    q, k, v = (x.requires_grad_() for x in _qkv((1, 64, 2, 32), torch.float32, cuda))
    flash_attention_cuda(q, k, v).square().sum().backward()
    got = [x.grad.clone() for x in (q, k, v)]
    for x in (q, k, v):
        x.grad = None
    flash_attention_reference(q, k, v).square().sum().backward()
    for a, x in zip(got, (q, k, v)):
        assert (a - x.grad).abs().max() <= 1e-4 * x.grad.abs().max()


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


def _force_id(force):
    return "x".join(map(str, map(int, force)))


# (N, H, W, Cin, Cout, groups): aligned; ragged H x W with Cin off the chunk and
# groups of 3 channels; Cin and Cout off 64 with 9-channel groups that straddle
# the 64-channel Cout tile; one channel per group; batch 16; a single ragged tile
K1_BF16_SHAPES = [(2, 32, 48, 64, 64, 8), (2, 37, 51, 12, 24, 8), (2, 37, 51, 200, 72, 8),
                  (3, 19, 13, 16, 8, 8), (16, 16, 16, 128, 64, 8), (1, 9, 7, 40, 136, 4)]


@pytest.mark.parametrize("shape", K1_BF16_SHAPES, ids=str)
@pytest.mark.parametrize("force", k1.LAUNCH_SHAPES, ids=_force_id)
def test_k1_bf16_every_launch_shape_matches_plain_version(cuda, force, shape):
    """Each tile, chunk and weight placement of the bf16 conv kernel, forced,
    with the tolerances of test_k1_bf16_matches_plain_version; repeated calls
    are bit-identical."""
    torch.backends.cudnn.allow_tf32 = False
    n, h, w, cin, cout, groups = shape
    try:
        k1.plan(n, h, w, cin, cout, torch.bfloat16, force=force)
    except ValueError:
        pytest.skip("this launch shape does not fit in shared memory at this Cin")
    x, kernel, bias, gamma, beta = _k1_args(n, h, w, cin, cout, torch.bfloat16, cuda)
    conv, stats = k1.conv3x3_stats(x, kernel, bias, groups, force=force)
    again = k1.conv3x3_stats(x, kernel, bias, groups, force=force)
    assert torch.equal(again[0], conv) and torch.equal(again[1], stats)
    plain_conv, plain_stats = k1.plain_conv3x3_stats(x.float(), kernel.bfloat16(),
                                                     bias.bfloat16(), groups)
    conv_err = (conv.float() - plain_conv).abs()
    assert (conv_err <= 4e-3 * plain_conv.abs() + 1e-4 * plain_conv.abs().max()).all()
    assert ((stats - plain_stats).abs().max() <= 1e-4 * plain_stats.abs().max())
    out = k1.gn_apply(conv, stats, gamma, beta, groups, activation=True).float()
    want = k1.plain_gn_apply(conv, stats, gamma, beta, groups, activation=True,
                             out_dtype=torch.float32)
    assert (out - want).abs().max().item() <= 2e-2


@pytest.mark.parametrize("shape", [(1, 9, 7, 40, 136, 4), (2, 37, 51, 200, 72, 8),
                                   (2, 20, 33, 24, 24, 8), (1, 16, 16, 72, 64, 8)], ids=str)
@pytest.mark.parametrize("force", k1.LAUNCH_SHAPES, ids=_force_id)
def test_k1_bf16_reads_nothing_past_cin_or_the_end_of_x(cuda, force, shape):
    """Cin a multiple of 8 but not of the chunk: the last chunk's channels past
    Cin must be zero-fills, not the bytes that follow the pixel. With x at the
    end of a buffer whose next bytes are NaN (0 x NaN = NaN would poison the
    window, the group's statistics and then the whole group), the result is
    finite and bit-identical to the same call with zeros there."""
    n, h, w, cin, cout, groups = shape
    try:
        k1.plan(n, h, w, cin, cout, torch.bfloat16, force=force)
    except ValueError:
        pytest.skip("this launch shape does not fit in shared memory at this Cin")
    x, kernel, bias, _, _ = _k1_args(n, h, w, cin, cout, torch.bfloat16, cuda)
    results = []
    for after in (0.0, float("nan")):
        buf = torch.full((x.numel() + 256,), after, dtype=torch.bfloat16, device=cuda)
        x_tail = buf[:x.numel()].view(x.shape).copy_(x)
        assert x_tail.data_ptr() % 16 == 0  # the vector path
        results.append(k1.conv3x3_stats(x_tail, kernel, bias, groups, force=force))
    (conv, stats), (conv_nan, stats_nan) = results
    assert torch.isfinite(conv_nan.float()).all() and torch.isfinite(stats_nan).all()
    assert torch.equal(conv_nan, conv) and torch.equal(stats_nan, stats)


# (N, H, W, Cin, Cout, groups) for the fp32 kernel: aligned; Cin 24 and 40 (whole
# 8-channel chunks), 12 and 20 (the last chunk's second vector past Cin: a
# zero-fill), 6 (no vector copies); ragged tiles and Cout off 64; batch 16
K1_FP32_SHAPES = [(2, 32, 48, 64, 64, 8), (2, 37, 51, 24, 72, 8), (1, 9, 7, 40, 136, 4),
                  (2, 20, 33, 12, 24, 8), (3, 19, 13, 20, 8, 8), (1, 16, 16, 6, 16, 4),
                  (16, 8, 8, 512, 256, 8)]


@pytest.mark.parametrize("shape", K1_FP32_SHAPES, ids=str)
@pytest.mark.parametrize("force", k1.FP32_LAUNCH_SHAPES, ids=_force_id)
def test_k1_fp32_every_launch_shape_matches_plain_version(cuda, force, shape):
    """Each tile of the 3xTF32 conv kernel, forced, against the plain version
    with TF32 off: conv and statistics within 1e-4 max|ref|, the chain within
    1e-4 max|ref|; repeated calls are bit-identical."""
    torch.backends.cudnn.allow_tf32 = False
    n, h, w, cin, cout, groups = shape
    x, kernel, bias, gamma, beta = _k1_args(n, h, w, cin, cout, torch.float32, cuda)
    conv, stats = k1.conv3x3_stats(x, kernel, bias, groups, force=force)
    again = k1.conv3x3_stats(x, kernel, bias, groups, force=force)
    assert torch.equal(again[0], conv) and torch.equal(again[1], stats)
    plain_conv, plain_stats = k1.plain_conv3x3_stats(x, kernel, bias, groups)
    assert (conv - plain_conv).abs().max() <= 1e-4 * plain_conv.abs().max()
    assert (stats - plain_stats).abs().max() <= 1e-4 * plain_stats.abs().max()
    out = k1.gn_apply(conv, stats, gamma, beta, groups, activation=True)
    want = k1.reference_chain(x, kernel, bias, gamma, beta, groups, activation=True)
    assert (out - want).abs().max() <= 1e-4 * want.abs().max()


@pytest.mark.parametrize("shape", [(1, 9, 7, 40, 136, 4), (2, 37, 51, 12, 72, 8),
                                   (2, 20, 33, 24, 24, 8), (1, 16, 16, 20, 64, 8)], ids=str)
@pytest.mark.parametrize("force", k1.FP32_LAUNCH_SHAPES, ids=_force_id)
def test_k1_fp32_reads_nothing_past_cin_or_the_end_of_x(cuda, force, shape):
    """As the bf16 test: with NaN right behind x, the fp32 result is finite and
    bit-identical to the call with zeros there."""
    n, h, w, cin, cout, groups = shape
    x, kernel, bias, _, _ = _k1_args(n, h, w, cin, cout, torch.float32, cuda)
    results = []
    for after in (0.0, float("nan")):
        buf = torch.full((x.numel() + 64,), after, device=cuda)
        x_tail = buf[:x.numel()].view(x.shape).copy_(x)
        results.append(k1.conv3x3_stats(x_tail, kernel, bias, groups, force=force))
    (conv, stats), (conv_nan, stats_nan) = results
    assert torch.isfinite(conv_nan).all() and torch.isfinite(stats_nan).all()
    assert torch.equal(conv_nan, conv) and torch.equal(stats_nan, stats)


def test_k1_fp32_nan_in_x_reaches_its_window(cuda):
    """The card's own NaN in one pixel of x reaches the conv at the 3x3
    window around it and the statistics of its sample, and nothing else."""
    x, kernel, bias, _, _ = _k1_args(2, 40, 50, 64, 64, torch.float32, cuda)
    x[1, 20, 30, 5] = torch.zeros((), device=cuda) / 0
    conv, stats = k1.conv3x3_stats(x, kernel, bias, 8)
    window = torch.zeros(40, 50, dtype=torch.bool, device=cuda)
    window[19:22, 29:32] = True
    assert torch.isnan(conv[1][window]).all() and torch.isfinite(conv[1][~window]).all()
    assert torch.isfinite(conv[0]).all() and torch.isfinite(stats[0]).all()
    assert torch.isnan(stats[1]).all()


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", [(1, 5, 7, 12), (2, 9, 4, 72), (16, 8, 8, 512), (1, 3, 3, 4096),
                                   (2, 304, 400, 64)])
def test_gn_apply_matches_plain_version(cuda, shape, dtype):
    """The vector path (C a multiple of the 16-byte vector), the element path
    (C = 12 in bf16; more than 256 vectors a pixel) and one channel per group,
    on statistics taken from the input itself: bf16 2e-2 abs, fp32 1e-4 max|ref|."""
    n, h, w, c = shape
    g = torch.Generator(cuda).manual_seed(3)
    conv = torch.randn(n, h, w, c, generator=g, device=cuda).to(dtype)
    gamma = 1.0 + 0.1 * torch.randn(c, generator=g, device=cuda)
    beta = 0.1 * torch.randn(c, generator=g, device=cuda)
    for groups in (4, c):
        grouped = conv.float().reshape(n, h * w, groups, c // groups)
        stats = torch.stack([grouped.sum((1, 3)), (grouped * grouped).sum((1, 3))], dim=-1)
        for act in (False, True):
            out = k1.gn_apply(conv, stats, gamma, beta, groups, activation=act)
            want = k1.plain_gn_apply(conv, stats, gamma, beta, groups, activation=act,
                                     out_dtype=torch.float32)
            assert torch.equal(out, k1.gn_apply(conv, stats, gamma, beta, groups, activation=act))
            tol = 2e-2 if dtype == torch.bfloat16 else 1e-4 * want.abs().max().item()
            assert (out.float() - want).abs().max().item() <= tol


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_k1_takes_pointers_off_16_bytes(cuda, dtype):
    """x (and so the conv output's consumer, gn_apply's input) 8 bytes off a
    16-byte boundary: the kernels take their scalar copy paths and agree with
    the aligned call bit for bit."""
    x, kernel, bias, gamma, beta = _k1_args(2, 19, 13, 16, 24, dtype, cuda)
    shift = 8 // x.element_size()
    buf = torch.empty(x.numel() + shift, dtype=dtype, device=cuda)
    x_off = buf[shift:].view(x.shape).copy_(x)
    assert x_off.data_ptr() % 16 == 8 and x_off.is_contiguous()
    conv, stats = k1.conv3x3_stats(x, kernel, bias, 8)
    conv_off, stats_off = k1.conv3x3_stats(x_off, kernel, bias, 8)
    assert torch.equal(conv_off, conv) and torch.equal(stats_off, stats)
    out = k1.gn_apply(conv, stats, gamma, beta, 8)
    buf2 = torch.empty(conv.numel() + shift, dtype=dtype, device=cuda)
    conv_shifted = buf2[shift:].view(conv.shape).copy_(conv)
    assert torch.equal(k1.gn_apply(conv_shifted, stats, gamma, beta, 8), out)


# CorrDiff's K1 chains (a SongUNet block's conv0 -> + emb -> GroupNorm(32) -> SiLU,
# 8 members): the decoder's first 448x448 block and a block at the attention resolution
CORRDIFF_CHAINS = [(8, 448, 448, 384, 128), (8, 28, 28, 512, 256)]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", CORRDIFF_CHAINS, ids=str)
def test_k1_sample_bias_silu_matches_plain_version(cuda, shape, dtype):
    """A per-sample bias [N, Cout] and the SiLU epilogue, against the plain
    versions on the same inputs, with test_k1_bf16_matches_plain_version's and
    test_k1_fp32_matches_plain_version's tolerances (SiLU's slope is at most
    1.1, so it keeps the normalised values' bounds); the variant's launch
    counted once."""
    torch.backends.cudnn.allow_tf32 = False
    n, h, w, cin, cout = shape
    if dtype == torch.float32 and h > 100:
        pytest.skip("fp32 at the 28x28 chain only: the 448x448 one takes 6 GB in fp32")
    x, kernel, bias, gamma, beta = _k1_args(n, h, w, cin, cout, dtype, cuda)
    sample_bias = torch.randn(n, cout, generator=torch.Generator(cuda).manual_seed(9),
                              device=cuda)
    before = k1.conv3x3_stats_sample_bias_launches
    conv, stats = k1.conv3x3_stats(x, kernel, bias, 32, sample_bias=sample_bias)
    assert k1.conv3x3_stats_sample_bias_launches == before + 1
    plain_conv, plain_stats = k1.plain_conv3x3_stats(x.float(), kernel.to(dtype), bias.to(dtype),
                                                     32, sample_bias)
    out = k1.gn_apply(conv, stats, gamma, beta, 32, 1e-6, "silu").float()
    want = k1.plain_gn_apply(conv, stats, gamma, beta, 32, 1e-6, "silu", out_dtype=torch.float32)
    conv_err = (conv.float() - plain_conv).abs()
    assert (stats - plain_stats).abs().max() <= 1e-4 * plain_stats.abs().max()
    if dtype == torch.bfloat16:
        assert (conv_err <= 4e-3 * plain_conv.abs() + 1e-4 * plain_conv.abs().max()).all()
        assert (out - want).abs().max().item() <= 2e-2
    else:
        assert conv_err.max() <= 1e-4 * plain_conv.abs().max()
        assert (out - want).abs().max() <= 1e-4 * want.abs().max()
        chain = k1.conv3x3_gn_cuda(x, kernel, bias, gamma, beta, 32, 1e-6, "silu", sample_bias)
        plain = k1.reference_chain(x, kernel, bias, gamma, beta, 32, 1e-6, "silu",
                                   sample_bias=sample_bias)
        assert (chain - plain).abs().max() <= 1e-4 * plain.abs().max()


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_k1_per_channel_route_unchanged_by_the_sample_bias_variant(cuda, dtype):
    """The flagship's launches (a per-channel bias alone) compute bit for bit
    what the variant computes with that bias moved into the per-sample one:
    the variant adds to the same fp32 value in registers, once a block."""
    x, kernel, bias, _, _ = _k1_args(2, 37, 51, 64, 72, dtype, cuda)
    for force in (None, *(k1.LAUNCH_SHAPES if dtype == torch.bfloat16 else ())):
        try:
            k1.plan(2, 37, 51, 64, 72, dtype, force=force)
        except ValueError:
            continue
        per_channel = k1.conv3x3_stats(x, kernel, bias, 8, force=force)
        moved = k1.conv3x3_stats(x, kernel, torch.zeros_like(bias), 8, force=force,
                                 sample_bias=bias.to(dtype).float().expand(2, 72))
        assert torch.equal(per_channel[0], moved[0]) and torch.equal(per_channel[1], moved[1])


def test_corrdiff_evaluation_takes_k1_with_its_sample_bias(cuda):
    """A tiny CorrDiff in fp32 on the card: every UNetBlock's chain is one
    launch of the per-sample-bias variant in evaluation, the nets agree with
    their CPU run (the plain chain) to 2e-4 of the largest value (3xTF32 K1,
    cuDNN with TF32 off, another summation order), and ``generate``'s sampler
    graph records 34 evaluations' launches of the variant per replay."""
    from sbgm_danra_tpu_torch import capture
    from sbgm_danra_tpu_torch.evaluate.corrdiff import generate
    from sbgm_danra_tpu_torch.models.songunet import SongUNetSpec, UNetBlock, build_corrdiff

    torch.backends.cudnn.allow_tf32 = False
    spec = SongUNetSpec(cond_channels=6, img_resolution=16, model_channels=16,
                        channel_mult=(1, 2), num_blocks=1, attn_resolutions=(8,))
    cpu = build_corrdiff(spec, generator=torch.Generator().manual_seed(3))
    with torch.no_grad():
        for p in cpu.parameters():  # off EDM's 1e-5 scales, so that every layer counts
            p.add_(0.05 * torch.randn(p.shape, generator=torch.Generator().manual_seed(4)))
    card = build_corrdiff(spec).to(cuda)
    card.load_state_dict(cpu.state_dict())
    g = torch.Generator().manual_seed(5)
    cond = dict(cond_img=torch.randn(2, 16, 16, 2, generator=g),
                lsm_cond=torch.randn(2, 16, 16, 2, generator=g),
                topo_cond=torch.randn(2, 16, 16, 2, generator=g))
    x, sigma = torch.randn(2, 16, 16, 1, generator=g), torch.tensor([3.0, 0.02])
    blocks = sum(isinstance(m, UNetBlock) for m in card.residual.modules())
    with torch.no_grad():
        before = k1.conv3x3_stats_sample_bias_launches
        got = card.denoise(x.to(cuda), sigma.to(cuda), **{k: v.to(cuda) for k, v in cond.items()})
        assert k1.conv3x3_stats_sample_bias_launches == before + blocks
        want = cpu.denoise(x, sigma, **cond)
        assert (got.cpu() - want).abs().max() <= 2e-4 * want.abs().max()
        mean = card.mean(**{k: v.to(cuda) for k, v in cond.items()})
        assert (mean.cpu() - cpu.mean(**cond)).abs().max() <= 2e-4 * mean.abs().max().item()
        date = {k: v[:1].to(cuda) for k, v in cond.items()}
        generate(card, date, 2, torch.Generator(cuda).manual_seed(6))
        generate(card, date, 2, torch.Generator(cuda).manual_seed(7))
    graph = [g for g in capture.stats() if g["name"].startswith("edm_sampler 2x16x16x1")][-1]
    per = graph["launches_per_replay"]
    assert per["conv3x3_stats_sample_bias"] == per["conv3x3_stats"] == 34 * blocks
    assert per["gn_apply"] == 34 * blocks and graph["replays"] >= 2


def test_k1_two_models_keep_their_own_weights(cuda):
    """The packed weights are kept per parameter: two blocks of one shape with
    different weights, called in turn, each match their own plain chain; so
    does a block after load_state_dict and after an in-place update."""
    from sbgm_danra_tpu_torch.models.unet import DecoderBlock

    torch.backends.cudnn.allow_tf32 = False
    blocks = [DecoderBlock(16, 8, time_embedding=16, gn_groups=4).to(cuda) for _ in range(2)]
    for i, block in enumerate(blocks):
        with torch.no_grad():
            for prm in block.parameters():
                prm.copy_(torch.randn(prm.shape, generator=torch.Generator().manual_seed(i + 1))
                          .to(cuda) * 0.2)
    fmap = torch.randn(2, 16, 6, 10, device=cuda)

    def check():
        for block in blocks:
            with torch.no_grad():
                got = block(fmap)
                block.cpu()
                want = block(fmap.cpu())
                block.to(cuda)
            assert (got.cpu() - want).abs().max().item() <= 1e-4 * want.abs().max().item()

    check()
    check()  # served from the cache
    blocks[0].load_state_dict(blocks[1].state_dict())
    with torch.no_grad():
        blocks[1].conv.weight.mul_(1.5)
    check()


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


# The decoder's 2x bilinear upsample (ops/upsample.py, csrc/upsample2x.cu): bit
# for bit against the plain version, which runs on the card as twenty PyTorch ops.

UP_SHAPES = [(2, 19, 25, 512), (3, 1, 7, 64), (2, 5, 1, 64), (4, 64, 64, 64), (2, 9, 11, 3)]


def _up_x(shape, dtype, cuda, seed=0):
    """Normal values scaled by powers of two from 2^-20 to 2^20, so that the
    products and sums round at every exponent."""
    g = torch.Generator(cuda).manual_seed(seed)
    scale = torch.exp2(torch.randint(-20, 21, shape, generator=g, device=cuda).float())
    return (torch.randn(shape, generator=g, device=cuda) * scale).to(dtype)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", UP_SHAPES)
def test_upsample_kernel_equals_the_plain_version(cuda, shape, dtype):
    """The dispatcher launches the kernel once a call, and it equals the plain
    version bit for bit (one channel a thread where C is off the 16-byte vector)."""
    x = _up_x(shape, dtype, cuda)
    before = up.launches
    got = up.upsample2x(x)
    assert up.launches == before + 1
    assert got.dtype == dtype and got.shape == (shape[0], 2 * shape[1], 2 * shape[2], shape[3])
    assert torch.equal(got, up.upsample2x_bilinear(x))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_upsample_kernel_takes_strided_and_unaligned_views(cuda, dtype):
    """A non-contiguous x (the wrapper copies it) and a contiguous x 8 bytes off
    a 16-byte boundary (the one-channel-a-thread path) equal the plain version."""
    x = _up_x((2, 7, 9, 64), dtype, cuda)
    strided = x.permute(0, 2, 1, 3)
    assert not strided.is_contiguous()
    assert torch.equal(up.upsample2x_cuda(strided), up.upsample2x_bilinear(strided))
    shift = 8 // x.element_size()
    buf = torch.empty(x.numel() + shift, dtype=dtype, device=cuda)
    x_off = buf[shift:].view(x.shape).copy_(x)
    assert x_off.data_ptr() % 16 == 8 and x_off.is_contiguous()
    assert torch.equal(up.upsample2x_cuda(x_off), up.upsample2x_bilinear(x))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("ij", [(0, 0), (3, 4), (6, 8)])
def test_upsample_nan_reaches_exactly_its_quads(cuda, dtype, ij):
    """A NaN at input pixel (i, j) of one channel reaches output rows 2i-1 .. 2i+2
    and columns 2j-1 .. 2j+2 (clamped to the map) of that channel, and nothing else."""
    h, w = 7, 9
    i, j = ij
    x = _up_x((2, h, w, 16), dtype, cuda)
    x[1, i, j, 5] = float("nan")
    want = torch.zeros(2, 2 * h, 2 * w, 16, dtype=torch.bool)
    want[1, max(2 * i - 1, 0):2 * i + 3, max(2 * j - 1, 0):2 * j + 3, 5] = True
    assert torch.equal(torch.isnan(up.upsample2x_cuda(x)).cpu(), want)


def test_decoder_takes_the_upsample_kernel_only_in_evaluation(cuda):
    """A decoder block on the card launches the kernel once in evaluation and
    never in training, where the plain, differentiable version runs."""
    from sbgm_danra_tpu_torch.models.unet import DecoderBlock

    block = DecoderBlock(16, 8, time_embedding=16, gn_groups=4).to(cuda)
    fmap = torch.randn(2, 16, 4, 6, device=cuda)
    skip, t = torch.randn(2, 8, 8, 12, device=cuda), torch.rand(2, device=cuda)
    before = up.launches
    with torch.no_grad():
        block(fmap, skip, t)
    assert up.launches == before + 1
    block(fmap, skip, t, train=True).sum().backward()
    assert up.launches == before + 1


# K2's backward (bwd_delta, bwd_dkdv, bwd_dq) and the forward's lse output

_BWD_SHAPES = [(2, s, 4 if d == 32 else 2, d) for s in (1000, 4096, 7600) for d in (32, 64, 128)]


def _packed_qkv(shape, dtype, cuda, seed):
    """q, k, v as the model hands them: strided chunks of one [B, S, 3C] projection."""
    b, s, h, d = shape
    g = torch.Generator(cuda).manual_seed(seed)
    packed = torch.randn(b, s, 3 * h * d, generator=g, device=cuda).to(dtype)
    return [t.reshape(shape) for t in packed.chunk(3, dim=-1)]


def _kernel_grads(q, k, v, dout):
    q, k, v = (x.detach().requires_grad_() for x in (q, k, v))
    out = flash_attention_cuda(q, k, v)
    out.backward(dout)
    return out.detach(), (q.grad, k.grad, v.grad)


def _check_bwd(shape, dtype, cuda, late_key_scale=None):
    """dq, dk, dv of the kernels against the dense plain backward in fp32 on the
    same inputs, the kernel's own output and the plain lse: each gradient within
    1e-2 (bf16: P and dS are rounded to bf16 as mma operands and the gradients
    to bf16, 2^-9 relative each, and a row's sums reach a few hundred terms of
    either sign) or 1e-4 (fp32: 3xTF32 keeps fp32's accuracy; summation order
    only) of its max |ref|; a second call repeats bit-identically, and one call
    is one backward launch of the dtype's variant. ``late_key_scale`` scales
    the keys past 4000."""
    q, k, v = _packed_qkv(shape, dtype, cuda, seed=3)
    if late_key_scale is not None:
        k = k.clone()
        k[:, 4000:] *= late_key_scale
    g = torch.Generator(cuda).manual_seed(4)
    dout = torch.randn(shape, generator=g, device=cuda).to(dtype)
    before = dict(cuda_attention.bwd_launches_by_variant)
    out, got = _kernel_grads(q, k, v, dout)
    variant = "tc_bf16" if dtype == torch.bfloat16 else "fp32"
    assert cuda_attention.bwd_launches_by_variant == {**before, variant: before[variant] + 1}
    _, again = _kernel_grads(q, k, v, dout)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    lse = cuda_attention.attention_lse(q, k)
    want = cuda_attention.flash_attention_bwd_reference(
        q.float(), k.float(), v.float(), out.float(), dout.float(), lse)
    tol = 1e-2 if dtype == torch.bfloat16 else 1e-4
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert a.dtype == dtype and a.shape == shape
        assert torch.isfinite(a).all(), name
        err = (a.float() - b).abs().max().item()
        assert err <= tol * b.abs().max().item(), (name, err, b.abs().max().item())


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", _BWD_SHAPES)
def test_bwd_matches_plain_version(cuda, shape, dtype):
    """See _check_bwd."""
    _check_bwd(shape, dtype, cuda)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", [(2, 33, 2, 24), (2, 65, 2, 24), (2, 7600, 2, 24),
                                   (1, 33, 1, 32)])
def test_bwd_ragged_and_small_sequences(cuda, shape, dtype):
    """S below one tile, one row past a tile, and the path's S = 7600 (a last
    tile of 48), with D = 24 zero-padded to 32: the last tile's padded rows
    (dk/dv) and keys (dq) must contribute nothing (see _check_bwd)."""
    _check_bwd(shape, dtype, cuda)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_bwd_late_keys_far_above_the_early_max(cuda, dtype):
    """Keys past 4000 x 8 (the F8 card test's forward case): scores some 40
    above the early ones in log2 units, so P is near 1 on a few keys and dS
    large there (see _check_bwd)."""
    _check_bwd((2, 7600, 4, 32), dtype, cuda, late_key_scale=8)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_bwd_one_call_is_one_launch_of_its_variant(cuda, dtype):
    """One backward call counts one backward launch of its dtype's variant and
    runs exactly the three backward kernels (delta, dk/dv, dq) once each on
    the card, instantiated for its dtype. A profiler session that records no
    device event at all (not even the gradient's fill) saw nothing and is
    taken again, at most three times."""
    from torch.profiler import ProfilerActivity, profile

    q, k, v = (x.detach().requires_grad_() for x in _packed_qkv((1, 300, 2, 32), dtype, cuda, 9))
    variant = "tc_bf16" if dtype == torch.bfloat16 else "fp32"
    for _ in range(3):
        out = flash_attention_cuda(q, k, v)
        before = dict(cuda_attention.bwd_launches_by_variant)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            out.backward(torch.ones_like(out))
            torch.cuda.synchronize()
        assert cuda_attention.bwd_launches_by_variant == {**before, variant: before[variant] + 1}
        device = [e.name for e in prof.events() if e.device_type.name == "CUDA"]
        if device:
            break
    else:
        pytest.fail("the profiler recorded no device event in three sessions")
    names = [n for n in device if "flash_attention_bwd" in n]
    for kernel in ("bwd_delta", "bwd_dkdv", "bwd_dq"):
        found = [n for n in names if kernel in n]
        assert len(found) == 1, (kernel, names)
        assert ("__nv_bfloat16" in found[0]) == (dtype == torch.bfloat16), found[0]
    assert len(names) == 3, names


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", [(2, 7600, 4, 32), (1, 1000, 2, 64), (2, 333, 2, 128),
                                   (2, 500, 2, 24)])
def test_lse_matches_plain_version(cuda, shape, dtype):
    """The forward's lse output against the plain log-sum-exp of the same
    inputs: 1e-4 absolute (values near log S); the output does not change
    when the lse is written."""
    q, k, v = _packed_qkv(shape, dtype, cuda, seed=5)
    out, lse = cuda_attention._launch(q, k, v, with_lse=True)
    want = cuda_attention.attention_lse(q, k)
    assert lse.shape == (shape[0], shape[2], shape[1])
    assert (lse - want).abs().max().item() <= 1e-4
    assert torch.equal(out, flash_attention_cuda(q, k, v))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_bwd_nan_in_a_key_reaches_exactly_what_reads_it(cuda, dtype):
    """A NaN in one key of (batch 0, head 1) makes every gradient of that
    (batch, head) NaN, as the plain backward's, and no other."""
    q, k, v = _packed_qkv((2, 4100, 2, 32), dtype, cuda, seed=6)
    k = k.clone()
    k[0, 3000, 1, 5] = float("nan")
    dout = torch.randn(q.shape, generator=torch.Generator(cuda).manual_seed(7),
                       device=cuda).to(dtype)
    out, got = _kernel_grads(q, k, v, dout)
    want = cuda_attention.flash_attention_bwd_reference(
        q, k, v, out, dout, cuda_attention.attention_lse(q, k))
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        differ = torch.isnan(a) != torch.isnan(b)
        assert not differ.any(), (name, differ.sum().item(), differ.nonzero()[:4].tolist(),
                                  a[differ][:4].tolist(), b[differ][:4].tolist())
        nan = torch.isnan(a[0, :, 1])
        assert nan.all(), (name, nan.sum().item(), nan.numel(),
                           (~nan).nonzero()[:4].tolist(), a[0, :, 1][~nan][:4].tolist())
        assert torch.isfinite(a[0, :, 0]).all() and torch.isfinite(a[1]).all(), name


def test_bwd_rejects_what_it_cannot_take(cuda):
    """A backward on tensors of mixed dtypes raises; nothing gives way to the plain version."""
    q, k, v = _packed_qkv((1, 128, 2, 32), torch.float32, cuda, seed=8)
    out, lse = cuda_attention._launch(q, k, v, with_lse=True)
    with pytest.raises(ValueError, match="dout"):
        cuda_attention._launch_bwd(q, k, v, out, out.bfloat16(), lse)


FAULTS = {"dk_zero": lambda dq, dk, dv: (dq, torch.zeros_like(dk), dv),
          "dq_x1.1": lambda dq, dk, dv: (dq * 1.1, dk, dv),
          "dv_x1.1": lambda dq, dk, dv: (dq, dk, dv * 1.1)}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_train_comparison_catches_a_k2_backward_fault(cuda, monkeypatch, capsys, fault):
    """chip_smoke.py's full-domain train comparison (one bf16 step at 608x800
    with K2 against the same step with the plain attention) fails when K2's
    backward is wrong: a fault planted in the wrapper's dq, dk or dv reaches
    only decoder block 1's attention and what lies upstream of it, and each
    parameter's gradient (the q, k and v parts of the fused projection apart)
    is held to its own max |ref|. Prints the reading."""
    import json

    import chip_smoke

    real = cuda_attention._launch_bwd

    def planted(*args):
        return FAULTS[fault](*real(*args))

    monkeypatch.setattr(cuda_attention, "_launch_bwd", planted)
    with pytest.raises(AssertionError, match="kernel vs plain attention"):
        chip_smoke.phase_train_full_domain(cuda, "bfloat16", 1, compare=True)
    row = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    cmp = row["kernel_vs_plain_attention"]
    with capsys.disabled():
        print(f"\n{fault}: grad_rel_err_max {cmp['grad_rel_err_max']:.3e} (limit "
              f"{chip_smoke.GRAD_REL_TOL}), overall {cmp['grad_rel_err_overall']:.3e}, "
              f"worst {cmp['grad_rel_err_worst'][:2]}")
    assert cmp["grad_rel_err_max"] > chip_smoke.GRAD_REL_TOL


def test_device_prefetch_copies_pinned_batches_in_order(cuda):
    """Host batches arrive on the card in order and unchanged, copied on a
    side stream ahead of the consumer; a consumer that stops early releases
    the producer thread."""
    import numpy as np

    from sbgm_danra_tpu_torch.data.loader import device_prefetch

    host = [{"x": np.full((64, 128, 128, 1), i, np.float32), "y": np.arange(64) + i}
            for i in range(6)]
    got = list(device_prefetch(iter(host), depth=2, device=cuda))
    assert len(got) == 6
    for i, b in enumerate(got):
        assert b["x"].is_cuda and bool((b["x"] == i).all()) and b["y"][0].item() == i
    for i, b in enumerate(device_prefetch(iter(host), depth=2, device=cuda)):
        if i == 1:
            break


def test_card_sampler_matches_the_cpu_sampler(cuda, tmp_path):
    """The card sampler at batch 32 against the same sampler on the CPU with
    the same draws: every key equal, the jump-flood SDF within 1e-6."""
    import os

    from sbgm_danra_tpu_torch.config import from_dict
    from sbgm_danra_tpu_torch.data.device_data import DeviceDataLoader, make_sample_fn
    from sbgm_danra_tpu_torch.data.factory import make_dataset
    from sbgm_danra_tpu_torch.data.paths import lsm_path, topo_path
    from sbgm_danra_tpu_torch.data.synthetic import SyntheticSpec, generate

    root = str(tmp_path)
    generate(SyntheticSpec(root=root, full_domain=(96, 128), n_days=10,
                           variables=("temp", "prcp"), crop_region=(8, 88, 16, 120)))
    cfg = from_dict({
        "paths": {"data_dir": root, "lsm_path": lsm_path(root), "topo_path": topo_path(root),
                  "stats_load_dir": os.path.join(root, "stats")},
        "highres": {"variable": "prcp", "data_size": [64, 64], "scaling_method": "log_zscore",
                    "full_domain_dims": [96, 128], "cutout_domains": [8, 88, 16, 120]},
        "lowres": {"condition_variables": ["temp", "prcp"],
                   "scaling_methods": ["zscore", "log_zscore"], "full_domain_dims": [96, 128]},
    })
    loader = DeviceDataLoader(make_dataset(cfg, "train"), 32, cfg_dropout_prob=0.5, device=cuda)
    draws = loader.draws(torch.Generator(cuda).manual_seed(0))
    card = loader.sample_from(*draws)
    s = loader.stacks
    ref = make_sample_fn(loader.crop_hw)(*(d.cpu() for d in draws), s.fields.cpu(),
                                         s.statics.cpu(), s.classifier.cpu())
    for k in ("x", "cond_img", "lsm_cond", "topo_cond", "y", "lsm_hr"):
        assert torch.equal(card[k].cpu(), ref[k]), k
    assert (card["sdf"].cpu() - ref["sdf"]).abs().max().item() <= 1e-6


# CUDA graphs (sbgm_danra_tpu_torch/capture.py, sampling/graphs.py, the
# captured train step and training/fused.py): replays against the eager
# calls, a capture that cannot be made, and the launch counts of a graph.

def _tiny_unet(cuda, backend="xla", seed=3):
    from sbgm_danra_tpu_torch.models.unet import ModelSpec, build_score_model

    spec = ModelSpec(in_channels=6, num_classes=4, last_fmap_channels=64, time_embedding=32,
                     num_heads=2, block_layers=(1, 1, 1, 1), attention_backend=backend)
    return build_score_model(spec, generator=torch.Generator().manual_seed(seed)).to(cuda)


def _card_cond(batch, hw, cuda, seed):
    g = torch.Generator(cuda).manual_seed(seed)
    return {"y": torch.randint(1, 5, (batch,), generator=g, device=cuda),
            "cond_img": torch.randn(batch, *hw, 2, generator=g, device=cuda),
            "lsm_cond": (torch.rand(batch, *hw, 2, generator=g, device=cuda) > 0.5).float(),
            "topo_cond": torch.randn(batch, *hw, 2, generator=g, device=cuda)}


GRAPH_SAMPLERS = {  # name: (sampler, config options, keyword options, per-row generators)
    "dpmpp": ("dpmpp_sampler", dict(num_steps=6, guidance_scale=3.0), {}, False),
    "edm_churn": ("edm_sampler", dict(num_steps=5, s_churn=2.0), {}, False),
    "pc_per_row": ("pc_sampler", dict(num_steps=3, guidance_scale=3.0),
                   {"per_member_step": True}, True),
    "em": ("em_sampler", dict(num_steps=4), {}, False),
    "ode_heun": ("ode_sampler", dict(num_steps=4, ode_method="heun"), {}, False),
    "ode_rk45": ("ode_sampler", dict(ode_method="rk45", rtol=1e-2, atol=1e-2, eps=0.5), {},
                 False),
}


@pytest.mark.parametrize("case", sorted(GRAPH_SAMPLERS))
def test_sampler_graph_replay_equals_the_eager_loop(cuda, monkeypatch, case):
    """A sampler's graph (captured at the first call, replayed at the second)
    gives the eager loop's sample bit for bit, given the same generators
    (cuDNN deterministic, so that both runs take the same algorithms)."""
    from sbgm_danra_tpu_torch.sampling import graphs
    from sbgm_danra_tpu_torch.sampling.samplers import SamplerConfig, get_sampler
    from sbgm_danra_tpu_torch.sde import VESDE

    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    name, options, kw, per_row = GRAPH_SAMPLERS[case]
    config = SamplerConfig(**options)
    model = _tiny_unet(cuda).eval()
    shape = (2, 64, 64, 1)
    cond = _card_cond(2, shape[1:3], cuda, 4)

    def rng(seed):
        if per_row:
            return [torch.Generator(cuda).manual_seed(seed + r) for r in range(shape[0])]
        return torch.Generator(cuda).manual_seed(seed)

    with torch.inference_mode():
        first = graphs.sample(name, model, rng(1), shape, VESDE(), config, cond=cond, **kw)
        second = graphs.sample(name, model, rng(2), shape, VESDE(), config, cond=cond, **kw)
        want = [get_sampler(name)(model, rng(s), shape, VESDE(), config, cond=cond, **kw)
                for s in (1, 2)]
    assert torch.isfinite(second).all()
    assert torch.equal(first, want[0]) and torch.equal(second, want[1])


def test_sampler_graph_with_draws_takes_each_calls_conditioning(cuda, monkeypatch):
    """A replay given its noise (``draws``, as a member-sharded ensemble
    gives it) copies the call's conditioning in too, and records its
    ``sample.inputs`` and ``sample.replay`` spans under a profiler."""
    from torch.profiler import ProfilerActivity, profile

    from sbgm_danra_tpu_torch.sampling import graphs
    from sbgm_danra_tpu_torch.sampling import samplers as S
    from sbgm_danra_tpu_torch.sde import VESDE

    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    config = S.SamplerConfig(num_steps=4, guidance_scale=3.0)
    model = _tiny_unet(cuda).eval()
    shape = (2, 64, 64, 1)
    n = S.n_draws(S.dpmpp_sampler, config)
    draws = torch.randn(n, *shape, generator=torch.Generator(cuda).manual_seed(5), device=cuda)
    conds = [_card_cond(2, shape[1:3], cuda, seed) for seed in (6, 7)]
    with torch.inference_mode():
        graphs.sample(S.dpmpp_sampler, model, None, shape, VESDE(), config, cond=conds[0],
                      draws=draws)
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            got = graphs.sample(S.dpmpp_sampler, model, None, shape, VESDE(), config,
                                cond=conds[1], draws=draws)
        want = S.dpmpp_sampler(model, None, shape, VESDE(), config, cond=conds[1], draws=draws)
    assert torch.equal(got, want)
    names = [n for _, n in sorted((e.start_ns(), e.name())
                                  for e in prof.profiler.kineto_results.events())]
    assert [n for n in names if n.startswith("sbgm:")] == ["sbgm:sample.inputs",
                                                          "sbgm:sample.replay"]


def test_graph_launch_counts_per_replay(cuda, monkeypatch):
    """A graph records K1's, K2's and the upsample's launches at capture and
    adds them to the wrappers' counts at every replay: one replay counts what
    one eager call launches (8 K1 chains, one K2 per attention layer and 5
    upsamples per evaluation)."""
    from sbgm_danra_tpu_torch import capture
    from sbgm_danra_tpu_torch.sampling import graphs
    from sbgm_danra_tpu_torch.sampling.samplers import SamplerConfig, dpmpp_sampler
    from sbgm_danra_tpu_torch.sde import VESDE

    monkeypatch.setattr(fa, "_FORCE_KERNEL", True)
    model = _tiny_unet(cuda, backend="pallas").eval()
    shape, config = (2, 64, 64, 1), SamplerConfig(num_steps=4)
    cond = _card_cond(2, shape[1:3], cuda, 5)

    def counts():
        return (k1.conv3x3_stats_launches, k1.gn_apply_launches, cuda_attention.launches,
                up.launches)

    with torch.inference_mode():
        before = counts()
        dpmpp_sampler(model, torch.Generator(cuda).manual_seed(0), shape, VESDE(), config,
                      cond=cond)
        after = counts()
        eager = [after[i] - before[i] for i in range(4)]
        graphs.sample(dpmpp_sampler, model, torch.Generator(cuda).manual_seed(0), shape,
                      VESDE(), config, cond=cond)
        before = counts()
        graphs.sample(dpmpp_sampler, model, torch.Generator(cuda).manual_seed(1), shape,
                      VESDE(), config, cond=cond)
        after = counts()
    evaluations = config.num_steps - 1
    assert eager[0] == eager[1] == 8 * evaluations and eager[2] > 0
    assert eager[3] == 5 * evaluations
    assert [after[i] - before[i] for i in range(4)] == eager
    stats = [s for s in capture.stats() if s["name"].startswith("dpmpp_sampler 2x64x64")]
    per = stats[-1]["launches_per_replay"]
    assert per["conv3x3_stats"] == per["gn_apply"] == 8 * evaluations
    assert per["flash_attention_fwd_fp32"] == eager[2]
    assert per["upsample2x"] == 5 * evaluations


def test_a_capture_that_fails_raises(cuda):
    """A host sync inside the captured call raises CaptureError: nothing runs
    the eager call in its place, and the card works on after it."""
    from sbgm_danra_tpu_torch import capture
    from sbgm_danra_tpu_torch.sampling import graphs
    from sbgm_danra_tpu_torch.sampling.samplers import SamplerConfig
    from sbgm_danra_tpu_torch.sde import VESDE

    x = torch.ones(64, device=cuda)
    with pytest.raises(capture.CaptureError, match="host sync"):
        capture.Graph("host sync", lambda x: x * float(x.sum()), [x])

    def syncing_score(x, t, **_):
        return -x / (1.0 + float(t[0]))

    with pytest.raises(capture.CaptureError):
        graphs.sample("dpmpp_sampler", syncing_score, torch.Generator(cuda).manual_seed(0),
                      (1, 8, 8, 1), VESDE(), SamplerConfig(num_steps=3))
    assert torch.cuda.current_stream(cuda) == torch.cuda.default_stream(cuda)
    assert (x + 1).sum().item() == 128.0


def _card_train_state(cuda):
    from sbgm_danra_tpu_torch.config import from_dict
    from sbgm_danra_tpu_torch.training.state import create_train_state

    cfg = from_dict({"training": {"learning_rate": 1e-3, "weight_init": False,
                                  "ema_decay": 0.9, "weight_decay": 1e-6}})
    model = _tiny_unet(torch.device("cpu"), seed=6)
    state = create_train_state(cfg, model)
    model.to(cuda)
    return state.to(cuda).make_capturable()


def _card_state(state):
    out = [v.detach().clone() for v in state.update_tensors()]
    return out


def test_train_step_graph_equals_the_eager_step(cuda, monkeypatch):
    """Three captured steps (capturable Adam, a tensor learning rate changed
    between steps, EMA, BatchNorm statistics) equal three eager steps bit for
    bit; a NaN batch with skip_nonfinite_updates leaves the state as it was."""
    from sbgm_danra_tpu_torch.sde import VESDE
    from sbgm_danra_tpu_torch.training.train_step import CapturedStep, make_train_step

    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    eager, graph = _card_train_state(cuda), _card_train_state(cuda)
    steps = {id(eager): make_train_step(eager.model, VESDE(), skip_nonfinite_updates=True),
             id(graph): CapturedStep(make_train_step(graph.model, VESDE(),
                                                     skip_nonfinite_updates=True),
                                     1e-3, "train step")}
    g = torch.Generator(cuda).manual_seed(7)
    for i in range(3):
        batch = {"x": torch.randn(2, 64, 64, 1, generator=g, device=cuda),
                 "sdf": torch.rand(2, 64, 64, 1, generator=g, device=cuda),
                 **_card_cond(2, (64, 64), cuda, 10 + i)}
        t = torch.rand(2, generator=g, device=cuda) * 0.999 + 1e-3
        z = torch.randn(2, 64, 64, 1, generator=g, device=cuda)
        losses = []
        for state in (eager, graph):
            state.with_learning_rate(1e-3 / (i + 1))
            losses.append(steps[id(state)](state, batch, t=t, z=z)["loss"])
        assert torch.equal(losses[0], losses[1])
        assert all(torch.equal(a, b) for a, b in zip(_card_state(eager), _card_state(graph)))
    kept = _card_state(graph)
    batch["x"][0, 0, 0, 0] = float("nan")
    metrics = steps[id(graph)](graph, batch, t=t, z=z)
    assert not bool(metrics["finite"]) and graph.step == 3
    assert all(torch.equal(a, b) for a, b in zip(kept, _card_state(graph)))


def test_eval_graph_reads_the_weights_train_replays_wrote(cuda, monkeypatch):
    """Captured train steps, the captured eval step (K1 on packs of the
    weights it reads), more captured train steps, the eval step again: each
    eval equals an eager eval of the state as it then is, on fresh packs, bit
    for bit. A replay runs no ATen op, so only the version counters that the
    train graph's replays advance tell the eval graph's packs (and K1's cache)
    that the weights moved. On the parameters and on the EMA."""
    from sbgm_danra_tpu_torch.sde import VESDE
    from sbgm_danra_tpu_torch.training.train_step import (CapturedStep, make_eval_step,
                                                          make_train_step)

    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    state = _card_train_state(cuda)
    train = CapturedStep(make_train_step(state.model, VESDE()), 1e-3, "train step")
    evals = {ema: (make_eval_step(state.model, VESDE(), use_ema=ema, capture=True),
                   make_eval_step(state.model, VESDE(), use_ema=ema)) for ema in (False, True)}
    g = torch.Generator(cuda).manual_seed(9)

    def batch(seed):
        return {"x": torch.randn(2, 64, 64, 1, generator=g, device=cuda),
                "sdf": torch.rand(2, 64, 64, 1, generator=g, device=cuda),
                **_card_cond(2, (64, 64), cuda, seed)}

    probe = batch(30)
    t = torch.rand(2, generator=g, device=cuda) * 0.999 + 1e-3
    z = torch.randn(2, 64, 64, 1, generator=g, device=cuda)
    seen = {ema: [] for ema in evals}
    for round_ in range(2):
        for i in range(2):
            train(state, batch(40 + 2 * round_ + i), g)
        for ema, (graph_eval, eager_eval) in evals.items():
            got = graph_eval(state, probe, t=t, z=z)["loss"]
            k1._packed.clear()  # the reference packs the weights afresh
            want = eager_eval(state, probe, t=t, z=z)["loss"]
            assert torch.equal(got, want), (round_, ema, got.item(), want.item())
            seen[ema].append(want.item())
    assert state.step == 4
    assert all(a != b for a, b in seen.values())  # the weights moved between the evals


def test_fused_graph_equals_eager_steps(cuda, monkeypatch, tmp_path):
    """Two chunks of 3 fused steps on the card sampler (jump flood inside the
    graph), captured, equal 3 + 3 eager steps on the same draws bit for bit:
    losses and every tensor of the state."""
    import os

    from sbgm_danra_tpu_torch.config import from_dict
    from sbgm_danra_tpu_torch.data.device_data import DeviceDataLoader
    from sbgm_danra_tpu_torch.data.factory import make_dataset
    from sbgm_danra_tpu_torch.data.paths import lsm_path, topo_path
    from sbgm_danra_tpu_torch.data.synthetic import SyntheticSpec, generate
    from sbgm_danra_tpu_torch.sde import VESDE
    from sbgm_danra_tpu_torch.training.fused import make_fused_train_step, step_draws

    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    root = str(tmp_path)
    generate(SyntheticSpec(root=root, full_domain=(96, 128), n_days=10,
                           variables=("temp", "prcp"), crop_region=(8, 88, 16, 120)))
    cfg = from_dict({
        "paths": {"data_dir": root, "lsm_path": lsm_path(root), "topo_path": topo_path(root),
                  "stats_load_dir": os.path.join(root, "stats")},
        "highres": {"variable": "prcp", "data_size": [64, 64], "scaling_method": "log_zscore",
                    "full_domain_dims": [96, 128], "cutout_domains": [8, 88, 16, 120]},
        "lowres": {"condition_variables": ["temp", "prcp"],
                   "scaling_methods": ["zscore", "log_zscore"], "full_domain_dims": [96, 128]},
    })
    loader = DeviceDataLoader(make_dataset(cfg, "train"), 4, cfg_dropout_prob=0.5, device=cuda)
    eager, graph = _card_train_state(cuda), _card_train_state(cuda)
    runs = {id(eager): make_fused_train_step(eager.model, VESDE(), loader.sample_fn),
            id(graph): make_fused_train_step(graph.model, VESDE(), loader.sample_fn,
                                             capture=True)}
    g = torch.Generator(cuda).manual_seed(8)
    for chunk in range(2):
        draws = loader.chunk_draws(0, 3 * chunk, 3)
        sdraws = step_draws(g, (4, 64, 64, 1), 3, device=cuda)
        traces = [runs[id(s)](s, draws, sdraws, loader.buffers())[1] for s in (eager, graph)]
        assert all(torch.equal(traces[0][k], traces[1][k]) for k in ("loss", "finite"))
        assert all(torch.equal(a, b) for a, b in zip(_card_state(eager), _card_state(graph)))
    assert graph.step == 6


def test_preview_after_train_replays_equals_the_eager_preview(cuda, monkeypatch):
    """Captured train steps, a preview on its graph, more captured train
    steps, a preview on its graph again: the second equals the eager loop's
    (the previews' default route) preview of the state as it then is, on
    fresh K1 packs and the same draws, bit for bit, and differs from the first
    (the EMA moved; the K1 packs the first preview made went stale through the
    train replays' version bumps)."""
    import numpy as np

    from sbgm_danra_tpu_torch.config import from_dict
    from sbgm_danra_tpu_torch.training.pipeline import TrainingPipeline

    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    cfg = from_dict({
        "highres": {"variable": "prcp", "data_size": [64, 64]},
        "lowres": {"condition_variables": ["temp", "prcp"]},
        "sampler": {"sampler_type": "dpmpp_sampler", "n_timesteps": 5, "time_embedding": 32,
                    "last_fmap_channels": 64, "num_heads": 2, "block_layers": [1, 1, 1, 1]},
        "training": {"learning_rate": 1e-3, "weight_init": False, "ema_decay": 0.9,
                     "batch_size": 2, "monitor_extremes": False},
        "classifier_free_guidance": {"enabled": True, "guidance_scale": 3.0},
    })
    rng = np.random.default_rng(0)

    def field(c):
        return rng.normal(size=(2, 64, 64, c)).astype(np.float32)

    train = [{"x": field(1), "sdf": np.abs(field(1)), "cond_img": field(2),
              "lsm_cond": field(2), "topo_cond": field(2),
              "y": rng.integers(1, 5, size=(2,)).astype(np.int32)} for _ in range(2)]
    gen = {"prcp_hr": field(1), "prcp_lr": field(1), "temp_lr": field(1), "lsm": field(2),
           "topo": field(2), "classifier": np.array([1, 3], np.int32)}
    pipe = TrainingPipeline(cfg, train, device=cuda, gen_loader=[gen])
    assert pipe.capture

    def preview(capture=False):
        return pipe.generate_previews(rng=torch.Generator(cuda).manual_seed(5), capture=capture)

    pipe.train_batches(2)
    k1.clear_packs()
    first = preview(capture=True)
    assert k1.stale_packs() == 0
    pipe.train_batches(2)
    assert k1.stale_packs() > 0
    graph = preview(capture=True)
    k1.clear_packs()  # the reference packs the weights afresh
    eager = preview()
    assert pipe.state.step == 4 and graph.shape == (2, 64, 64) and np.isfinite(graph).all()
    assert np.array_equal(graph, eager)
    assert not np.array_equal(first, graph)

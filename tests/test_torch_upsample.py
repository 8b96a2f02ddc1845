"""Torch port: the 2x bilinear upsample's dispatcher, the kernel's arithmetic and
its route through the UNet, on the CPU (the kernel itself is held against the
plain version in ``tests/test_torch_cuda.py``)."""

import pytest
import torch

from sbgm_danra_tpu_torch import capture
from sbgm_danra_tpu_torch.models import unet
from sbgm_danra_tpu_torch.models.unet import DecoderBlock, ModelSpec, build_score_model
from sbgm_danra_tpu_torch.ops import upsample as up
from sbgm_danra_tpu_torch.ops.upsample import upsample2x, upsample2x_bilinear

SHAPES = [(2, 19, 25, 64), (1, 1, 7, 8), (1, 5, 1, 16), (3, 4, 4, 512), (2, 3, 5, 3)]
DTYPES = [torch.bfloat16, torch.float32]


def _x(shape, dtype, seed=0):
    """Normal values scaled by powers of two from 2^-20 to 2^20, so that the
    products and sums round at every exponent."""
    g = torch.Generator().manual_seed(seed)
    scale = torch.exp2(torch.randint(-20, 21, shape, generator=g).float())
    return (torch.randn(shape, generator=g) * scale).to(dtype)


def one_pass(x: torch.Tensor) -> torch.Tensor:
    """The kernel's order of operations (``csrc/upsample2x.cu``) in plain torch:
    for each input pixel, the H pass 0.25 a + 0.75 m of its clamped row
    neighbours at the columns j-1, j, j+1, then the W pass of those values into
    the 2x2 output quad, each product and sum rounded to fp32 on its own, one
    rounding to x's dtype at the end."""
    n, h, w, c = x.shape
    xf = x.float()
    rows, cols = torch.arange(h), torch.arange(w)

    def tap(a, m):
        return 0.25 * a + 0.75 * m

    def w_pass(hp):
        return (tap(hp[:, :, (cols - 1).clamp(min=0)], hp),
                tap(hp[:, :, (cols + 1).clamp(max=w - 1)], hp))

    even = w_pass(tap(xf[:, (rows - 1).clamp(min=0)], xf))
    odd = w_pass(tap(xf[:, (rows + 1).clamp(max=h - 1)], xf))
    quad = torch.stack([torch.stack(even, dim=3), torch.stack(odd, dim=3)], dim=2)
    return quad.reshape(n, 2 * h, 2 * w, c).to(x.dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", SHAPES)
def test_kernel_arithmetic_equals_the_plain_version(shape, dtype):
    """The one-pass quad, in the kernel's order, is the two-axis chain bit for bit."""
    x = _x(shape, dtype)
    assert torch.equal(one_pass(x), upsample2x_bilinear(x))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", SHAPES[:3])
def test_dispatcher_takes_the_plain_version_on_the_cpu(shape, dtype):
    x = _x(shape, dtype, seed=1)
    before = up.launches
    assert torch.equal(upsample2x(x), upsample2x_bilinear(x))
    assert up.launches == before


def test_kernel_entry_refuses_cpu_tensors():
    with pytest.raises(ValueError, match="needs a CUDA tensor"):
        up.upsample2x_cuda(torch.zeros(1, 2, 2, 8))


def test_replays_add_their_launches():
    before = up.launches
    up.count_replay({"upsample2x": 15})
    up.count_replay({"conv3x3_stats": 8})
    assert up.launches == before + 15
    up.launches = before


def test_kernel_names_maps_every_wrapper_key():
    assert capture.kernel_names({"k1/conv3x3_stats": 8, "k1/gn_apply": 8, "k2/fwd/tc_bf16": 1,
                                 "k2/bwd/fp32": 2, "up/upsample2x": 5}) == {
        "conv3x3_stats": 8, "gn_apply": 8, "flash_attention_fwd_tc_bf16": 1,
        "flash_attention_bwd_fp32": 2, "upsample2x": 5}


@pytest.fixture
def spy(monkeypatch):
    """The UNet's calls of the dispatcher, by input shape."""
    calls = []

    def counted(x):
        calls.append(tuple(x.shape))
        return upsample2x(x)

    monkeypatch.setattr(unet, "upsample2x", counted)
    return calls


@pytest.mark.parametrize("train", [False, True])
def test_decoder_block_takes_the_dispatcher_only_in_evaluation(spy, train):
    block = DecoderBlock(16, 8, time_embedding=16, gn_groups=4)
    fmap = torch.randn(2, 16, 3, 5)
    with torch.backends.mkldnn.flags(enabled=False):
        out = block(fmap, torch.randn(2, 8, 6, 10), torch.rand(2), train=train)
    assert out.shape == (2, 8, 6, 10)
    assert spy == ([] if train else [(2, 3, 5, 16)])


@pytest.mark.parametrize("train", [False, True])
def test_score_unet_upsamples_five_times_an_evaluation(spy, train):
    """Decoder blocks 0-3 and the final block each upsample once: through the
    dispatcher in evaluation, never in training."""
    spec = ModelSpec(in_channels=6, num_classes=4, last_fmap_channels=64, time_embedding=32,
                     num_heads=2, block_layers=(1, 1, 1, 1))
    model = build_score_model(spec, generator=torch.Generator().manual_seed(0))
    g = torch.Generator().manual_seed(1)
    x = torch.randn(2, 32, 32, 1, generator=g)
    cond = {"y": torch.tensor([1, 2]), "cond_img": torch.randn(2, 32, 32, 2, generator=g),
            "lsm_cond": torch.randn(2, 32, 32, 2, generator=g),
            "topo_cond": torch.randn(2, 32, 32, 2, generator=g)}
    with torch.no_grad(), torch.backends.mkldnn.flags(enabled=False):
        model(x, torch.full((2,), 0.5), **cond, train=train)
    assert spy == ([] if train else [(2, 1, 1, 64), (2, 2, 2, 32), (2, 4, 4, 16), (2, 8, 8, 8),
                                     (2, 16, 16, 8)])

"""Torch port: CorrDiff's standalone GroupNorm on NHWC (``fused_conv_gn.group_norm_cuda``:
``group_norm_stats`` then ``group_norm_apply``, ``csrc/conv3x3_gn.cu``) and its route in
``models/songunet.py``.

On the CPU: the route (the CPU and ``train=True`` routes are ``F.group_norm`` in fp32, bit
for bit what the model computed before the kernels), the launch counter's arithmetic, the
kernels' names, the statistics' plain version. On the card (marked ``cuda``, skipped
elsewhere) the kernels against ``F.group_norm``, CorrDiff on the card against the
benchmark's plain reference, and the counts inside a captured graph. The card machine has no
JAX and this file imports none:

    python -m pytest tests/test_torch_group_norm.py --noconftest -q
"""

import copy
import json
import re
from pathlib import Path

import pytest
import torch
import torch.nn.functional as F

from sbgm_danra_tpu_torch import capture
from sbgm_danra_tpu_torch.models import songunet
from sbgm_danra_tpu_torch.models.songunet import CorrDiff, GroupNorm, SongUNetSpec, UNetBlock
from sbgm_danra_tpu_torch.ops import fused_conv_gn as k1
from sbgm_danra_tpu_torch.ops import launches

ROOT = Path(__file__).resolve().parents[1]
FULL = json.loads((ROOT / "portbench" / "configs" / "corrdiff-448.json").read_text())
EPS = songunet.GN_EPS


def _spec(cfg: dict, dtype: str) -> SongUNetSpec:
    m = cfg["model"]
    return SongUNetSpec(
        cond_channels=m["cond_channels"], img_resolution=m["img_resolution"],
        model_channels=m["model_channels"], channel_mult=tuple(m["channel_mult"]),
        num_blocks=m["num_blocks"], attn_resolutions=tuple(m["attn_resolutions"]),
        compute_dtype=dtype)


def _tiny_config() -> dict:
    cfg = copy.deepcopy(FULL)
    cfg["model"].update(img_resolution=16, model_channels=16, channel_mult=[1, 2],
                        num_blocks=1, attn_resolutions=[8], compute_dtype="float32")
    return cfg


def _standalone_norms(net) -> int:
    """GroupNorms a net evaluation runs on their own: every block's GN0, every
    attention's GN2, the output's (GN1 is K1's)."""
    blocks = [m for m in net.modules() if isinstance(m, UNetBlock)]
    return len(blocks) + sum(b.attention for b in blocks) + 1


def _f_group_norm(x, gamma, beta, groups, activation):
    """F.group_norm (+ SiLU) of NHWC ``x`` in fp32, NHWC."""
    y = F.group_norm(x.float().permute(0, 3, 1, 2), groups, gamma.float(), beta.float(), EPS)
    return (F.silu(y) if activation == "silu" else y).permute(0, 2, 3, 1)


# ---------------------------------------------------------------------------
# CPU


@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("silu", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cpu_and_train_routes_are_f_group_norm(dtype, silu, train):
    """Off the kernels' route, a GroupNorm is ``F.group_norm`` of the fp32
    map cast to the compute dtype, then SiLU where asked: bit for bit the
    model's arithmetic before the kernels (GN0 and the output's norm took
    ``F.silu`` of the module's result)."""
    g = torch.Generator().manual_seed(1)
    x = (torch.randn(2, 5, 6, 48, generator=g) * 3 + 1).to(dtype)
    x = x.permute(0, 3, 1, 2)  # NCHW view of channels-last memory, as the model holds maps
    norm = GroupNorm(48, dtype, silu=silu)
    with torch.no_grad():
        norm.weight.copy_(1 + 0.2 * torch.randn(48, generator=g))
        norm.bias.copy_(0.2 * torch.randn(48, generator=g))
        want = F.group_norm(x.float(), 12, norm.weight, norm.bias, EPS).to(dtype)
        want = F.silu(want) if silu else want
        assert torch.equal(norm(x, train), want)
    assert not songunet.uses_kernels(x.device, train)


def test_kernels_only_on_the_card_in_evaluation(monkeypatch):
    """The route rule: the kernels on a CUDA device with ``train`` False, else
    ``F.group_norm``; a CPU evaluation never calls the kernels' entry."""
    assert songunet.uses_kernels(torch.device("cuda"), False)
    assert songunet.uses_kernels("cuda:1", False)
    assert not songunet.uses_kernels(torch.device("cuda"), True)
    assert not songunet.uses_kernels(torch.device("cpu"), False)

    def refuse(*a, **k):
        raise AssertionError("a CPU tensor reached the GroupNorm kernels")

    monkeypatch.setattr(songunet, "group_norm_cuda", refuse)
    with torch.no_grad():
        GroupNorm(16, silu=True)(torch.randn(1, 16, 4, 4))


def test_published_nets_run_62_group_norms_an_evaluation():
    """At the published widths (on the meta device, the plain route) one
    evaluation of a net calls 62 standalone GroupNorms: 55 blocks' GN0, 6
    attentions' GN2, the output's; a residual replay of 34 evaluations holds
    2,108 ``group_norm`` launches."""
    with torch.device("meta"):
        net = CorrDiff(_spec(FULL, "bfloat16"))
    calls = []
    for m in net.residual.modules():
        if isinstance(m, GroupNorm):
            m.register_forward_hook(lambda *a: calls.append(1))
    with torch.device("meta"), torch.no_grad():
        x = torch.empty(1, 448, 448, 1)
        cond = {k: torch.empty(1, 448, 448, 2) for k in ("cond_img", "lsm_cond", "topo_cond")}
        net.denoise(x, torch.ones(1), **cond, train=True)
    assert len(calls) == _standalone_norms(net.residual) == 62
    assert 34 * len(calls) == 2108


def _kernels(source: str) -> dict:
    """``__global__`` function name -> its body, from a CUDA source."""
    out = {}
    for m in re.finditer(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s+)?(\w+)\s*\(",
                         source):
        body = source[source.index("{", m.end()):]
        depth = 0
        for i, ch in enumerate(body):
            depth += {"{": 1, "}": -1}.get(ch, 0)
            if depth == 0:
                out[m.group(1)] = body[:i + 1]
                break
    return out


def test_kernel_names_stay_apart_from_k1s():
    """The profiler bills kernels by name: the NHWC GroupNorm's two kernels
    hold neither ``conv3x3_stats`` nor ``gn_apply`` (K1's roofline readers'
    substrings), K1's kernels still hold theirs, and the two normalise
    kernels share one body (``normalise``), not copies of it."""
    kernels = _kernels(k1.SOURCE.read_text())
    mine = {"group_norm_stats_kernel", "group_norm_apply_kernel"}
    assert mine <= set(kernels)
    for name in mine:
        assert "conv3x3_stats" not in name and "gn_apply" not in name
    assert {"conv3x3_stats_tc_kernel", "conv3x3_stats_tf32_kernel", "gn_apply_kernel"} <= set(
        kernels)
    for name in ("gn_apply_kernel", "group_norm_apply_kernel"):
        assert re.fullmatch(r"\{\s*normalise<T, ACT>\([^;]*\);\s*\}", kernels[name]), name
    assert "finish_statistics(" in kernels["group_norm_stats_kernel"]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape, groups", [((2, 5, 7, 64), 16), ((3, 4, 3, 30), 6)])
def test_plain_statistics_with_the_plain_normalise_are_group_norm(shape, groups, dtype):
    """``plain_group_norm_stats`` then ``plain_gn_apply`` (the kernels' plain
    versions: one-pass variance) against ``F.group_norm`` in fp32, float32
    rounding apart (2e-5 of the largest value)."""
    g = torch.Generator().manual_seed(2)
    x = (torch.randn(*shape, generator=g) + 0.5).to(dtype)
    c = shape[-1]
    gamma, beta = 1 + 0.1 * torch.randn(c, generator=g), 0.1 * torch.randn(c, generator=g)
    stats = k1.plain_group_norm_stats(x, groups)
    assert stats.shape == (shape[0], groups, 2) and stats.dtype == torch.float32
    for act in (False, "silu"):
        got = k1.plain_gn_apply(x, stats, gamma, beta, groups, EPS, act, out_dtype=torch.float32)
        want = _f_group_norm(x, gamma, beta, groups, act)
        assert (got - want).abs().max() <= 2e-5 * want.abs().max()


def test_stats_launch_shape():
    """One wave of 4 blocks an SM over (sample, 64-channel tile); no more
    blocks than trips of a block's pixel rows (32 a trip in bf16, 16 in
    fp32, 4 on the element path)."""
    assert k1.stats_slots(8, 448 * 448, 128, 2) == 4 * 132 // 16 == 33
    assert k1.stats_slots(8, 448 * 448, 384, 2) == 4 * 132 // 48 == 11
    assert k1.stats_slots(8, 28 * 28, 512, 2) == 8
    assert k1.stats_slots(1, 28 * 28, 512, 2) == 25  # 784 pixels, 32 a trip
    assert k1.stats_slots(1, 28 * 28, 512, 4) == 49  # 16 a trip in fp32
    assert k1.stats_slots(2, 9, 30, 2) == 3  # element path: 4 pixels a trip
    assert k1.stats_slots(4096, 64, 4096, 2) == 1


def test_group_norm_kernels_refuse_cpu_tensors():
    x, v = torch.zeros(1, 4, 4, 8), torch.ones(8)
    for call in (lambda: k1.group_norm_cuda(x, v, v, 2),
                 lambda: k1.group_norm_stats(x, 2),
                 lambda: k1.group_norm_apply(x, torch.zeros(1, 2, 2), v, v, 2)):
        with pytest.raises(ValueError, match="CUDA"):
            call()


# ---------------------------------------------------------------------------
# the card


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


CASES = {  # name: (x [N, H, W, C], groups, mean of x)
    "corrdiff_448": ((8, 448, 448, 128), 32, 0.0),  # the largest GN0 map
    "corrdiff_448_cpg12": ((8, 448, 448, 384), 32, 0.0),  # a decoder block's GN0, 12 a group
    "corrdiff_28": ((8, 28, 28, 512), 32, 0.0),  # the attention resolution
    "ragged_72": ((3, 37, 41, 72), 8, 0.0),  # vectors; a second channel tile of 8
    "scalar_30": ((3, 37, 41, 30), 6, 0.0),  # C off the vector: the element path
    "mean_4_std": ((2, 96, 80, 256), 32, 4.0),  # group mean 4x its standard deviation
}


@pytest.mark.cuda
@pytest.mark.parametrize("activation", [False, "silu"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("case", list(CASES))
def test_kernels_match_f_group_norm(cuda, case, dtype, activation):
    """``group_norm_cuda`` against ``F.group_norm`` (+ SiLU) in fp32 on the
    same input, with K1's tolerances (bf16 2e-2, fp32 1e-4 of the largest
    value); the statistics within 1e-5 of the plain version's; a repeat bit
    for bit; one ``group_norm`` and one ``group_norm_stats`` launch counted,
    none of K1's."""
    shape, groups, mean = CASES[case]
    c = shape[-1]
    g = torch.Generator(cuda).manual_seed(3)
    x = (mean + torch.randn(shape, generator=g, device=cuda)).to(dtype)
    gamma = 1.0 + 0.1 * torch.randn(c, generator=g, device=cuda)
    beta = 0.1 * torch.randn(c, generator=g, device=cuda)
    before = launches.snapshot()
    got = k1.group_norm_cuda(x, gamma, beta, groups, EPS, activation)
    assert launches.since(before) == {"group_norm": 1, "group_norm_stats": 1}
    assert got.dtype == dtype and got.shape == x.shape and got.is_contiguous()
    assert torch.equal(k1.group_norm_cuda(x, gamma, beta, groups, EPS, activation), got)
    want = _f_group_norm(x, gamma, beta, groups, activation)
    tol = 2e-2 if dtype == torch.bfloat16 else 1e-4 * want.abs().max().item()
    assert (got.float() - want).abs().max().item() <= tol
    del want
    stats, plain = k1.group_norm_stats(x, groups), k1.plain_group_norm_stats(x, groups)
    assert (stats - plain).abs().max() <= 1e-5 * plain.abs().max()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_unaligned_map_takes_the_element_path(cuda, dtype):
    """x 8 bytes off a 16-byte boundary (a channel count on the vector): the
    element loads, within the same tolerances."""
    g = torch.Generator(cuda).manual_seed(4)
    x = torch.randn(2, 19, 23, 64, generator=g, device=cuda).to(dtype)
    shift = 8 // x.element_size()
    x_off = torch.empty(x.numel() + shift, dtype=dtype, device=cuda)[shift:].view(x.shape)
    x_off.copy_(x)
    assert x_off.data_ptr() % 16 == 8
    gamma, beta = torch.ones(64, device=cuda), torch.zeros(64, device=cuda)
    got = k1.group_norm_cuda(x_off, gamma, beta, 16, EPS, "silu")
    want = _f_group_norm(x, gamma, beta, 16, "silu")
    tol = 2e-2 if dtype == torch.bfloat16 else 1e-4 * want.abs().max().item()
    assert (got.float() - want).abs().max().item() <= tol


@pytest.mark.cuda
def test_no_backward_through_the_kernels(cuda):
    x = torch.randn(1, 4, 4, 16, device=cuda, requires_grad=True)
    v = torch.ones(16, device=cuda)
    with pytest.raises(NotImplementedError, match="no backward"):
        k1.group_norm_cuda(x, v, v, 4).sum().backward()


@pytest.mark.cuda
def test_corrdiff_on_the_card_takes_the_kernels(cuda):
    """A tiny CorrDiff on the card: every standalone GroupNorm of an
    evaluation is one ``group_norm`` and one ``group_norm_stats`` launch; the fp32 nets agree with their
    CPU run (F.group_norm, the plain chain) to 2e-4 of the largest value, and
    the bf16 denoiser with the benchmark's fp32 reference within the CPU
    test's 3% relative L2 (``tests/test_torch_corrdiff.py``); ``generate``'s
    sampler graph records 34 evaluations' ``group_norm`` launches per replay
    beside K1's; ``train=True`` takes ``F.group_norm``, with gradients."""
    from portbench.reference import corrdiff as ref
    from portbench.reference.unet import exact
    from sbgm_danra_tpu_torch.evaluate.corrdiff import generate
    from sbgm_danra_tpu_torch.models.songunet import build_corrdiff

    cfg = _tiny_config()
    weights = ref.make_weights(cfg, 2**31 + 20, "cpu")
    nets = {}
    for dtype, dev in (("float32", "cpu"), ("float32", cuda), ("bfloat16", cuda)):
        net = build_corrdiff(_spec(cfg, dtype))
        net.load_state_dict(weights)
        nets[dtype, str(dev)] = net.to(dev)
    cpu, card, card_bf16 = nets.values()
    g = torch.Generator().manual_seed(5)
    cond = {k: torch.randn(2, 16, 16, 2, generator=g) for k in ("cond_img", "lsm_cond",
                                                                "topo_cond")}
    on_card = {k: v.to(cuda) for k, v in cond.items()}
    x, sigma = torch.randn(2, 16, 16, 1, generator=g), torch.tensor([3.0, 0.02])
    norms = _standalone_norms(card.residual)
    with exact(), torch.no_grad():
        before = launches.snapshot()
        got = card.denoise(x.to(cuda), sigma.to(cuda), **on_card)
        blocks = sum(isinstance(m, UNetBlock) for m in card.residual.modules())
        ran = launches.since(before)
        assert (ran["group_norm"], ran["group_norm_stats"], ran["gn_apply"]) == (norms, norms,
                                                                                 blocks)
        want = cpu.denoise(x, sigma, **cond)
        assert (got.cpu() - want).abs().max() <= 2e-4 * want.abs().max()
        mean = card.mean(**on_card).cpu()
        assert (mean - cpu.mean(**cond)).abs().max() <= 2e-4 * mean.abs().max()
        residual = ref.SongUNet(weights, "residual", cfg)
        for i, s in enumerate(sigma.tolist()):
            row = {k: v[i:i + 1] for k, v in cond.items()}
            d = card_bf16.denoise(x[i:i + 1].to(cuda), sigma[i:i + 1].to(cuda),
                                  **{k: v.to(cuda) for k, v in row.items()}).cpu()
            r = ref.denoise(residual, x[i:i + 1], s, row)
            assert ((d - r).norm() / r.norm()).item() < 0.03
        date = {k: v[:1] for k, v in on_card.items()}
        for seed in (6, 7):
            generate(card_bf16, date, 2, torch.Generator(cuda).manual_seed(seed))
    graph = [s for s in capture.stats() if s["name"].startswith("edm_sampler 2x16x16x1")][-1]
    per = graph["launches_per_replay"]
    assert per["group_norm"] == per["group_norm_stats"] == 34 * norms
    assert per["gn_apply"] == 34 * blocks
    assert graph["replays"] >= 2
    before = launches.snapshot()
    out = card.denoise(x.to(cuda), sigma.to(cuda), **on_card, train=True)
    out.sum().backward()
    ran = launches.since(before)
    assert ran["group_norm"] == ran["group_norm_stats"] == 0
    assert card.residual.dec["16x16_aux_norm"].weight.grad is not None

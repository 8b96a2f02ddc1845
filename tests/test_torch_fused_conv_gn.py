"""Torch port: K1 (fused conv3x3 + GroupNorm) and the decoder block it serves,
against the JAX package on the CPU.

On the CPU the port's ``conv3x3_gn_relu`` is its plain version
(``reference_chain``); the JAX side runs the Pallas kernel in interpret mode,
as ``tests/test_fused_conv_gn.py`` does. The CUDA kernels themselves are held
against the plain version on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sbgm_danra_tpu.models.unet import DecoderBlock as JaxDecoderBlock
from sbgm_danra_tpu.ops import fused_conv_gn as jax_k1
from sbgm_danra_tpu_torch.convert import state_dict_from_flax
from sbgm_danra_tpu_torch.models.unet import DecoderBlock
from sbgm_danra_tpu_torch.ops import fused_conv_gn as k1
from sbgm_danra_tpu_torch.ops import launches
from profile_port import CHAINS_128, CHAINS_FULL, K1_RAGGED
from tests.torch_parity import random_variables, rel_err

# the shapes of tests/test_fused_conv_gn.py (cout = 2 cin), and a decoder chain
CASES = [
    ((2, 16, 16, 8), 16, 4),
    ((1, 32, 24, 16), 32, 8),
    ((3, 8, 8, 32), 64, 8),
    ((2, 8, 8, 64), 64, 8),
]


def _inputs(shape, cout, seed):
    rng = np.random.default_rng(seed)
    cin = shape[-1]
    return (
        rng.normal(size=shape).astype(np.float32),
        (0.1 * rng.normal(size=(3, 3, cin, cout))).astype(np.float32),
        (0.05 * rng.normal(size=(cout,))).astype(np.float32),
        (1.0 + 0.1 * rng.normal(size=(cout,))).astype(np.float32),
        (0.1 * rng.normal(size=(cout,))).astype(np.float32),
    )


class TestConv3x3GN:
    @pytest.mark.parametrize("activation", [True, False], ids=["relu", "no_act"])
    @pytest.mark.parametrize("shape, cout, groups", CASES, ids=lambda c: str(c))
    def test_fp32_matches_jax_kernel_and_chain(self, shape, cout, groups, activation):
        """fp32, 2e-5 abs + 2e-5 rel, the JAX kernel test's own tolerance:
        only the summation order of the conv and the statistics differs."""
        args = _inputs(shape, cout, seed=sum(shape) + cout)
        got = k1.conv3x3_gn_relu(*map(torch.from_numpy, args), groups=groups,
                                 activation=activation).numpy()
        jargs = [jnp.asarray(a) for a in args]
        pallas = jax_k1.conv3x3_gn_relu(*jargs, groups, activation=activation, interpret=True)
        chain = jax_k1.reference_chain(*jargs, groups, activation=activation)
        assert got.shape == (*shape[:3], cout)
        for want in (pallas, chain):
            np.testing.assert_allclose(got, np.asarray(want), atol=2e-5, rtol=2e-5)
        if not activation:
            assert got.min() < 0

    def test_bf16_matches_jax_kernel(self):
        """bf16 in and out on both sides; both round the conv output to bf16
        before normalising and the result once more: 2e-2 abs (the outputs
        are O(1); half a bf16 ulp near 4 is 1.6e-2). oneDNN off (ROADMAP
        F5)."""
        args = _inputs((2, 8, 8, 64), 64, seed=7)
        with torch.backends.mkldnn.flags(enabled=False):
            got = k1.conv3x3_gn_relu(*(torch.from_numpy(a).bfloat16() for a in args),
                                     groups=8, activation=False)
        want = jax_k1.conv3x3_gn_relu(*(jnp.asarray(a, jnp.bfloat16) for a in args), 8,
                                      activation=False, interpret=True)
        assert got.dtype == torch.bfloat16
        diff = np.abs(got.float().numpy() - np.asarray(want, np.float32))
        assert diff.max() <= 2e-2

    def test_cpu_tensor_takes_the_plain_version(self):
        args = [torch.from_numpy(a) for a in _inputs((2, 8, 8, 16), 16, seed=3)]
        before = launches.snapshot()
        got = k1.conv3x3_gn_relu(*args, groups=4, activation=False)
        torch.testing.assert_close(got, k1.reference_chain(*args, groups=4, activation=False),
                                   rtol=0, atol=0)
        assert not launches.since(before)

    def test_kernel_entry_point_refuses_cpu_tensors(self):
        args = [torch.from_numpy(a) for a in _inputs((1, 8, 8, 8), 8, seed=4)]
        with pytest.raises(ValueError, match="needs CUDA tensors"):
            k1.conv3x3_gn_cuda(*args, groups=4)

    @pytest.mark.parametrize("bad, match", [
        (dict(groups=3), "not divisible"),
        (dict(kernel=np.zeros((3, 3, 5, 16), np.float32)), "HWIO"),
        (dict(gamma=np.ones(8, np.float32)), "gamma"),
    ])
    def test_rejects_bad_arguments(self, bad, match):
        x, kernel, bias, gamma, beta = _inputs((1, 8, 8, 8), 16, seed=5)
        kw = dict(x=x, kernel=kernel, bias=bias, gamma=gamma, beta=beta)
        kw.update({k: v for k, v in bad.items() if k != "groups"})
        with pytest.raises(ValueError, match=match):
            k1.reference_chain(**{k: torch.from_numpy(v) for k, v in kw.items()},
                               groups=bad.get("groups", 4))

    def test_backward_raises(self):
        with pytest.raises(NotImplementedError, match="no backward"):
            k1._Conv3x3GN.backward(None, torch.zeros(1))


# the decoder chains of one flagship UNet evaluation (128 px at batch 16,
# 608x800 at batch 2) and the shapes off every tile, chunk and Cout tile, as
# the card's measurements take them
PLAN_SHAPES = ([(16, c) for c in dict.fromkeys(CHAINS_128)]
               + [(2, c) for c in dict.fromkeys(CHAINS_FULL)]
               + K1_RAGGED + [(26, (64, 64, 64, 64)), (3, (19, 13, 16, 8))])
# where the sweep on the card found resident weights faster: Cin <= 128 and
# at least three tiles a block
RESIDENT = {(2, (152, 200, 128, 128)), (2, (304, 400, 64, 64)), (26, (64, 64, 64, 64))}


def _coverage(p, h, w):
    """How often each output pixel of one (sample, Cout tile) is computed by
    the plan's blocks: block ``slot`` walks tiles slot, slot + slots, ..."""
    th, tw = p.tile
    tiles_x = -(-w // tw)
    n_tiles = tiles_x * -(-h // th)
    count = np.zeros((h, w), np.int64)
    for slot in range(p.grid[0]):
        for tile in range(slot, n_tiles, p.grid[0]):
            y0, x0 = (tile // tiles_x) * th, (tile % tiles_x) * tw
            count[y0:y0 + th, x0:x0 + tw] += 1
    return count


class TestPlan:
    @pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "fp32"])
    @pytest.mark.parametrize("n, chain", PLAN_SHAPES, ids=lambda v: str(v))
    def test_plan_covers_the_output_once_within_shared_memory(self, n, chain, dtype):
        h, w, cin, cout = chain
        p = k1.plan(n, h, w, cin, cout, dtype)
        assert p.shared_bytes <= k1.MAX_SHARED_BYTES == 232_448
        assert (_coverage(p, h, w) == 1).all()
        slots, cout_tiles, batch = p.grid
        assert batch == n and 1 <= slots
        # 64-channel Cout tiles cover every channel exactly once
        assert (cout_tiles - 1) * 64 < cout <= cout_tiles * 64
        assert p.threads <= 1024 and p.blocks_per_sm >= 1
        if dtype == torch.float32:
            # 3xTF32 on the tensor cores: 8-channel chunks, split weights
            # streamed, the bf16 plan's tile; three stages of the split halo and
            # weights, the warps' channel sums and three copy barriers
            assert (p.variant, p.mma, p.chunk, p.stages) == ("stream", "tf32x3", 8, 3)
            assert p.tile == k1.plan(n, h, w, cin, cout, torch.bfloat16).tile
            assert p.threads == p.tile[0] * p.tile[1]
            halo = (p.tile[0] + 2) * (p.tile[1] + 2)
            assert p.shared_bytes == 4 * (3 * (2 * 8 * halo + 9 * 2 * 8 * 64)
                                          + p.threads // 32 * 64 * 2) + 3 * 8
            return
        assert p.mma == "wgmma" and p.stages == 3 and p.chunk in (16, 32)
        assert p.tile in ((16, 16), (8, 16)) and p.threads == p.tile[0] * p.tile[1]
        assert p.variant == ("ws" if (n, chain) in RESIDENT else "stream")
        if p.variant == "ws":
            assert cin <= 128
        # the bytes the kernel lays out: resident weights, three stages, output
        # staging (144-byte rows) and the warps' channel sums
        warps = p.threads // 32
        halo = (p.tile[0] + 2) * (p.tile[1] + 2) * p.chunk
        cin_pad = -(-cin // 32) * 32
        elems = (9 * cin_pad * 64 + 3 * halo if p.variant == "ws"
                 else 3 * (halo + 9 * p.chunk * 64))
        assert p.shared_bytes == 2 * (elems + warps * 32 * 72) + warps * 64 * 2 * 4 + 4 * 8

    def test_small_maps_take_the_small_tile(self):
        assert k1.plan(16, 8, 8, 512, 512, torch.bfloat16).tile == (8, 16)
        assert k1.plan(16, 16, 16, 256, 256, torch.bfloat16).tile == (8, 16)
        assert k1.plan(2, 304, 400, 64, 64, torch.bfloat16).tile == (16, 16)

    def test_forced_plans_and_what_does_not_fit(self):
        p = k1.plan(2, 152, 200, 128, 128, torch.bfloat16, force=(8, 16, 32, 1))
        assert (p.variant, p.tile, p.chunk) == ("ws", (8, 16), 32)
        for force in ((16, 16, 16, 0), (8, 16, 16, 0), (8, 16, 16, 1)):
            # tried on the card and not kept: plan never picks them, so no kernel is built
            with pytest.raises(ValueError, match="no kernel"):
                k1.plan(2, 38, 50, 512, 512, torch.bfloat16, force=force)
        with pytest.raises(ValueError, match="shared memory"):  # 295 KB of weights
            k1.plan(2, 38, 50, 256, 256, torch.bfloat16, force=(16, 16, 32, 1))
        with pytest.raises(ValueError, match="shared memory"):
            k1.plan(2, 152, 200, 128, 128, torch.bfloat16, force=(16, 16, 32, 1))
        with pytest.raises(ValueError, match="no kernel"):
            k1.plan(2, 38, 50, 64, 64, torch.bfloat16, force=(8, 8, 32, 0))
        with pytest.raises(ValueError, match="no kernel"):  # a bf16 shape in fp32
            k1.plan(2, 38, 50, 64, 64, torch.float32, force=(16, 16, 32, 0))
        for force in k1.FP32_LAUNCH_SHAPES:
            p = k1.plan(2, 38, 50, 512, 512, torch.float32, force=force)
            assert (p.tile, p.chunk, p.mma) == (tuple(force[:2]), 8, "tf32x3")
        with pytest.raises(ValueError, match="no kernel"):  # the fp32 kernel streams its weights
            k1.plan(2, 38, 50, 16, 16, torch.float32, force=(16, 16, 8, 1))
        with pytest.raises(TypeError, match="not supported"):
            k1.plan(2, 38, 50, 64, 64, torch.float16)
        with pytest.raises(ValueError, match="unsupported shape"):
            k1.plan(0, 38, 50, 64, 64, torch.bfloat16)

    @pytest.mark.parametrize("n, pixels, c, itemsize", [
        (2, 304 * 400, 64, 2), (16, 64, 512, 2), (1, 63, 12, 2), (2, 1881, 72, 4),
        (3, 5, 4096, 2)])
    def test_apply_blocks_cover_every_vector(self, n, pixels, c, itemsize):
        blocks = k1.apply_blocks(n, pixels, c, itemsize)
        assert 1 <= blocks <= 65535 and blocks * n <= max(n, 16 * 132)


def _split_want(kernel):
    """split_tiled_weights' layout, built element by element from its docstring."""
    _, _, cin, cout = kernel.shape
    w = kernel.double().numpy()
    tiles, chunks = -(-cout // 64), -(-cin // 8)
    want = np.zeros((tiles, 9, chunks, 2, 2, 64, 4), np.float32)
    for t in range(tiles):
        for tap in range(9):
            for o in range(min(64, cout - 64 * t)):
                for c in range(cin):
                    v = np.float32(w[tap // 3, tap % 3, c, 64 * t + o])
                    hi = _round_tf32_np(v)
                    lo = _round_tf32_np(np.float32(v - hi))
                    want[t, tap, c // 8, :, (c % 8) // 4, o, c % 4] = hi, lo
    return torch.from_numpy(want)


def _round_tf32_np(v):
    """Round fp32 to TF32, to nearest, ties away from zero, on the bits."""
    bits = np.asarray(v, np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


class TestPackedWeights:
    def _conv(self, seed, cin=12, cout=24):
        torch.manual_seed(seed)
        return torch.nn.Conv2d(cin, cout, 3, padding=1)

    def test_layout_is_tap_major_then_output_channel(self):
        """The fp32 kernel's split weights: per (Cout tile, tap, 8-channel
        chunk) hi then lo, each [2 groups of 4 channels][64 outputs][4]."""
        kernel = torch.from_numpy(_inputs((1, 4, 4, 12), 24, seed=1)[1])
        split = k1.split_tiled_weights(kernel)
        assert split.dtype == torch.float32 and split.is_contiguous()
        assert split.shape == (1, 9, 2, 2, 2, 64, 4)
        torch.testing.assert_close(split, _split_want(kernel), rtol=0, atol=0)
        assert k1.split_tiled_weights(kernel) is split  # kept
        bf16 = k1.tiled_weights(kernel, torch.bfloat16)  # a copy of its own per kind
        assert k1.split_tiled_weights(kernel) is split and k1.tiled_weights(
            kernel, torch.bfloat16) is bf16

    @pytest.mark.parametrize("cin, cout", [(12, 24), (64, 64), (200, 72), (40, 136)])
    def test_tiled_layout_is_the_packed_one_cut_into_cout_tiles(self, cin, cout):
        kernel = torch.from_numpy(_inputs((1, 4, 4, cin), cout, seed=2)[1])
        tiled = k1.tiled_weights(kernel, torch.bfloat16)
        packed = kernel.permute(0, 1, 3, 2).reshape(9, cout, cin).bfloat16()
        tiles, cin8 = -(-cout // 64), -(-cin // 32) * 4
        assert tiled.shape == (tiles, 9, cin8, 64, 8) and tiled.is_contiguous()
        want = torch.zeros(9, tiles * 64, cin8 * 8, dtype=torch.bfloat16)
        want[:, :cout, :cin] = packed
        for t in range(tiles):
            for k in range(cin8):
                torch.testing.assert_close(tiled[t, :, k], want[:, 64 * t:64 * t + 64,
                                                                8 * k:8 * k + 8], rtol=0, atol=0)
        assert k1.tiled_weights(kernel, torch.bfloat16) is tiled
        with torch.no_grad():
            kernel.mul_(2.0)
        assert k1.tiled_weights(kernel, torch.bfloat16) is not tiled

    def test_remade_after_load_state_dict_and_in_place_update(self):
        conv = self._conv(0)
        hwio = lambda: conv.weight.permute(2, 3, 1, 0)  # noqa: E731  a fresh view per call
        want = lambda: _split_want(hwio().detach())  # noqa: E731
        first = k1.split_tiled_weights(hwio())
        assert k1.split_tiled_weights(hwio()) is first
        conv.load_state_dict(self._conv(1).state_dict())
        second = k1.split_tiled_weights(hwio())
        assert second is not first
        torch.testing.assert_close(second, want(), rtol=0, atol=0)
        with torch.no_grad():
            conv.weight.mul_(2.0)
        third = k1.split_tiled_weights(hwio())
        torch.testing.assert_close(third, want(), rtol=0, atol=0)
        torch.testing.assert_close(third, 2.0 * second, rtol=0, atol=0)  # exact: a power of 2
        with torch.inference_mode():  # the serving path reads through the same cache
            assert k1.split_tiled_weights(hwio()) is third

    def test_each_parameter_has_its_own_copy_and_it_dies_with_it(self):
        a, b = self._conv(2), self._conv(3)
        pa = k1.split_tiled_weights(a.weight.permute(2, 3, 1, 0))
        pb = k1.split_tiled_weights(b.weight.permute(2, 3, 1, 0))
        assert not torch.equal(pa, pb)
        assert k1.split_tiled_weights(a.weight.permute(2, 3, 1, 0)) is pa
        kept = len(k1._packed)
        del a, pa
        import gc
        gc.collect()
        assert len(k1._packed) == kept - 1

    @pytest.mark.parametrize("cin, cout", [(12, 24), (64, 64), (40, 136)])
    def test_split_is_exact_to_2_pow_minus_22(self, cin, cout):
        """hi has at most 10 mantissa bits (its 13 low bits are zero), lo too,
        and hi + lo equals w to 2^-22 |w|; padding past Cin and Cout is zero."""
        kernel = torch.from_numpy(_inputs((1, 4, 4, cin), cout, seed=cin)[1])
        split = k1.split_tiled_weights(kernel)
        bits = split.view(torch.int32)
        assert ((bits & 0x1FFF) == 0).all()
        hi, lo = split[:, :, :, 0], split[:, :, :, 1]
        w = ((hi.double() + lo.double()).permute(1, 0, 4, 2, 3, 5)  # [9, tiles, 64, k, 2, 4]
             .reshape(9, -1, split.shape[2] * 8))
        want = kernel.double().permute(0, 1, 3, 2).reshape(9, cout, cin)
        assert (w[:, cout:].abs().sum() == 0) and (w[:, :, cin:].abs().sum() == 0)
        assert ((w[:, :cout, :cin] - want).abs() <= 2.0**-22 * want.abs()).all()
        assert (lo.abs() <= 2.0**-11 * hi.abs()).all()

    def test_round_tf32_matches_the_bit_rule_and_rounds_ties_away(self):
        rng = np.random.default_rng(0)
        v = np.concatenate([rng.normal(size=4096).astype(np.float32),
                            np.array([1 + 2**-11, -(1 + 2**-11), 1 + 3 * 2**-11, 0.0, -0.0,
                                      np.float32(3.4e38), np.inf, -np.inf], np.float32)])
        got = k1.round_tf32(torch.from_numpy(v)).numpy()
        np.testing.assert_array_equal(got.view(np.uint32), _round_tf32_np(v).view(np.uint32))
        assert got[4096] == 1 + 2**-10 and got[4097] == -(1 + 2**-10)  # ties away from zero
        assert got[4098] == 1 + 2 * 2**-10

    def test_casts_are_kept_per_parameter_and_fp32_passes_through(self):
        bias = torch.nn.Parameter(torch.randn(24))
        assert k1._as(bias, torch.float32) is bias  # nothing to do
        cast = k1._as(bias, torch.bfloat16)
        assert cast.dtype == torch.bfloat16 and k1._as(bias, torch.bfloat16) is cast
        with torch.no_grad():
            bias.add_(1.0)
        torch.testing.assert_close(k1._as(bias, torch.bfloat16), bias.detach().bfloat16(),
                                   rtol=0, atol=0)

    def test_inference_tensors_are_packed_anew(self):
        with torch.inference_mode():
            kernel = torch.randn(3, 3, 4, 8)
            first = k1.split_tiled_weights(kernel)
            kernel.mul_(4.0)  # no version counter: never served from the cache
            torch.testing.assert_close(k1.split_tiled_weights(kernel), 4.0 * first,
                                       rtol=0, atol=0)


def _block_pair(in_ch, out_ch, norm, seed, hw):
    kw = dict(time_embedding=16, activation="silu", norm=norm, gn_groups=4)
    jax_block = JaxDecoderBlock(out_ch, **kw)
    fmap = jnp.zeros((2, *hw, in_ch))
    abstract = jax.eval_shape(lambda: jax_block.init(
        jax.random.PRNGKey(0), fmap, jnp.zeros((2, 2 * hw[0], 2 * hw[1], out_ch)),
        jnp.ones((2,))))
    variables = random_variables(abstract, seed)
    block = DecoderBlock(in_ch, out_ch, **kw)
    block.load_state_dict(state_dict_from_flax(variables, block))
    return jax_block, variables, block


class TestDecoderBlock:
    @pytest.mark.parametrize("with_skip, with_t", [(True, True), (False, False), (True, False)],
                             ids=["skip_time", "plain", "skip_only"])
    @pytest.mark.parametrize("norm", ["group", "instance"])
    def test_fp32_matches_flax_block(self, norm, with_skip, with_t):
        """The production chain (ROADMAP F1): the JAX DecoderBlock, upsample ->
        conv_up -> norm1 -> conv -> norm2 (+skip, +time) -> SiLU, against the
        port's block, whose two conv -> norm chains are K1 calls without
        activation. Bridged random weights (norm affine included), fp32:
        max |err| <= 1e-4 max |ref|."""
        in_ch, out_ch, hw = 16, 8, (6, 10)
        jax_block, variables, block = _block_pair(in_ch, out_ch, norm, seed=11, hw=hw)
        rng = np.random.default_rng(12)
        fmap = rng.normal(size=(2, *hw, in_ch)).astype(np.float32)
        skip = rng.normal(size=(2, 2 * hw[0], 2 * hw[1], out_ch)).astype(np.float32)
        t = np.array([0.2, 0.9], np.float32)
        want = np.asarray(jax_block.apply(
            variables, jnp.asarray(fmap), jnp.asarray(skip) if with_skip else None,
            jnp.asarray(t) if with_t else None))
        nchw = lambda a: torch.from_numpy(a).permute(0, 3, 1, 2)  # noqa: E731
        with torch.no_grad():
            got = block(nchw(fmap), nchw(skip) if with_skip else None,
                        torch.from_numpy(t) if with_t else None).permute(0, 2, 3, 1).numpy()
        assert got.shape == want.shape == (2, 2 * hw[0], 2 * hw[1], out_ch)
        assert rel_err(got, want) <= 1e-4


def test_pack_cache_goes_stale_on_a_write_and_clears():
    """A cached pack is stale once its parameter is written in place (its
    version counter moves), and ``clear_packs`` empties the cache; the next
    call packs afresh."""
    weight = torch.nn.Parameter(torch.randn(3, 3, 4, 8, generator=torch.Generator().manual_seed(0)))
    made = []

    def pack():
        made.append(weight.detach().clone())
        return made[-1]

    k1.clear_packs()
    assert k1._cached(weight, "probe", pack) is k1._cached(weight, "probe", pack)
    assert len(made) == 1 and k1.stale_packs() == 0
    with torch.no_grad():
        weight.mul_(2.0)
    assert k1.stale_packs() == 1
    assert torch.equal(k1._cached(weight, "probe", pack), 2.0 * made[0])
    assert len(made) == 2 and k1.stale_packs() == 0
    k1.clear_packs()
    assert k1.stale_packs() == 0
    k1._cached(weight, "probe", pack)
    assert len(made) == 3

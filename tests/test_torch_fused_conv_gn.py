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
        before = (k1.conv3x3_stats_launches, k1.gn_apply_launches)
        got = k1.conv3x3_gn_relu(*args, groups=4, activation=False)
        torch.testing.assert_close(got, k1.reference_chain(*args, groups=4, activation=False),
                                   rtol=0, atol=0)
        assert (k1.conv3x3_stats_launches, k1.gn_apply_launches) == before

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

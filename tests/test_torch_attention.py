"""Torch port: flash attention (plain version, dispatcher, CUDA entry point) and
SpatialSelfAttention against the JAX package."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sbgm_danra_tpu.models.attention import SpatialSelfAttention as JaxAttention
from sbgm_danra_tpu.ops import flash_attention as jax_fa
from sbgm_danra_tpu.ops.pallas_attention import pallas_flash_attention
from sbgm_danra_tpu_torch.convert import state_dict_from_flax
from sbgm_danra_tpu_torch.models.attention import SpatialSelfAttention
from sbgm_danra_tpu_torch.ops import _nvcc, cuda_attention
from sbgm_danra_tpu_torch.ops import flash_attention as fa
from sbgm_danra_tpu_torch.ops.cuda_attention import (
    _padded_head_dim,
    flash_attention_cuda,
    flash_attention_reference,
)
from tests.torch_parity import random_variables


def _qkv(b=2, s=300, h=2, d=32, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(b, s, h, d)).astype(np.float32) for _ in range(3)]


class TestPlainVersion:
    @pytest.mark.parametrize("s", [300, 1000])
    @pytest.mark.parametrize("d", [24, 32])
    def test_matches_pallas_kernel(self, s, d):
        """The port's plain version against the Pallas kernel (interpreted on
        the CPU) at a ragged S and a padded D. Both accumulate in fp32 in
        different orders: 2e-5, the JAX kernel's own test tolerance."""
        q, k, v = _qkv(s=s, d=d)
        want = np.asarray(pallas_flash_attention(*map(jnp.asarray, (q, k, v)), 256, 256))
        got = flash_attention_reference(*map(torch.from_numpy, (q, k, v))).numpy()
        np.testing.assert_allclose(got, want, atol=2e-5, rtol=2e-5)

    def test_returns_input_dtype(self):
        q, k, v = (torch.from_numpy(a).bfloat16() for a in _qkv(s=64))
        assert flash_attention_reference(q, k, v).dtype == torch.bfloat16


class TestDispatcher:
    def test_cpu_takes_plain_version(self):
        q, k, v = map(torch.from_numpy, _qkv(s=64))
        want = flash_attention_reference(q, k, v)
        torch.testing.assert_close(fa.flash_attention(q, k, v), want, rtol=0, atol=0)

    def test_force_kernel_on_cpu_still_plain(self, monkeypatch):
        monkeypatch.setattr(fa, "_FORCE_KERNEL", True)
        q, k, v = map(torch.from_numpy, _qkv(s=64))
        torch.testing.assert_close(
            fa.flash_attention(q, k, v), flash_attention_reference(q, k, v), rtol=0, atol=0
        )

    def test_dense_matches_plain(self):
        """SDPA (the 'xla' backend and the short-S path) against the plain
        version: same math, fp32, 1e-5."""
        q, k, v = map(torch.from_numpy, _qkv(s=200))
        torch.testing.assert_close(fa.dense_attention(q, k, v),
                                   flash_attention_reference(q, k, v), rtol=1e-5, atol=1e-5)

    @pytest.mark.parametrize(
        "s, forced, route",
        [(4096, False, "kernel"), (7600, False, "kernel"), (4095, False, "dense"),
         (256, True, "kernel")],
    )
    def test_device_routing(self, monkeypatch, s, forced, route):
        """Off the CPU: the kernel at S >= 4096 (or when forced), dense below.
        Meta tensors stand in for CUDA ones; only the routing is under test."""
        calls = []
        monkeypatch.setattr(fa, "flash_attention_cuda", lambda q, k, v: calls.append("kernel") or q)
        monkeypatch.setattr(fa, "dense_attention", lambda q, k, v: calls.append("dense") or q)
        monkeypatch.setattr(fa, "_FORCE_KERNEL", forced)
        q = torch.empty(1, s, 4, 32, device="meta")
        fa.flash_attention(q, q, q)
        assert calls == [route]


class TestCudaEntryPoint:
    def test_raises_on_cpu_tensors(self):
        """The kernel's entry point never computes on the CPU in its stead."""
        q, k, v = map(torch.from_numpy, _qkv(s=64))
        before = cuda_attention.launches
        with pytest.raises(ValueError, match="needs CUDA tensors"):
            flash_attention_cuda(q, k, v)
        assert cuda_attention.launches == before

    def test_build_names_missing_nvcc(self, monkeypatch, tmp_path):
        monkeypatch.setenv("PATH", str(tmp_path))
        monkeypatch.setenv("CUDA_HOME", str(tmp_path))
        monkeypatch.setattr(_nvcc.os.path, "exists", lambda p: False)
        cuda_attention.build_library.cache_clear()
        try:
            with pytest.raises(RuntimeError, match="nvcc not found"):
                cuda_attention.build_library()
        finally:
            cuda_attention.build_library.cache_clear()

    @pytest.mark.parametrize("d, padded", [(8, 32), (24, 32), (32, 32), (33, 64), (128, 128)])
    def test_head_dim_padding(self, d, padded):
        assert _padded_head_dim(d) == padded

    def test_head_dim_above_128_raises(self):
        with pytest.raises(ValueError, match="head_dim 160"):
            _padded_head_dim(160)

    def test_backward_raises(self):
        with pytest.raises(NotImplementedError, match="backward"):
            cuda_attention._FlashAttention.backward(None, torch.zeros(1))


def _jax_attention_variables(channels, heads, seed):
    module = JaxAttention(channels, heads)
    abstract = jax.eval_shape(lambda: module.init(jax.random.PRNGKey(0),
                                                  jnp.zeros((1, 4, 4, channels))))
    return random_variables(abstract, seed)


class TestSpatialSelfAttention:
    @pytest.mark.parametrize("backend", ["xla", "pallas"])
    def test_matches_flax_module(self, monkeypatch, backend):
        """Bridged weights, fp32, |err| <= 1e-5: LayerNorm eps 1e-6 and the
        tanh GELU must match Flax for this to hold. 'pallas' forces the kernel
        path on both sides (Pallas interpreted; the port's plain version)."""
        monkeypatch.setattr(jax_fa, "_FORCE_PALLAS", backend == "pallas")
        monkeypatch.setattr(fa, "_FORCE_KERNEL", backend == "pallas")
        channels, heads = 32, 2
        variables = _jax_attention_variables(channels, heads, seed=3)
        x = np.random.default_rng(4).normal(size=(2, 6, 10, channels)).astype(np.float32)
        want = np.asarray(JaxAttention(channels, heads, backend=backend).apply(
            variables, jnp.asarray(x)))
        module = SpatialSelfAttention(channels, heads, backend)
        module.load_state_dict(state_dict_from_flax(variables, module))
        with torch.no_grad():
            got = module(torch.from_numpy(x)).numpy()
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)

    def test_ring_backend_not_ported(self):
        module = SpatialSelfAttention(8, 2, "ring")
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            module(torch.zeros(1, 2, 2, 8))

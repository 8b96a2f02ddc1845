"""Torch port: flash attention (plain version, dispatcher, CUDA entry point) and
SpatialSelfAttention against the JAX package."""

from types import SimpleNamespace

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
    KernelLayout,
    _padded_head_dim,
    flash_attention_cuda,
    flash_attention_reference,
    kernel_layout,
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

    def test_views_reach_the_kernel_uncopied(self, monkeypatch):
        """The dispatcher hands the model's strided QKV chunks to the kernel as
        they are (the kernel reads them in place)."""
        seen = []
        monkeypatch.setattr(fa, "flash_attention_cuda", lambda *qkv: seen.extend(qkv) or qkv[0])
        q, k, v = _packed_views(2, 4096, 4, 32)
        fa.flash_attention(q, k, v)
        assert all(a is b for a, b in zip(seen, (q, k, v)))

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

    def test_build_hash_covers_included_headers(self, tmp_path):
        """An edited header of csrc builds anew: the library name hashes the
        local headers a source includes."""
        (tmp_path / "h.cuh").write_text("// v1\n")
        source = tmp_path / "k.cu"
        source.write_text('#include <stdint.h>\n#include "h.cuh"\nint f() { return 0; }\n')
        before = _nvcc.digest(source)
        (tmp_path / "h.cuh").write_text("// v2\n")
        assert _nvcc.digest(source) != before
        assert _nvcc.digest(_nvcc.CSRC_DIR / "flash_attention.cu") != _nvcc.digest(
            _nvcc.CSRC_DIR / "conv3x3_gn.cu")

    @pytest.mark.parametrize("d, padded", [(8, 32), (24, 32), (32, 32), (33, 64), (128, 128)])
    def test_head_dim_padding(self, d, padded):
        assert _padded_head_dim(d) == padded

    def test_head_dim_above_128_raises(self):
        with pytest.raises(ValueError, match="head_dim 160"):
            _padded_head_dim(160)

    def test_backward_raises(self):
        """The backward launches the kernels or raises: on CPU tensors it
        raises, and nothing gives way to the plain backward."""
        q, k, v = map(torch.from_numpy, _qkv(s=64))
        ctx = SimpleNamespace(saved_tensors=(q, k, v, q, torch.zeros(2, 2, 64)))
        before = cuda_attention.bwd_launches
        with pytest.raises(ValueError, match="needs CUDA tensors"):
            cuda_attention._FlashAttention.backward(ctx, torch.zeros_like(q))
        assert cuda_attention.bwd_launches == before


def _layout(*tensors):
    """kernel_layout of meta tensors: shapes, strides, dtypes and (offset) addresses."""
    return kernel_layout(*zip(*((x.shape, x.stride(), x.dtype, x.data_ptr()) for x in tensors)))


def _packed_views(b, s, h, d, dtype=torch.bfloat16):
    """q, k, v as the model makes them: chunks of one [B, S, 3C] projection."""
    qkv = torch.empty(b, s, 3 * h * d, dtype=dtype, device="meta")
    return [t.reshape(b, s, h, d) for t in qkv.chunk(3, dim=-1)]


class TestKernelLayout:
    """The wrapper's checks, without a card: what the kernel is handed."""

    def test_packed_qkv_views_pass_with_row_stride_3c(self):
        q, k, v = _packed_views(2, 7600, 4, 32)
        assert _layout(q, k, v) == KernelLayout("tc_bf16", 32, False, ((7600 * 384, 384),) * 3)

    @pytest.mark.parametrize("dtype, variant", [(torch.bfloat16, "tc_bf16"),
                                                (torch.float32, "fp32")])
    def test_variant_chosen_by_dtype(self, dtype, variant):
        x = torch.empty(1, 64, 2, 32, dtype=dtype, device="meta")
        assert _layout(x, x, x) == KernelLayout(variant, 32, False, ((4096, 64),) * 3)

    def test_head_dim_24_pads_to_32(self):
        """The padded copies are contiguous, so any layout is taken."""
        q, k, v = _packed_views(2, 1000, 2, 24)
        assert _layout(q, k, v) == KernelLayout("tc_bf16", 32, True, ((1000 * 64, 64),) * 3)

    def test_refuses_non_unit_d_stride(self):
        x = torch.empty(1, 64, 32, 2, dtype=torch.bfloat16, device="meta").transpose(2, 3)
        with pytest.raises(ValueError, match="unit stride on D"):
            _layout(x, x, x)

    def test_refuses_head_stride_other_than_d(self):
        x = torch.empty(1, 64, 2, 64, dtype=torch.bfloat16, device="meta")[..., :32]
        with pytest.raises(ValueError, match="head stride == D"):
            _layout(x, x, x)

    def test_refuses_mixed_dtypes(self):
        x = torch.empty(1, 64, 2, 32, device="meta")
        with pytest.raises(ValueError, match="share one"):
            _layout(x, x.bfloat16(), x)

    def test_refuses_mixed_shapes(self):
        x = torch.empty(1, 64, 2, 32, device="meta")
        with pytest.raises(ValueError, match="share one"):
            _layout(x, x[:, :32], x)

    def test_refuses_unsupported_dtype(self):
        x = torch.empty(1, 64, 2, 32, dtype=torch.float16, device="meta")
        with pytest.raises(TypeError, match="float16"):
            _layout(x, x, x)

    def test_refuses_head_dim_above_128(self):
        x = torch.empty(1, 64, 2, 160, dtype=torch.bfloat16, device="meta")
        with pytest.raises(ValueError, match="head_dim 160"):
            _layout(x, x, x)

    @pytest.mark.parametrize("dtype, ok", [(torch.bfloat16, False), (torch.float32, True)])
    def test_bf16_rows_must_be_16_byte_aligned(self, dtype, ok):
        """Row stride 68 elements: 136 bytes in bf16 (refused, the kernel copies
        rows 16 bytes at a time), 272 in fp32 (taken)."""
        x = torch.empty(1, 64, 68, dtype=dtype, device="meta")[..., :64].reshape(1, 64, 2, 32)
        if ok:
            assert _layout(x, x, x).strides == ((4352, 68),) * 3
        else:
            with pytest.raises(ValueError, match="16-byte aligned"):
                _layout(x, x, x)

    def test_bf16_address_must_be_16_byte_aligned(self):
        base = torch.empty(4 + 64 * 64, dtype=torch.bfloat16, device="meta")
        x = base[4:].view(1, 64, 2, 32)  # 8 bytes past an aligned address
        with pytest.raises(ValueError, match="16-byte aligned"):
            _layout(x, x, x)

    @pytest.mark.parametrize("row, offset", [(66, 0), (64, 2)], ids=["row_stride", "address"])
    def test_fp32_rows_must_be_16_byte_aligned(self, row, offset):
        """The fp32 variant copies rows 16 bytes at a time too: a row stride of
        66 floats (264 bytes) or an address 8 bytes off is refused."""
        base = torch.empty(offset + 64 * row, device="meta")
        x = base[offset:].view(1, 64, row)[..., :64].reshape(1, 64, 2, 32)
        with pytest.raises(ValueError, match="16-byte aligned"):
            _layout(x, x, x)

    def test_refuses_grid_above_limit(self):
        x = torch.empty(65536, 1, 1, 32, dtype=torch.bfloat16, device="meta")
        with pytest.raises(ValueError, match="grid limit"):
            _layout(x, x, x)


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
        """The 'ring' backend (ported: ``parallel/ring_attention.py``) without a
        ring context, and inside a one-rank mesh's, is dense attention, the
        'xla' module's output, counted as dense; ring-sharded runs are in
        tests/test_torch_ring_attention.py."""
        from sbgm_danra_tpu_torch.parallel import mesh as pmesh
        from sbgm_danra_tpu_torch.parallel.ring_attention import ring_context, ring_stats

        module = SpatialSelfAttention(8, 2, "ring")
        dense = SpatialSelfAttention(8, 2, "xla")
        dense.load_state_dict(module.state_dict())
        x = torch.from_numpy(np.random.default_rng(0).normal(size=(1, 2, 2, 8)).astype(np.float32))
        with torch.no_grad():
            want = dense(x)
            torch.testing.assert_close(module(x), want, rtol=0, atol=0)
            with ring_context(pmesh.make_mesh(device="cpu")):
                torch.testing.assert_close(module(x), want, rtol=0, atol=0)
        assert ring_stats(torch.nn.Sequential(module)) == {
            "0": {"ring": 0, "dense": 2, "tokens": 4}}


class TestBackwardPlainVersion:
    """K2's backward: the plain lse and ``flash_attention_bwd_reference`` (what
    the card holds the backward kernels against) against ``jax.grad`` of the
    Pallas kernel, run in interpret mode as tests/test_pallas_attention.py runs
    it (its VJP recomputes dense attention)."""

    @pytest.mark.parametrize("s, d", [(300, 32), (200, 24)])
    def test_matches_jax_grad_of_pallas_kernel(self, s, d):
        """dq, dk, dv for a random cotangent at a ragged S (not a multiple of
        128) and a padded D: 5e-5 abs + 5e-5 rel, the JAX test's own gradient
        tolerance."""
        q, k, v = _qkv(s=s, d=d, seed=2)
        g = np.random.default_rng(3).normal(size=q.shape).astype(np.float32)

        def f(q_, k_, v_):
            return jnp.sum(pallas_flash_attention(q_, k_, v_, 128, 128) * g)

        want = jax.grad(f, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
        tq, tk, tv = map(torch.from_numpy, (q, k, v))
        out = flash_attention_reference(tq, tk, tv)
        lse = cuda_attention.attention_lse(tq, tk)
        got = cuda_attention.flash_attention_bwd_reference(tq, tk, tv, out, torch.from_numpy(g),
                                                           lse)
        for a, b in zip(got, want):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=5e-5, rtol=5e-5)

    def test_lse_matches_jax(self):
        q, k, _ = _qkv(s=300, d=32, seed=4)
        scores = jnp.einsum("bqhd,bkhd->bhqk", jnp.asarray(q) / np.sqrt(32.0), jnp.asarray(k))
        want = jax.nn.logsumexp(scores, axis=-1)
        got = cuda_attention.attention_lse(torch.from_numpy(q), torch.from_numpy(k))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-6)

    def test_returns_input_dtype(self):
        q, k, v = (torch.from_numpy(a).bfloat16() for a in _qkv(s=64))
        out = flash_attention_reference(q, k, v)
        grads = cuda_attention.flash_attention_bwd_reference(
            q, k, v, out, torch.ones_like(out), cuda_attention.attention_lse(q, k))
        assert all(x.dtype == torch.bfloat16 and x.shape == q.shape for x in grads)

"""Torch port: the score UNet and its ops against the JAX package, on the CPU."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from sbgm_danra_tpu.models.embeddings import GaussianFourierEmbedding as JaxEmbedding
from sbgm_danra_tpu.ops import flash_attention as jax_fa
from sbgm_danra_tpu.ops.stem_conv import conv8x8s2_direct, conv8x8s2_s2d
from sbgm_danra_tpu.ops.upsample import upsample2x_bilinear as jax_upsample
from sbgm_danra_tpu_torch.models.embeddings import GaussianFourierEmbedding
from sbgm_danra_tpu_torch.models.unet import ModelSpec, build_score_model, inference_spec
from sbgm_danra_tpu_torch.ops import flash_attention as fa
from sbgm_danra_tpu_torch.ops.stem_conv import conv8x8s2
from sbgm_danra_tpu_torch.ops.upsample import upsample2x_bilinear
from tests.torch_parity import (
    TINY,
    jax_apply,
    jax_model_and_variables,
    model_inputs,
    rel_err,
    torch_inputs,
    torch_model,
)

VARIANTS = {
    "xla": {},
    "pallas": {"attention_backend": "pallas"},
    "fuse_head": {"fuse_head": True, "fuse_upsample": "dilated", "stem_impl": "s2d"},
    "conv_transpose": {"use_resize_conv": False},
    "instance_norm": {"decoder_norm": "instance"},
    "no_norm_gelu": {"decoder_norm": "none", "decoder_activation": "gelu"},
    "relu_no_classes": {"decoder_activation": "relu", "num_classes": None},
}


class TestScoreUNet:
    @pytest.mark.parametrize("variant", sorted(VARIANTS))
    def test_fp32_matches_flax(self, monkeypatch, variant):
        """Tiny UNet with random bridged weights (BatchNorm statistics
        included), fp32: max |err| <= 1e-4 max |ref|. Only the summation
        order of convs and matmuls differs (measured ~1e-6). 'pallas' forces
        the kernel path on both sides (Pallas interpreted; the port's plain
        version on the CPU)."""
        spec_kw = {**TINY, **VARIANTS[variant]}
        inputs = model_inputs(seed=1)
        if spec_kw["num_classes"] is None:
            inputs.pop("y")
        forced = variant == "pallas"
        monkeypatch.setattr(jax_fa, "_FORCE_PALLAS", forced)
        monkeypatch.setattr(fa, "_FORCE_KERNEL", forced)
        model, variables = jax_model_and_variables(spec_kw, inputs, seed=2)
        want = jax_apply(model, variables, inputs)
        with torch.no_grad():
            got = torch_model(spec_kw, variables)(**torch_inputs(inputs)).numpy()
        assert got.shape == want.shape == (2, 32, 32, 1)
        assert rel_err(got, want) <= 1e-4

    def test_bf16_matches_flax(self):
        """compute_dtype bfloat16 on both sides. bf16 keeps 8 significant bits
        (relative rounding up to 2^-9), and the two frameworks round at
        different places through some 40 layers of a random network, so
        max |err| <= 5e-2 max |ref| (measured 1e-2 to 3.2e-2). oneDNN is off
        for the torch side: this CPU build's oneDNN bf16 kernel gets an
        8-channel 8x8/s2 conv wrong (a library fault on the CPU only; the
        card uses cuDNN)."""
        spec_kw = {**TINY, "compute_dtype": "bfloat16"}
        inputs = model_inputs(seed=3)
        model, variables = jax_model_and_variables(spec_kw, inputs, seed=4)
        want = jax_apply(model, variables, inputs)
        with torch.no_grad(), torch.backends.mkldnn.flags(enabled=False):
            got = torch_model(spec_kw, variables)(**torch_inputs(inputs))
        assert got.dtype == torch.float32  # the score leaves in x's dtype
        assert rel_err(got.numpy(), want) <= 5e-2

    def test_padded_full_domain_shape(self):
        """A non-square padded domain (64x96) through the whole model."""
        spec_kw = {**TINY, "in_channels": 5}
        inputs = model_inputs(batch=1, hw=(64, 96), seed=5)
        inputs["cond_img"] = inputs["cond_img"][..., :1]
        model, variables = jax_model_and_variables(spec_kw, inputs, seed=6)
        want = jax_apply(model, variables, inputs)
        with torch.no_grad():
            got = torch_model(spec_kw, variables)(**torch_inputs(inputs)).numpy()
        assert got.shape == (1, 64, 96, 1)
        assert rel_err(got, want) <= 1e-4

    def test_train_mode_not_ported(self):
        model = build_score_model(ModelSpec(**TINY))
        x = torch.zeros(1, 32, 32, 1)
        with pytest.raises(NotImplementedError, match="training"):
            model(x, torch.ones(1), train=True)

    def test_inference_spec_fuses_head_at_full_domain(self):
        spec = ModelSpec(**TINY)
        assert inference_spec(spec, (608, 800)).fuse_head
        assert not inference_spec(spec, (128, 128)).fuse_head


class TestOps:
    def test_upsample_matches_jax_and_interpolate(self):
        """Exact bilinear 2x: equal to the JAX taps op and to F.interpolate
        (half-pixel, clamped), borders included; fp32 rounding only, 1e-6."""
        x = np.random.default_rng(0).normal(size=(2, 5, 7, 3)).astype(np.float32)
        got = upsample2x_bilinear(torch.from_numpy(x))
        np.testing.assert_allclose(got.numpy(), np.asarray(jax_upsample(jnp.asarray(x))),
                                   atol=1e-6, rtol=1e-6)
        interp = F.interpolate(torch.from_numpy(x).permute(0, 3, 1, 2), scale_factor=2,
                               mode="bilinear", align_corners=False).permute(0, 2, 3, 1)
        torch.testing.assert_close(got, interp, atol=1e-6, rtol=1e-6)
        for edge in (np.s_[:, 0], np.s_[:, -1], np.s_[:, :, 0], np.s_[:, :, -1]):
            torch.testing.assert_close(got[edge], interp[edge], atol=1e-6, rtol=1e-6)

    @pytest.mark.parametrize("hw", [(16, 16), (10, 14), (9, 13)])
    def test_stem_conv_matches_both_jax_lowerings(self, hw):
        rng = np.random.default_rng(1)
        x = rng.normal(size=(2, *hw, 3)).astype(np.float32)
        k = (rng.normal(size=(8, 8, 3, 5)) / 14).astype(np.float32)
        got = conv8x8s2(torch.from_numpy(x).permute(0, 3, 1, 2),
                        torch.from_numpy(k.transpose(3, 2, 0, 1).copy())).permute(0, 2, 3, 1)
        for lowering in (conv8x8s2_direct, conv8x8s2_s2d):
            want = np.asarray(lowering(jnp.asarray(x), jnp.asarray(k)))
            np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)

    def test_fourier_embedding_matches_jax(self):
        w = (30.0 * np.random.default_rng(2).normal(size=(8,))).astype(np.float32)
        t = np.array([0.001, 0.37, 1.0], np.float32)
        want = JaxEmbedding(16).apply({"buffers": {"W": jnp.asarray(w)}}, jnp.asarray(t))
        module = GaussianFourierEmbedding(16)
        module.W.copy_(torch.from_numpy(w))
        np.testing.assert_allclose(module(torch.from_numpy(t)).numpy(), np.asarray(want),
                                   atol=1e-5, rtol=1e-5)

    def test_seeded_init_is_reproducible_and_flax_like(self):
        """Same generator seed, same weights; label row 0 zero; Fourier W with
        std near 30; conv kernels with variance near 1/fan_in."""
        a = build_score_model(ModelSpec(**TINY), generator=torch.Generator().manual_seed(5))
        b = build_score_model(ModelSpec(**TINY), generator=torch.Generator().manual_seed(5))
        for (ka, va), (kb, vb) in zip(a.state_dict().items(), b.state_dict().items()):
            assert ka == kb and torch.equal(va, vb)
        assert float(a.encoder.label_emb.weight.detach()[0].abs().max()) == 0.0
        w = a.decoder.block0.conv_up.weight.detach()
        fan_in = w[0].numel()
        assert abs(float(w.var()) * fan_in - 1.0) < 0.1
        assert 15.0 < float(a.encoder.time_embed.W.std()) < 45.0

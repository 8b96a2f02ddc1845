"""Torch port: the Flax -> torch weight bridge (sbgm_danra_tpu_torch/convert.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sbgm_danra_tpu.models.unet import ModelSpec as JaxSpec
from sbgm_danra_tpu.models.unet import build_score_model as jax_build
from sbgm_danra_tpu_torch.convert import flatten, load_flax_npz, state_dict_from_flax
from sbgm_danra_tpu_torch.models.unet import ModelSpec, build_score_model
from tests.torch_parity import (
    TINY,
    jax_apply,
    jax_model_and_variables,
    jax_to_np,
    model_inputs,
    rel_err,
    torch_inputs,
    torch_model,
)


@pytest.fixture(scope="module")
def bridged():
    inputs = model_inputs()
    model, variables = jax_model_and_variables(TINY, inputs, seed=1)
    return model, variables, inputs


class TestBridge:
    def test_from_jax_init(self):
        """A real Flax init (label row 0 zeroed, Fourier buffers drawn) bridges
        into a torch model that computes the same score. fp32 on the CPU:
        only summation order differs, so 1e-4 of the output's scale."""
        inputs = model_inputs()
        model = jax_build(JaxSpec(**TINY))
        init = jax.jit(lambda key, a: model.init({"params": key}, **a, train=False))
        variables = jax_to_np(init(jax.random.PRNGKey(0),
                                   {k: jnp.asarray(v) for k, v in inputs.items()}))
        tm = torch_model(TINY, variables)
        assert float(tm.encoder.label_emb.weight.detach()[0].abs().max()) == 0.0
        np.testing.assert_array_equal(
            tm.encoder.time_embed.W.numpy(), variables["buffers"]["encoder"]["time_embed"]["W"]
        )
        with torch.no_grad():
            got = tm(**torch_inputs(inputs)).numpy()
        assert rel_err(got, jax_apply(model, variables, inputs)) <= 1e-4

    def test_every_leaf_maps(self, bridged):
        _, variables, _ = bridged
        tm = build_score_model(ModelSpec(**TINY))
        sd = state_dict_from_flax(variables, tm)
        assert set(sd) == set(tm.state_dict())
        conv = variables["params"]["encoder"]["conv1"]["kernel"]  # HWIO
        np.testing.assert_array_equal(sd["encoder.conv1.weight"].numpy(),
                                      conv.transpose(3, 2, 0, 1))
        dense = variables["params"]["encoder"]["attn4"]["qkv"]["kernel"]  # [in, out]
        np.testing.assert_array_equal(sd["encoder.attn4.qkv.weight"].numpy(), dense.T)
        bn = variables["batch_stats"]["encoder"]["bn1"]["BatchNorm_0"]
        np.testing.assert_array_equal(sd["encoder.bn1.running_var"].numpy(), bn["var"])

    def test_npz_round_trip(self, bridged, tmp_path):
        _, variables, _ = bridged
        path = tmp_path / "weights.npz"
        np.savez(path, **flatten(variables))
        a = load_flax_npz(str(path), build_score_model(ModelSpec(**TINY))).state_dict()
        b = state_dict_from_flax(variables, build_score_model(ModelSpec(**TINY)))
        for key, value in b.items():
            torch.testing.assert_close(a[key], value, rtol=0, atol=0)


class TestParamCount:
    def test_flagship_count_matches_jax(self):
        """19,083,842 parameters at in_channels=6 (4 classes), on both sides;
        JAX counted from eval_shape so nothing large is initialised there."""
        spec_kw = dict(in_channels=6, num_classes=4)
        inputs = model_inputs(batch=1, hw=(128, 128))
        model = jax_build(JaxSpec(**spec_kw))
        abstract = jax.eval_shape(lambda: model.init(
            {"params": jax.random.PRNGKey(0)}, **{k: jnp.asarray(v) for k, v in inputs.items()},
            train=False))
        n_jax = sum(int(np.prod(x.shape)) for x in jax.tree.leaves(abstract["params"]))
        n_torch = sum(p.numel() for p in build_score_model(ModelSpec(**spec_kw)).parameters())
        assert n_jax == n_torch == 19_083_842


class TestBridgeErrors:
    def test_unknown_key_raises(self, bridged):
        _, variables, _ = bridged
        flat = flatten(variables)
        flat["params/encoder/bogus/kernel"] = np.zeros((3, 3), np.float32)
        with pytest.raises(KeyError, match="bogus"):
            state_dict_from_flax(flat, build_score_model(ModelSpec(**TINY)))

    def test_unknown_leaf_name_raises(self, bridged):
        _, variables, _ = bridged
        flat = flatten(variables)
        flat["params/encoder/conv1/gamma"] = np.zeros((3,), np.float32)
        with pytest.raises(KeyError, match="gamma"):
            state_dict_from_flax(flat, build_score_model(ModelSpec(**TINY)))

    def test_missing_key_raises(self, bridged):
        _, variables, _ = bridged
        flat = flatten(variables)
        del flat["batch_stats/encoder/bn1/BatchNorm_0/mean"]
        with pytest.raises(KeyError, match="encoder.bn1.running_mean"):
            state_dict_from_flax(flat, build_score_model(ModelSpec(**TINY)))

    def test_shape_mismatch_raises(self, bridged):
        _, variables, _ = bridged
        flat = flatten(variables)
        flat["params/encoder/time_proj0/bias"] = np.zeros((3,), np.float32)
        with pytest.raises(ValueError, match="time_proj0"):
            state_dict_from_flax(flat, build_score_model(ModelSpec(**TINY)))

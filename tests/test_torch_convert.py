"""Torch port: the weight bridge both ways (sbgm_danra_tpu_torch/convert.py),
and a checkpoint the port trained imported into the JAX package
(import_torch_checkpoint.py)."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sbgm_danra_tpu.models.unet import ModelSpec as JaxSpec
from sbgm_danra_tpu.models.unet import build_score_model as jax_build
from sbgm_danra_tpu_torch.convert import (
    flatten,
    flax_from_state_dicts,
    load_flax_npz,
    load_npz,
    state_dict_from_flax,
    state_dicts_from_flax,
    write_flax_npz,
)
from sbgm_danra_tpu_torch.models.unet import ModelSpec, build_score_model
from tests.torch_parity import (  # noqa: F401 (one_thread: a module fixture)
    TINY,
    jax_apply,
    jax_model_and_variables,
    jax_to_np,
    model_inputs,
    one_thread,
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


class TestToFlax:
    """The torch -> Flax direction (``flax_from_state_dicts``) is the exact
    inverse of the Flax -> torch one: bit for bit, with and without the EMA
    copy, on the resize-conv decoder and on the ConvTranspose ablation."""

    @pytest.mark.parametrize("with_ema", [False, True], ids=["params", "with_ema"])
    @pytest.mark.parametrize("extra", [{}, {"use_resize_conv": False}],
                             ids=["resize_conv", "conv_transpose"])
    def test_round_trip_bit_identical(self, with_ema, extra):
        spec_kw = {**TINY, **extra}
        _, variables = jax_model_and_variables(spec_kw, model_inputs(), seed=2)
        if with_ema:
            _, other = jax_model_and_variables(spec_kw, model_inputs(), seed=3)
            variables = {**variables, "ema_params": other["params"]}
        model = build_score_model(ModelSpec(**spec_kw))
        params, ema = state_dicts_from_flax(variables, model)
        model.load_state_dict(params)
        back = flatten(flax_from_state_dicts(model, ema))
        want = flatten(variables)
        assert set(back) == set(want)
        for key, value in want.items():
            assert back[key].dtype == value.dtype and back[key].shape == value.shape, key
            np.testing.assert_array_equal(back[key], value, err_msg=key)

    def test_ema_params_alone(self, bridged, tmp_path):
        """A port checkpoint's ``ema_params`` (parameters only) and the npz writer."""
        _, variables, _ = bridged
        model = torch_model(TINY, variables)
        ema = {k: v.detach() + 1.0 for k, v in model.named_parameters()}
        path = tmp_path / "w.npz"
        flat = write_flax_npz(str(path), model, ema)
        params, ema_back = state_dicts_from_flax(load_npz(str(path)), model)
        assert set(flat) == set(load_npz(str(path)))
        for key, value in ema.items():
            torch.testing.assert_close(ema_back[key], value, rtol=0, atol=0)
        for key, value in model.state_dict().items():
            torch.testing.assert_close(params[key], value, rtol=0, atol=0)


def _trained_cfg(root: str) -> dict:
    """tests/test_torch_cli.py's tiny config, trained 2 steps with no previews."""
    from tests.test_torch_cli import _cfg_dict

    d = _cfg_dict(root)
    d["visualization"] = {"preview_every": 0, "plot_losses": False}
    # JAX's eager Xavier re-init costs about a minute on the CPU in
    # _load_pipeline_for_sampling's state; the loaded weights replace it anyway
    d["training"]["weight_init"] = False
    return d


@pytest.fixture(scope="module")
def port_trained(tmp_path_factory):
    """A tiny model trained 2 steps by the port on synthetic data (oneDNN off
    while training: ROADMAP F5), exported with ``convert --to_flax`` and
    written as an Orbax checkpoint by ``import_torch_checkpoint.py``."""
    import import_torch_checkpoint
    from sbgm_danra_tpu_torch import convert
    from sbgm_danra_tpu_torch.cli import main_app
    from tests.test_torch_cli import _write

    root = str(tmp_path_factory.mktemp("to_flax"))
    path = _write(root, _trained_cfg(root))
    main_app.main(["--config_path", path, "--mode", "synthetic_data", "--n_days", "16"])
    with torch.backends.mkldnn.flags(enabled=False):
        main_app.main(["--config_path", path, "--mode", "train", "--device", "cpu"])
    npz = os.path.join(root, "w.npz")
    assert convert.main(["--to_flax", "--config_path", path, "--out", npz, "--best"]) == 0
    jax_dir = os.path.join(root, "jax_ckpt")
    assert import_torch_checkpoint.main(["--config_path", path, "--npz", npz, "--step", "2",
                                         f"paths.checkpoint_dir={jax_dir}"]) == 0
    return dict(root=root, path=path, npz=npz, jax_dir=jax_dir)


def test_port_checkpoint_scores_alike_in_jax(port_trained):
    """The port's trained checkpoint, through ``convert --to_flax`` and
    ``import_torch_checkpoint.py``, loads in the JAX package's
    ``_load_pipeline_for_sampling`` unchanged; its EMA score on the same
    inputs equals the port's within the fp32 UNet parity tolerance (1e-4 of
    max |ref|, as ``TestBridge.test_from_jax_init``)."""
    from sbgm_danra_tpu.cli.entries import _load_pipeline_for_sampling as jax_load
    from sbgm_danra_tpu.config import load_config as jax_load_config
    from sbgm_danra_tpu_torch.cli.entries import _load_pipeline_for_sampling as port_load
    from sbgm_danra_tpu_torch.config import load_config

    cfg = load_config(port_trained["path"])
    jax_cfg = jax_load_config(port_trained["path"],
                              {"paths.checkpoint_dir": port_trained["jax_dir"]})
    port_pipe, _ = port_load(cfg, "cpu")
    jax_pipe, _ = jax_load(jax_cfg)
    assert int(jax_pipe.state.step) == 2 and port_pipe.state.step == 2
    rng = np.random.default_rng(7)
    inputs = {"x": rng.normal(size=(2, 32, 32, 1)).astype(np.float32),
              "t": np.array([0.3, 0.8], np.float32),
              "y": np.array([1, 3], np.int32),
              "cond_img": rng.normal(size=(2, 32, 32, 1)).astype(np.float32),
              "lsm_cond": rng.normal(size=(2, 32, 32, 2)).astype(np.float32),
              "topo_cond": rng.normal(size=(2, 32, 32, 2)).astype(np.float32)}
    with torch.no_grad():
        got = port_pipe.score_fn(use_ema=True)(**torch_inputs(inputs)).numpy()
    jax_inputs = {k: jnp.asarray(v) for k, v in inputs.items()}
    want = np.asarray(jax.jit(jax_pipe.score_fn(use_ema=True))(**jax_inputs))
    assert np.isfinite(got).all()
    assert rel_err(got, want) <= 1e-4
    # the trained weights, not an init: the EMA moved off the raw parameters
    raw = np.asarray(jax.jit(jax_pipe.score_fn(use_ema=False))(**jax_inputs))
    assert rel_err(raw, want) > 1e-6

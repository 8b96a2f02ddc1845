"""Torch port: the back-transforms (F9) against the JAX package's, and the
serving engine's units and EMA weights."""

import dataclasses
import json
import logging
import os

import numpy as np
import pytest
import torch
import yaml

from sbgm_danra_tpu import transforms as jax_tf
from sbgm_danra_tpu_torch import transforms as tf
from sbgm_danra_tpu_torch.config import from_dict, load_config
from sbgm_danra_tpu_torch.convert import flatten, state_dict_from_flax
from sbgm_danra_tpu_torch.models.unet import ModelSpec, build_score_model
from sbgm_danra_tpu_torch.sampling.samplers import SamplerConfig
from sbgm_danra_tpu_torch.serve import InferenceEngine, ServeSettings, settings_from_config
from sbgm_danra_tpu_torch.training.checkpointing import CheckpointManager
from sbgm_danra_tpu_torch.training.state import TrainState, make_optimizer
from tests.torch_parity import TINY, jax_model_and_variables, model_inputs

HW = (32, 32)
STATS = {  # (model, variable): global stats
    ("DANRA", "prcp"): {"mean": 2.1, "std": 3.4, "min": 0.0, "max": 80.0, "log_mean": -1.3,
                        "log_std": 2.2, "log_min": -4.6, "log_max": 4.4},
    ("ERA5", "temp"): {"mean": 281.0, "std": 7.5, "min": 250.0, "max": 305.0, "log_mean": 5.6,
                       "log_std": 0.03, "log_min": 5.5, "log_max": 5.7},
    ("ERA5", "prcp"): {"mean": 1.9, "std": 2.8, "min": 0.0, "max": 60.0, "log_mean": -1.1,
                       "log_std": 2.0, "log_min": -4.6, "log_max": 4.1},
}
CFG = {
    "highres": {"model": "DANRA", "variable": "prcp", "data_size": list(HW),
                "scaling_method": "log_zscore", "cutout_domains": [170, 350, 340, 520]},
    "lowres": {"model": "ERA5", "condition_variables": ["temp", "prcp"],
               "scaling_methods": ["zscore", "log_minus1_1"]},
    "sampler": {"sampler_type": "dpmpp_sampler", "last_fmap_channels": 64, "time_embedding": 32,
                "num_heads": 2, "block_layers": [1, 1, 1, 1]},
    "evaluation": {"n_steps": 4},
}


@pytest.fixture(scope="module")
def stats_tree(tmp_path_factory):
    """A stats tree as the statistics pipeline writes it, and a run config on it."""
    root = tmp_path_factory.mktemp("stats")
    for (model, var), stats in STATS.items():
        crop = "170_350_340_520" if model == "DANRA" else "full"
        path = jax_tf.stats_path(str(root), model, var, "589x789", crop, "all")
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "w") as f:
            json.dump(stats, f)
    cfg_path = root / "cfg.yaml"
    cfg_path.write_text(yaml.safe_dump({**CFG, "paths": {"stats_load_dir": str(root)}}))
    return str(cfg_path)


def test_back_transforms_match_jax(stats_tree):
    """The port's back-transforms from the config's stats against the JAX
    package's ``build_back_transforms_from_stats``, called with the arguments
    that cli/entries.py:30-57 gives it, on numpy and on torch: 1e-6 relative."""
    ours = tf.back_transforms_for_config(load_config(stats_tree))
    theirs = jax_tf.build_back_transforms_from_stats(
        hr_var="prcp", hr_model="DANRA", domain_str_hr="589x789",
        crop_region_str_hr="170_350_340_520", hr_scaling_method="log_zscore", hr_buffer_frac=0.5,
        lr_vars=["temp", "prcp"], lr_model="ERA5", domain_str_lr="589x789",
        crop_region_str_lr="full", lr_scaling_methods=["zscore", "log_minus1_1"],
        lr_buffer_frac=0.5, split="all", stats_dir_root=os.path.dirname(stats_tree))
    assert set(ours) == set(theirs) == {"prcp_hr", "generated", "temp_lr", "prcp_lr"}
    x = np.random.default_rng(0).normal(size=(2, *HW)).astype(np.float32) * 2.0
    for key in ours:
        want = np.asarray(theirs[key](x))
        np.testing.assert_allclose(ours[key](x), want, rtol=1e-6, err_msg=key)
        np.testing.assert_allclose(ours[key](torch.from_numpy(x)).numpy(), want, rtol=1e-5,
                                   err_msg=key)


@pytest.mark.parametrize("method", ["zscore", "scale01", "scale_minus1_1", "log", "log_01",
                                    "log_minus1_1", "log_zscore", "none"])
def test_every_method_matches_jax(method):
    stats = STATS[("DANRA", "prcp")]
    x = np.linspace(-3.0, 3.0, 50, dtype=np.float32)
    np.testing.assert_allclose(tf.back_transform_from_stats(method, stats, 0.3)(x),
                               np.asarray(jax_tf.back_transform_from_stats(method, stats, 0.3)(x)),
                               rtol=1e-6)


def test_missing_stats_warn_and_give_none(tmp_path, caplog):
    cfg = load_config(_write(tmp_path, {**CFG, "paths": {"stats_load_dir": str(tmp_path)}}))
    with caplog.at_level(logging.WARNING):
        assert tf.back_transforms_for_config(cfg) == {}
    assert "Back transforms unavailable" in caplog.text
    assert settings_from_config(cfg).back_transform is None


def _write(tmp_path, data) -> str:
    path = tmp_path / "cfg.yaml"
    path.write_text(yaml.safe_dump(data))
    return str(path)


def _settings(**kw):
    return ServeSettings(spec=ModelSpec(**TINY), sampler_type="dpmpp_sampler",
                         sampler=SamplerConfig(num_steps=4, guidance_scale=3.0), sample_hw=HW,
                         n_lr=2, model_string="tiny", **kw)


def _conditions():
    rng = np.random.default_rng(1)
    return {"y": np.int64(2), "cond_img": rng.normal(size=(*HW, 2)).astype(np.float32),
            "lsm_cond": np.ones((*HW, 2), np.float32), "topo_cond": np.zeros((*HW, 2), np.float32)}


def test_engine_generates_in_physical_units(stats_tree):
    """With the config's stats the engine's fields are the back-transform of
    the fields it gives without them (same seed and weights)."""
    settings = settings_from_config(load_config(stats_tree))
    assert settings.back_transform is not None
    weights = build_score_model(settings.spec, generator=torch.Generator().manual_seed(0))
    engines = [InferenceEngine(s, weights.state_dict(), "cpu", max_members=2)
               for s in (settings, dataclasses.replace(settings, back_transform=None))]
    try:
        phys, norm = (e.generate(_conditions(), n_members=2, seed=4) for e in engines)
    finally:
        for e in engines:
            e.close()
    np.testing.assert_allclose(phys, settings.back_transform(norm), rtol=1e-6)
    assert phys.dtype == np.float32 and (phys > 0).all()  # log_zscore -> precipitation


def _train_state_with_ema():
    model = build_score_model(ModelSpec(**TINY), generator=torch.Generator().manual_seed(1))
    state = TrainState(model, make_optimizer(from_dict({}).training, model.parameters()))
    with torch.no_grad():
        for e in state.ema_params.values():
            e.mul_(0.5).add_(0.1)
    return state


@pytest.mark.parametrize("load_ema", [True, False])
def test_engine_loads_ema_from_the_ports_checkpoint(tmp_path, load_ema):
    state = _train_state_with_ema()
    path = CheckpointManager(str(tmp_path)).save(3, state, {"val_loss": 1.0})
    engine = InferenceEngine(_settings(load_ema=load_ema), path, "cpu", max_members=1)
    try:
        want = state.ema_params if load_ema else dict(state.model.named_parameters())
        for name, p in engine.model.named_parameters():
            assert torch.equal(p, want[name]), name
    finally:
        engine.close()


def test_engine_loads_ema_from_a_bridged_npz(tmp_path):
    """A bridged .npz with ema_params/ (export_flax_checkpoint.py's layout):
    load_ema serves the EMA tree; without ema_params/ it raises."""
    _, variables = jax_model_and_variables(TINY, model_inputs(hw=HW), seed=2)
    _, ema = jax_model_and_variables(TINY, model_inputs(hw=HW), seed=3)
    flat = flatten({**variables, "ema_params": ema["params"]})
    path = str(tmp_path / "w.npz")
    np.savez(path, **flat)
    engine = InferenceEngine(_settings(load_ema=True), path, "cpu", max_members=1)
    try:
        want = state_dict_from_flax({**variables, "params": ema["params"]}, engine.model)
        for key, v in engine.model.state_dict().items():
            assert torch.equal(v, want[key]), key
    finally:
        engine.close()
    np.savez(path, **flatten(variables))
    with pytest.raises(KeyError, match="ema_params"):
        InferenceEngine(_settings(load_ema=True), path, "cpu", max_members=1)

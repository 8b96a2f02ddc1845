"""Torch port: generation and evaluation against the JAX package's on the CPU.

- ``SampleGenerator``: JAX's and the port's get the same collated batch (a
  one-element list as the loader) and the same back-transforms from one
  statistics directory; the sampler's call is replaced on both sides by the
  same fixed array (ROADMAP F4: the samplers' noise cannot agree), and every
  npz of each mode must have the same name, shape and values (equal, or
  within 1e-6 of the largest |value| where a float32 back-transform runs on
  each side).
- ``Evaluation``'s statistics on the same artifacts, CRPS, the spread
  calibration, the spectrum estimator and the sentinels on seeded arrays:
  within 1e-6 relative.
- The quality study: the regimes' exact scores at seeded (x, t) within 1e-5
  relative, ``evaluate_ensemble`` on the same members and truths exactly, and
  the study run on the CPU with the statistics of the three headline regimes.
- ``repeat_condition``, ``generate_ensemble(mesh=...)``, the trainer's
  ``score_fn(image_hw=...)`` and previews, and the new config fields.
"""

import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sbgm_danra_tpu import config as jax_config
from sbgm_danra_tpu.cli.entries import _back_transforms as jax_back_transforms
from sbgm_danra_tpu.evaluate import calibration as jax_cal
from sbgm_danra_tpu.evaluate import crps as jax_crps
from sbgm_danra_tpu.evaluate import evaluation as jax_evaluation
from sbgm_danra_tpu.evaluate import full_domain as jax_full_domain
from sbgm_danra_tpu.evaluate import generation as jax_generation
from sbgm_danra_tpu.evaluate import quality_study as jax_qs
from sbgm_danra_tpu.parallel import ensemble as jax_ensemble
from sbgm_danra_tpu.pipelines import comparison as jax_comparison
from sbgm_danra_tpu.utils import sentinels as jax_sentinels
from sbgm_danra_tpu_torch import config
from sbgm_danra_tpu_torch.data.factory import make_dataset
from sbgm_danra_tpu_torch.data.loader import collate
from sbgm_danra_tpu_torch.data.paths import lsm_path, topo_path
from sbgm_danra_tpu_torch.data.synthetic import SyntheticSpec, generate
from sbgm_danra_tpu_torch.evaluate import calibration, crps, evaluation
from sbgm_danra_tpu_torch.evaluate import generation
from sbgm_danra_tpu_torch.evaluate import quality_study as qs
from sbgm_danra_tpu_torch.parallel import ensemble
from sbgm_danra_tpu_torch.pipelines import comparison
from sbgm_danra_tpu_torch.models.unet import build_score_model
from sbgm_danra_tpu_torch.training.pipeline import TrainingPipeline, share_tensors
from sbgm_danra_tpu_torch.transforms import back_transforms_for_config
from sbgm_danra_tpu_torch.utils import sentinels

GRID = (48, 64)
CROP = (8, 40, 16, 56)
REL = 1e-6  # of the largest |value|, where float32 arithmetic runs on each side


def _close(got, want, rel=REL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype, (got.shape, want.shape,
                                                                  got.dtype, want.dtype)
    if np.array_equal(got, want, equal_nan=True):
        return
    scale = max(float(np.abs(want).max()), 1e-30)
    assert float(np.abs(got.astype(np.float64) - want).max()) <= rel * scale


def _cfg_dict(root, sample_dir, **evaluation):
    return {
        "experiment": {"config_name": "tiny_gen"},
        "paths": {"data_dir": root, "checkpoint_dir": os.path.join(root, "ckpt"),
                  "sample_dir": sample_dir, "lsm_path": lsm_path(root),
                  "topo_path": topo_path(root), "stats_load_dir": os.path.join(root, "stats")},
        "highres": {"variable": "prcp", "data_size": [32, 32], "scaling_method": "log_zscore",
                    "full_domain_dims": list(GRID), "cutout_domains": list(CROP),
                    "buffer_frac": 0.5},
        "lowres": {"condition_variables": ["temp", "prcp"],
                   "scaling_methods": ["zscore", "log_zscore"], "full_domain_dims": list(GRID),
                   "buffer_frac": 0.5},
        "sampler": {"sampler_type": "dpmpp_sampler", "n_timesteps": 25, "time_embedding": 32,
                    "last_fmap_channels": 64, "num_heads": 2, "block_layers": [1, 1, 1, 1]},
        "data_handling": {"num_workers": 1, "n_gen_samples": 3},
        "training": {"seed": 0, "batch_size": 2, "monitor_extremes": False, "verbose": False},
        "classifier_free_guidance": {"enabled": True, "guidance_scale": 3.0},
        "evaluation": {"n_steps": 5, "seed": 0, "n_repeats": 4, **evaluation},
    }


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    """Synthetic stores and statistics; a collated crop batch of 3 test-split
    days and a full-domain batch of 1; the two packages' back-transforms."""
    root = str(tmp_path_factory.mktemp("torch_generation"))
    generate(SyntheticSpec(root=root, full_domain=GRID, n_days=12, variables=("temp", "prcp"),
                           crop_region=CROP, seed=2))
    d = _cfg_dict(root, os.path.join(root, "samples"))
    cfg = config.from_dict(d)
    crops = make_dataset(cfg, "train")
    rng = np.random.default_rng(4)
    batch = collate([crops.__getitem__(i, rng=rng) for i in range(3)])
    whole = make_dataset(cfg, "test", full_domain=True)
    full = collate([whole.__getitem__(0, rng=rng)])
    return dict(root=root, batch=batch, full=full,
                bt=back_transforms_for_config(cfg),
                jax_bt=jax_back_transforms(jax_config.from_dict(d)))


def _fixed(n, hw, seed):
    return np.random.default_rng(seed).normal(size=(n, *hw)).astype(np.float32)


def _generators(env, monkeypatch, tag, **evaluation):
    """A JAX and a port generator on the same batch, their sampler calls
    replaced by the same fixed fields."""
    root = env["root"]
    d = {side: _cfg_dict(root, os.path.join(root, f"{tag}_{side}"), **evaluation)
         for side in ("jax", "torch")}
    loader = [env["full"] if tag == "full_domain" else env["batch"]]
    jg = jax_generation.SampleGenerator(jax_config.from_dict(d["jax"]), None, loader,
                                        back_transforms=env["jax_bt"])
    tg = generation.SampleGenerator(config.from_dict(d["torch"]), None, loader,
                                    back_transforms=env["bt"], device="cpu")
    crop = _fixed(4, (32, 32), 7)
    jg._run_sampler = lambda n, cond: crop[:n]
    tg._run_sampler = lambda n, cond: tg._sampled(lambda: torch.from_numpy(crop[:n])[..., None])
    monkeypatch.setattr(jax_generation, "generate_ensemble",
                        lambda *a, n_members, **k: jnp.asarray(crop[:n_members, ..., None]))
    monkeypatch.setattr(generation, "generate_ensemble",
                        lambda *a, n_members, **k: torch.from_numpy(crop[:n_members, ..., None]))
    whole = _fixed(1, GRID, 8)
    monkeypatch.setattr(jax_full_domain, "sample_full_domain", lambda *a, **k: whole)
    monkeypatch.setattr(generation, "sample_full_domain", lambda *a, **k: whole)
    return jg, tg


def _artifacts(path):
    return {name: np.load(os.path.join(path, name))["arr_0"] for name in sorted(os.listdir(path))}


@pytest.mark.parametrize("mode,alpha", [("multiple", None), ("single", None),
                                        ("repeated", None), ("repeated", 1.3),
                                        ("full_domain", None)])
def test_sample_generator_artifacts_equal_jax(env, monkeypatch, mode, alpha):
    """Names, shapes and values of every npz of the mode; the LR channels in
    the sorted {var}_lr order (prcp_lr, then temp_lr); spread calibration in
    normalised space before the back-transform."""
    tag = f"{mode}_{alpha}" if mode != "full_domain" else mode
    jg, tg = _generators(env, monkeypatch, tag, spread_calibration=alpha)
    want = getattr(jg, f"generate_{mode}")()
    got = getattr(tg, f"generate_{mode}")()
    _close(got, np.asarray(want))
    jax_files, port_files = _artifacts(jg.sample_path), _artifacts(tg.sample_path)
    assert list(port_files) == list(jax_files) and len(port_files) == 6
    suffix = {"multiple": "multi_n_3", "single": "single", "repeated": "repeated_4",
              "full_domain": "full_domain"}[mode]
    assert f"cond_samples_prcp_{suffix}.npz" in port_files
    for name, value in jax_files.items():
        _close(port_files[name], value)


def test_spread_calibration_runs_before_the_back_transform(env, monkeypatch):
    """alpha rescales the normalised members about their mean: the
    back-transformed artifact is the inverse of the rescaled field."""
    _, tg = _generators(env, monkeypatch, "alpha_check", spread_calibration=0.5)
    got = tg.generate_repeated()
    crop = _fixed(4, (32, 32), 7)
    want = env["bt"]["generated"](calibration.apply_spread_scale(crop, 0.5))
    _close(got, want)


@pytest.fixture(scope="module")
def artifacts(env):
    """The port's artifacts of every mode, written once (random fields in
    place of the sampler's)."""
    root = env["root"]
    d = _cfg_dict(root, os.path.join(root, "eval_samples"))
    cfg = config.from_dict(d)
    gen = generation.SampleGenerator(cfg, None, [env["batch"]], back_transforms=env["bt"],
                                     device="cpu")
    fields = _fixed(4, (32, 32), 11)
    gen._run_sampler = lambda n, cond: gen._sampled(lambda: torch.from_numpy(fields[:n])[..., None])
    generation_ensemble = generation.generate_ensemble
    generation.generate_ensemble = lambda *a, n_members, **k: torch.from_numpy(
        fields[:n_members, ..., None])
    try:
        gen.generate_multiple()
        gen.generate_single()
        gen.generate_repeated()
    finally:
        generation.generate_ensemble = generation_ensemble
    return d


@pytest.mark.parametrize("sample_type,n", [("multiple", 3), ("single", 1), ("repeated", 4)])
def test_evaluation_statistics_equal_jax(artifacts, sample_type, n):
    jev = jax_evaluation.Evaluation(jax_config.from_dict(artifacts), sample_type, n)
    tev = evaluation.Evaluation(config.from_dict(artifacts), sample_type, n)
    assert tev.suffix == jev.suffix
    pairs = [(tev.full_pixel_statistics(save_figs=False), jev.full_pixel_statistics(
        save_figs=False)), (tev.spatial_statistics(), jev.spatial_statistics()),
        (tev.daily_statistics(), jev.daily_statistics()),
        (tev.power_spectrum_comparison(), jev.power_spectrum_comparison())]
    if sample_type == "repeated":
        pairs.append((tev.ensemble_crps(), jev.ensemble_crps()))
    else:
        with pytest.raises(ValueError):
            tev.ensemble_crps()
    for got, want in pairs:
        assert set(got) == set(want)
        for key in want:
            _close(np.asarray(got[key]), np.asarray(want[key]))
    assert set(tev.cond_imgs) == set(jev.cond_imgs) == {"temp", "prcp"}
    for path in ("pixel_stats", "spatial_stats"):
        saved = os.path.join(tev.fig_path, f"{path}_{sample_type}.npz")
        assert os.path.exists(saved)


def _members(seed, shape=(6, 5, 7)):
    rng = np.random.default_rng(seed)
    return rng.gamma(1.5, 2.0, size=shape), rng.gamma(1.5, 2.0, size=shape[1:])


@pytest.mark.parametrize("fair", [True, False])
def test_crps_equals_jax(fair):
    members, obs = _members(0)
    _close(crps.crps_ensemble(members, obs, fair), jax_crps.crps_ensemble(members, obs, fair))
    assert crps.crps_mean(members, obs, fair) == jax_crps.crps_mean(members, obs, fair)
    _close(crps.crps_ensemble(members[:1], obs), jax_crps.crps_ensemble(members[:1], obs))


@pytest.mark.parametrize("batched", [False, True])
def test_calibration_equals_jax(batched):
    rng = np.random.default_rng(1)
    shape = (3, 5, 6, 7) if batched else (5, 6, 7)
    members = rng.normal(size=shape)
    truth = rng.normal(size=shape[:1] + shape[2:] if batched else shape[1:])
    _close(calibration.apply_spread_scale(members, 1.7), jax_cal.apply_spread_scale(members, 1.7))
    assert calibration.ensemble_spread_skill(members, truth) == \
        jax_cal.ensemble_spread_skill(members, truth)
    assert calibration.spread_scale_closed_form(members, truth) == \
        jax_cal.spread_scale_closed_form(members, truth)
    for rule in ("crps", "spread_skill"):
        assert calibration.fit_spread_scale(members, truth, rule) == \
            jax_cal.fit_spread_scale(members, truth, rule)
    with pytest.raises(ValueError):
        calibration.fit_spread_scale(members, truth[0] if batched else truth[None, None], "crps")


def test_spectrum_estimator_equals_jax():
    rng = np.random.default_rng(2)
    a = [rng.normal(size=(24, 40)) for _ in range(3)]
    b = [rng.gamma(2.0, size=(24, 40)) for _ in range(3)]
    _close(comparison.compute_2d_power_spectrum(a[0]),
           jax_comparison.compute_2d_power_spectrum(a[0]))
    _close(comparison.radial_average(b[0]), jax_comparison.radial_average(b[0]))
    _close(comparison.spectrum_of_fields(a), jax_comparison.spectrum_of_fields(a))
    got = comparison.compare_power_spectra(a, b, 2.5).as_dict()
    want = jax_comparison.compare_power_spectra(a, b, 2.5).as_dict()
    assert set(got) == set(want)
    for key in want:
        _close(np.asarray(got[key]), np.asarray(want[key]))


@pytest.mark.parametrize("kind", ["calm", "extreme", "negative"])
def test_sentinels_equal_jax(kind):
    rng = np.random.default_rng(3)
    x = rng.gamma(1.0, 3.0, size=(4, 16, 16)).astype(np.float32)
    if kind == "extreme":
        x[1, 3, 3] = 900.0
    elif kind == "negative":
        x[2, 0, 0] = -0.5
    assert sentinels.report_precip_extremes(x, "t", 300.0) == \
        jax_sentinels.report_precip_extremes(x, "t", 300.0)
    _close(sentinels.clamp_extremes(x, 5.0), jax_sentinels.clamp_extremes(x, 5.0))


def _regimes(size=16):
    pairs = [(qs.gaussian_regime(), jax_qs.gaussian_regime()),
             (qs.bimodal_regime(), jax_qs.bimodal_regime()),
             (qs.correlated_regime(size=size), jax_qs.correlated_regime(size=size))]
    ours = qs.default_regimes(size=size)
    theirs = jax_qs.default_regimes(size=size)
    return pairs + list(zip(ours[3:], theirs[3:]))


@pytest.mark.parametrize("index", range(5))
def test_quality_regime_scores_equal_jax(index):
    """The exact noised score at seeded (x, t), 1e-5 relative (the correlated
    regimes through the FFT in complex64 on each side); the regime's target
    moments equal."""
    ours, theirs = _regimes()[index]
    assert (ours.name, ours.mean, ours.std) == (theirs.name, theirs.mean, theirs.std)
    rng = np.random.default_rng(index)
    x = (3.0 * rng.normal(size=(4, 16, 16, 1))).astype(np.float32)
    t = rng.uniform(1e-3, 1.0, size=(4,)).astype(np.float32)
    got = ours.score_fn(torch.from_numpy(x), torch.from_numpy(t)).numpy()
    want = np.asarray(theirs.score_fn(jnp.asarray(x), jnp.asarray(t)))
    _close(got, want, rel=1e-5)
    draws = ours.sample_truth(torch.Generator().manual_seed(0), (512, 16, 16, 1)).numpy()
    assert abs(draws.mean() - ours.mean) < 0.1 * ours.std and abs(draws.std() / ours.std - 1) < 0.1


def test_evaluate_ensemble_equals_jax():
    rng = np.random.default_rng(5)
    members = rng.normal(size=(16, 8, 8, 1)).astype(np.float32)
    truths = rng.normal(size=(32, 8, 8, 1)).astype(np.float32)
    ours, theirs = _regimes()[1]
    assert qs.evaluate_ensemble(members, truths, ours) == \
        jax_qs.evaluate_ensemble(members, truths, theirs)
    assert qs.rank_histogram_deviation(members, truths) == \
        jax_qs.rank_histogram_deviation(members, truths)
    assert list(qs.SAMPLER_GRID) == list(jax_qs.SAMPLER_GRID)
    results = {"bimodal": {"edm_18": {**qs.evaluate_ensemble(members, truths, ours), "nfe": 34}}}
    assert qs.format_table(results) == jax_qs.format_table(results)


def test_quality_study_on_the_cpu():
    """The study's default sizes (64 members, 16x16, 256 truths) with
    edm-18, dpmpp-25 and pc-100 on the three headline regimes: std ratio and
    spread/skill within [0.9, 1.1] (the JAX study's 0.96-1.00 on these)."""
    grid = [s for s in qs.SAMPLER_GRID if s["label"] in ("edm_18", "dpmpp_25", "pc_100")]
    out = qs.run_study(sampler_grid=grid, regimes=qs.default_regimes(stress=False),
                       device="cpu")
    assert set(out) == {"unimodal", "bimodal", "correlated"}
    for regime, rows in out.items():
        assert set(rows) == {"edm_18", "dpmpp_25", "pc_100"}
        for label, m in rows.items():
            assert 0.9 <= m["std_ratio"] <= 1.1, (regime, label, m)
            assert 0.9 <= m["spread_skill"] <= 1.1, (regime, label, m)


def test_repeat_condition_equals_jax():
    rng = np.random.default_rng(6)
    cond = {"y": np.array([2, 3], np.int32),
            "cond_img": rng.normal(size=(2, 4, 4, 2)).astype(np.float32),
            "lsm_cond": None}
    got = ensemble.repeat_condition({k: None if v is None else torch.from_numpy(v)
                                     for k, v in cond.items()}, 5)
    want = jax_ensemble.repeat_condition(cond, 5)
    assert got["lsm_cond"] is None and want["lsm_cond"] is None
    for key in ("y", "cond_img"):
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]))


def test_generate_ensemble_one_sampler_call_and_mesh_raises():
    """n members of one condition are one call of n rows, with or without a
    one-rank mesh (the same rows); a mesh whose shape needs more ranks than
    the run has raises."""
    from sbgm_danra_tpu_torch.parallel import mesh as pmesh

    seen = []

    def score(x, t, **c):
        seen.append((x.shape[0], c["cond_img"].shape[0]))
        return -x

    cond = {"cond_img": torch.ones(1, 4, 4, 1)}
    out = ensemble.generate_ensemble(score, torch.Generator().manual_seed(0), 6, (4, 4, 1),
                                     cond=cond, sampler="dpmpp_sampler",
                                     config=qs.SamplerConfig(num_steps=3), capture=False)
    assert out.shape == (6, 4, 4, 1) and seen == [(6, 6), (6, 6)]
    meshed = ensemble.generate_ensemble(score, torch.Generator().manual_seed(0), 6, (4, 4, 1),
                                        cond=cond, sampler="dpmpp_sampler",
                                        config=qs.SamplerConfig(num_steps=3), capture=False,
                                        mesh=pmesh.make_mesh(device="cpu"))
    assert torch.equal(meshed, out) and seen[2:] == [(6, 6), (6, 6)]
    with pytest.raises(ValueError, match="needs 2 devices"):
        ensemble.generate_ensemble(score, torch.Generator(), 6, (4, 4, 1),
                                   mesh=pmesh.make_mesh({"data": 2}, device="cpu"))


def test_new_config_fields_keep_jax_defaults():
    for cls, jax_cls, names in (
            (config.EvaluationConfig, jax_config.EvaluationConfig,
             [f.name for f in dataclasses.fields(config.EvaluationConfig)]),
            (config.TrainingConfig, jax_config.TrainingConfig, ["monitor_extremes",
                                                                "extreme_cap"]),
            (config.VisualizationConfig, jax_config.VisualizationConfig,
             ["save_figs", "preview_every"]),
            (config.PathsConfig, jax_config.PathsConfig, ["sample_dir"])):
        for name in names:
            assert getattr(cls(), name) == getattr(jax_cls(), name), name


@pytest.fixture(scope="module")
def pipe(env):
    cfg = config.from_dict(_cfg_dict(env["root"], os.path.join(env["root"], "pipe")))
    return TrainingPipeline(cfg, [], device="cpu", back_transforms=env["bt"],
                            gen_loader=[env["batch"]])


def test_score_fn_for_an_image_size_shares_the_trained_tensors(pipe):
    """score_fn(image_hw=...) builds the model for the size on the same
    tensors (nothing copied; attention 'pallas', the flash dispatcher) and
    scores as score_fn() does (both dense on the CPU at 64 tokens)."""
    rng = np.random.default_rng(9)
    x = torch.from_numpy(rng.normal(size=(2, 64, 64, 1)).astype(np.float32))
    t = torch.tensor([0.3, 0.7])
    cond = {k: torch.from_numpy(rng.normal(size=(2, 64, 64, 2)).astype(np.float32))
            for k in ("cond_img", "lsm_cond", "topo_cond")}
    cond["y"] = torch.tensor([1, 2])
    with torch.no_grad(), torch.backends.mkldnn.flags(enabled=False):
        want = pipe.score_fn()(x, t, **cond)
        got = pipe.score_fn(image_hw=(64, 64))(x, t, **cond)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5 * float(want.abs().max()))
    spec = dataclasses.replace(pipe.spec, attention_backend="pallas", fuse_head=True)
    model = share_tensors(build_score_model(spec), pipe.model)
    for mine, theirs in ((model.parameters(), pipe.model.parameters()),
                         (model.buffers(), pipe.model.buffers())):
        mine, theirs = list(mine), list(theirs)
        assert len(mine) == len(theirs) and all(a is b for a, b in zip(mine, theirs))


def test_previews_on_the_live_weights(pipe):
    """The same draws give the same preview; a moved EMA gives another."""
    with torch.backends.mkldnn.flags(enabled=False):
        a = pipe.generate_previews(n_steps=3, rng=torch.Generator().manual_seed(1))
        b = pipe.generate_previews(n_steps=3, rng=torch.Generator().manual_seed(1))
        for v in pipe.state.ema_params.values():
            v.mul_(1.01)
        c = pipe.generate_previews(n_steps=3, rng=torch.Generator().manual_seed(1))
    assert a.shape == (3, 32, 32) and np.isfinite(a).all()
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a, c)


def test_sentinel_reads_the_back_transformed_batch(pipe, monkeypatch):
    seen = []
    monkeypatch.setattr("sbgm_danra_tpu_torch.training.pipeline.report_precip_extremes",
                        lambda x, name, cap: seen.append((x.shape, name, cap)))
    monkeypatch.setattr(pipe.cfg.training, "monitor_extremes", True)
    pipe._monitor_extremes(torch.zeros(2, 32, 32, 1))
    assert seen == [((2, 32, 32, 1), "train-HR", 300.0)]

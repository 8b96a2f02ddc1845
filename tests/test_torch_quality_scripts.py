"""Torch port: the quality scripts (sbgm_danra_tpu_torch/scripts/) on the CPU.

Each script runs on a tiny checkpoint the port trained (tests/test_torch_cli.py's
config: 32x32 crops of a 48x64 synthetic archive, 2 steps) with ``--device
cpu`` at tiny sizes, and must write the JSON keys the JAX script writes,
listed here with the JAX script's line numbers. The full-domain script's
metric helpers are held against the JAX script's own (``region_masks``,
``ens_metrics``, ``spectrum_logmse``), and the flagship ``metrics`` against
the same numbers computed with the JAX package's ``evaluate.crps`` and
``pipelines.comparison``, on seeded numpy ensembles (1e-6 relative). The
sampler draws are not compared: the two packages' random streams differ
(ROADMAP F4).
"""

import importlib.util
import json
import os

import numpy as np
import pytest
import torch

from sbgm_danra_tpu.evaluate.crps import crps_ensemble as jax_crps
from sbgm_danra_tpu.pipelines.comparison import compute_2d_power_spectrum as jax_ps
from sbgm_danra_tpu.pipelines.comparison import radial_average as jax_radial
from sbgm_danra_tpu_torch.config import load_config
from sbgm_danra_tpu_torch.scripts import edm_quality_study, flagship_quality_eval
from sbgm_danra_tpu_torch.scripts import full_domain_quality_eval as fdq
from sbgm_danra_tpu_torch.transforms import back_transforms_for_config

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REL = 1e-6


def _jax_script(name: str):
    """A JAX script of ``scripts/`` loaded from its file (the directory is no package)."""
    spec = importlib.util.spec_from_file_location(f"jax_{name}",
                                                  os.path.join(ROOT, "scripts", f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread for the module (restored after): the suite's
    workers share the cores (see ``tests/test_torch_windowed.py``)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """tests/test_torch_cli.py's tiny config, 16 synthetic days, trained 2
    steps by the port on the CPU (oneDNN off while training: ROADMAP F5)."""
    from sbgm_danra_tpu_torch.cli import main_app
    from tests.test_torch_cli import _cfg_dict, _write

    root = str(tmp_path_factory.mktemp("quality"))
    d = _cfg_dict(root)
    d["visualization"] = {"preview_every": 0, "plot_losses": False}
    path = _write(root, d)
    main_app.main(["--config_path", path, "--mode", "synthetic_data", "--n_days", "16"])
    with torch.backends.mkldnn.flags(enabled=False):
        main_app.main(["--config_path", path, "--mode", "train", "--device", "cpu"])
    return dict(root=root, path=path, cfg=load_config(path))


# the JAX scripts' keys
FLAGSHIP_TOP = {"n_dates", "members", "image_hw"}  # flagship_quality_eval.py:212
FLAGSHIP_SPACE = {"crps", "rmse_mean", "spread", "spread_skill"}  # :203-208
FLAGSHIP_METRICS = {"normalized", "physical", "rank_histogram", "spectrum_log_mse"}  # :178-214
FLAGSHIP_RUNS = {  # :226-228, :238-240, :275-280, :328-334, :336-339
    "edm_w3": {"compile_s", "run_s"}, "edm_w0": {"run_s"}, "edm_w7": {"run_s"},
    "dpmpp25_w3": {"compile_s", "run_s"}, "dpmpp25_w0": {"compile_s", "run_s"},
    "dpmpp35_w3": {"compile_s", "run_s"},
    "edm_w3_cal_crps": {"alpha"}, "edm_w3_cal_spread_skill": {"alpha"},
    "dpmpp25_w3_cal_crps": {"alpha", "val_run_s"},
}
FLAGSHIP_CALIBRATION = {"fit_split", "fit_dates", "val_run_s", "alpha_crps",
                        "alpha_spread_skill"}  # :304-309
FULL_TOP = {"n_dates", "members", "domain", "padded", "sampler"}  # full_domain_quality_eval.py:148-150
FULL_BLOCK = {"overall", "in_crop", "out_of_crop", "spectrum_logmse", "gen_wall_s",
              "s_per_member_field", "out_of_crop_crps_penalty_pct"}  # :182-192
FULL_REGION = {"crps", "rmse_mean", "spread", "spread_skill"}  # :72-77


def test_flagship_keys(trained, tmp_path):
    out = tmp_path / "flagship.json"
    ran = flagship_quality_eval.main([
        "--config", trained["path"], "--n_dates", "2", "--members", "2", "--skip_pc",
        "--dpmpp", "--calibrate", "--out", str(out), "--device", "cpu"])
    with open(out) as f:
        results = json.load(f)
    assert results == json.loads(json.dumps(ran["results"]))
    assert set(results) == FLAGSHIP_TOP | set(FLAGSHIP_RUNS) | {"calibration"}
    assert results["n_dates"] == 2 and results["members"] == 2
    assert results["image_hw"] == [32, 32]
    for name, extra in FLAGSHIP_RUNS.items():
        assert set(results[name]) == FLAGSHIP_METRICS | extra, name
        for space in ("normalized", "physical"):
            assert set(results[name][space]) == FLAGSHIP_SPACE
            assert all(np.isfinite(v) for v in results[name][space].values()), name
        assert len(results[name]["rank_histogram"]) == 3
    assert set(results["calibration"]) == FLAGSHIP_CALIBRATION
    # each run on the CPU's eager loop, 8 / 18 evaluations a call at 10 nodes
    runs = ran["runs"]
    assert set(runs) == (set(FLAGSHIP_RUNS) - {k for k in FLAGSHIP_RUNS if "_cal_" in k}
                         | {"calibration/valid_edm_w3", "calibration/valid_dpmpp25_w3"})
    assert all(r["route"] == "eager" and r["sampler_calls"] == 1 for r in runs.values())
    assert runs["edm_w3"]["unet_evaluations"] == 18
    assert runs["dpmpp25_w0"]["unet_evaluations"] == 24
    assert all(r["k1_launches"] == [0, 0] for r in runs.values())


def test_full_domain_keys(trained, tmp_path):
    out = tmp_path / "full_domain.json"
    ran = fdq.main(["--config", trained["path"], "--n_dates", "1", "--members", "2",
                    "--member_chunk", "2", "--out", str(out), "--device", "cpu"])
    with open(out) as f:
        results = json.load(f)
    assert set(results) == FULL_TOP | {"w0", "w3"}
    assert results["domain"] == [48, 64] and results["padded"] == [64, 64]
    assert results["sampler"] == "edm_10_churn0"
    for w in ("w0", "w3"):
        assert set(results[w]) == FULL_BLOCK
        for region in ("overall", "in_crop", "out_of_crop"):
            assert set(results[w][region]) == FULL_REGION
            assert np.isfinite(results[w][region]["crps"])
        assert ran["runs"][w]["unet_evaluations"] == 18


def test_edm_study_runs(monkeypatch):
    """The study's regimes and sampler grid as the JAX script prints them (a
    reduced grid: the JAX script's arguments at tiny sizes)."""
    from sbgm_danra_tpu_torch.evaluate import quality_study as qs

    grid = [s for s in qs.SAMPLER_GRID if s["label"] in ("edm_18", "dpmpp_25")]
    monkeypatch.setattr(qs, "SAMPLER_GRID", grid)
    monkeypatch.setattr(edm_quality_study, "run_study",
                        lambda **kw: qs.run_study(sampler_grid=grid, **kw))
    results = edm_quality_study.main(["--members", "4", "--truths", "4", "--size", "8",
                                      "--device", "cpu"])
    assert set(results) == {r.name for r in qs.default_regimes(size=8)}
    for rows in results.values():
        assert set(rows) == {"edm_18", "dpmpp_25"}
        assert all(np.isfinite(m["std_ratio"]) and np.isfinite(m["spread_skill"])
                   for m in rows.values())


def _ensembles(seed: int, n=3, k=6, h=24, w=32):
    rng = np.random.default_rng(seed)
    truth = rng.normal(size=(n, h, w)).astype(np.float32)
    members = (truth[:, None] + 0.8 * rng.normal(size=(n, k, h, w))).astype(np.float32)
    return members, truth


def _close(a, b):
    if isinstance(a, dict):
        assert set(a) == set(b)
        for key in a:
            _close(a[key], b[key])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _close(x, y)
    elif a is None or b is None:
        assert a is b
    else:
        assert abs(a - b) <= REL * max(abs(a), abs(b), 1e-30), (a, b)


@pytest.mark.parametrize("seed", [0, 1])
def test_full_domain_helpers_match_jax(seed):
    jax_fdq = _jax_script("full_domain_quality_eval")
    members, truth = _ensembles(seed)
    crop = (4, 18, 6, 22)
    for mine, theirs in zip(fdq.region_masks(24, 32, crop), jax_fdq.region_masks(24, 32, crop)):
        np.testing.assert_array_equal(mine, theirs)
    in_mask, out_mask = fdq.region_masks(24, 32, crop)
    for mask in (None, in_mask, out_mask):
        _close(fdq.ens_metrics(members, truth, mask), jax_fdq.ens_metrics(members, truth, mask))
    _close(fdq.spectrum_logmse(members, truth), jax_fdq.spectrum_logmse(members, truth))


def _jax_metrics(members, truth, back):
    """JAX's ``metrics`` (scripts/flagship_quality_eval.py:169-215) on the JAX
    package's CRPS and spectrum functions."""
    n, k, h, w = members.shape
    out = {}
    for space, mem, tru in (("normalized", members, truth),
                            ("physical", np.asarray(back(members)), np.asarray(back(truth)))):
        crps = np.mean([jax_crps(mem[i], tru[i]).mean() for i in range(n)])
        mean = mem.mean(axis=1)
        rmse = float(np.sqrt(((mean - tru) ** 2).mean()))
        spread = float(np.sqrt(((mem - mean[:, None]) ** 2).sum(axis=1).mean() / (k - 1)))
        out[space] = {"crps": float(crps), "rmse_mean": rmse, "spread": spread,
                      "spread_skill": float(spread * np.sqrt((k + 1) / k) / rmse)}
    rng = np.random.default_rng(0)
    ii, jj = rng.integers(0, h, 400), rng.integers(0, w, 400)
    ranks = (members[:, :, ii, jj] < truth[:, None, ii, jj]).sum(axis=1).ravel()
    hist, _ = np.histogram(ranks, bins=np.arange(k + 2) - 0.5)
    out["rank_histogram"] = (hist / hist.sum()).round(5).tolist()

    def spec(fields):
        return jax_radial(np.mean([jax_ps(f) for f in fields], axis=0))

    s_gen = spec(members.reshape(-1, h, w)[:: max(1, k // 4)])
    out["spectrum_log_mse"] = float(np.mean((np.log(s_gen + 1e-12)
                                             - np.log(spec(truth) + 1e-12)) ** 2))
    return out


@pytest.mark.parametrize("seed", [0, 1])
def test_flagship_metrics_match_jax(trained, seed):
    """The port's ``metrics`` against JAX's formula on the JAX package's
    functions, with the checkpoint's own back-transform (log_zscore prcp)."""
    back = back_transforms_for_config(trained["cfg"])
    members, truth = _ensembles(seed)
    _close(flagship_quality_eval.metrics(members, truth, back),
           _jax_metrics(members, truth, back["generated"]))
    assert set(flagship_quality_eval.metrics(members, truth, {})) == FLAGSHIP_METRICS - {
        "physical"}

"""Torch port: the data-preparation and analysis layer against the JAX package's.

Splits, global statistics, temporal aggregation, store comparison,
correlations, preprocessing, the two data CLIs and the figures are numpy on
the host in both packages, so the same store goes through each JAX function
and its port, and the results must agree: the stores key for key and array
for array, every number within 1e-12 relative (0 expected: the port keeps the
JAX module's float64 sums in the same order), the same file names. One
synthetic store (32x48, 16 days, seed 1, written by the JAX generator, as
``tests/test_pipelines.py``) serves the module; a test that writes copies it
first. No JAX program is compiled.
"""

import dataclasses
import datetime
import json
import os
import shutil

import numpy as np
import pytest
import yaml

from sbgm_danra_tpu.cli import main_data_app as jax_data_app
from sbgm_danra_tpu.config import from_dict as jax_from_dict
from sbgm_danra_tpu.data.synthetic import SyntheticSpec, generate
from sbgm_danra_tpu.pipelines import comparison as jax_comparison
from sbgm_danra_tpu.pipelines import correlations as jax_correlations
from sbgm_danra_tpu.pipelines import figures as jax_figures
from sbgm_danra_tpu.pipelines import preprocess as jax_preprocess
from sbgm_danra_tpu.pipelines import splits as jax_splits
from sbgm_danra_tpu.pipelines import stats_pipeline as jax_stats
from sbgm_danra_tpu.utils import plotting as jax_plotting
from sbgm_danra_tpu_torch.cli import main_app, main_data_app
from sbgm_danra_tpu_torch.config import from_dict
from sbgm_danra_tpu_torch.data import zarrlite
from sbgm_danra_tpu_torch.data.paths import build_data_path
from sbgm_danra_tpu_torch.pipelines import (comparison, correlations, figures, preprocess,
                                            splits, stats_pipeline)
from sbgm_danra_tpu_torch.utils import plotting

GRID = (32, 48)
CROP = (4, 28, 8, 40)
RTOL = 1e-12  # stated; the two packages agree exactly here


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("torch_pipe_env"))
    generate(SyntheticSpec(root=root, full_domain=GRID, n_days=16, seed=1))
    return root


def _copy(env, dst) -> str:
    shutil.copytree(env, dst)
    return str(dst)


def config_dict(root: str, **sections) -> dict:
    d = {
        "paths": {"data_dir": root, "stats_load_dir": os.path.join(root, "stats_out"),
                  "sample_dir": os.path.join(root, "samples")},
        "highres": {"model": "DANRA", "variable": "temp", "data_size": [16, 16],
                    "full_domain_dims": list(GRID), "cutout_domains": list(CROP),
                    "scaling_method": "zscore"},
        "lowres": {"model": "ERA5", "condition_variables": ["temp"],
                   "scaling_methods": ["zscore"], "full_domain_dims": list(GRID)},
        "data_handling": {"num_workers": 2},
    }
    d.update(sections)
    return d


def assert_same(got, want, path="result"):
    """Nested dicts, lists and arrays equal within ``RTOL`` (NaN equal to NaN)."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), path
        for k in want:
            assert_same(got[k], want[k], f"{path}[{k!r}]")
    elif isinstance(want, (list, tuple)) and not (want and np.isscalar(want[0])
                                                  and not isinstance(want[0], str)):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            assert_same(g, w, f"{path}[{i}]")
    elif isinstance(want, (str, datetime.datetime)) or want is None:
        assert got == want, path
    else:
        np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64),
                                   rtol=RTOL, atol=0, equal_nan=True, err_msg=path)


def assert_stores_equal(a: str, b: str):
    ga, gb = zarrlite.open_group(a), zarrlite.open_group(b)
    assert ga.keys() == gb.keys(), (a, b)
    for day in ga.keys():
        assert ga[day].keys() == gb[day].keys(), day
        for key in ga[day].keys():
            np.testing.assert_array_equal(ga[day][key][...], gb[day][key][...])


def files_under(root: str) -> set:
    return {os.path.relpath(os.path.join(d, f), root) for d, _, fs in os.walk(root) for f in fs}


# -- splits --------------------------------------------------------------------------------


@pytest.mark.parametrize("section", [
    {"method": "Time", "train_years": [1990, 1999], "valid_years": [2000, 2000],
     "test_years": [2001, 2002]},
    {"method": "Random", "seed": 3},
], ids=["Time", "Random"])
def test_splits_from_config_match_jax(env, tmp_path, section):
    mine_root, jax_root = _copy(env, tmp_path / "mine"), _copy(env, tmp_path / "jax")
    d = {**config_dict(""), "splits": section}
    written = splits.create_splits_from_config(
        from_dict({**d, "paths": {"data_dir": mine_root}}))
    want = jax_splits.create_splits_from_config(
        jax_from_dict({**d, "paths": {"data_dir": jax_root}}))
    assert written == want
    assert sum(n for k, n in written.items() if k.startswith("DANRA/temp/")) == 16
    for key in written:
        model, var, split = key.split("/")
        assert_stores_equal(build_data_path(mine_root, model, var, GRID, split),
                            build_data_path(jax_root, model, var, GRID, split))


def test_assign_splits_and_unknown_method():
    dates = [f"2000{m:02d}{d:02d}" for m in (1, 6, 11) for d in range(1, 11)]
    for spec in (dict(method="Random", seed=7, fractions={"a": 0.5, "b": 0.3, "c": 0.2}),
                 dict(method="Time", year_ranges={"x": (1999, 2000)})):
        assert (splits.assign_splits(dates, splits.SplitSpec(**spec))
                == jax_splits.assign_splits(dates, jax_splits.SplitSpec(**spec)))
    for mod in (splits, jax_splits):
        with pytest.raises(ValueError, match="Unknown split method"):
            mod.assign_splits(dates, mod.SplitSpec(method="Blocked"))


# -- statistics ----------------------------------------------------------------------------


@pytest.mark.parametrize("var,model", [("temp", "DANRA"), ("prcp", "ERA5")])
def test_compute_global_stats_matches_jax(env, var, model):
    store = build_data_path(env, model, var, GRID, "all")
    for crop in (None, CROP):
        got = stats_pipeline.compute_global_stats(store, var, model, crop, num_workers=3)
        want = jax_stats.compute_global_stats(store, var, model, crop, num_workers=3)
        assert_same(got, want)
        assert got == want  # bit-equal, beyond the stated tolerance


def test_run_data_statistics_writes_jax_files(env, tmp_path):
    d = config_dict(env, lowres={"model": "ERA5", "condition_variables": ["temp", "prcp"],
                                 "scaling_methods": ["zscore", "log_zscore"],
                                 "full_domain_dims": list(GRID), "cutout_domains": list(CROP)})
    mine, theirs = str(tmp_path / "mine"), str(tmp_path / "jax")
    got = stats_pipeline.run_data_statistics(
        from_dict({**d, "paths": {**d["paths"], "stats_load_dir": mine}}))
    want = jax_stats.run_data_statistics(
        jax_from_dict({**d, "paths": {**d["paths"], "stats_load_dir": theirs}}))
    assert_same(got, want)
    assert files_under(mine) == files_under(theirs) and len(files_under(mine)) == 6
    for rel in files_under(mine):
        with open(os.path.join(mine, rel)) as f, open(os.path.join(theirs, rel)) as g:
            assert_same(json.load(f), json.load(g), rel)


def test_streaming_stats_empty_raises():
    with pytest.raises(ValueError, match="No data"):
        stats_pipeline.StreamingStats().finalize()


@pytest.mark.parametrize("agg_method", ["mean", "sum", "max", "min"])
@pytest.mark.parametrize("agg_time", ["daily", "weekly", "monthly", "yearly"])
def test_aggregation_matches_jax(agg_time, agg_method):
    rng = np.random.default_rng(11)
    ts = [datetime.datetime(1999, 12, 20) + datetime.timedelta(days=5 * i) for i in range(30)]
    fields = [rng.normal(size=(3, 4)) for _ in ts]
    got = stats_pipeline.aggregate_fields(fields, ts, agg_time, agg_method)
    want = jax_stats.aggregate_fields(fields, ts, agg_time, agg_method)
    assert_same(got, want)
    got_s = list(stats_pipeline.aggregate_stream(zip(fields, ts), agg_time, agg_method))
    want_s = list(jax_stats.aggregate_stream(zip(fields, ts), agg_time, agg_method))
    assert [t for t, _ in got_s] == [t for t, _ in want_s]
    assert_same([c for _, c in got_s], [c for _, c in want_s])


def test_aggregation_errors_match_jax():
    # ISO weeks 1999-52, 2000-1, then 1999-52 again
    ts = [datetime.datetime(2000, 1, d) for d in (1, 10, 2)]
    fields = [np.ones((2, 2))] * 3
    for mod in (stats_pipeline, jax_stats):
        with pytest.raises(ValueError, match="reappeared"):
            list(mod.aggregate_stream(zip(fields, ts), "weekly"))
        with pytest.raises(ValueError, match="Unsupported aggregation_time"):
            mod.aggregate_fields(fields, ts, "hourly")
        with pytest.raises(ValueError, match="Unsupported aggregation method"):
            list(mod.aggregate_stream(zip(fields, ts), "monthly", "median"))


# -- comparison, correlations, preprocessing -----------------------------------------------


def test_run_comparison_by_season_matches_jax(env):
    args = (build_data_path(env, "DANRA", "temp", GRID, "all"),
            build_data_path(env, "ERA5", "temp", GRID, "all"), "temp")
    kw = dict(crop=CROP, by_season=True, max_days=12)
    got = comparison.run_comparison(*args, **kw)
    want = jax_comparison.run_comparison(*args, **kw)
    assert_same(got, want)
    assert list(got["seasonal_spectra"]) == [4]
    const = np.ones((4, 4))
    assert_same(comparison.compare_fields(const, np.eye(4)),
                jax_comparison.compare_fields(const, np.eye(4)))


def test_run_correlations_matches_jax(env):
    args = (build_data_path(env, "DANRA", "temp", GRID, "all"),
            build_data_path(env, "ERA5", "prcp", GRID, "all"), "temp", "prcp")
    kw = dict(crop=CROP, transforms={"prcp": np.log1p})
    got = correlations.run_correlations(*args, **kw)
    want = jax_correlations.run_correlations(*args, **kw)
    assert_same(got, want)
    assert np.isfinite(got["temporal_spearman"])
    with pytest.raises(ValueError, match="Unknown method"):
        correlations.compute_temporal_correlation(np.arange(3), np.arange(3), "kendall")


def test_filter_store_and_npz_conversion_match_jax(tmp_path):
    fields = {"temp_8x8_20000101": np.ones((8, 8), np.float32),
              "temp_8x8_20000102": np.ones((4, 4), np.float32),
              "temp_8x8_20000103": np.full((8, 8), np.nan, np.float32)}
    mine, theirs = str(tmp_path / "mine.zarr"), str(tmp_path / "jax.zarr")
    preprocess.fields_to_zarr(mine, fields)
    jax_preprocess.fields_to_zarr(theirs, fields)
    assert_stores_equal(mine, theirs)
    for kw in (dict(expected_shape=(8, 8)), dict(required_keys=("t",))):
        assert preprocess.filter_store(mine, **kw) == jax_preprocess.filter_store(theirs, **kw)
    npz_dir = tmp_path / "npz"
    npz_dir.mkdir()
    rng = np.random.default_rng(0)
    for day in ("20000101", "20000102"):
        np.savez(npz_dir / f"temp_8x8_{day}.npz", data=rng.normal(size=(8, 8)), t=np.ones(3))
    (npz_dir / "temp_8x8_20000103.npz").write_bytes(b"not an npz")
    assert (preprocess.npz_dir_to_zarr(str(npz_dir), str(tmp_path / "a.zarr"))
            == jax_preprocess.npz_dir_to_zarr(str(npz_dir), str(tmp_path / "b.zarr")) == 2)
    assert_stores_equal(str(tmp_path / "a.zarr"), str(tmp_path / "b.zarr"))


def test_small_data_batches_match_jax(env, tmp_path):
    variables = {"DANRA": ["temp", "prcp"], "ERA5": ["temp"]}
    got = preprocess.create_small_data_batches(env, str(tmp_path / "a"), variables, GRID,
                                               n_samples=5, seed=4)
    want = jax_preprocess.create_small_data_batches(env, str(tmp_path / "b"), variables, GRID,
                                                    n_samples=5, seed=4)
    assert got == want == {"DANRA/temp": 5, "DANRA/prcp": 5, "ERA5/temp": 5}
    for model, vars_ in variables.items():
        for var in vars_:
            assert_stores_equal(build_data_path(str(tmp_path / "a"), model, var, GRID, "all_small"),
                                build_data_path(str(tmp_path / "b"), model, var, GRID, "all_small"))


# -- the CLIs --------------------------------------------------------------------------------


DATA_MODES = {
    "create_splits": ["splits.method=Random"],
    "run_statistics": ["--agg_time", "monthly", "--agg_method", "max"],
    "run_comparison": [],
    "create_small_batches": ["--n_samples", "3"],
    "run_correlation": ["--figures"],
}


@pytest.mark.parametrize("mode", list(DATA_MODES))
def test_data_cli_mode_writes_what_jax_writes(env, tmp_path, mode):
    """Each mode of ``main_data_app`` on a copy of the store, beside JAX's on
    another: the same files (stores array for array, statistics JSONs within
    ``RTOL``, figures by name) and, where JAX logs a result, the same line."""
    roots = {}
    for side, run in (("mine", main_data_app.main), ("jax", jax_data_app.main)):
        root = roots[side] = _copy(env, tmp_path / side)
        path = os.path.join(str(tmp_path), f"{side}.yaml")
        with open(path, "w") as f:
            yaml.safe_dump(config_dict(root), f)
        extra = (["--out_dir", os.path.join(root, "small")]
                 if mode == "create_small_batches" else [])
        run(["--config_path", path, "--mode", mode, *DATA_MODES[mode], *extra])
    mine, theirs = files_under(roots["mine"]), files_under(roots["jax"])
    assert mine == theirs
    new = mine - files_under(env)
    assert new or mode in ("run_comparison",)
    for rel in sorted(new):
        if rel.endswith(".json") and "stats_out" in rel:
            with open(os.path.join(roots["mine"], rel)) as f, \
                    open(os.path.join(roots["jax"], rel)) as g:
                assert_same(json.load(f), json.load(g), rel)
    stores = {r.split(".zarr/")[0] + ".zarr" for r in new if ".zarr/" in r}
    assert len(stores) == {"create_splits": 6, "create_small_batches": 2}.get(mode, 0)
    for rel in stores:
        assert_stores_equal(os.path.join(roots["mine"], rel), os.path.join(roots["jax"], rel))
    assert sum(r.endswith(".png") for r in new) == (3 if mode == "run_correlation" else 0)


def test_data_cli_returns_its_results(env, tmp_path):
    root = _copy(env, tmp_path / "data")
    path = str(tmp_path / "cfg.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(config_dict(root), f)
    out = main_data_app.main(["--config_path", path, "--mode", "run_comparison"])
    want = jax_comparison.run_comparison(
        build_data_path(root, "DANRA", "temp", GRID, "all"),
        build_data_path(root, "ERA5", "temp", GRID, "all"), "temp", crop=CROP, by_season=True)
    assert_same(out["comparison"], want)
    out = main_data_app.main(["--config_path", path, "--mode", "run_statistics",
                              "--agg_time", "weekly"])
    assert out["composites"]["periods"] == 3 and np.isfinite(out["composites"]["std"])
    assert set(out["statistics"]) == {"DANRA/temp/full/all", "DANRA/temp/4_28_8_40/all",
                                      "ERA5/temp/full/all"}


@pytest.mark.parametrize("mode", ["data_splits", "run_statistics"])
def test_main_app_data_modes_write_what_jax_writes(env, tmp_path, mode):
    """``main_app``'s two data-preparation modes against what JAX's ``run_mode``
    calls for them (``create_splits_from_config``, ``run_data_statistics``)."""
    d = config_dict("", splits={"method": "Random", "seed": 2})
    roots = {side: _copy(env, tmp_path / side) for side in ("mine", "jax")}
    path = str(tmp_path / "mine.yaml")
    with open(path, "w") as f:
        yaml.safe_dump({**d, "paths": {**d["paths"], "data_dir": roots["mine"],
                                       "stats_load_dir": os.path.join(roots["mine"], "st")}}, f)
    got = main_app.main(["--config_path", path, "--mode", mode])
    jax_cfg = jax_from_dict({**d, "paths": {"data_dir": roots["jax"],
                                            "stats_load_dir": os.path.join(roots["jax"], "st")}})
    {"data_splits": jax_splits.create_splits_from_config,
     "run_statistics": jax_stats.run_data_statistics}[mode](jax_cfg)
    assert files_under(roots["mine"]) == files_under(roots["jax"])
    if mode == "data_splits":
        assert sum(n for k, n in got.items() if k.startswith("ERA5/")) == 16
        for key in got:
            model, var, split = key.split("/")
            assert_stores_equal(build_data_path(roots["mine"], model, var, GRID, split),
                                build_data_path(roots["jax"], model, var, GRID, split))
    else:
        for rel in files_under(os.path.join(roots["mine"], "st")):
            with open(os.path.join(roots["mine"], "st", rel)) as f, \
                    open(os.path.join(roots["jax"], "st", rel)) as g:
                assert_same(json.load(f), json.load(g), rel)


# -- figures ---------------------------------------------------------------------------------


def test_figures_write_the_pngs_jax_writes(env, tmp_path, monkeypatch):
    """Every figure function of ``utils/plotting.py`` and
    ``pipelines/figures.py`` on the same inputs as JAX's: the same files,
    each a PNG. JAX's side only names its files (``savefig`` writes an empty
    one), so that each figure is rendered once."""
    import matplotlib.figure

    rng = np.random.default_rng(3)
    store = build_data_path(env, "DANRA", "temp", GRID, "all")
    series = figures.per_timestep_series(store, "temp", "DANRA", crop=CROP, max_days=5)
    want_series = jax_figures.per_timestep_series(store, "temp", "DANRA", crop=CROP, max_days=5)
    assert_same({k: v for k, v in series.items() if k != "dates"},
                {k: v for k, v in want_series.items() if k != "dates"})
    assert list(series["dates"]) == list(want_series["dates"])
    corr = correlations.run_correlations(store, build_data_path(env, "ERA5", "temp", GRID, "all"),
                                         "temp", "temp", max_days=5)
    batch = {"x": rng.normal(size=(2, 8, 8, 1)), "cond_img": rng.normal(size=(2, 8, 8, 2)),
             "lsm_cond": rng.normal(size=(2, 8, 8, 2))}
    grid = {"temp_hr": rng.normal(size=(2, 8, 8, 1)), "prcp_lr": rng.normal(size=(2, 8, 8, 1)),
            "lsm": rng.normal(size=(2, 8, 8, 2)), "sdf": rng.normal(size=(2, 8, 8, 1))}
    field, lsm, generated = rng.normal(size=(8, 8)), rng.random((8, 8)), rng.normal(size=(2, 8, 8))
    dirs = {}
    for side, plots, figs in (("mine", plotting, figures), ("jax", jax_plotting, jax_figures)):
        if side == "jax":
            monkeypatch.setattr(matplotlib.figure.Figure, "savefig",
                                lambda self, path, **kw: open(path, "wb").close())
        out = dirs[side] = str(tmp_path / side)
        figs.plot_variable_statistics("temp", "DANRA", series, out)
        figs.plot_correlation_figures(corr, "temp", "temp", "DANRA", "ERA5", out)
        fig = plots.plot_samples_and_generated(batch, generated)
        fig.savefig(os.path.join(out, "grid.png"))
        plotting.pyplot().close(fig)
        plots.plot_pixel_histograms(field, field + 1, "degC", os.path.join(out, "pixel.png"))
        plots.plot_error_histograms(field, field, os.path.join(out, "err.png"))
        plots.plot_batch_grid(grid, "temp", path=os.path.join(out, "batch.png"))
        plots.plot_losses({"train_loss": [2.0, 1.0], "val_loss": [3.0, 1.5]},
                          os.path.join(out, "losses.png"))
        plots.plot_sample(field, "prcp", lsm, mask_ocean=True, path=os.path.join(out, "s.png"))
        plots.plot_sample_with_boxplot(field, "temp", lsm, True, os.path.join(out, "box.png"))
    assert files_under(dirs["mine"]) == files_under(dirs["jax"])
    assert len(files_under(dirs["mine"])) == 15
    for name in files_under(dirs["mine"]):
        with open(os.path.join(dirs["mine"], name), "rb") as f:
            assert f.read(8) == b"\x89PNG\r\n\x1a\n", name
    assert plotting.cmap_for("prcp") == jax_plotting.cmap_for("prcp") == "inferno"


def test_plot_or_skip_without_matplotlib(monkeypatch, caplog):
    import sys

    monkeypatch.setitem(sys.modules, "matplotlib", None)
    caplog.set_level("INFO", logger="sbgm_danra_tpu_torch.utils.plotting")
    assert plotting.plot_or_skip("losses", plotting.plot_losses, {"train_loss": [1.0]}) is None
    assert "figure losses skipped: matplotlib missing" in caplog.text
    with pytest.raises(ImportError):
        plotting.plot_losses({"train_loss": [1.0]})


def test_variable_registry_and_splits_defaults_are_jax_s():
    from sbgm_danra_tpu.utils.units import VARIABLE_REGISTRY as jax_registry
    from sbgm_danra_tpu_torch.utils.units import VARIABLE_REGISTRY

    assert VARIABLE_REGISTRY == jax_registry
    assert (dataclasses.asdict(from_dict({}).splits)
            == dataclasses.asdict(jax_from_dict({}).splits))

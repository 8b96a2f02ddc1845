"""Torch port: the host data path against the JAX package's on the CPU.

The copied numpy modules (paths, units, dates, resize, the host SDF, the
forward transforms, zarrlite, the synthetic generator, ``DanraDataset``) must
give the same arrays as JAX's on the same inputs (``np.array_equal``; the
synthetic stores byte for byte); the host ``DataLoader`` the same batches at
the same seed; the port's CLI writes a dataset and trains on it. One tiny
synthetic dataset (64x96 grid, 12 days, written by the JAX generator) serves
the module.
"""

import os

import numpy as np
import pytest
import torch
import yaml

from sbgm_danra_tpu import transforms as jax_T
from sbgm_danra_tpu.config import from_dict as jax_from_dict
from sbgm_danra_tpu.data import factory as jax_factory
from sbgm_danra_tpu.data import paths as jax_paths
from sbgm_danra_tpu.data import synthetic as jax_synthetic
from sbgm_danra_tpu.data.loader import DataLoader as JaxDataLoader
from sbgm_danra_tpu.data.loader import extract_batch as jax_extract_batch
from sbgm_danra_tpu.ops import resize as jax_resize
from sbgm_danra_tpu.ops import sdf as jax_sdf
from sbgm_danra_tpu.utils import dates as jax_dates
from sbgm_danra_tpu.utils import units as jax_units
from sbgm_danra_tpu_torch import transforms as T
from sbgm_danra_tpu_torch.cli import main_app
from sbgm_danra_tpu_torch.config import from_dict
from sbgm_danra_tpu_torch.data import factory, paths, synthetic, zarrlite
from sbgm_danra_tpu_torch.data.loader import DataLoader, device_prefetch, extract_batch
from sbgm_danra_tpu_torch.ops import resize, sdf
from sbgm_danra_tpu_torch.training.pipeline import TrainingPipeline
from sbgm_danra_tpu_torch.utils import dates, units

GRID = (64, 96)
CROP_REGION = (8, 56, 16, 80)


def config_dict(root: str, **sections) -> dict:
    """A tiny flagship-shaped run config (prcp HR in log_zscore, temp and prcp
    LR, lsm and topo, SDF loss, CFG 0.1, 4 seasons) over the module's data."""
    d = {
        "experiment": {"config_name": "tiny_data"},
        "paths": {
            "data_dir": root,
            "checkpoint_dir": os.path.join(root, "ckpt"),
            "sample_dir": os.path.join(root, "samples"),
            "lsm_path": jax_paths.lsm_path(root),
            "topo_path": jax_paths.topo_path(root),
            "stats_load_dir": os.path.join(root, "stats"),
        },
        "highres": {"variable": "prcp", "data_size": [32, 32], "scaling_method": "log_zscore",
                    "full_domain_dims": list(GRID), "cutout_domains": list(CROP_REGION)},
        "lowres": {"condition_variables": ["temp", "prcp"],
                   "scaling_methods": ["zscore", "log_zscore"], "full_domain_dims": list(GRID)},
        "sampler": {"time_embedding": 32, "last_fmap_channels": 64, "num_heads": 2,
                    "block_layers": [1, 1, 1, 1]},
        "data_handling": {"num_workers": 2, "n_gen_samples": 2},
        "training": {"seed": 3, "batch_size": 4, "epochs": 1, "steps_per_epoch": 2,
                     "lr_scheduler": "none", "early_stopping": False, "ema_decay": 0.9,
                     "monitor_extremes": False, "verbose": False},
        "classifier_free_guidance": {"enabled": True, "drop_prob": 0.1},
    }
    for name, values in sections.items():
        d[name] = {**d.get(name, {}), **values}
    return d


def spec_for(cls, root):
    return cls(root=root, full_domain=GRID, n_days=12, variables=("temp", "prcp"),
               crop_region=CROP_REGION, seed=5)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("torch_data"))
    jax_synthetic.generate(spec_for(jax_synthetic.SyntheticSpec, root))
    return root


@pytest.fixture(autouse=True)
def _onednn_off():
    """oneDNN corrupts the heap in the tiny UNet's training backward on this
    CPU (ROADMAP F5); the CLI tests train."""
    with torch.backends.mkldnn.flags(enabled=False):
        yield


def _files(root):
    out = {}
    for d, _, names in os.walk(root):
        for n in names:
            path = os.path.join(d, n)
            out[os.path.relpath(path, root)] = path
    return out


def test_synthetic_generate_writes_the_same_files(data, tmp_path):
    """Chunks, ``.zarray`` / ``.zgroup`` and statistics byte for byte; the
    geography npz files (zip members carry a time stamp) array for array."""
    synthetic.generate(spec_for(synthetic.SyntheticSpec, str(tmp_path)))
    want, got = _files(data), _files(str(tmp_path))
    assert sorted(want) == sorted(got) and len(want) > 100
    for rel, path in want.items():
        if rel.endswith(".npz"):
            with np.load(path) as a, np.load(got[rel]) as b:
                assert np.array_equal(a["data"], b["data"]), rel
            continue
        with open(path, "rb") as fa, open(got[rel], "rb") as fb:
            assert fa.read() == fb.read(), rel


def test_zarrlite_reads_windows_as_jax_does(data):
    from sbgm_danra_tpu.data import zarrlite as jax_zarrlite

    path = jax_paths.build_data_path(data, "DANRA", "prcp", GRID, "train")
    key = zarrlite.open_group(path).keys()[0]
    mine = zarrlite.open_group(path)[key]["data"]
    ref = jax_zarrlite.open_group(path)[key]["data"]
    for sel in (np.s_[...], np.s_[3:41, 10:77], np.s_[5], np.s_[-1, 2:9]):
        assert np.array_equal(mine[sel], ref[sel])


def _copied_cases():
    rng = np.random.default_rng(0)
    field = rng.normal(size=(2, 37, 53)).astype(np.float32) * 10
    mask = (rng.random((29, 31)) > 0.6).astype(np.float32)
    stats = {"mean": 3.1, "std": 2.2, "min": -5.0, "max": 12.0, "log_mean": 0.4,
             "log_std": 1.3, "log_min": -4.6, "log_max": 2.7}
    pos = np.abs(field)
    cases = {
        "paths": lambda m: (m["paths"].build_data_path("/d", "ERA5", "temp", (589, 789), "valid"),
                            m["paths"].build_data_path("/d", "DANRA", "prcp", (5, 7), "all", False),
                            m["paths"].lsm_path("/d"), m["paths"].topo_path("/d")),
        "units": lambda m: [m["units"].correct_variable_units(v, mod, field)
                            for v, mod in (("temp", "ERA5"), ("prcp", "DANRA"), ("prcp", "ERA5"),
                                           ("cape", "ERA5"), ("msl", "ERA5"), ("z_pl_500", "ERA5"),
                                           ("nwvf", "DANRA"))],
        "dates": lambda m: [(m["dates"].file_date(f"temp_589x789_{d}"),
                             *(m["dates"].classifier_from_date(d, n) for n in (4, 12, 366, None)))
                            for d in ("20000229", "20011231", "19990615", "20040301")],
        "resize": lambda m: [m["resize"].resize(field, hw, mode) for hw in ((64, 64), (16, 21))
                             for mode in ("bilinear", "nearest")],
        "host_sdf": lambda m: [m["sdf"].sdf_from_mask(mask), m["sdf"].generate_sdf(mask),
                               m["sdf"].sdf_from_mask(np.ones_like(mask))],
        "forward_transforms": lambda m: [
            m["T"].transform_from_stats(kind, stats, 0.3)(x)
            for kind, x in (("zscore", field), ("scale01", field), ("scale_minus1_1", field),
                            ("log", pos), ("log_01", pos), ("log_minus1_1", pos),
                            ("log_zscore", pos), ("none", field))]
        + [m["T"].Compose((m["T"].ZScore(1.0, 2.0), m["T"].LinearScale(-1.0, 1.0, -3.0, 4.0)))(
            field)],
    }
    return cases


PORT = {"paths": paths, "units": units, "dates": dates, "resize": resize, "sdf": sdf, "T": T}
JAX = {"paths": jax_paths, "units": jax_units, "dates": jax_dates, "resize": jax_resize,
       "sdf": jax_sdf, "T": jax_T}


@pytest.mark.parametrize("case", sorted(_copied_cases()))
def test_copied_modules_match_jax(case):
    """The same inputs give equal outputs (``np.array_equal``); numpy in gives
    numpy out."""
    fn = _copied_cases()[case]
    got, want = fn(PORT), fn(JAX)
    for g, w in zip(got, want):
        if isinstance(w, np.ndarray):
            assert isinstance(g, np.ndarray) and g.dtype == w.dtype, case
            assert np.array_equal(g, w), case
        else:
            assert g == w, case


def test_load_global_stats_and_missing(data):
    args = (os.path.join(data, "stats"), "DANRA", "prcp", "64x96", "8_56_16_80", "all")
    assert T.load_global_stats(*args) == jax_T.load_global_stats(*args) is not None
    assert T.load_global_stats(*args[:-1], "nope") is None


def _datasets(root, split, **kw):
    d = config_dict(root)
    return (factory.make_dataset(from_dict(d), split, **kw),
            jax_factory.make_dataset(jax_from_dict(d), split, **kw))


def _assert_items_equal(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        assert np.asarray(got[k]).dtype == np.asarray(want[k]).dtype, k
        assert np.array_equal(got[k], want[k]), k


@pytest.mark.parametrize("split,kw", [("train", {}), ("test", {"full_domain": True})])
def test_dataset_items_match_jax(data, split, kw):
    """Every item of the split, drawn with the same per-index generator: crops,
    units, transforms, geo, SDF, classes, CFG dropout (train)."""
    mine, ref = _datasets(data, split, **kw)
    assert mine.common_dates == ref.common_dates
    for i in range(len(ref)):
        for seed in range(3 if split == "train" else 1):
            _assert_items_equal(mine.__getitem__(i, rng=np.random.default_rng((seed, i))),
                                ref.__getitem__(i, rng=np.random.default_rng((seed, i))))
    if kw:
        assert mine[0]["prcp_hr"].shape == (*GRID, 1)


@pytest.mark.parametrize("workers", [1, 3])
def test_host_loader_batches_match_jax(data, workers):
    """Epochs 0 and 1 of the shuffled train loader: the same batches, array
    for array, at the same seed."""
    mine, ref = _datasets(data, "train")
    a = DataLoader(mine, batch_size=3, shuffle=True, num_workers=workers, seed=7)
    b = JaxDataLoader(ref, batch_size=3, shuffle=True, num_workers=workers, seed=7)
    assert len(a) == len(b) == 2
    for epoch in (0, 1):
        a.set_epoch(epoch)
        b.set_epoch(epoch)
        got, want = list(a), list(b)
        assert len(got) == len(want) == 2
        for g, w in zip(got, want):
            _assert_items_equal(g, w)
            _assert_items_equal(extract_batch(g, "prcp"), jax_extract_batch(w, "prcp"))


def test_device_prefetch_passes_cpu_batches_through():
    batches = [{"x": np.full((2, 3), i, np.float32)} for i in range(4)]
    assert list(device_prefetch(iter(batches), depth=2, device="cpu")) == batches


@pytest.mark.parametrize("device_dataset", [False, True])
def test_cli_synthetic_data_then_train(tmp_path, device_dataset):
    """``--mode synthetic_data`` then ``--mode train --device cpu``: one epoch
    of 2 steps, finite losses, a checkpoint that ``TrainingPipeline.load``
    reads back."""
    root = str(tmp_path)
    d = config_dict(root, data_handling={"device_dataset": device_dataset},
                    visualization={"plot_losses": True})
    path = os.path.join(root, "run.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(d, f)
    main_app.main(["--config_path", path, "--mode", "synthetic_data", "--n_days", "12",
                   "--no_all_split"])
    assert not os.path.exists(paths.build_data_path(root, "DANRA", "prcp", GRID, "all"))
    main_app.main(["--config_path", path, "--mode", "train", "--device", "cpu",
                   "training.verbose=true"])
    cfg = from_dict(d)
    pipe = TrainingPipeline(cfg, [], device="cpu")
    pipe.load()
    assert pipe.epoch == 1 and pipe.state.step == 2
    assert all(np.isfinite(pipe.history["train_loss"] + pipe.history["val_loss"]))
    written = set(os.listdir(os.path.join(root, "samples")))
    assert {f"losses_{pipe.model_string}.json", f"losses_{pipe.model_string}.png",
            f"config_{pipe.model_string}.yaml"} <= written


STATS_KEYS_EXACT = ("mean", "min", "max", "log_mean", "log_min", "log_max")


@pytest.mark.parametrize("mode", ["data_splits", "run_statistics"])
def test_cli_data_prep_modes(tmp_path, mode):
    """``--mode synthetic_data`` (with the 'all' split), then ``--mode
    data_splits`` (Random: every synthetic day falls in 2000) or ``--mode
    run_statistics`` into a fresh statistics directory. Splits: each store's
    train/valid/test days add up to the 12, are disjoint, and equal the 'all'
    store's days. Statistics: every JSON the synthetic writer also wrote
    agrees with it (its sums are shifted, ``StreamingStats``' are not: 1e-9
    relative, std 1e-6)."""
    root = str(tmp_path)
    path = os.path.join(root, "run.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(config_dict(root, splits={"method": "Random", "seed": 1}), f)
    main_app.main(["--config_path", path, "--mode", "synthetic_data", "--n_days", "12"])
    if mode == "data_splits":
        written = main_app.main(["--config_path", path, "--mode", mode])
        assert len(written) == 3 * 3  # DANRA prcp, ERA5 temp and prcp x three splits
        for model, var in (("DANRA", "prcp"), ("ERA5", "temp"), ("ERA5", "prcp")):
            every = zarrlite.open_group(paths.build_data_path(root, model, var, GRID, "all"))
            days = []
            for split in ("train", "valid", "test"):
                store = zarrlite.open_group(paths.build_data_path(root, model, var, GRID, split))
                assert written[f"{model}/{var}/{split}"] == len(store.keys()) > 0
                for key in store.keys():
                    assert np.array_equal(store[key]["data"][...], every[key]["data"][...])
                days += store.keys()
            assert sorted(days) == every.keys() and len(days) == 12
    else:
        out_dir = os.path.join(root, "stats_new")
        results = main_app.main(["--config_path", path, "--mode", mode,
                                 f"paths.stats_load_dir={out_dir}"])
        crop = "_".join(map(str, CROP_REGION))
        assert set(results) == {f"DANRA/prcp/full/all", f"DANRA/prcp/{crop}/all",
                                "ERA5/temp/full/all", "ERA5/prcp/full/all"}
        for key in results:
            model, var, crop_str, split = key.split("/")
            size = f"{GRID[0]}x{GRID[1]}"
            got = T.load_global_stats(out_dir, model, var, size, crop_str, split)
            want = T.load_global_stats(os.path.join(root, "stats"), model, var, size,
                                       crop_str, split)
            assert got["n"] == 12 * (GRID[0] * GRID[1] if crop_str == "full" else 48 * 64)
            for k, v in want.items():
                tol = 1e-9 if k in STATS_KEYS_EXACT else 1e-6
                assert abs(got[k] - v) <= tol * abs(v), (key, k, got[k], v)


def test_fused_steps_guard_and_windowed_residency(data):
    """fused_steps needs a device train loader, as in JAX, and then runs K
    steps per dispatch (one chunk of 4 steps where 1 is asked: JAX's ceil);
    a window of days builds the rotating-window train loader (the valid split
    stays resident), which the fused steps take as well."""
    d = config_dict(data, training={"fused_steps": 4})
    mine_host = factory.make_loaders(from_dict(d), device="cpu")[0]
    with pytest.raises(ValueError, match="device-resident"):
        TrainingPipeline(from_dict(d), mine_host, device="cpu")
    dd = config_dict(data, training={"fused_steps": 4}, data_handling={"device_dataset": True})
    train = factory.make_loaders(from_dict(dd), device="cpu")[0]
    pipe = TrainingPipeline(from_dict(dd), train, device="cpu")
    assert np.isfinite(pipe.train_batches(1))
    assert pipe.state.step == 4 and train.epoch == 1
    from sbgm_danra_tpu_torch.data.device_data import DeviceDataLoader
    from sbgm_danra_tpu_torch.data.windowed_data import WindowedDeviceLoader

    windowed = config_dict(data, training={"fused_steps": 4},
                           data_handling={"device_dataset": True, "device_window_days": 4})
    train, valid, _ = factory.make_loaders(from_dict(windowed), device="cpu")
    assert isinstance(train, WindowedDeviceLoader) and isinstance(valid, DeviceDataLoader)
    assert train.n_windows == 2 and train.window_days == 4
    pipe = TrainingPipeline(from_dict(windowed), train, device="cpu")
    assert np.isfinite(pipe.train_batches(1))
    assert pipe.state.step == 4 and train.epoch == 1


@pytest.mark.parametrize("shape,key", [((30, 40), "data"), ((1, 30, 40), "tp"),
                                       ((2, 3, 30, 40), "arr_0")])
def test_windowed_field_read_equals_jax_crop(tmp_path, shape, key):
    """``extract_2d(..., window=...)`` decodes only the chunks under the crop
    and gives JAX's whole-field read cropped, leading axes at index 0."""
    from sbgm_danra_tpu.data import zarrlite as jax_zarrlite
    from sbgm_danra_tpu.data.dataset import extract_2d as jax_extract_2d
    from sbgm_danra_tpu_torch.data.dataset import extract_2d

    data = np.random.default_rng(1).normal(size=shape).astype(np.float32)
    group = zarrlite.open_group(str(tmp_path / "s.zarr"), mode="w")
    group.create_group("prcp_30x40_20000101").array(key, data, chunks=(*shape[:-2], 8, 16))
    read = zarrlite.open_group(str(tmp_path / "s.zarr"))
    want = jax_extract_2d(jax_zarrlite.open_group(str(tmp_path / "s.zarr")),
                          "prcp_30x40_20000101", "prcp")
    for window in ((3, 20, 5, 37), (0, 30, 0, 40), (9, 10, 39, 40)):
        x1, x2, y1, y2 = window
        got = extract_2d(read, "prcp_30x40_20000101", "prcp", window=window)
        assert np.array_equal(got, want[x1:x2, y1:y2])
    assert np.array_equal(extract_2d(read, "prcp_30x40_20000101", "prcp"), want)

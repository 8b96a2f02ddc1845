"""Config -> datasets and loaders (counterpart of ``sbgm_danra_tpu/data/factory.py``).

``make_dataset`` is a copy (``full_domain=True`` included). ``make_loaders``
builds the same three loaders as JAX: with ``data_handling.device_dataset``
the train and valid splits live on ``device`` (``DeviceDataLoader``), else
they are host ``DataLoader``s; the gen loader over the test split is a host
loader either way. With ``device_window_days > 0`` the train split rotates
through two card windows (``WindowedDeviceLoader``, for archives larger than
the card) and the valid split stays fully resident.
"""

from __future__ import annotations

import logging
from typing import Optional, Tuple

import numpy as np
import torch

from sbgm_danra_tpu_torch import transforms as T
from sbgm_danra_tpu_torch.data.dataset import DanraDataset, VariableSource
from sbgm_danra_tpu_torch.data.loader import DataLoader
from sbgm_danra_tpu_torch.data.paths import build_data_path

logger = logging.getLogger(__name__)


def _load_geo_npz(path: str, flip: bool = False) -> np.ndarray:
    """Load a full-domain geo field from npz (reference training_utils.py:139-167).

    The reference applies np.flipud to its production files (stored north-up);
    synthetic data is already array-oriented, so flipping is opt-in.
    """
    with np.load(path) as z:
        key = "data" if "data" in z else list(z.keys())[0]
        arr = np.asarray(z[key], dtype=np.float32)
    return np.flipud(arr).copy() if flip else arr


def _domain_str(dims) -> str:
    return f"{dims[0]}x{dims[1]}"


def _crop_str(domains) -> str:
    return "_".join(map(str, domains)) if domains else "full"


def _make_transform(
    cfg, variable: str, model: str, method: str, domain_str: str, crop_str: str,
    buffer_frac: float, inline_params: Optional[dict],
) -> Optional[T.Transform]:
    """Stats-file transform if available, else legacy inline params
    (the dual convention of default_config.yaml vs full_run_config_new.yaml)."""
    stats_root = cfg.paths.stats_load_dir
    stats = T.load_global_stats(stats_root, model, variable, domain_str, crop_str, "all")
    if stats is not None:
        return T.transform_from_stats(method, stats, buffer_frac)
    if inline_params:
        p = inline_params
        stats = {
            "mean": p.get("glob_mean"), "std": p.get("glob_std"),
            "min": p.get("glob_min"), "max": p.get("glob_max"),
            "log_mean": p.get("glob_mean_log"), "log_std": p.get("glob_std_log"),
            "log_min": p.get("glob_min_log"), "log_max": p.get("glob_max_log"),
        }
        return T.transform_from_stats(method, stats, p.get("buffer_frac", buffer_frac))
    raise FileNotFoundError(
        f"No stats for {model}/{variable} under {stats_root} and no inline "
        "scaling_params in the config — run the statistics pipeline first."
    )


def make_dataset(
    cfg, split: str, n_samples: Optional[int] = None, full_domain: bool = False
) -> DanraDataset:
    """``full_domain=True`` yields FULL-field samples (no cutouts, sizes =
    full_domain_dims) while keeping the transform stats keyed exactly as in
    training — the model was normalized with the training-crop statistics, so
    full-domain inference must reuse them (evaluate/full_domain.py)."""
    hr_cfg, lr_cfg = cfg.highres, cfg.lowres
    geo_cfg = cfg.stationary_conditions.geographic_conditions
    season_cfg = cfg.stationary_conditions.seasonal_conditions
    scaling = cfg.transforms.scaling
    stats_cutouts = cfg.transforms.sample_w_cutouts
    cutouts = stats_cutouts and not full_domain
    if full_domain and stats_cutouts and scaling:
        # Scientific caveat (VERDICT r2 weak 5): the model only ever saw
        # training-crop statistics, so whole-domain conditioning is normalized
        # with them too. Regions whose climate leaves the crop's envelope
        # (e.g. far-field topography-driven extremes) will be mis-normalized.
        logger.warning(
            "full-domain sampling normalizes whole-domain conditioning with "
            "TRAINING-CROP statistics (crop %s): values outside the crop's "
            "climate envelope are mis-normalized; interpret far-from-crop "
            "regions with care (docs/DESIGN.md 'Full-domain stats caveat').",
            cfg.highres.cutout_domains,
        )

    hr_domain = _domain_str(hr_cfg.full_domain_dims)
    lr_domain = _domain_str(lr_cfg.full_domain_dims)
    hr_crop = _crop_str(hr_cfg.cutout_domains if stats_cutouts else None)
    lr_crop = _crop_str(lr_cfg.cutout_domains if stats_cutouts else None)

    hr_transform = (
        _make_transform(
            cfg, hr_cfg.variable, hr_cfg.model, hr_cfg.scaling_method, hr_domain,
            hr_crop, hr_cfg.buffer_frac, hr_cfg.scaling_params,
        )
        if scaling
        else None
    )
    hr = VariableSource(
        name=hr_cfg.variable,
        model=hr_cfg.model,
        zarr_path=build_data_path(
            cfg.paths.data_dir, hr_cfg.model, hr_cfg.variable, hr_cfg.full_domain_dims, split
        ),
        scaling_method=hr_cfg.scaling_method,
        transform=hr_transform,
    )
    lr_sources = []
    inline_list = lr_cfg.scaling_params or [None] * len(lr_cfg.condition_variables or ())
    for i, (var, method) in enumerate(
        zip(lr_cfg.condition_variables or (), lr_cfg.scaling_methods or ())
    ):
        transform = (
            _make_transform(
                cfg, var, lr_cfg.model, method, lr_domain, lr_crop,
                lr_cfg.buffer_frac, inline_list[i] if i < len(inline_list) else None,
            )
            if scaling
            else None
        )
        lr_sources.append(
            VariableSource(
                name=var,
                model=lr_cfg.model,
                zarr_path=build_data_path(
                    cfg.paths.data_dir, lr_cfg.model, var, lr_cfg.full_domain_dims, split
                ),
                scaling_method=method,
                transform=transform,
            )
        )

    lsm = topo = None
    if geo_cfg.sample_w_geo:
        lsm = _load_geo_npz(cfg.paths.lsm_path)
        topo = _load_geo_npz(cfg.paths.topo_path)

    hr_size = tuple(hr_cfg.full_domain_dims) if full_domain else tuple(hr_cfg.data_size)
    if full_domain:
        lr_size = tuple(lr_cfg.full_domain_dims)
    else:
        lr_size = tuple(lr_cfg.data_size) if lr_cfg.data_size else None
    return DanraDataset(
        hr=hr,
        lr_conditions=lr_sources,
        hr_data_size=hr_size,
        lr_data_size=lr_size,
        cutouts=cutouts,
        cutout_domains=hr_cfg.cutout_domains,
        lr_cutout_domains=lr_cfg.cutout_domains,
        resize_factor=lr_cfg.resize_factor,
        geo_variables=geo_cfg.geo_variables if geo_cfg.sample_w_geo else (),
        lsm_full_domain=lsm,
        topo_full_domain=topo,
        topo_norm=(geo_cfg.norm_min, geo_cfg.norm_max),
        split=split,
        n_samples=n_samples,
        cache_size=cfg.data_handling.cache_size,
        sdf_weighted_loss=cfg.training.sdf_weighted_loss and geo_cfg.sample_w_sdf,
        conditional_seasons=season_cfg.sample_w_cond_season,
        n_classes=season_cfg.n_seasons if season_cfg.sample_w_cond_season else None,
        cfg_dropout_enabled=cfg.classifier_free_guidance.enabled,
        cfg_dropout_prob=cfg.classifier_free_guidance.drop_prob,
        seed=cfg.training.seed,
    )


def make_loaders(cfg, device="cuda") -> Tuple:
    """train / valid / gen loaders. With ``data_handling.device_dataset`` the
    train and valid splits are resident on ``device`` and each batch is put
    together there; the gen loader stays on the host (small, and its samples
    carry dates)."""
    dh, t = cfg.data_handling, cfg.training
    if dh.device_dataset:
        from sbgm_danra_tpu_torch.data.device_data import DeviceDataLoader

        if dh.device_window_days > 0:
            # an archive larger than the card: rotating windows for the train
            # split (data/windowed_data.py); valid below stays fully resident
            from sbgm_danra_tpu_torch.data.windowed_data import WindowedDeviceLoader

            if dh.device_window_dtype not in ("float32", "bfloat16"):
                raise ValueError("data_handling.device_window_dtype must be 'float32' or "
                                 f"'bfloat16', got {dh.device_window_dtype!r}")
            train = WindowedDeviceLoader(
                make_dataset(cfg, "train"),
                batch_size=t.batch_size,
                window_days=dh.device_window_days,
                steps_per_epoch=t.steps_per_epoch,
                window_steps=dh.device_window_steps,
                seed=t.seed,
                cfg_dropout_prob=cfg.classifier_free_guidance.drop_prob,
                dtype=getattr(torch, dh.device_window_dtype),
                layout=dh.device_window_layout,
                device=device,
            )
        else:
            train = DeviceDataLoader(
                make_dataset(cfg, "train"),
                batch_size=t.batch_size,
                steps_per_epoch=t.steps_per_epoch,
                seed=t.seed,
                cfg_dropout_prob=cfg.classifier_free_guidance.drop_prob,
                device=device,
            )
        valid = DeviceDataLoader(
            make_dataset(cfg, "valid"),
            batch_size=t.batch_size,
            seed=t.seed + 1,
            device=device,
        )
    else:
        train = DataLoader(
            make_dataset(cfg, "train"),
            batch_size=t.batch_size,
            shuffle=True,
            drop_last=True,
            num_workers=dh.num_workers,
            seed=t.seed,
        )
        valid = DataLoader(
            make_dataset(cfg, "valid"),
            batch_size=t.batch_size,
            shuffle=False,
            drop_last=False,
            num_workers=dh.num_workers,
            seed=t.seed + 1,
        )
    return train, valid, make_gen_loader(cfg)


def make_gen_loader(cfg) -> DataLoader:
    """The gen loader of ``make_loaders``: the test split on the host, in order,
    ``data_handling.n_gen_samples`` a batch."""
    dh = cfg.data_handling
    return DataLoader(
        make_dataset(cfg, "test", n_samples=None),
        batch_size=dh.n_gen_samples,
        shuffle=False,
        drop_last=False,
        num_workers=dh.num_workers,
        seed=cfg.training.seed + 2,
    )

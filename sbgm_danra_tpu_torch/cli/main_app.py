"""The port's pipeline CLI (counterpart of ``sbgm_danra_tpu/cli/main_app.py``).

    python -m sbgm_danra_tpu_torch.cli.main_app --config_path cfg.yaml \
        --mode {synthetic_data,data_splits,run_statistics,train,generate,evaluate,full_pipeline} \
        [--skip_training] [--skip_generation] [--skip_evaluation] \
        [--n_days N] [--no_all_split] [--device cuda] [key=value ...]

``synthetic_data`` writes the synthetic DANRA/ERA5 stores, geography and
statistics of the config's variables under ``paths.data_dir``
(``data/synthetic.py``); ``data_splits`` writes the train/valid/test stores
from each variable's ``all`` store as ``splits`` asks
(``pipelines/splits.py``) and ``run_statistics`` the global-statistics JSONs
of the ``all`` split under ``paths.stats_load_dir``, which the transforms
read (``pipelines/stats_pipeline.py``), both numpy on the host, so a raw
archive goes to a trained model with the port alone; ``train``,
``generate`` and ``evaluate`` run the
entry functions of ``cli/entries.py``, ``full_pipeline`` all three, on
``--device`` (default ``cuda``; evaluation is numpy on the host). The
existence gates are JAX's: ``generate`` needs a trained checkpoint
(``check_model_exists``) and ``evaluate`` generated samples
(``check_generated_samples_exist``), else ``SystemExit``; ``full_pipeline``
skips a stage whose input is missing, with a warning. Reading a YAML config
needs PyYAML. The data-analysis modes are in ``cli/main_data_app.py``.
"""

from __future__ import annotations

import argparse
import glob
import logging
import os
import time

from sbgm_danra_tpu_torch.config import get_model_string, load_config, parse_override

logger = logging.getLogger(__name__)

MODES = ("train", "generate", "evaluate", "full_pipeline", "data_splits", "run_statistics",
         "synthetic_data")


def check_model_exists(cfg) -> bool:
    ckpt_dir = os.path.join(cfg.paths.checkpoint_dir, get_model_string(cfg))
    return os.path.isdir(ckpt_dir) and bool(os.listdir(ckpt_dir))


def check_generated_samples_exist(cfg) -> bool:
    sample_path = os.path.join(cfg.paths.sample_dir, "generation", get_model_string(cfg),
                               "generated_samples")
    return bool(glob.glob(os.path.join(sample_path, "gen_samples_*.npz")))


def synthetic_data(cfg, n_days: int, no_all_split: bool) -> dict:
    """Write every variable the config trains on: the HR target and the LR
    conditions, at the HR full domain, with the HR crop's statistics."""
    from sbgm_danra_tpu_torch.data.synthetic import SyntheticSpec, generate

    variables = tuple(dict.fromkeys(
        [cfg.highres.variable, *(cfg.lowres.condition_variables or ())]))
    spec = SyntheticSpec(
        root=cfg.paths.data_dir,
        full_domain=tuple(cfg.highres.full_domain_dims),
        n_days=n_days,
        variables=variables,
        crop_region=tuple(cfg.highres.cutout_domains) if cfg.highres.cutout_domains else None,
    )
    if no_all_split:
        # train/valid/test only: 'all' duplicates every field and only the
        # data-analysis modes read it
        spec.splits = {k: v for k, v in spec.resolved_splits().items() if k != "all"}
    t0 = time.perf_counter()
    written = generate(spec)
    logger.info("synthetic data (%d days) written under %s in %s s", n_days, cfg.paths.data_dir,
                time.perf_counter() - t0)
    return written


def run_mode(cfg, mode: str, args):
    """Run ``mode``; returns what its entry function returns (``full_pipeline``:
    a dict of the stages that ran)."""
    from sbgm_danra_tpu_torch.cli import entries

    if mode == "synthetic_data":
        return synthetic_data(cfg, args.n_days, args.no_all_split)
    if mode == "data_splits":
        from sbgm_danra_tpu_torch.pipelines.splits import create_splits_from_config

        return create_splits_from_config(cfg)
    if mode == "run_statistics":
        from sbgm_danra_tpu_torch.pipelines.stats_pipeline import run_data_statistics

        return run_data_statistics(cfg)
    if mode == "train":
        return entries.train_main(cfg, device=args.device)
    if mode == "generate":
        if not check_model_exists(cfg):
            raise SystemExit("No trained checkpoint found — run --mode train first "
                             f"(looked under {cfg.paths.checkpoint_dir})")
        return entries.generation_main(cfg, device=args.device)
    if mode == "evaluate":
        if not check_generated_samples_exist(cfg):
            raise SystemExit("No generated samples found — run --mode generate first")
        return entries.evaluation_main(cfg)
    if mode == "full_pipeline":
        out = {}
        if not args.skip_training:
            out["train"] = entries.train_main(cfg, device=args.device)
        if not args.skip_generation:
            if check_model_exists(cfg):
                out["generate"] = entries.generation_main(cfg, device=args.device)
            else:
                logger.warning("skipping generation: no checkpoint found")
        if not args.skip_evaluation:
            if check_generated_samples_exist(cfg):
                out["evaluate"] = entries.evaluation_main(cfg)
            else:
                logger.warning("skipping evaluation: no generated samples found")
        return out
    raise SystemExit(f"Unknown mode: {mode}")


def main(argv=None):
    parser = argparse.ArgumentParser(description="sbgm_danra_tpu_torch pipeline")
    parser.add_argument("--config_path", required=True)
    parser.add_argument("--mode", default="full_pipeline", choices=MODES)
    parser.add_argument("--skip_training", action="store_true")
    parser.add_argument("--skip_generation", action="store_true")
    parser.add_argument("--skip_evaluation", action="store_true")
    parser.add_argument("--n_days", type=int, default=64, help="synthetic_data days")
    parser.add_argument("--no_all_split", action="store_true",
                        help="synthetic_data: skip the duplicate 'all' split")
    parser.add_argument("--device", default="cuda",
                        help="train, generate, full_pipeline: the torch device")
    parser.add_argument(
        "overrides", nargs="*", help="dot-key config overrides, e.g. training.epochs=3"
    )
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    overrides = dict(parse_override(s) for s in args.overrides)
    cfg = load_config(args.config_path, overrides)
    return run_mode(cfg, args.mode, args)


if __name__ == "__main__":
    main()

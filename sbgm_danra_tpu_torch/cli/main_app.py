"""The port's pipeline CLI (counterpart of ``sbgm_danra_tpu/cli/main_app.py``).

    python -m sbgm_danra_tpu_torch.cli.main_app --config_path cfg.yaml \
        --mode {synthetic_data,train} [--n_days N] [--no_all_split] \
        [--device cuda] [key=value ...]

``synthetic_data`` writes the synthetic DANRA/ERA5 stores, geography and
statistics of the config's variables under ``paths.data_dir``
(``data/synthetic.py``); ``train`` trains on them (``cli/entries.py``) on
``--device`` (default ``cuda``). The JAX CLI's other modes are not ported
yet and raise, naming the ROADMAP item. Reading a YAML config needs PyYAML.
"""

from __future__ import annotations

import argparse
import logging
import time

from sbgm_danra_tpu_torch.config import load_config, parse_override

logger = logging.getLogger(__name__)

MODES = ("train", "generate", "evaluate", "full_pipeline", "data_splits", "run_statistics",
         "synthetic_data")
NOT_PORTED = {
    "generate": "ROADMAP Queue 1, item 'orchestration' (evaluate/generation.py)",
    "evaluate": "ROADMAP Queue 1, item 'orchestration' (evaluate/evaluation.py)",
    "full_pipeline": "ROADMAP Queue 1, item 'orchestration' (generate and evaluate)",
    "data_splits": "ROADMAP Queue 1, item 'orchestration' (pipelines/splits.py)",
    "run_statistics": "ROADMAP Queue 1, item 'orchestration' (pipelines/stats_pipeline.py)",
}


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


def run_mode(cfg, mode: str, args) -> None:
    if mode in NOT_PORTED:
        raise NotImplementedError(
            f"--mode {mode} is not ported to sbgm_danra_tpu_torch yet: {NOT_PORTED[mode]}")
    if mode == "synthetic_data":
        synthetic_data(cfg, args.n_days, args.no_all_split)
    elif mode == "train":
        from sbgm_danra_tpu_torch.cli.entries import train_main

        train_main(cfg, device=args.device)
    else:
        raise SystemExit(f"Unknown mode: {mode}")


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description="sbgm_danra_tpu_torch pipeline")
    parser.add_argument("--config_path", required=True)
    parser.add_argument("--mode", default="full_pipeline", choices=MODES)
    parser.add_argument("--n_days", type=int, default=64, help="synthetic_data days")
    parser.add_argument("--no_all_split", action="store_true",
                        help="synthetic_data: skip the duplicate 'all' split")
    parser.add_argument("--device", default="cuda", help="train: the torch device")
    parser.add_argument(
        "overrides", nargs="*", help="dot-key config overrides, e.g. training.epochs=3"
    )
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    overrides = dict(parse_override(s) for s in args.overrides)
    cfg = load_config(args.config_path, overrides)
    run_mode(cfg, args.mode, args)


if __name__ == "__main__":
    main()

"""The port's data-operations CLI (counterpart of
``sbgm_danra_tpu/cli/main_data_app.py``, the same arguments and log lines).

    python -m sbgm_danra_tpu_torch.cli.main_data_app --config_path cfg.yaml --mode \
        {create_splits,run_statistics,run_comparison,create_small_batches,run_correlation} \
        [--n_samples N] [--out_dir DIR] [--agg_time {daily,weekly,monthly,yearly}] \
        [--agg_method {mean,sum,max,min}] [--figures] [--max_days N] [key=value ...]

numpy on the host (no ``--device``). ``main`` returns what the mode computed:
``{"splits": days written per store}``, ``{"statistics": ..., "figures":
..., "composites": ...}``, ``{"comparison": ...}``, ``{"small_batches":
...}`` or ``{"correlations": {lr_var: ...}}``. ``--figures`` writes the
statistics and correlation figures under ``{paths.sample_dir}/figures``;
where matplotlib is missing each is skipped with a log line. Reading a YAML
config needs PyYAML.
"""

from __future__ import annotations

import argparse
import logging
import os
from typing import Dict

from sbgm_danra_tpu_torch.config import load_config, parse_override
from sbgm_danra_tpu_torch.data.paths import build_data_path
from sbgm_danra_tpu_torch.utils.plotting import plot_or_skip

logger = logging.getLogger(__name__)


def main(argv=None) -> Dict[str, object]:
    parser = argparse.ArgumentParser(description="SBGM DANRA data operations")
    parser.add_argument("--config_path", required=True)
    parser.add_argument(
        "--mode",
        required=True,
        choices=[
            "create_splits",
            "run_statistics",
            "run_comparison",
            "create_small_batches",
            "run_correlation",
        ],
    )
    parser.add_argument("--n_samples", type=int, default=8)
    parser.add_argument("--out_dir", default=None)
    parser.add_argument("--agg_time", default=None,
                        choices=["daily", "weekly", "monthly", "yearly"],
                        help="run_statistics: also log stats of temporally "
                             "aggregated composites")
    parser.add_argument("--agg_method", default="mean",
                        choices=["mean", "sum", "max", "min"])
    parser.add_argument("--figures", action="store_true",
                        help="run_statistics/run_correlation: also write the "
                             "per-variable stats and correlation figures")
    parser.add_argument("--max_days", type=int, default=None,
                        help="figure series cap (streaming figure data)")
    parser.add_argument("overrides", nargs="*")
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    cfg = load_config(args.config_path, dict(parse_override(s) for s in args.overrides))

    hr, lr = cfg.highres, cfg.lowres
    result: Dict[str, object] = {}
    if args.mode == "create_splits":
        from sbgm_danra_tpu_torch.pipelines.splits import create_splits_from_config

        result["splits"] = create_splits_from_config(cfg)
    elif args.mode == "run_statistics":
        from sbgm_danra_tpu_torch.pipelines.stats_pipeline import run_data_statistics

        result["statistics"] = run_data_statistics(cfg)
        if args.figures:
            from sbgm_danra_tpu_torch.pipelines.figures import (
                per_timestep_series,
                plot_variable_statistics,
            )

            fig_dir = os.path.join(cfg.paths.sample_dir, "figures", "statistics")
            figures = result["figures"] = {}
            jobs = [(hr.model, hr.variable, hr.full_domain_dims, hr.cutout_domains)] + [
                (lr.model, v, lr.full_domain_dims, lr.cutout_domains)
                for v in (lr.condition_variables or ())
            ]
            for model, var, dims, crop in jobs:
                store = build_data_path(cfg.paths.data_dir, model, var, dims, "all")
                series = per_timestep_series(
                    store, var, model, crop=crop, max_days=args.max_days
                )
                figures[f"{model}/{var}"] = plot_or_skip(
                    f"statistics of {model}/{var}", plot_variable_statistics,
                    var, model, series, fig_dir)
        if args.agg_time:
            import datetime

            from sbgm_danra_tpu_torch.data import zarrlite
            from sbgm_danra_tpu_torch.data.dataset import extract_2d
            from sbgm_danra_tpu_torch.pipelines.stats_pipeline import aggregate_stream
            from sbgm_danra_tpu_torch.utils.dates import file_date

            store = build_data_path(cfg.paths.data_dir, hr.model, hr.variable,
                                    hr.full_domain_dims, "all")
            group = zarrlite.open_group(store)
            keys = sorted(group.keys())
            # one field in memory at a time (stats_pipeline.aggregate_stream)
            items = (
                (extract_2d(group, k, hr.variable),
                 datetime.datetime.strptime(file_date(k), "%Y%m%d"))
                for k in keys
            )
            n_periods, total, total_sq, count = 0, 0.0, 0.0, 0
            for _, comp in aggregate_stream(items, args.agg_time, args.agg_method):
                n_periods += 1
                total += comp.sum()
                total_sq += (comp * comp).sum()
                count += comp.size
            mean = total / max(count, 1)
            std = (max(total_sq / max(count, 1) - mean * mean, 0.0)) ** 0.5
            result["composites"] = {"periods": n_periods, "mean": mean, "std": std}
            logger.info(
                "%s %s composites (%s/%s): %d periods, mean %.4f std %.4f",
                hr.model, hr.variable, args.agg_time, args.agg_method,
                n_periods, mean, std,
            )
    elif args.mode == "run_comparison":
        from sbgm_danra_tpu_torch.pipelines.comparison import run_comparison

        # compare the HR variable between the HR and LR stores on common dates
        out = result["comparison"] = run_comparison(
            build_data_path(cfg.paths.data_dir, hr.model, hr.variable,
                            hr.full_domain_dims, "all"),
            build_data_path(cfg.paths.data_dir, lr.model, hr.variable,
                            lr.full_domain_dims, "all"),
            hr.variable,
            model_a=hr.model,
            model_b=lr.model,
            crop=hr.cutout_domains,
            by_season=True,
        )
        ts = out["timeseries"]
        logger.info(
            "%s vs %s %s: bias %.4f rmse %.4f corr %.4f; spectrum logMSE %.4f",
            hr.model, lr.model, hr.variable,
            ts["bias"].mean(), ts["rmse"].mean(), ts["corr"].mean(),
            out["spectrum"]["log_mse"],
        )
    elif args.mode == "create_small_batches":
        from sbgm_danra_tpu_torch.pipelines.preprocess import create_small_data_batches

        variables = {
            hr.model: [hr.variable],
            lr.model: list(lr.condition_variables or ()),
        }
        result["small_batches"] = create_small_data_batches(
            cfg.paths.data_dir,
            args.out_dir or cfg.paths.data_dir,
            variables,
            tuple(hr.full_domain_dims),
            n_samples=args.n_samples,
        )
    elif args.mode == "run_correlation":
        from sbgm_danra_tpu_torch.pipelines.correlations import run_correlations

        correlations = result["correlations"] = {}
        for lr_var in lr.condition_variables or ():
            out = correlations[lr_var] = run_correlations(
                build_data_path(cfg.paths.data_dir, hr.model, hr.variable,
                                hr.full_domain_dims, "all"),
                build_data_path(cfg.paths.data_dir, lr.model, lr_var,
                                lr.full_domain_dims, "all"),
                hr.variable,
                lr_var,
                hr_model=hr.model,
                lr_model=lr.model,
                crop=hr.cutout_domains,
            )
            logger.info(
                "%s_hr vs %s_lr: temporal pearson %.4f spearman %.4f",
                hr.variable, lr_var,
                out["temporal_pearson"], out["temporal_spearman"],
            )
            if args.figures:
                from sbgm_danra_tpu_torch.pipelines.figures import plot_correlation_figures

                plot_or_skip(
                    f"correlations of {hr.variable}_hr vs {lr_var}_lr",
                    plot_correlation_figures,
                    out, hr.variable, lr_var, hr.model, lr.model,
                    os.path.join(cfg.paths.sample_dir, "figures", "correlations"),
                )
    return result


if __name__ == "__main__":
    main()

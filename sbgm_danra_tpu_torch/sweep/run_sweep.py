"""Sweep runner: search spaces + objective over the port's training pipeline
(counterpart of ``sbgm_danra_tpu/sweep/run_sweep.py``).

- high-impact space: learning rate (log-uniform), optimizer, n_timesteps,
  time embedding, CFG guidance scale, block layers, attention heads;
- medium-impact space: batch size, ema decay, weight decay,
  last_fmap_channels;
- per-trial frozen config dump to ``generated/trial_NNNNN.yaml`` beside the
  study (skipped with a log line without PyYAML);
- shared sqlite study (``study.py``, the JAX package's engine copied), so N
  workers, of either package, each run trials of one study;
- SuccessiveHalving pruning on the per-epoch validation loss, through
  ``TrainingPipeline.train``'s ``on_epoch_end``.

Each trial builds a new architecture in the same process, on ``device``
(``make_loaders(cfg, device)``, ``TrainingPipeline(..., device=device)``).
The rule for its memory is stated once, in ``release_trial_memory``: when a
trial ends, completed, pruned (by the pruner or for a broken architecture)
or failed, its pipeline and loaders are dropped with the frames that hold
them, the sampler graphs (``sampling/graphs.clear``) and K1's weight packs
(``fused_conv_gn.clear_packs``) go, and the card's cache is emptied, so the
card's reserved memory does not grow from trial to trial. JAX's
``setup_jax_env`` (a compile cache for the TPU) has no counterpart.
"""

from __future__ import annotations

import copy
import gc
import logging
import os
import traceback
from typing import Any, Callable, Dict, Optional

import torch

from sbgm_danra_tpu_torch.config import Config, deep_update, from_dict, resolve_env
from sbgm_danra_tpu_torch.sweep.study import (
    GPSampler,
    Study,
    SuccessiveHalvingPruner,
    Trial,
    TrialPruned,
)

logger = logging.getLogger(__name__)


def sample_high_impact(trial: Trial) -> Dict[str, Any]:
    """High-impact search space (the JAX runner's, in its order)."""
    return {
        "training.learning_rate": trial.suggest_float("learning_rate", 1e-5, 3e-3, log=True),
        "training.optimizer": trial.suggest_categorical("optimizer", ["adam", "adamw"]),
        "sampler.n_timesteps": trial.suggest_int("n_timesteps", 200, 1500),
        "sampler.time_embedding": trial.suggest_categorical("time_embedding", [128, 256, 512]),
        "classifier_free_guidance.guidance_scale": trial.suggest_float(
            "guidance_scale", 0.5, 8.0
        ),
        "sampler.block_layers": trial.suggest_categorical(
            "block_layers", [(1, 1, 1, 1), (2, 2, 2, 2), (3, 3, 3, 3)]
        ),
        "sampler.num_heads": trial.suggest_categorical("num_heads", [2, 4, 8]),
    }


def sample_medium_impact(trial: Trial) -> Dict[str, Any]:
    """Medium-impact space (the JAX runner's)."""
    return {
        "training.batch_size": trial.suggest_categorical("batch_size", [8, 16, 32]),
        "training.ema_decay": trial.suggest_float("ema_decay", 0.99, 0.9999, log=True),
        "training.weight_decay": trial.suggest_float("weight_decay", 1e-8, 1e-4, log=True),
        "sampler.last_fmap_channels": trial.suggest_categorical(
            "last_fmap_channels", [256, 512]
        ),
    }


def build_trial_config(
    base: Dict[str, Any], trial: Trial, include_medium: bool = False,
    out_dir: Optional[str] = None,
) -> Config:
    raw = copy.deepcopy(base)
    updates = sample_high_impact(trial)
    if include_medium:
        updates.update(sample_medium_impact(trial))
    deep_update(raw, updates)
    cfg = from_dict(raw)
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        cfg.dump(os.path.join(out_dir, f"trial_{trial.trial_id:05d}.yaml"))
    return cfg


def release_trial_memory(device) -> None:
    """The end of a trial: whatever its outcome, everything it put on the
    card goes. The caller has dropped its references to the trial's pipeline
    and loaders (and cleared the frames of the exception that ended it);
    collecting them frees the model, the train state, the card stacks and
    the pipeline's captured train and eval steps with their pools. The
    sampler graphs and K1's weight packs are caches of their own modules and
    are dropped here, as are cuBLAS's workspaces (one a stream it ran on);
    then the card's allocator returns its cached blocks."""
    from sbgm_danra_tpu_torch.ops import fused_conv_gn
    from sbgm_danra_tpu_torch.sampling import graphs

    graphs.clear()
    fused_conv_gn.clear_packs()
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
        clear_workspaces = getattr(torch._C, "_cuda_clearCublasWorkspaces", None)
        if clear_workspaces is not None:  # PyTorch's own; absent from CPU builds
            clear_workspaces()
        torch.cuda.empty_cache()


def make_objective(
    base_config: Dict[str, Any],
    epochs: int = 5,
    steps_per_epoch: Optional[int] = None,
    include_medium: bool = False,
    generated_dir: Optional[str] = None,
    device="cuda",
    after_trial: Optional[Callable[[Trial], None]] = None,
):
    """Objective: a short training run on ``device``, reporting the
    per-epoch validation loss (the training loss where there is none), which
    the pruner may stop. A broken architecture (a ValueError or
    AssertionError while building the loaders or the pipeline) is pruned, not
    failed, as in JAX. ``after_trial(trial)`` runs once the trial's memory
    is released."""

    def objective(trial: Trial) -> float:
        from sbgm_danra_tpu_torch.data.factory import make_loaders
        from sbgm_danra_tpu_torch.training.pipeline import TrainingPipeline

        cfg = build_trial_config(base_config, trial, include_medium, generated_dir)
        pipeline = train_loader = valid_loader = None
        best = float("inf")

        def on_epoch_end(pipe, epoch, train_loss, val_loss):
            nonlocal best
            monitored = val_loss if val_loss == val_loss else train_loss
            best = min(best, monitored)
            trial.report(monitored, step=epoch)
            if trial.should_prune(step=epoch):
                raise TrialPruned()

        try:
            try:
                train_loader, valid_loader, _ = make_loaders(cfg, device)
                pipeline = TrainingPipeline(cfg, train_loader, valid_loader, device=device)
            except (ValueError, AssertionError) as e:
                logger.warning("trial %d: broken architecture (%s); pruned",
                               trial.trial_id, e)
                raise TrialPruned(str(e)) from e
            pipeline.train(epochs=epochs, steps_per_epoch=steps_per_epoch,
                           on_epoch_end=on_epoch_end)
            return best
        except BaseException as e:
            # the finished frames of the exception hold the trial's pipeline
            # (its own ``self``, the callback's ``pipe``): drop their locals
            traceback.clear_frames(e.__traceback__)
            if e.__cause__ is not None:
                traceback.clear_frames(e.__cause__.__traceback__)
            raise
        finally:
            if pipeline is not None:
                pipeline.checkpoints.close()
            pipeline = train_loader = valid_loader = None
            release_trial_memory(device)
            if after_trial is not None:
                after_trial(trial)

    return objective


def run_sweep(
    config_path: str,
    storage_path: str,
    n_trials: int = 1,
    epochs: int = 5,
    steps_per_epoch: Optional[int] = None,
    include_medium: bool = False,
    seed: int = 42,
    device="cuda",
    after_trial: Optional[Callable[[Trial], None]] = None,
) -> Study:
    """One worker's share of the study; N workers share ``storage_path``."""
    import yaml

    with open(config_path) as f:
        base = resolve_env(yaml.safe_load(f))
    # GP expected-improvement after a Halton startup phase
    study = Study(
        storage_path,
        sampler=GPSampler(seed=seed),
        pruner=SuccessiveHalvingPruner(min_resource=1, reduction_factor=4),
        load_if_exists=True,
    )
    generated = os.path.join(os.path.dirname(storage_path), "generated")
    study.optimize(
        make_objective(base, epochs, steps_per_epoch, include_medium, generated, device,
                       after_trial),
        n_trials=n_trials,
    )
    return study


def main(argv=None):
    import argparse

    p = argparse.ArgumentParser(description="hyperparameter sweep worker")
    p.add_argument("--config_path", required=True)
    p.add_argument("--storage", required=True, help="shared sqlite study path")
    p.add_argument("--n_trials", type=int, default=1)
    p.add_argument("--epochs", type=int, default=5)
    p.add_argument("--steps_per_epoch", type=int, default=None)
    p.add_argument("--medium", action="store_true")
    p.add_argument("--device", default="cuda", help="the trials' device (default: the card)")
    args = p.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    study = run_sweep(
        args.config_path, args.storage, args.n_trials, args.epochs,
        args.steps_per_epoch, args.medium, device=args.device,
    )
    try:
        best = study.best_trial
        logger.info("best trial %d: %.5f %s", best["trial_id"], best["value"], best["params"])
    except ValueError:
        logger.info("no completed trials yet")
    return study


if __name__ == "__main__":
    main()

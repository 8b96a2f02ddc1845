#!/usr/bin/env python3
"""Export a JAX training checkpoint for the torch port.

    python export_flax_checkpoint.py --config_path configs/flagship_synth.yaml --out weights.npz
        [--checkpoint_dir DIR] [--best | --step N]

Restores the JAX package's Orbax checkpoint of a run (by default the latest
under ``paths.checkpoint_dir/<model string>``, as ``TrainingPipeline`` writes
it) into a train state built from the run config, and writes its variables as
one ``.npz`` whose keys are ``/``-joined paths: ``params/...``,
``batch_stats/...``, ``buffers/...`` and ``ema_params/...``. The port reads it
with ``sbgm_danra_tpu_torch.convert`` (``state_dicts_from_flax``; the serving
engine loads the EMA weights from it when ``training.load_ema`` is set).

It runs where JAX and Orbax are installed; the card machine has neither, so
the export is made there and the ``.npz`` is copied over.
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import Dict, Optional

import numpy as np

def write_npz(state, path: str) -> Dict[str, np.ndarray]:
    """The train state's variables, with the EMA copy, as ``/``-keyed arrays in ``path``."""
    from sbgm_danra_tpu_torch.convert import flatten

    flat = flatten({"params": state.params, "batch_stats": state.batch_stats,
                    "buffers": state.buffers, "ema_params": state.ema_params})
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez(path, **flat)
    return flat


def restore_state(cfg, directory: str, step: Optional[int] = None, best: bool = False):
    """A train state for ``cfg`` restored from the Orbax checkpoints in ``directory``."""
    import jax
    import jax.numpy as jnp

    from sbgm_danra_tpu.models.unet import build_score_model
    from sbgm_danra_tpu.sde import VESDE
    from sbgm_danra_tpu.training.checkpointing import CheckpointManager
    from sbgm_danra_tpu.training.pipeline import model_spec_from_config
    from sbgm_danra_tpu.training.state import create_train_state

    model = build_score_model(model_spec_from_config(cfg), VESDE())
    h, w = cfg.highres.data_size
    geo = cfg.stationary_conditions.geographic_conditions
    sample = {"x": jnp.zeros((1, h, w, 1), jnp.float32)}
    n_lr = len(cfg.lowres.condition_variables or ())
    if n_lr:
        sample["cond_img"] = jnp.zeros((1, h, w, n_lr), jnp.float32)
    if geo.sample_w_geo:
        sample["lsm_cond"] = jnp.zeros((1, h, w, 2), jnp.float32)
        sample["topo_cond"] = jnp.zeros((1, h, w, 2), jnp.float32)
    if cfg.num_classes() is not None:
        sample["y"] = jnp.zeros((1,), jnp.int32)
    # the structure and shapes to restore into: traced, not run
    state = jax.eval_shape(lambda: create_train_state(cfg, model, sample, jax.random.PRNGKey(0)))
    manager = CheckpointManager(directory)
    try:
        restored, _ = manager.restore(state, step=step, best=best)
    finally:
        manager.close()
    return restored


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--config_path", required=True)
    p.add_argument("--out", required=True, help="the .npz to write")
    p.add_argument("--checkpoint_dir", default=None,
                   help="default: paths.checkpoint_dir/<model string> of the config")
    which = p.add_mutually_exclusive_group()
    which.add_argument("--best", action="store_true", help="the best-validation checkpoint")
    which.add_argument("--step", type=int, default=None)
    p.add_argument("overrides", nargs="*", help="dot-key config overrides, a.b=value")
    args = p.parse_args(argv)

    from sbgm_danra_tpu.config import load_config, parse_override
    from sbgm_danra_tpu.utils.naming import get_model_string

    cfg = load_config(args.config_path, dict(parse_override(s) for s in args.overrides))
    directory = args.checkpoint_dir or os.path.join(cfg.paths.checkpoint_dir,
                                                    get_model_string(cfg))
    state = restore_state(cfg, directory, step=args.step, best=args.best)
    flat = write_npz(state, args.out)
    print(f"wrote {len(flat)} arrays (step {int(state.step)}) to {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

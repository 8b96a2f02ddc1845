#!/usr/bin/env python3
"""Import a checkpoint of the torch port into the JAX package.

    python -m sbgm_danra_tpu_torch.convert --to_flax --config_path CFG --out w.npz
    python import_torch_checkpoint.py --config_path CFG --npz w.npz
        [--checkpoint_dir DIR] [--step N] [--epoch E] [--val_loss V]

The counterpart of ``export_flax_checkpoint.py``. The ``.npz`` holds the
port's weights as Flax variables (``/``-joined paths: ``params/...``,
``batch_stats/...``, ``buffers/...`` and ``ema_params/...``). This script
builds a JAX train state for the run config (as ``export_flax_checkpoint.py``'s
``restore_state`` builds its target), puts the ``.npz``'s arrays in place of
its parameters, BatchNorm statistics, buffers and EMA copy, and saves it with
the JAX package's ``CheckpointManager`` under ``paths.checkpoint_dir/<model
string>`` (or ``--checkpoint_dir``) as step ``--step``, the best checkpoint
there when it is the only one. ``sbgm_danra_tpu.cli.entries.
_load_pipeline_for_sampling`` (``load(best=True)``) then loads it unchanged.
The optimizer's state is the freshly initialised one: the import is for
sampling and evaluation, not for resuming the port's run.

It runs where JAX and Orbax are installed; the card machine has neither, so
the ``.npz`` is made there and copied over.
"""

from __future__ import annotations

import argparse
import copy
import os
import sys
from typing import Dict

import numpy as np

_COLLECTIONS = ("params", "batch_stats", "buffers", "ema_params")


def _nested(flat: Dict[str, np.ndarray], collection: str) -> Dict:
    out: Dict = {}
    for key, value in flat.items():
        parts = key.split("/")
        if parts[0] != collection:
            continue
        node = out
        for part in parts[1:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = value
    return out


def _fill(template, values, path: str):
    """``values`` (nested dicts of arrays) in ``template``'s structure, each
    leaf checked for its place, shape and dtype."""
    import jax.numpy as jnp

    if hasattr(template, "shape"):
        if not isinstance(values, np.ndarray):
            raise KeyError(f"{path}: the .npz holds no array here")
        if values.shape != template.shape:
            raise ValueError(f"{path}: shape {values.shape} != the model's {template.shape}")
        return jnp.asarray(values, dtype=template.dtype)
    if not isinstance(values, dict) or set(values) != set(template):
        have = set(values) if isinstance(values, dict) else set()
        raise KeyError(f"{path}: the .npz has {sorted(have)}, the model {sorted(template)}")
    return {k: _fill(template[k], values[k], f"{path}/{k}") for k in template}


def state_from_npz(cfg, path: str, step: int = 0):
    """A JAX train state for ``cfg`` holding the ``.npz``'s variables at ``step``."""
    import jax
    import jax.numpy as jnp

    from sbgm_danra_tpu.models.unet import build_score_model
    from sbgm_danra_tpu.sde import VESDE
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
    # the .npz's variables take the place of the model's init (and of the
    # Xavier re-initialisation): the structure to fill is traced, not run
    init_cfg = copy.deepcopy(cfg)
    init_cfg.training.weight_init = False
    key = jax.random.PRNGKey(0)
    abstract = jax.eval_shape(lambda: create_train_state(init_cfg, model, sample, key))
    with np.load(path) as data:
        flat = {name: data[name] for name in data.files}
    unknown = sorted({k.split("/")[0] for k in flat} - set(_COLLECTIONS))
    if unknown:
        raise KeyError(f"{path}: unknown collections {unknown}")
    filled = {c: _fill(getattr(abstract, c), _nested(flat, c), c) for c in _COLLECTIONS
              if c != "ema_params" or any(k.startswith("ema_params/") for k in flat)}
    variables = {c: filled[c] for c in ("params", "batch_stats", "buffers")}
    state = create_train_state(init_cfg, model, sample, key, variables=variables)
    return state.replace(step=jnp.asarray(step, jnp.int32), **filled)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--config_path", required=True)
    p.add_argument("--npz", required=True, help="the .npz of convert --to_flax")
    p.add_argument("--checkpoint_dir", default=None,
                   help="default: paths.checkpoint_dir/<model string> of the config")
    p.add_argument("--step", type=int, default=0, help="the step to save the state as")
    p.add_argument("--epoch", type=int, default=0, help="the metadata's epoch")
    p.add_argument("--val_loss", type=float, default=0.0,
                   help="the metadata's validation loss (the best checkpoint is the lowest)")
    p.add_argument("overrides", nargs="*", help="dot-key config overrides, a.b=value")
    args = p.parse_args(argv)

    from sbgm_danra_tpu.config import load_config, parse_override
    from sbgm_danra_tpu.training.checkpointing import CheckpointManager
    from sbgm_danra_tpu.utils.naming import get_model_string

    cfg = load_config(args.config_path, dict(parse_override(s) for s in args.overrides))
    directory = args.checkpoint_dir or os.path.join(cfg.paths.checkpoint_dir,
                                                    get_model_string(cfg))
    state = state_from_npz(cfg, args.npz, args.step)
    manager = CheckpointManager(directory)
    try:
        manager.save(args.step, state, {"epoch": args.epoch, "val_loss": args.val_loss})
        best = manager.best_step()
    finally:
        manager.close()
    print(f"saved step {args.step} under {directory} (best step {best})")
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Weight bridge between the JAX package's Flax variables and the port's ``state_dict``.

The input is the tree ``{"params", "batch_stats", "buffers"}`` as nested dicts
of numpy arrays (``jax.tree.map(np.asarray, variables)``), or the same tree in
an ``.npz`` whose keys are the ``/``-joined paths. Module paths carry over
name for name (``encoder/layer1/block0/conv1`` -> ``encoder.layer1.block0.conv1``;
Flax's inner ``BatchNorm_0`` level is dropped); the leaves map as:

- conv kernels HWIO -> OIHW (the stems and ``_ConvParams`` holders included);
- ConvTranspose kernels (kh, kw, in, out) -> (in, out, kh, kw), spatially
  flipped: Flax's transposed conv does not flip its kernel, torch's does;
- Dense kernels [in, out] -> Linear weights [out, in];
- GroupNorm / LayerNorm / BatchNorm ``scale`` -> ``weight``; ``bias`` as is;
- BatchNorm ``mean`` / ``var`` -> ``running_mean`` / ``running_var``;
- ``label_emb/embedding`` -> ``label_emb.weight``; the Fourier ``W`` buffers as is.

Unknown or missing keys, and shape mismatches, raise. A training checkpoint's
tree may also hold ``ema_params`` (the EMA copy of ``params``, as
``export_flax_checkpoint.py`` writes it): ``state_dicts_from_flax`` maps it
onto a second state_dict with the same statistics and buffers. This module
imports no JAX.

The torch -> Flax direction is the exact inverse (``flax_from_state_dicts``):
each state_dict entry's owning module decides its Flax name and layout (conv
weights OIHW -> HWIO, a ``ConvTranspose2d``'s weight transposed back and
un-flipped, ``Linear`` -> Dense kernel, ``Embedding`` -> ``embedding``, a norm's
``weight`` -> ``scale``, ``running_*`` -> ``mean`` / ``var``) and every
``layers.BatchNorm`` gets Flax's inner ``BatchNorm_0`` level back.
``write_flax_npz`` writes the tree as the ``/``-keyed ``.npz`` that
``export_flax_checkpoint.py`` writes, and

    python -m sbgm_danra_tpu_torch.convert --to_flax --config_path CFG --out w.npz
        [--checkpoint_dir DIR] [--best | --step N] [a.b=value ...]

turns a checkpoint of the port's trainer (``training/checkpointing.py``; by
default the latest under ``paths.checkpoint_dir/<model string>``) into that
file, its EMA copy included. ``import_torch_checkpoint.py`` (where JAX and
Orbax are installed) restores it into a JAX train state and writes it as the
JAX package's best checkpoint.
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import Dict, Mapping, Optional

import numpy as np
import torch
from torch import nn

from sbgm_danra_tpu_torch.models.layers import BatchNorm, GroupNorm, LayerNorm

_COLLECTIONS = ("params", "batch_stats", "buffers")


def flatten(variables: Mapping) -> Dict[str, np.ndarray]:
    """Nested dict tree -> {"params/encoder/conv1/kernel": array, ...}."""
    out: Dict[str, np.ndarray] = {}

    def walk(node, prefix):
        if isinstance(node, Mapping):
            for key, child in node.items():
                walk(child, f"{prefix}/{key}" if prefix else str(key))
        else:
            out[prefix] = np.asarray(node)

    walk(variables, "")
    return out


def load_npz(path: str) -> Dict[str, np.ndarray]:
    """An ``.npz`` of ``/``-joined paths -> the flat {path: array} dict."""
    with np.load(path) as data:
        return {key: data[key] for key in data.files}


def _convert_leaf(path: str, value: np.ndarray):
    parts = path.split("/")
    collection, mods, leaf = parts[0], [p for p in parts[1:-1] if p != "BatchNorm_0"], parts[-1]
    if collection not in _COLLECTIONS or not mods:
        raise KeyError(f"unknown Flax variable {path!r}")
    if collection == "batch_stats":
        names = {"mean": "running_mean", "var": "running_var"}
        if leaf not in names:
            raise KeyError(f"unknown batch statistic {path!r}")
        leaf = names[leaf]
    elif collection == "buffers":
        if leaf != "W":
            raise KeyError(f"unknown buffer {path!r}")
    elif leaf == "kernel":
        if value.ndim == 4 and mods[-1] == "transpose":
            value = value[::-1, ::-1].transpose(2, 3, 0, 1)
        elif value.ndim == 4:
            value = value.transpose(3, 2, 0, 1)
        elif value.ndim == 2:
            value = value.T
        else:
            raise KeyError(f"kernel {path!r} of rank {value.ndim}")
        leaf = "weight"
    elif leaf in ("scale", "embedding"):
        leaf = "weight"
    elif leaf != "bias":
        raise KeyError(f"unknown parameter {path!r}")
    return ".".join(mods + [leaf]), np.ascontiguousarray(value)


def state_dict_from_flax(variables: Mapping, model: nn.Module) -> Dict[str, torch.Tensor]:
    """Map a Flax variable tree (nested, or already flat) onto ``model``'s state_dict.

    Raises ``KeyError`` on Flax variables the model has no place for, on model
    entries the tree does not fill, and ``ValueError`` on shape mismatches.
    """
    flat = flatten(variables) if any(isinstance(v, Mapping) for v in variables.values()) \
        else {k: np.asarray(v) for k, v in variables.items()}
    target = model.state_dict()
    out: Dict[str, torch.Tensor] = {}
    for path, value in flat.items():
        key, arr = _convert_leaf(path, value)
        if key not in target:
            raise KeyError(f"Flax variable {path!r} -> {key!r} has no place in the torch model")
        if tuple(arr.shape) != tuple(target[key].shape):
            raise ValueError(
                f"{path!r} -> {key!r}: shape {arr.shape} != model's {tuple(target[key].shape)}"
            )
        out[key] = torch.tensor(arr, dtype=target[key].dtype)
    missing = sorted(set(target) - set(out))
    if missing:
        raise KeyError(f"the Flax tree does not fill {len(missing)} model entries: {missing[:8]}")
    return out


def state_dicts_from_flax(variables: Mapping, model: nn.Module):
    """(params state_dict, EMA state_dict or None) from a tree that may hold
    ``ema_params`` beside ``params``, ``batch_stats`` and ``buffers``."""
    flat = flatten(variables) if any(isinstance(v, Mapping) for v in variables.values()) \
        else dict(variables)
    ema = {k[len("ema_"):]: v for k, v in flat.items() if k.startswith("ema_params/")}
    base = {k: v for k, v in flat.items() if not k.startswith("ema_params/")}
    params = state_dict_from_flax(base, model)
    if not ema:
        return params, None
    shared = {k: v for k, v in base.items() if not k.startswith("params/")}
    return params, state_dict_from_flax({**ema, **shared}, model)


def load_flax_npz(path: str, model: nn.Module) -> nn.Module:
    """Load a bridged ``.npz`` of Flax variables into ``model`` (in place)."""
    model.load_state_dict(state_dicts_from_flax(load_npz(path), model)[0])
    return model


_NORMS = (BatchNorm, GroupNorm, LayerNorm)
_STAT_NAMES = {"running_mean": "mean", "running_var": "var"}


def _flax_leaf(model: nn.Module, key: str, value: torch.Tensor, buffers) -> tuple:
    """(collection, Flax module path, leaf name, array) of one state_dict entry,
    the inverse of ``_convert_leaf``, decided by the module that owns it."""
    prefix, _, name = key.rpartition(".")
    module = model.get_submodule(prefix)
    mods = prefix.split(".") + (["BatchNorm_0"] if isinstance(module, BatchNorm) else [])
    arr = value.detach().cpu().numpy()
    if name in _STAT_NAMES and key in buffers:
        return "batch_stats", mods, _STAT_NAMES[name], arr
    if key in buffers:
        if name != "W":
            raise KeyError(f"unknown buffer {key!r}")
        return "buffers", mods, name, arr
    if name == "bias":
        return "params", mods, name, arr
    if name != "weight":
        raise KeyError(f"unknown parameter {key!r}")
    if isinstance(module, nn.ConvTranspose2d):
        return "params", mods, "kernel", arr.transpose(2, 3, 0, 1)[::-1, ::-1]
    if arr.ndim == 4:
        return "params", mods, "kernel", arr.transpose(2, 3, 1, 0)
    if isinstance(module, nn.Linear):
        return "params", mods, "kernel", arr.T
    if isinstance(module, nn.Embedding):
        return "params", mods, "embedding", arr
    if isinstance(module, _NORMS):
        return "params", mods, "scale", arr
    raise KeyError(f"no Flax place for {key!r} of {type(module).__name__}")


def _insert(tree: Dict, collection: str, mods, leaf: str, arr: np.ndarray) -> None:
    node = tree.setdefault(collection, {})
    for mod in mods:
        node = node.setdefault(mod, {})
    node[leaf] = np.ascontiguousarray(arr)


def flax_from_state_dicts(model: nn.Module,
                          ema_state_dict: Optional[Mapping[str, torch.Tensor]] = None) -> Dict:
    """``model``'s weights as the Flax tree ``{"params", "batch_stats",
    "buffers"[, "ema_params"]}`` of nested dicts of numpy arrays, the exact
    inverse of ``state_dicts_from_flax``. ``ema_state_dict``: the EMA copy of
    the parameters (a full state_dict, or the parameters alone, as a port
    checkpoint's ``ema_params`` holds them); only its parameters are read."""
    buffers = {k for k, _ in model.named_buffers()}
    tree: Dict = {c: {} for c in _COLLECTIONS}
    for key, value in model.state_dict().items():
        _insert(tree, *_flax_leaf(model, key, value, buffers))
    if ema_state_dict is not None:
        tree["ema_params"] = {}
        params = {k for k, _ in model.named_parameters()}
        missing = sorted(params - set(ema_state_dict))
        if missing:
            raise KeyError(f"the EMA state_dict lacks {len(missing)} parameters: {missing[:8]}")
        for key in sorted(params):
            _, mods, leaf, arr = _flax_leaf(model, key, ema_state_dict[key], buffers)
            _insert(tree, "ema_params", mods, leaf, arr)
    return tree


def write_flax_npz(path: str, model: nn.Module,
                   ema_state_dict: Optional[Mapping[str, torch.Tensor]] = None
                   ) -> Dict[str, np.ndarray]:
    """``flax_from_state_dicts(model, ema_state_dict)`` as the ``/``-keyed
    ``.npz`` ``export_flax_checkpoint.py`` writes; returns the flat arrays."""
    flat = flatten(flax_from_state_dicts(model, ema_state_dict))
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez(path, **flat)
    return flat


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="Convert a port checkpoint to Flax variables.")
    p.add_argument("--to_flax", action="store_true", required=True,
                   help="the port's checkpoint -> the /-keyed .npz of Flax variables")
    p.add_argument("--config_path", required=True)
    p.add_argument("--out", required=True, help="the .npz to write")
    p.add_argument("--checkpoint_dir", default=None,
                   help="default: paths.checkpoint_dir/<model string> of the config")
    which = p.add_mutually_exclusive_group()
    which.add_argument("--best", action="store_true", help="the best-validation checkpoint")
    which.add_argument("--step", type=int, default=None)
    p.add_argument("overrides", nargs="*", help="dot-key config overrides, a.b=value")
    args = p.parse_args(argv)

    from sbgm_danra_tpu_torch.config import get_model_string, load_config, parse_override
    from sbgm_danra_tpu_torch.models.unet import build_score_model, model_spec_from_config
    from sbgm_danra_tpu_torch.training.checkpointing import CheckpointManager, model_state_dict

    cfg = load_config(args.config_path, dict(parse_override(s) for s in args.overrides))
    directory = args.checkpoint_dir or os.path.join(cfg.paths.checkpoint_dir,
                                                    get_model_string(cfg))
    step, tree = CheckpointManager(directory).load_tree(step=args.step, best=args.best)
    model = build_score_model(model_spec_from_config(cfg))
    model.load_state_dict(model_state_dict(tree))
    flat = write_flax_npz(args.out, model, tree.get("ema_params") or None)
    print(f"wrote {len(flat)} arrays (step {step}) to {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Weight bridge: the JAX package's Flax variables -> the port's ``state_dict``.

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
imports no JAX. The torch -> Flax direction is not ported yet.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch
from torch import nn

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

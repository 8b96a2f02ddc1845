"""Shared helpers for the torch-port parity tests (``tests/test_torch_*.py``).

Inputs and weights are made with numpy from a seed and handed to both
packages; JAX stays on the CPU (``tests/conftest.py``), and the two sides meet
only as numpy arrays.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sbgm_danra_tpu.models.unet import ModelSpec as JaxSpec
from sbgm_danra_tpu.models.unet import build_score_model as jax_build
from sbgm_danra_tpu_torch.convert import state_dict_from_flax
from sbgm_danra_tpu_torch.models.unet import ModelSpec, build_score_model

# the tiny flagship of __graft_entry__._spec(tiny=True)
TINY = dict(in_channels=6, num_classes=4, last_fmap_channels=64, time_embedding=32,
            num_heads=2, block_layers=(1, 1, 1, 1))


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for each module that imports this fixture
    (restored after): the suite's workers share the cores, and spinning
    threads slow the others' small ops (the rk45 parity test: 28 s alone,
    107-205 s beside one process of these tests)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def model_inputs(batch: int = 2, hw=(32, 32), seed: int = 0) -> dict:
    rng = np.random.default_rng(seed)
    h, w = hw
    return {
        "x": rng.normal(size=(batch, h, w, 1)).astype(np.float32),
        "t": rng.uniform(0.05, 1.0, size=(batch,)).astype(np.float32),
        "y": rng.integers(0, 5, size=(batch,)).astype(np.int32),
        "cond_img": rng.normal(size=(batch, h, w, 2)).astype(np.float32),
        "lsm_cond": rng.normal(size=(batch, h, w, 2)).astype(np.float32),
        "topo_cond": rng.normal(size=(batch, h, w, 2)).astype(np.float32),
    }


def random_variables(abstract, seed: int = 0):
    """Numpy values for every leaf of an abstract Flax variable tree.

    Kernels get N(0, 1/fan_in); biases, norm offsets and BatchNorm means small
    nonzero values; scales and variances values around 1; the Fourier
    frequencies N(0, 30^2). Nonzero where init would put zeros, so that the
    bridge's every mapping is exercised.
    """
    rng = np.random.default_rng(seed)

    def leaf(path, spec):
        name = path[-1].key
        shape = spec.shape
        if name == "kernel":
            fan_in = int(np.prod(shape[:-1]))
            v = rng.normal(size=shape) / np.sqrt(fan_in)
        elif name in ("scale", "var"):
            v = rng.uniform(0.5, 1.5, size=shape)
        elif name == "W":
            v = 30.0 * rng.normal(size=shape)
        else:  # bias, mean, embedding
            v = 0.1 * rng.normal(size=shape)
        return v.astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, abstract)


def jax_to_np(tree):
    return jax.tree.map(np.asarray, tree)


def jax_model_and_variables(spec_kw: dict, inputs: dict, seed: int = 0):
    """The Flax model and random numpy variables shaped like its init."""
    model = jax_build(JaxSpec(**spec_kw))
    abstract = jax.eval_shape(
        lambda: model.init({"params": jax.random.PRNGKey(0)},
                           **{k: jnp.asarray(v) for k, v in inputs.items()}, train=False)
    )
    return model, random_variables(abstract, seed)


def jax_apply(model, variables, inputs: dict) -> np.ndarray:
    fn = jax.jit(lambda v, a: model.apply(v, **a, train=False))
    return np.asarray(fn(variables, {k: jnp.asarray(v) for k, v in inputs.items()}))


def torch_model(spec_kw: dict, variables) -> torch.nn.Module:
    model = build_score_model(ModelSpec(**spec_kw))
    model.load_state_dict(state_dict_from_flax(variables, model))
    return model


def torch_inputs(inputs: dict) -> dict:
    return {k: torch.from_numpy(np.array(v)) for k, v in inputs.items()}


def rel_err(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())

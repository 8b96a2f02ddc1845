"""Torch port: K train steps per dispatch (``training/fused.py``) and its
pieces, against the JAX package and the eager steps on the CPU.

- the on-device skip of a non-finite update: a NaN batch leaves every part of
  the state as it was (also at the first step, before the optimizer has
  state), and with finite batches the step equals the plain step bit for bit;
- ``DeviceDataLoader.iter_chunks`` hands out the draws ``__iter__`` makes,
  step for step;
- ``TrainingPipeline`` with ``fused_steps = 2`` trains what ``fused_steps =
  0`` trains over 4 steps, bit for bit (losses, parameters, EMA, BatchNorm
  statistics, step);
- the port's ``fused`` at K = 2 against JAX's ``make_fused_train_step``, given
  JAX's draws (its batch keys through the port's sampler, its step keys' t
  and z): losses within rtol 1e-4, parameters and EMA within 2.5 lr (Adam's
  step; the large majority within 1e-5), BatchNorm statistics within 1e-5, as
  for three eager steps (``tests/test_torch_training.py``). Where a gradient
  is float noise, Adam's step is +-lr of either sign and the bound is (2 K +
  0.5) lr: the entries ``_zero_gradient_entries`` names, and those whose
  first-step gradient is below 1e-6 of their parameter's largest (at 32x32
  crops the deepest attention sees 4 tokens, and its q and k weights get
  gradients ~5e-8 of its v weights'). JAX's own fused chunk differs from its
  eager steps by up to 3.8 lr in such entries.

One synthetic dataset (the JAX generator, 64x96, 12 days) and one compiled
JAX fused chunk serve the module. Training runs with oneDNN off (ROADMAP F5).
"""

import jax
import numpy as np
import pytest
import torch

from sbgm_danra_tpu import sde as jax_sde
from sbgm_danra_tpu.config import from_dict as jax_from_dict
from sbgm_danra_tpu.data import device_data as jax_dd
from sbgm_danra_tpu.data import factory as jax_factory
from sbgm_danra_tpu.data import synthetic as jax_synthetic
from sbgm_danra_tpu.training.fused import chunk_keys
from sbgm_danra_tpu.training.fused import make_fused_train_step as jax_make_fused
from sbgm_danra_tpu.training.state import create_train_state as jax_create_state
from sbgm_danra_tpu_torch.config import from_dict
from sbgm_danra_tpu_torch.convert import state_dict_from_flax
from sbgm_danra_tpu_torch.data import device_data as dd
from sbgm_danra_tpu_torch.data import factory
from sbgm_danra_tpu_torch.models.unet import ModelSpec, build_score_model
from sbgm_danra_tpu_torch.sde import VESDE
from sbgm_danra_tpu_torch.training.fused import make_fused_train_step
from sbgm_danra_tpu_torch.training.pipeline import TrainingPipeline
from sbgm_danra_tpu_torch.training.state import create_train_state
from sbgm_danra_tpu_torch.training.train_step import make_train_step
from tests.test_torch_data import CROP_REGION, config_dict, spec_for
from tests.test_torch_device_data import jax_draws
from tests.test_torch_training import (
    LR,
    TRAIN,
    _batch,
    _flax_tree,
    _jax_draws,
    _tb,
    _zero_gradient_entries,
)
from tests.torch_parity import TINY, jax_model_and_variables, torch_model

K = 2
B = 4
P = 0.5  # CFG dropout, so that kept and dropped samples are drawn


@pytest.fixture(autouse=True)
def _onednn_off():
    """oneDNN corrupts the heap in the tiny UNet's training backward on this
    CPU (ROADMAP F5)."""
    with torch.backends.mkldnn.flags(enabled=False):
        yield


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("torch_fused"))
    jax_synthetic.generate(spec_for(jax_synthetic.SyntheticSpec, root))
    return root


def _cfg(root, **training):
    return config_dict(root, data_handling={"device_dataset": True},
                       classifier_free_guidance={"drop_prob": P},
                       training={**TRAIN, "batch_size": B, **training})


def _state_tensors(state):
    return ({k: v.clone() for k, v in state.model.state_dict().items()},
            {k: v.clone() for k, v in state.ema_params.items()},
            [{k: v.clone() for k, v in s.items()} for s in state.optimizer.state.values()],
            state.step)


def _assert_same_state(a, b):
    for x, y in zip(a[:2], b[:2]):
        assert x.keys() == y.keys() and all(torch.equal(x[k], y[k]) for k in x)
    assert len(a[2]) == len(b[2])
    for x, y in zip(a[2], b[2]):
        assert all(torch.equal(x[k], y[k]) for k in x)
    assert a[3] == b[3]


def _tiny_state():
    model = build_score_model(ModelSpec(**TINY), generator=torch.Generator().manual_seed(4))
    return create_train_state(from_dict({"training": TRAIN}), model)


def test_skip_nonfinite_on_the_device():
    """skip_nonfinite_updates selects on the device: a NaN first step (the
    optimizer has no state yet) leaves the parameters, EMA, BatchNorm
    statistics and step as they were and the optimizer at its starting
    zeros; then finite steps equal the plain step's, bit for bit."""
    good = _tb(_batch(seed=0))
    bad = dict(good, x=good["x"].clone())
    bad["x"][1, 5, 6, 0] = float("nan")
    skip, plain = _tiny_state(), _tiny_state()
    step_skip = make_train_step(skip.model, VESDE(), skip_nonfinite_updates=True)
    step_plain = make_train_step(plain.model, VESDE())
    before = _state_tensors(skip)
    m = step_skip(skip, bad, generator=torch.Generator().manual_seed(1))
    assert not bool(m["finite"]) and skip.step == 0
    after = _state_tensors(skip)
    _assert_same_state(before[:2] + ([], 0), after[:2] + ([], after[3]))
    assert all(not v.any() for s in after[2] for v in s.values())
    for seed in (2, 3):
        m = step_skip(skip, good, generator=torch.Generator().manual_seed(seed))
        step_plain(plain, good, generator=torch.Generator().manual_seed(seed))
        assert bool(m["finite"])
        _assert_same_state(_state_tensors(skip), _state_tensors(plain))
    assert skip.step == 2


def test_iter_chunks_yields_the_iterators_draws(data):
    loader = dd.DeviceDataLoader(factory.make_dataset(from_dict(_cfg(data)), "train"), B,
                                 steps_per_epoch=4, cfg_dropout_prob=P, device="cpu")
    loader.set_epoch(3)
    eager = list(loader)
    loader.set_epoch(3)
    chunks = list(loader.iter_chunks(2))
    assert loader.epoch == 4 and len(chunks) == 2 and len(eager) == 4
    for step, batch in enumerate(eager):
        stacks, draws = chunks[step // 2]
        assert all(d.shape[0] == 2 for d in draws)
        got = loader.sample_fn(*(d[step % 2] for d in draws), *stacks)
        assert got.keys() == batch.keys() and all(torch.equal(got[k], batch[k]) for k in batch)
    want = loader.draws(dd.step_generator(loader.device, loader.seed, 3, 1))
    assert all(torch.equal(a, b[1]) for a, b in zip(want, chunks[0][1]))
    with pytest.raises(ValueError, match="positive"):
        next(loader.iter_chunks(0))


def test_pipeline_fused_equals_one_step_per_dispatch(data):
    """Two chunks of 2 fused steps against 4 eager steps from the same seed:
    every loss, parameter, EMA tensor, BatchNorm statistic and the step."""
    runs = {}
    for fused in (0, K):
        cfg = from_dict(_cfg(data, fused_steps=fused, steps_per_epoch=4, detect_anomaly=True))
        train, _, _ = factory.make_loaders(cfg, device="cpu")
        pipe = TrainingPipeline(cfg, train, device="cpu")
        losses = []
        if fused:
            inner = pipe._fused

            def record(*args, inner=inner):
                state, traces = inner(*args)
                assert traces["loss"].shape == (K,) and bool(traces["finite"].all())
                losses.extend(traces["loss"])
                return state, traces
            pipe._fused = record
        else:
            inner = pipe._train_step

            def record(*args, inner=inner, **kw):
                metrics = inner(*args, **kw)
                losses.append(metrics["loss"])
                return metrics
            pipe._train_step = record
        mean = pipe.train_batches(4)
        runs[fused] = (losses, mean, _state_tensors(pipe.state))
    (l0, m0, s0), (l2, m2, s2) = runs[0], runs[K]
    assert len(l0) == len(l2) == 4 and all(torch.equal(a, b) for a, b in zip(l0, l2))
    assert m0 == m2 and s0[3] == 4
    _assert_same_state(s0, s2)


@pytest.fixture(scope="module")
def jax_fused(data):
    """JAX's fused chunk of K steps on the tiny UNet from random variables."""
    d = _cfg(data)
    ref_stacks = jax_dd.build_device_stacks(jax_factory.make_dataset(jax_from_dict(d), "train"))
    sampler = jax_dd.make_batch_sampler(ref_stacks, (32, 32), CROP_REGION, B,
                                        cfg_dropout_prob=P)
    first = sampler(jax.random.PRNGKey(7))
    init = {k: np.asarray(first[k]) for k in ("x", "y", "cond_img", "lsm_cond", "topo_cond")}
    init["t"] = np.full((B,), 0.5, np.float32)
    model, variables = jax_model_and_variables(TINY, init, seed=2)
    state = jax_create_state(jax_from_dict(d), model, init, jax.random.PRNGKey(0),
                             variables=variables)
    batch_keys = chunk_keys(jax.random.PRNGKey(21), 0, K)
    step_keys = jax.random.split(jax.random.PRNGKey(22), K)
    fused = jax_make_fused(model, jax_sde.VESDE(), sampler.raw)
    buffers = (ref_stacks.hr, ref_stacks.lr, ref_stacks.lsm, ref_stacks.topo,
               ref_stacks.classifier)
    final, traces = fused(state, batch_keys, step_keys, *buffers)
    return dict(variables=jax.tree.map(np.asarray, variables), batch_keys=batch_keys,
                step_keys=step_keys, final=final, losses=np.asarray(traces["loss"]),
                n_days=ref_stacks.n_days)


def _close_after_k_steps(got, want, model, grads, steps):
    """Within 2.5 lr, (2 steps + 0.5) lr where the gradient is float noise
    (see the module's notes); more than 95% of entries within 1e-5."""
    tight = total = 0
    for key, w in want.items():
        g, w = got[key].detach().numpy(), w.numpy()
        noise = np.abs(grads[key]) <= 1e-6 * np.abs(grads[key]).max()
        atol = np.where(_zero_gradient_entries(model, key, g.shape) | noise,
                        (2 * steps + 0.5) * LR, 2.5 * LR).astype(np.float32)
        assert (np.abs(g - w) <= atol).all(), (key, np.abs(g - w).max())
        tight += int((np.abs(g - w) < 1e-5).sum())
        total += g.size
    assert tight / total > 0.95


def test_fused_matches_jax_with_jax_draws(data, jax_fused):
    cfg = from_dict(_cfg(data))
    loader = dd.DeviceDataLoader(factory.make_dataset(cfg, "train"), B, cfg_dropout_prob=P,
                                 device="cpu")
    state = create_train_state(cfg, torch_model(TINY, jax_fused["variables"]))
    draws = [torch.stack(parts) for parts in zip(*(
        jax_draws(key, jax_fused["n_days"], batch=B, p=P) for key in jax_fused["batch_keys"]))]
    sdraws = [torch.stack(parts) for parts in zip(*(
        _jax_draws(key, (B, 32, 32, 1)) for key in jax_fused["step_keys"]))]
    probe = create_train_state(cfg, torch_model(TINY, jax_fused["variables"]))
    first = loader.sample_fn(*(d[0] for d in draws), *loader.buffers())
    make_train_step(probe.model, VESDE())(probe, {k: v for k, v in first.items() if k != "lsm_hr"},
                                          t=sdraws[0][0], z=sdraws[1][0])
    grads = {n: p.grad.numpy() for n, p in probe.model.named_parameters()}
    fused = make_fused_train_step(state.model, VESDE(), loader.sample_fn)
    _, traces = fused(state, draws, sdraws, loader.buffers())
    np.testing.assert_allclose(traces["loss"].numpy(), jax_fused["losses"], rtol=1e-4)
    assert bool(traces["finite"].all()) and state.step == int(jax_fused["final"].step) == K
    final = jax_fused["final"]
    want = state_dict_from_flax(_flax_tree(final, final.params), state.model)
    want_ema = state_dict_from_flax(_flax_tree(final, final.ema_params), state.model)
    _close_after_k_steps(dict(state.model.named_parameters()),
                         {k: want[k] for k, _ in state.model.named_parameters()}, state.model,
                         grads, steps=K)
    _close_after_k_steps(state.ema_params, {k: want_ema[k] for k in state.ema_params},
                         state.model, grads, steps=K)
    for key, v in state.batch_stats().items():
        np.testing.assert_allclose(v.numpy(), want[key].numpy(), atol=1e-5, rtol=1e-5,
                                   err_msg=key)

"""Torch port: the training engine against the JAX package's on the CPU.

The DSM loss, BatchNorm's training forward and update, one and three train
steps of the tiny UNet against ``make_train_step`` (JAX's own t and z draws
fed to both sides), remat, skipped non-finite steps, the optimizers, Xavier
init, the schedulers, the port's checkpoints and pipeline (the rate-limited
best checkpoint, the loss history, ``train_main``'s log file and frozen
config), and the export of a JAX checkpoint with its EMA weights. One
compiled JAX train step and one compiled JAX gradient are shared by the
module (``jax_run``).
"""

import dataclasses
import json
import logging
import os
import sys
import types

import flax
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import yaml

from sbgm_danra_tpu import losses as jax_losses
from sbgm_danra_tpu import sde as jax_sde
from sbgm_danra_tpu.config import from_dict as jax_from_dict
from sbgm_danra_tpu.models.resnet import BatchNorm as JaxBatchNorm
from sbgm_danra_tpu.training import schedulers as jax_sched
from sbgm_danra_tpu.training.state import create_train_state as jax_create_state
from sbgm_danra_tpu.training.train_step import make_train_step as jax_make_train_step
from sbgm_danra_tpu_torch import losses
from sbgm_danra_tpu_torch.config import from_dict, load_config
from sbgm_danra_tpu_torch.convert import state_dict_from_flax, state_dicts_from_flax
from sbgm_danra_tpu_torch.models.layers import BatchNorm
from sbgm_danra_tpu_torch.models.unet import ModelSpec, build_score_model
from sbgm_danra_tpu_torch.sde import VESDE, VPSDE, dsm_loss, sdf_weights
from sbgm_danra_tpu_torch.training import schedulers
from sbgm_danra_tpu_torch.training.checkpointing import CheckpointManager, model_state_dict
from sbgm_danra_tpu_torch.training.pipeline import TrainingPipeline, extract_batch
from sbgm_danra_tpu_torch.training.state import (
    TrainState,
    create_train_state,
    make_optimizer,
    xavier_init_convs,
)
from sbgm_danra_tpu_torch.training.train_step import (
    make_eval_step,
    make_score_fn,
    make_train_step,
)
from tests.torch_parity import TINY, jax_model_and_variables, torch_model

LR = 1e-3
HW = (64, 64)
TRAIN = {"learning_rate": LR, "weight_init": False, "ema_decay": 0.9, "weight_decay": 1e-6}


def _batch(seed=0, batch=2):
    rng = np.random.default_rng(seed)
    h, w = HW
    return {
        "x": rng.normal(size=(batch, h, w, 1)).astype(np.float32),
        "y": rng.integers(0, 5, size=(batch,)).astype(np.int32),
        "cond_img": rng.normal(size=(batch, h, w, 2)).astype(np.float32),
        "lsm_cond": rng.normal(size=(batch, h, w, 2)).astype(np.float32),
        "topo_cond": rng.normal(size=(batch, h, w, 2)).astype(np.float32),
        "sdf": rng.normal(size=(batch, h, w, 1)).astype(np.float32),
    }


def _jax_draws(rng, x_shape, t_eps=1e-3):
    """The t and z that the JAX dsm_loss draws from ``rng``."""
    t_rng, z_rng = jax.random.split(rng)
    t = jax.random.uniform(t_rng, (x_shape[0],), jnp.float32, minval=t_eps, maxval=1.0)
    z = jax.random.normal(z_rng, x_shape, jnp.float32)
    return torch.from_numpy(np.array(t)), torch.from_numpy(np.array(z))


def _tb(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


def _port_state(variables, optimizer="adam"):
    cfg = from_dict({"training": {**TRAIN, "optimizer": optimizer}})
    model = torch_model(TINY, variables)
    return create_train_state(cfg, model)


@pytest.fixture(autouse=True)
def _onednn_off():
    """This CPU build's oneDNN corrupts the heap in the tiny UNet's training
    backward (a glibc abort, a segfault or wrong numbers in a later test;
    ROADMAP F5), so the port trains here on PyTorch's own CPU convolutions.
    The port's code is the same either way."""
    with torch.backends.mkldnn.flags(enabled=False):
        yield


@pytest.fixture(scope="module")
def jax_run():
    """The tiny UNet in JAX: random variables, one compiled gradient of the
    DSM loss and three steps of one compiled ``make_train_step``."""
    batches = [_batch(seed=s) for s in range(3)]
    init = {k: v for k, v in batches[0].items() if k != "sdf"}
    init["t"] = np.full((2,), 0.5, np.float32)
    model, variables = jax_model_and_variables(TINY, init, seed=1)
    variables = jax.tree.map(jnp.asarray, variables)
    cfg = jax_from_dict({"training": TRAIN})
    state = jax_create_state(cfg, model, {k: jnp.asarray(v) for k, v in init.items()},
                             jax.random.PRNGKey(0), variables=variables)
    rngs = [jax.random.PRNGKey(10 + i) for i in range(3)]
    keys = ("y", "cond_img", "lsm_cond", "topo_cond")

    @jax.jit
    def grads(params, batch, rng):
        def loss(p):
            def score_fn(x_t, t, **cond):
                out, _ = model.apply({"params": p, "batch_stats": state.batch_stats,
                                      "buffers": state.buffers}, x_t, t, **cond, train=True,
                                     mutable=["batch_stats"])
                return out
            return jax_sde.dsm_loss(score_fn, batch["x"], rng, sdf=batch["sdf"],
                                    **{k: batch[k] for k in keys})
        return jax.grad(loss)(params)

    jb = [{k: jnp.asarray(v) for k, v in b.items()} for b in batches]
    g0 = grads(state.params, jb[0], rngs[0])
    step = jax.jit(jax_make_train_step(model, jax_sde.VESDE()))
    states, losses_ = [state], []
    for b, r in zip(jb, rngs):
        new, m = step(states[-1], b, r)
        states.append(new)
        losses_.append(float(m["loss"]))
    return dict(model=model, variables=jax.tree.map(np.asarray, variables), batches=batches,
                rngs=rngs, grads=jax.tree.map(np.asarray, g0), states=states, losses=losses_)


def _flax_tree(state, params):
    return {"params": params, "batch_stats": state.batch_stats, "buffers": state.buffers}


def _close_after_adam(got: dict, want: dict, model, steps: int, lr: float = LR):
    """Within 2.5 lr everywhere, and the large majority within 1e-5: Adam turns
    any same-sign gradient pair into (nearly) the same +-lr step, but where a
    gradient is ~0 float noise can flip its sign (tests/test_full_domain.py).
    Where it is 0 in exact arithmetic (``_zero_gradient_entries``) the sign is
    noise at every step: up to 2 lr a step apart, 2 lr steps + 0.5 lr."""
    tight = total = 0
    for key, w in want.items():
        g = got[key].detach().numpy()
        atol = np.full(g.shape, 2.5 * lr, np.float32)
        atol[_zero_gradient_entries(model, key, g.shape)] = (2 * steps + 0.5) * lr
        assert (np.abs(g - w.numpy()) <= atol).all(), (key, np.abs(g - w.numpy()).max())
        tight += int((np.abs(g - w.numpy()) < 1e-5).sum())
        total += g.size
    assert tight / total > 0.95


def _zero_gradient_entries(model, name: str, shape) -> np.ndarray:
    """The entries of a parameter whose gradient is 0 in exact arithmetic: the
    key third of an attention block's qkv bias (a bias on every key shifts a
    row's scores by one constant, which softmax removes), and the biases of
    ``_zero_in_exact_arithmetic``."""
    mask = np.zeros(shape, bool)
    if name.endswith("qkv.bias"):
        c = shape[0] // 3
        mask[c:2 * c] = True
    elif _zero_in_exact_arithmetic(model, name):
        mask[...] = True
    return mask


def _zero_in_exact_arithmetic(model, name: str) -> bool:
    """The bias of a decoder conv whose GroupNorm holds one channel per group:
    the norm removes any per-channel constant, so its gradient is 0."""
    if not name.endswith(("conv.bias", "conv_up.bias")) or not name.startswith("decoder."):
        return False
    block = model.get_submodule(name.rsplit(".", 2)[0])
    norm = block.norm2 if name.endswith("conv.bias") else block.norm1
    return norm is not None and norm.num_groups == getattr(block, name.split(".")[-2]).out_channels


class TestLoss:
    @pytest.mark.parametrize("with_sdf", [True, False])
    @pytest.mark.parametrize("sde_name", ["ve", "vp"])
    def test_dsm_loss_matches_jax(self, with_sdf, sde_name):
        """JAX's own t and z draws fed to the port: the same loss (1e-6
        relative), a sum over H, W, C and a mean over the batch."""
        rng = np.random.default_rng(0)
        x = rng.normal(size=(3, 8, 8, 1)).astype(np.float32)
        sdf = rng.normal(size=x.shape).astype(np.float32) if with_sdf else None
        w = rng.normal(size=(1, 1, 1, 1)).astype(np.float32)
        key = jax.random.PRNGKey(3)
        jsde, tsde = (jax_sde.VESDE(), VESDE()) if sde_name == "ve" else (jax_sde.VPSDE(), VPSDE())
        want = jax_sde.dsm_loss(lambda x_t, t: -x_t * w * t[:, None, None, None], jnp.asarray(x),
                                key, sde=jsde, sdf=None if sdf is None else jnp.asarray(sdf))
        t, z = _jax_draws(key, x.shape)
        got = dsm_loss(lambda x_t, t_: -x_t * torch.from_numpy(w) * t_[:, None, None, None],
                       torch.from_numpy(x), t=t, z=z, sde=tsde,
                       sdf=None if sdf is None else torch.from_numpy(sdf))
        np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)

    def test_dsm_loss_draws_from_the_generator(self):
        x = torch.zeros(4, 8, 8, 1)
        seen = []
        fn = lambda x_t, t: seen.append(t) or torch.zeros_like(x_t)  # noqa: E731
        a = dsm_loss(fn, x, generator=torch.Generator().manual_seed(1))
        b = dsm_loss(fn, x, generator=torch.Generator().manual_seed(1))
        assert a == b and torch.equal(seen[0], seen[1])
        assert (seen[0] >= 1e-3).all() and (seen[0] <= 1.0).all()

    def test_sdf_weights_and_aux_losses_match_jax(self):
        rng = np.random.default_rng(1)
        a, b, sdf = (rng.normal(size=(4, 6, 6, 1)).astype(np.float32) for _ in range(3))
        traj = rng.normal(size=(3, 2, 5)).astype(np.float32), rng.normal(size=(3, 2, 5)).astype(
            np.float32)
        ta, tb, ts = map(torch.from_numpy, (a, b, sdf))
        pairs = [
            (sdf_weights(ts, ta, 0.9, 0.3), jax_sde.sdf_weights(jnp.asarray(sdf), a, 0.9, 0.3)),
            (sdf_weights(None, ta), jax_sde.sdf_weights(None, a)),
            (losses.simple_loss(ta, tb), jax_losses.simple_loss(a, b)),
            (losses.hybrid_loss(*map(torch.from_numpy, traj), 0.3),
             jax_losses.hybrid_loss(*traj, 0.3)),
            (losses.sdf_weighted_mse(ta, tb, ts), jax_losses.sdf_weighted_mse(a, b, sdf)),
        ]
        for got, want in pairs:
            np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-7)


class TestBatchNorm:
    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    def test_train_forward_and_running_stats_match_flax(self, dtype):
        """Batch mean and biased one-pass variance in fp32, the result in the
        module's dtype, and ra = 0.9 ra + 0.1 batch (Flax's momentum 0.9)."""
        rng = np.random.default_rng(2)
        x = (3.0 + 2.0 * rng.normal(size=(4, 5, 6, 8))).astype(np.float32)  # NHWC
        jdt = getattr(jnp, dtype)
        bn = JaxBatchNorm(dtype=jdt)
        variables = bn.init(jax.random.PRNGKey(0), jnp.asarray(x), train=False)
        variables = jax.tree.map(np.asarray, variables)
        params = {"BatchNorm_0": {"scale": rng.uniform(0.5, 1.5, 8).astype(np.float32),
                                  "bias": rng.normal(size=8).astype(np.float32)}}
        stats = {"BatchNorm_0": {"mean": rng.normal(size=8).astype(np.float32),
                                 "var": rng.uniform(0.5, 2.0, 8).astype(np.float32)}}
        want, mut = bn.apply({"params": params, "batch_stats": stats},
                             jnp.asarray(x).astype(jdt), train=True, mutable=["batch_stats"])
        ours = BatchNorm(8, getattr(torch, dtype))
        with torch.no_grad():
            ours.weight.copy_(torch.from_numpy(params["BatchNorm_0"]["scale"]))
            ours.bias.copy_(torch.from_numpy(params["BatchNorm_0"]["bias"]))
            ours.running_mean.copy_(torch.from_numpy(stats["BatchNorm_0"]["mean"]))
            ours.running_var.copy_(torch.from_numpy(stats["BatchNorm_0"]["var"]))
        xt = torch.from_numpy(x).to(getattr(torch, dtype)).permute(0, 3, 1, 2)
        got = ours(xt, train=True)
        assert got.dtype == getattr(torch, dtype)
        tol = 1e-5 if dtype == "float32" else 1e-2
        np.testing.assert_allclose(got.permute(0, 2, 3, 1).float().detach().numpy(),
                                   np.asarray(want, np.float32), atol=tol, rtol=tol)
        before = ours.running_mean.clone()
        assert torch.equal(ours.running_mean, before)  # the forward updated nothing
        ours.update_running_stats()
        new = mut["batch_stats"]["BatchNorm_0"]
        np.testing.assert_allclose(ours.running_mean.numpy(), np.asarray(new["mean"]), rtol=1e-6,
                                   atol=1e-6)
        np.testing.assert_allclose(ours.running_var.numpy(), np.asarray(new["var"]), rtol=1e-5,
                                   atol=1e-6)
        with pytest.raises(RuntimeError, match="no train-mode forward"):
            ours.update_running_stats()


class TestTrainStep:
    def test_one_step_loss_and_gradients_match_jax(self, jax_run):
        """Loss at 1e-5 relative; every gradient within 1e-4 of its leaf's max |g|."""
        state = _port_state(jax_run["variables"])
        t, z = _jax_draws(jax_run["rngs"][0], jax_run["batches"][0]["x"].shape)
        step = make_train_step(state.model, VESDE())
        metrics = step(state, _tb(jax_run["batches"][0]), t=t, z=z)
        np.testing.assert_allclose(metrics["loss"].item(), jax_run["losses"][0], rtol=1e-5)
        want = state_dict_from_flax(
            {"params": jax_run["grads"], "batch_stats": jax_run["variables"]["batch_stats"],
             "buffers": jax_run["variables"]["buffers"]}, state.model)
        for name, p in state.model.named_parameters():
            w = want[name].numpy()
            got = p.grad.numpy() if p.grad is not None else np.zeros_like(w)  # unused: JAX's 0
            if _zero_in_exact_arithmetic(state.model, name):
                # float noise on both sides: each held to 1e-4 of its conv
                # weight's largest gradient
                bound = 1e-4 * np.abs(want[name[:-len("bias")] + "weight"].numpy()).max()
                assert np.abs(got).max() <= bound and np.abs(w).max() <= bound, name
                continue
            np.testing.assert_allclose(got, w, atol=1e-4 * np.abs(w).max(), rtol=0, err_msg=name)

    def test_three_steps_params_ema_and_batch_stats_match_jax(self, jax_run):
        """After three Adam steps: params and EMA within 2.5 lr (the large
        majority within 1e-5), BatchNorm running statistics within 1e-5."""
        state = _port_state(jax_run["variables"])
        step = make_train_step(state.model, VESDE())
        for b, r, want_loss in zip(jax_run["batches"], jax_run["rngs"], jax_run["losses"]):
            t, z = _jax_draws(r, b["x"].shape)
            np.testing.assert_allclose(step(state, _tb(b), t=t, z=z)["loss"].item(), want_loss,
                                       rtol=1e-4)
        final = jax_run["states"][-1]
        assert state.step == int(final.step) == 3
        want = state_dict_from_flax(_flax_tree(final, final.params), state.model)
        want_ema = state_dict_from_flax(_flax_tree(final, final.ema_params), state.model)
        _close_after_adam(dict(state.model.named_parameters()),
                          {k: want[k] for k, _ in state.model.named_parameters()},
                          state.model, steps=3)
        _close_after_adam(state.ema_params, {k: want_ema[k] for k in state.ema_params},
                          state.model, steps=3)
        for key, v in state.batch_stats().items():
            np.testing.assert_allclose(v.numpy(), want[key].numpy(), atol=1e-5, rtol=1e-5,
                                       err_msg=key)

    def test_remat_matches_plain(self, jax_run):
        """The checkpointed score function recomputes the forward in the
        backward: same loss, same gradients (1e-5 of max |g|), and the
        BatchNorm statistics folded in once."""
        runs = []
        for remat in (False, True):
            state = _port_state(jax_run["variables"])
            t, z = _jax_draws(jax_run["rngs"][0], jax_run["batches"][0]["x"].shape)
            m = make_train_step(state.model, VESDE(), remat=remat)(
                state, _tb(jax_run["batches"][0]), t=t, z=z)
            runs.append((m["loss"].item(), {n: p.grad.clone() for n, p in
                                            state.model.named_parameters()},
                         state.batch_stats()))
        (l0, g0, s0), (l1, g1, s1) = runs
        np.testing.assert_allclose(l1, l0, rtol=1e-6)
        for name in g0:
            torch.testing.assert_close(g1[name], g0[name], rtol=0,
                                       atol=1e-5 * g0[name].abs().max().item() + 1e-12)
        for key in s0:
            torch.testing.assert_close(s1[key], s0[key], rtol=1e-6, atol=1e-7)

    def test_skip_nonfinite_updates_leaves_the_state(self, jax_run):
        """A NaN batch with skip_nonfinite_updates: finite False, and the
        params, optimizer state, EMA, BatchNorm statistics and step untouched,
        as the JAX step keeps the old state; the next finite step proceeds."""
        state = _port_state(jax_run["variables"])
        step = make_train_step(state.model, VESDE(), skip_nonfinite_updates=True)
        good = _tb(jax_run["batches"][0])
        step(state, good, generator=torch.Generator().manual_seed(0))
        snapshot = (
            {k: v.clone() for k, v in state.model.state_dict().items()},
            {k: v.clone() for k, v in state.ema_params.items()},
            {id(p): {k: v.clone() for k, v in s.items()}
             for p, s in state.optimizer.state.items()},
        )
        bad = dict(good, x=good["x"].clone())
        bad["x"][0, 3, 4, 0] = float("nan")
        m = step(state, bad, generator=torch.Generator().manual_seed(1))
        assert not bool(m["finite"]) and state.step == 1
        for k, v in state.model.state_dict().items():
            assert torch.equal(v, snapshot[0][k]), k
        for k, v in state.ema_params.items():
            assert torch.equal(v, snapshot[1][k]), k
        for p, s in state.optimizer.state.items():
            assert all(torch.equal(v, snapshot[2][id(p)][k]) for k, v in s.items())
        m = step(state, good, generator=torch.Generator().manual_seed(2))
        assert bool(m["finite"]) and state.step == 2

    def test_eval_step_and_score_fn_use_the_ema(self, jax_run):
        """train=False on the EMA weights through functional_call equals a
        model that holds the EMA weights."""
        state = _port_state(jax_run["variables"])
        with torch.no_grad():
            for e in state.ema_params.values():
                e.mul_(0.5)
        b = _tb(jax_run["batches"][1])
        t, z = _jax_draws(jax_run["rngs"][1], b["x"].shape)
        got = make_eval_step(state.model, VESDE(), use_ema=True)(state, b, t=t, z=z)["loss"]
        ema_model = build_score_model(ModelSpec(**TINY))
        ema_model.load_state_dict({**state.model.state_dict(), **state.ema_params})
        want = make_eval_step(ema_model, VESDE())(
            TrainState(ema_model, make_optimizer(from_dict({}).training,
                                                 ema_model.parameters())), b, t=t, z=z)["loss"]
        torch.testing.assert_close(got, want, rtol=1e-6, atol=0)
        cond = {k: b[k] for k in ("y", "cond_img", "lsm_cond", "topo_cond")}
        with torch.no_grad():
            torch.testing.assert_close(make_score_fn(state.model, state)(b["x"], t, **cond),
                                       ema_model(b["x"], t, **cond), rtol=1e-6, atol=1e-6)


class TestOptimizers:
    @pytest.mark.parametrize("name", ["adam", "adamw", "sgd"])
    def test_updates_match_optax(self, name):
        """Three updates of the port's optimizer against the JAX factory's
        optax chain on the same parameters and gradients (1e-6)."""
        from sbgm_danra_tpu.training.state import make_optimizer as jax_make_optimizer

        rng = np.random.default_rng(4)
        p0 = rng.normal(size=(5, 7)).astype(np.float32)
        grads = [rng.normal(size=p0.shape).astype(np.float32) for _ in range(3)]
        section = {"optimizer": name, "learning_rate": 1e-2, "weight_decay": 1e-2,
                   "momentum": 0.9}
        tx = jax_make_optimizer(jax_from_dict({"training": section}))
        jp = jnp.asarray(p0)
        opt_state = tx.init(jp)
        param = torch.nn.Parameter(torch.from_numpy(p0.copy()))
        opt = make_optimizer(from_dict({"training": section}).training, [param])
        for g in grads:
            upd, opt_state = tx.update(jnp.asarray(g), opt_state, jp)
            jp = optax.apply_updates(jp, upd)
            param.grad = torch.from_numpy(g)
            opt.step()
        np.testing.assert_allclose(param.detach().numpy(), np.asarray(jp), rtol=1e-6, atol=1e-6)

    def test_learning_rate_is_injectable(self, jax_run):
        state = _port_state(jax_run["variables"])
        assert state.learning_rate == LR
        assert state.with_learning_rate(2.5e-4) is state
        assert all(g["lr"] == 2.5e-4 for g in state.optimizer.param_groups)

    def test_xavier_bounds_and_biases(self):
        """Every conv weight within Xavier's bound sqrt(6 / (fan_in + fan_out))
        with the JAX function's fans (HWIO), filling it; conv biases 0.01;
        nothing else touched; as many convs as the JAX function re-draws (the
        rank-4 kernels of the Flax tree)."""
        model = build_score_model(ModelSpec(**TINY))
        before = {k: v.clone() for k, v in model.state_dict().items()}
        xavier_init_convs(model, torch.Generator().manual_seed(0))
        _, variables = jax_model_and_variables(TINY, {k: v for k, v in _batch().items()
                                                      if k != "sdf"} | {
            "t": np.full((2,), 0.5, np.float32)})
        flat = flax.traverse_util.flatten_dict(variables["params"])
        n_conv = 0
        for module_name, module in model.named_modules():
            if not isinstance(module, torch.nn.Conv2d):
                continue
            n_conv += 1
            w = module.weight
            hwio = w.permute(2, 3, 1, 0).shape
            bound = np.sqrt(6.0 / (np.prod(hwio[:2]) * (hwio[2] + hwio[3])))
            assert w.abs().max() <= bound and w.abs().max() > 0.8 * bound, module_name
            if module.bias is not None:
                assert torch.all(module.bias == 0.01)
        jax_kernels = [v for k, v in flat.items() if k[-1] == "kernel" and v.ndim == 4]
        assert n_conv == len(jax_kernels)
        for key, v in model.state_dict().items():
            parent = key.rsplit(".", 1)[0]
            if not isinstance(model.get_submodule(parent), torch.nn.Conv2d):
                assert torch.equal(v, before[key]), key


class TestSchedulers:
    @pytest.mark.parametrize("name", ["none", "StepLR", "CosineAnnealing", "ReduceLROnPlateau"])
    def test_match_jax(self, name):
        section = {"learning_rate": 1e-3, "lr_scheduler": name,
                   "lr_scheduler_params": {"step_size": 2, "t_max": 5, "patience": 1}}
        ours = schedulers.make_scheduler(from_dict({"training": section}))
        theirs = jax_sched.make_scheduler(jax_from_dict({"training": section}))
        vals = [1.0, 0.9, 0.95, 0.96, 0.97, 0.5, 0.6, 0.7]
        assert [ours.step(v) for v in vals] == [theirs.step(v) for v in vals]
        assert ours.state_dict() == theirs.state_dict()
        a, b = schedulers.EarlyStopping(2, 0.01), jax_sched.EarlyStopping(2, 0.01)
        assert [a.update(v) for v in vals] == [b.update(v) for v in vals]


class TestCheckpoints:
    def test_round_trip_and_exact_resume(self, jax_run, tmp_path):
        """Save after two steps, restore into a fresh state: the third step
        then gives bit-identical parameters, EMA and statistics; step, learning
        rate and scheduler round-trip; best and latest are tracked."""
        batches = [_tb(b) for b in jax_run["batches"]]
        draws = [_jax_draws(r, b["x"].shape) for r, b in zip(jax_run["rngs"], batches)]
        state = _port_state(jax_run["variables"])
        step = make_train_step(state.model, VESDE())
        sched = schedulers.ReduceLROnPlateau(LR, patience=0)
        for b, (t, z) in zip(batches[:2], draws[:2]):
            step(state, b, t=t, z=z)
        sched.step(1.0)
        state.with_learning_rate(sched.step(2.0))
        manager = CheckpointManager(str(tmp_path / "ckpt"), max_to_keep=2)
        manager.save(state.step, state, {"val_loss": 0.5, "epoch": 2}, scheduler=sched)
        step(state, batches[2], t=draws[2][0], z=draws[2][1])
        manager.save(state.step, state, {"val_loss": 0.7, "epoch": 3})

        fresh = _port_state(jax_run["variables"])
        fresh_sched = schedulers.ReduceLROnPlateau(LR, patience=0)
        reopened = CheckpointManager(str(tmp_path / "ckpt"), max_to_keep=2)
        assert reopened.best_step() == 2 and reopened.latest_step() == 3
        meta = reopened.restore(fresh, best=True, scheduler=fresh_sched)
        assert meta["epoch"] == 2 and fresh.step == 2
        assert fresh.learning_rate == state.learning_rate == fresh_sched.lr == LR / 2
        make_train_step(fresh.model, VESDE())(fresh, batches[2], t=draws[2][0], z=draws[2][1])
        for (k, v), w in zip(fresh.model.state_dict().items(), state.model.state_dict().values()):
            assert torch.equal(v, w), k
        for k, v in fresh.ema_params.items():
            assert torch.equal(v, state.ema_params[k]), k
        _, tree = reopened.load_tree()
        sd = model_state_dict(tree, use_ema=True)
        assert all(torch.equal(sd[k], v) for k, v in state.ema_params.items())


def _same_tree(a, b) -> bool:
    """Checkpoint trees equal: every tensor bit for bit, every other value =="""
    if isinstance(a, torch.Tensor):
        return isinstance(b, torch.Tensor) and a.dtype == b.dtype and torch.equal(a, b)
    if isinstance(a, dict):
        return isinstance(b, dict) and a.keys() == b.keys() and all(
            _same_tree(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return type(a) is type(b) and len(a) == len(b) and all(
            _same_tree(x, y) for x, y in zip(a, b))
    return a == b


class TestAsyncCheckpoints:
    """``CheckpointManager.save(..., block=False)`` and
    ``training.async_checkpointing``: a snapshot now, the write on the
    manager's worker thread."""

    def _trained(self, jax_run):
        batches = [_tb(b) for b in jax_run["batches"]]
        draws = [_jax_draws(r, b["x"].shape) for r, b in zip(jax_run["rngs"], batches)]
        state = _port_state(jax_run["variables"])
        step = make_train_step(state.model, VESDE())
        for b, (t, z) in zip(batches[:2], draws[:2]):
            step(state, b, t=t, z=z)
        return state

    def test_the_worker_writes_the_snapshot_not_the_live_state(self, jax_run, tmp_path,
                                                              monkeypatch):
        """The state changes in place before the worker writes (its
        ``torch.save`` held until then): the file holds the state from
        before the change. A worker's error surfaces at ``wait()``, once."""
        import threading

        state = self._trained(jax_run)
        before = {k: v.clone() for k, v in state.model.state_dict().items()}
        ema = {k: v.clone() for k, v in state.ema_params.items()}
        gate, real_save = threading.Event(), torch.save

        def held(obj, path):
            assert gate.wait(60)
            real_save(obj, path)

        monkeypatch.setattr(torch, "save", held)
        manager = CheckpointManager(str(tmp_path / "ckpt"))
        manager.save(state.step, state, {"val_loss": 0.5}, block=False)
        with torch.no_grad():
            for t in (*state.model.parameters(), *state.ema_params.values()):
                t.add_(1.0)
        gate.set()
        step, tree = manager.load_tree()  # waits for the worker
        assert step == 2 and manager.best_step() == 2
        sd = model_state_dict(tree)
        assert all(torch.equal(sd[k], v) for k, v in before.items())
        assert all(torch.equal(tree["ema_params"][k], v) for k, v in ema.items())
        assert not torch.equal(next(state.model.parameters()), sd[next(iter(
            dict(state.model.named_parameters())))])

        def failing(obj, path):
            raise OSError("disk full")

        monkeypatch.setattr(torch, "save", failing)
        manager.save(3, state, {"val_loss": 0.4}, block=False)  # returns at once
        with pytest.raises(OSError, match="disk full"):
            manager.wait()
        manager.wait()  # re-raised once; nothing in flight
        assert manager.latest_step() == 2
        manager.close()

    def test_async_and_blocking_saves_write_equal_checkpoints(self, jax_run, tmp_path):
        state = self._trained(jax_run)
        sched = schedulers.ReduceLROnPlateau(LR, patience=0)
        sched.step(1.0)
        trees = []
        for block in (True, False):
            manager = CheckpointManager(str(tmp_path / f"block_{block}"))
            manager.save(state.step, state, {"val_loss": 0.5, "epoch": 2}, scheduler=sched,
                         block=block)
            trees.append(manager.load_tree()[1])
            manager.close()
        assert _same_tree(*trees) and trees[0]["step"] == 2 and trees[0]["scheduler"]

    def test_async_checkpointing_in_the_epoch_loop_writes_what_blocking_writes(
            self, tmp_path, monkeypatch):
        """The rate-limited cadence of ``TestCheckpointCadence`` (validation
        10, 2, 8, 9, interval 3: live writes, a held best flushed later) with
        ``training.async_checkpointing`` on and off: the same steps on disk,
        each checkpoint with the same contents; ``train`` returns with the
        last write done."""
        written = {}
        for on in (False, True):
            cfg = _run_cfg(tmp_path / str(on), checkpoint_min_interval_epochs=3,
                           async_checkpointing=on)
            pipe = _scripted(cfg, monkeypatch, [10.0, 2.0, 8.0, 9.0])
            pipe.train(epochs=4)
            assert pipe.checkpoints._pending is None
            index = dict(pipe.checkpoints._index)
            written[on] = {s: pipe.checkpoints.load_tree(s)[1] for s in index}
        assert sorted(written[True]) == sorted(written[False]) == [1, 2]
        for s in written[True]:
            assert _same_tree(written[True][s], written[False][s]), s


class TestPipeline:
    def test_epoch_loop_with_raw_batches(self, tmp_path):
        """Any iterable of collated dataset samples trains (extract_batch maps
        them), validates, steps the scheduler, writes the best checkpoint and
        loads it back."""
        cfg = from_dict({
            "paths": {"checkpoint_dir": str(tmp_path), "sample_dir": str(tmp_path / "samples")},
            "highres": {"variable": "prcp", "data_size": list(HW)},
            "lowres": {"condition_variables": ["temp", "prcp"]},
            "sampler": {"last_fmap_channels": 64, "time_embedding": 32, "num_heads": 2,
                        "block_layers": [1, 1, 1, 1]},
            "training": {"learning_rate": 1e-3, "lr_scheduler": "StepLR",
                         "lr_scheduler_params": {"step_size": 1, "gamma": 0.5}},
        })
        rng = np.random.default_rng(5)
        raw = [{"prcp_hr": rng.normal(size=(2, *HW, 1)).astype(np.float32),
                "temp_lr": rng.normal(size=(2, *HW, 1)).astype(np.float32),
                "prcp_lr": rng.normal(size=(2, *HW, 1)).astype(np.float32),
                "lsm": rng.normal(size=(2, *HW, 2)).astype(np.float32),
                "topo": rng.normal(size=(2, *HW, 2)).astype(np.float32),
                "classifier": np.array([1, 3]), "sdf": rng.normal(size=(2, *HW, 1))
                .astype(np.float32)} for _ in range(2)]
        mapped = extract_batch(raw[0], "prcp")
        np.testing.assert_array_equal(mapped["cond_img"][..., 1:], raw[0]["temp_lr"])
        pipe = TrainingPipeline(cfg, raw, valid_loader=raw[:1], device="cpu")
        history = pipe.train(epochs=2, steps_per_epoch=2)
        assert pipe.state.step == 4 and pipe.epoch == 2
        assert all(np.isfinite(history["train_loss"])) and history["lr"] == [1e-3, 5e-4]
        assert pipe.state.learning_rate == 2.5e-4
        before = {k: v.clone() for k, v in pipe.model.state_dict().items()}
        best = pipe.checkpoints.best_step()
        pipe.load(best=True)
        assert pipe.state.step == best
        assert pipe.epoch == (1 if best == 2 else 2)
        if best == 4:
            assert all(torch.equal(v, before[k]) for k, v in pipe.model.state_dict().items())
        cond = {k: torch.from_numpy(v[:1]) for k, v in extract_batch(raw[0], "prcp").items()
                if k in ("cond_img", "lsm_cond", "topo_cond")}
        out = pipe.score_fn()(torch.zeros(1, *HW, 1), torch.tensor([0.5]), **cond)
        assert out.shape == (1, *HW, 1) and torch.isfinite(out).all()


RUN = {"highres": {"variable": "prcp", "data_size": list(HW)},
       "lowres": {"condition_variables": ["temp", "prcp"]},
       "sampler": {"last_fmap_channels": 64, "time_embedding": 32, "num_heads": 2,
                   "block_layers": [1, 1, 1, 1]}}


def _run_cfg(tmp_path, **training):
    return from_dict({**RUN, "paths": {"checkpoint_dir": str(tmp_path / "ckpt"),
                                       "sample_dir": str(tmp_path / "samples")},
                      "training": {"weight_init": False, "early_stopping": False,
                                   "lr_scheduler": "StepLR",
                                   "lr_scheduler_params": {"step_size": 1, "gamma": 0.5},
                                   **training}})


def _scripted(cfg, monkeypatch, val_losses):
    """A pipeline whose epochs train nothing: each adds 1 to every parameter
    and EMA tensor in place (as a train step writes them) and counts a step;
    validation returns ``val_losses`` in turn (JAX's tests script them so)."""
    pipe = TrainingPipeline(cfg, [], device="cpu")

    @torch.no_grad()
    def train_batches(max_steps=None):
        for p in pipe.model.parameters():
            p.add_(1.0)
        for e in pipe.state.ema_params.values():
            e.add_(1.0)
        pipe.state.step = pipe.state.step + 1
        return 1.0

    vals = iter(val_losses)
    monkeypatch.setattr(pipe, "train_batches", train_batches)
    monkeypatch.setattr(pipe, "validate_batches", lambda max_steps=None: next(vals))
    return pipe


class TestCheckpointCadence:
    """``training.checkpoint_min_interval_epochs`` (ROADMAP F11), on the
    scripted validation losses of ``tests/test_training.py``'s cadence tests."""

    def test_interval_gates_saves(self, tmp_path, monkeypatch):
        """Improvements at epochs 1-5 with interval 3: live writes at 1 and 4,
        the epoch-5 improvement held and flushed at the loop's end, as JAX's
        ``test_checkpoint_interval_gates_saves`` pins; on disk, steps 1, 4, 5."""
        cfg = _run_cfg(tmp_path, checkpoint_min_interval_epochs=3)
        pipe = _scripted(cfg, monkeypatch, [100.0 - e for e in range(5)])
        saved, flushed = [], []
        save, flush = pipe.save, pipe._flush_pending
        monkeypatch.setattr(pipe, "save", lambda val: (saved.append(pipe.epoch), save(val)))
        monkeypatch.setattr(pipe, "_flush_pending",
                            lambda pending: (flushed.append(pending[2]["epoch"]), flush(pending)))
        pipe.train(epochs=5)
        assert saved == [1, 4] and flushed == [5]
        assert sorted(pipe.checkpoints._index) == [1, 4, 5]
        assert pipe.checkpoints.best_step() == 5

    def test_rate_limited_best_keeps_its_own_weights(self, tmp_path, monkeypatch):
        """Validation 10, 2, 8, 9 with interval 3: epoch 2's improvement is
        held and flushed at epoch 4; ``load(best=True)`` gives epoch 2, min
        validation 2.0, epoch 2's weights, EMA and scheduler, not epoch 4's
        (a snapshot that aliased the live tensors would save epoch 4's)."""
        cfg = _run_cfg(tmp_path, checkpoint_min_interval_epochs=3)
        pipe = _scripted(cfg, monkeypatch, [10.0, 2.0, 8.0, 9.0])
        at = {}

        def record(p, epoch, *_):
            at[epoch] = ({k: v.clone() for k, v in p.model.state_dict().items()},
                         {k: v.clone() for k, v in p.state.ema_params.items()})

        pipe.train(epochs=4, on_epoch_end=record)
        assert sorted(pipe.checkpoints._index) == [1, 2]
        loaded = TrainingPipeline(cfg, [], device="cpu")
        loaded.load(best=True)
        assert loaded.epoch == 2 and loaded.state.step == 2
        assert min(loaded.history["val_loss"]) == pytest.approx(2.0)
        assert loaded.history == {k: v[:2] for k, v in pipe.history.items()}
        weights, ema = at[2]
        for k, v in loaded.model.state_dict().items():
            assert torch.equal(v, weights[k]), k
        assert all(torch.equal(v, ema[k]) for k, v in loaded.state.ema_params.items())
        assert not torch.equal(next(loaded.model.parameters()), next(pipe.model.parameters()))
        assert loaded.scheduler.lr == loaded.state.learning_rate == pipe.history["lr"][1]

    def test_an_early_stop_flushes_the_held_best(self, tmp_path, monkeypatch):
        cfg = _run_cfg(tmp_path, checkpoint_min_interval_epochs=10, early_stopping=True,
                       early_stopping_params={"patience": 1, "min_delta": 0.0})
        pipe = _scripted(cfg, monkeypatch, [5.0, 4.0, 4.5, 4.6, 1.0])
        pipe.train(epochs=5)
        assert pipe.epoch == 3 and sorted(pipe.checkpoints._index) == [1, 2]
        assert pipe.checkpoints.best_step() == 2


def test_train_writes_the_loss_history_as_jax(tmp_path, monkeypatch):
    """``losses_{model_string}.json`` (ROADMAP F12): JAX's keys, one entry an
    epoch, the bytes JAX's ``_dump_history`` writes for the same history."""
    from sbgm_danra_tpu.training.pipeline import TrainingPipeline as JaxPipeline

    cfg = _run_cfg(tmp_path)
    pipe = _scripted(cfg, monkeypatch, [3.0, 2.0, 2.5])
    pipe.train(epochs=3)
    path = tmp_path / "samples" / f"losses_{pipe.model_string}.json"
    history = json.loads(path.read_text())
    assert set(history) == {"train_loss", "val_loss", "lr"}
    assert all(len(v) == 3 for v in history.values()) and history["val_loss"] == [3.0, 2.0, 2.5]
    theirs = tmp_path / "jax"
    JaxPipeline._dump_history(types.SimpleNamespace(
        cfg=types.SimpleNamespace(paths=types.SimpleNamespace(sample_dir=str(theirs))),
        model_string=pipe.model_string, history=pipe.history))
    assert path.read_bytes() == (theirs / path.name).read_bytes()


@pytest.fixture
def fresh_run_logger():
    """The package logger without handlers, so that ``setup_logger`` opens
    this test's log file; restored after."""
    log = logging.getLogger("sbgm_danra_tpu_torch")
    saved, log.handlers = log.handlers, []
    yield log
    for handler in log.handlers:
        handler.close()
    log.handlers = saved


@pytest.mark.parametrize("with_yaml", [True, False])
def test_train_main_writes_its_log_and_frozen_config(tmp_path, monkeypatch, caplog,
                                                     fresh_run_logger, with_yaml):
    """``train_main`` (ROADMAP F13): the run's log file under
    ``sample_dir/logs``, ``config_{model_string}.yaml`` that reads back to the
    same config, and the losses JSON and figure; with PyYAML refused, one skip
    line and no YAML file."""
    from sbgm_danra_tpu_torch.cli import entries

    cfg = _run_cfg(tmp_path, epochs=1)
    monkeypatch.setattr(entries, "make_loaders", lambda cfg, device: ([], None, None))
    monkeypatch.setattr(TrainingPipeline, "train_batches", lambda self, max_steps=None: 1.0)
    if not with_yaml:
        monkeypatch.setitem(sys.modules, "yaml", None)
    caplog.set_level(logging.INFO)
    pipe = entries.train_main(cfg, device="cpu")
    samples = tmp_path / "samples"
    assert [f.endswith(".log") for f in os.listdir(samples / "logs")] == [True]
    frozen = samples / f"config_{pipe.model_string}.yaml"
    assert (samples / f"losses_{pipe.model_string}.json").exists()
    assert (samples / f"losses_{pipe.model_string}.png").exists()
    if with_yaml:
        assert load_config(str(frozen)) == cfg
    else:
        assert not frozen.exists()
        assert f"frozen config {frozen.name} skipped: PyYAML missing" in caplog.text


def test_export_flax_checkpoint_to_convert(jax_run, tmp_path):
    """A JAX Orbax checkpoint -> export_flax_checkpoint.py -> convert.py: the
    params and the EMA state_dicts equal the JAX state's, mapped."""
    import export_flax_checkpoint
    from sbgm_danra_tpu.config import load_config as jax_load_config
    from sbgm_danra_tpu.models.unet import ModelSpec as JaxSpec
    from sbgm_danra_tpu.training.checkpointing import CheckpointManager as JaxManager
    from sbgm_danra_tpu.training.pipeline import model_spec_from_config as jax_spec
    from sbgm_danra_tpu.utils.naming import get_model_string

    section = {
        "paths": {"checkpoint_dir": str(tmp_path / "ckpt")},
        "highres": {"data_size": list(HW)},
        "lowres": {"condition_variables": ["temp", "prcp"]},
        "sampler": {"last_fmap_channels": 64, "time_embedding": 32, "num_heads": 2,
                    "block_layers": [1, 1, 1, 1]},
        "training": {"weight_init": False},
    }
    cfg_path = tmp_path / "cfg.yaml"
    cfg_path.write_text(yaml.safe_dump(section))
    cfg = jax_load_config(str(cfg_path))
    assert dataclasses.asdict(jax_spec(cfg)) == dataclasses.asdict(JaxSpec(**TINY))
    state = jax_run["states"][-1]  # the tiny UNet after three steps: EMA != params
    manager = JaxManager(os.path.join(cfg.paths.checkpoint_dir, get_model_string(cfg)))
    manager.save(int(state.step), state, {"val_loss": 1.0})
    manager.close()
    out = tmp_path / "weights.npz"
    assert export_flax_checkpoint.main(["--config_path", str(cfg_path), "--out", str(out)]) == 0
    with np.load(out) as data:
        flat = {k: data[k] for k in data.files}
    assert {k.split("/")[0] for k in flat} == {"params", "batch_stats", "buffers", "ema_params"}
    torch_model_ = build_score_model(ModelSpec(**TINY))
    params, ema = state_dicts_from_flax(flat, torch_model_)
    np_state = jax.tree.map(np.asarray, state)
    want_params = state_dict_from_flax(_flax_tree(np_state, np_state.params), torch_model_)
    want_ema = state_dict_from_flax(_flax_tree(np_state, np_state.ema_params), torch_model_)
    assert any(not torch.equal(want_params[k], want_ema[k]) for k in want_params)
    for key in want_params:
        assert torch.equal(params[key], want_params[key]), key
        assert torch.equal(ema[key], want_ema[key]), key

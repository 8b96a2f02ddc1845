"""Torch port: ``parallel/`` (meshes, the data-parallel step with global-batch
BatchNorm, member-sharded ensembles, tensor-parallel hooks) against the JAX
package's own parallel functions on its 8 virtual CPU devices.

The port runs as two gloo processes on the CPU, launched once for the module
(``parallel.launch.spawn`` of ``tests/torch_parallel_cases.py``'s
``parallel_module``, which does every check of this module on both ranks and
returns their results); the JAX references are computed here. Tolerances:
the loss at 1e-4 relative and the parameters at rtol 1e-4 / atol 1e-6, JAX's
own for its DP step against one device. After one Adam step a parameter
whose gradient is float noise on both sides (its sign flips) moves by +-lr
whatever its size, so those entries are held within 2.5 lr, as the port's
training parity test holds them (``tests/test_torch_training.py``), and
must be few.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from sbgm_danra_tpu.config import from_dict as jax_from_dict
from sbgm_danra_tpu.models.unet import ModelSpec as JaxSpec
from sbgm_danra_tpu.models.unet import build_score_model as jax_build
from sbgm_danra_tpu.parallel import tp as jax_tp
from sbgm_danra_tpu.parallel.ensemble import generate_ensemble as jax_ensemble
from sbgm_danra_tpu.parallel.mesh import make_mesh as jax_make_mesh
from sbgm_danra_tpu.parallel.train import make_parallel_steps as jax_parallel_steps
from sbgm_danra_tpu.sampling import SamplerConfig as JaxSamplerConfig
from sbgm_danra_tpu.sde import VESDE as JaxVESDE
from sbgm_danra_tpu.training.state import create_train_state as jax_create_state
from sbgm_danra_tpu_torch.config import from_dict
from sbgm_danra_tpu_torch.convert import _convert_leaf, state_dict_from_flax
from sbgm_danra_tpu_torch.models.layers import BatchNorm
from sbgm_danra_tpu_torch.models.unet import ModelSpec, build_score_model
from sbgm_danra_tpu_torch.parallel import mesh as pmesh
from sbgm_danra_tpu_torch.parallel import tp
from sbgm_danra_tpu_torch.parallel.ensemble import generate_ensemble
from sbgm_danra_tpu_torch.parallel.launch import spawn
from sbgm_danra_tpu_torch.parallel.train import make_parallel_steps
from sbgm_danra_tpu_torch.sampling.samplers import SamplerConfig
from sbgm_danra_tpu_torch.sde import VESDE
from sbgm_danra_tpu_torch.training.state import create_train_state
from sbgm_danra_tpu_torch.training.train_step import make_eval_step, make_train_step
from tests.test_torch_training import _zero_gradient_entries
from tests.torch_parity import TINY, jax_model_and_variables, model_inputs

LR = 1e-3
TRAIN = {"learning_rate": LR, "weight_init": False, "ema_decay": 0.9, "weight_decay": 1e-6}
GLOBAL = 8  # the global batch: 1 row a JAX device, 4 a port rank
HW = (64, 64)


def _batch(seed=0, batch=GLOBAL, hw=HW):
    rng = np.random.default_rng(seed)
    h, w = hw
    return {
        "x": rng.normal(size=(batch, h, w, 1)).astype(np.float32),
        "y": rng.integers(0, 5, size=(batch,)).astype(np.int32),
        "cond_img": rng.normal(size=(batch, h, w, 2)).astype(np.float32),
        "lsm_cond": rng.normal(size=(batch, h, w, 2)).astype(np.float32),
        "topo_cond": rng.normal(size=(batch, h, w, 2)).astype(np.float32),
        "sdf": rng.normal(size=(batch, h, w, 1)).astype(np.float32),
    }


def _jax_draws(rng, x_shape, t_eps=1e-3):
    """The t and z that JAX's dsm_loss draws from ``rng``."""
    t_rng, z_rng = jax.random.split(rng)
    t = jax.random.uniform(t_rng, (x_shape[0],), jnp.float32, minval=t_eps, maxval=1.0)
    z = jax.random.normal(z_rng, x_shape, jnp.float32)
    return np.array(t), np.array(z)


def _tensors(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


@pytest.fixture(scope="module")
def jax_dp(devices):
    """JAX's make_parallel_steps on {data: 8}: one train step of the tiny UNet
    on random variables, and its t and z."""
    batch = _batch()
    init = {k: v for k, v in batch.items() if k != "sdf"}
    init["t"] = np.full((GLOBAL,), 0.5, np.float32)
    model, np_variables = jax_model_and_variables(TINY, init, seed=1)
    cfg = jax_from_dict({"training": TRAIN})
    state = jax_create_state(cfg, model, {k: jnp.asarray(v) for k, v in init.items()},
                             jax.random.PRNGKey(0),
                             variables=jax.tree.map(jnp.asarray, np_variables))
    mesh = jax_make_mesh({"data": 8})
    train_step, eval_step, pstate, batch_sh = jax_parallel_steps(model, JaxVESDE(), cfg, state,
                                                                 mesh)
    sharded = {k: jax.device_put(jnp.asarray(v), batch_sh) for k, v in batch.items()}
    key = jax.random.PRNGKey(7)
    new, metrics = train_step(pstate, sharded, key)
    t, z = _jax_draws(key, batch["x"].shape)
    flax = lambda params: {"params": params, "batch_stats": new.batch_stats,  # noqa: E731
                           "buffers": new.buffers}
    port = build_score_model(ModelSpec(**TINY))
    return dict(
        variables=np_variables, batch=batch, t=t, z=z,
        loss=float(metrics["loss"]),
        params=state_dict_from_flax(jax.tree.map(np.asarray, flax(new.params)), port),
        ema=state_dict_from_flax(jax.tree.map(np.asarray, flax(new.ema_params)), port),
    )


def _torch_state_dict(variables):
    return state_dict_from_flax(variables, build_score_model(ModelSpec(**TINY)))


@pytest.fixture(scope="module")
def bn_inputs():
    rng = np.random.default_rng(5)
    x = (3.0 + 2.0 * rng.normal(size=(8, 6, 5, 4))).astype(np.float32)  # NCHW
    w = rng.normal(size=x.shape).astype(np.float32)
    bn = BatchNorm(6)
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(rng.uniform(0.5, 1.5, 6).astype(np.float32)))
        bn.bias.copy_(torch.from_numpy(rng.normal(size=6).astype(np.float32)))
        bn.running_mean.copy_(torch.from_numpy(rng.normal(size=6).astype(np.float32)))
        bn.running_var.copy_(torch.from_numpy(rng.uniform(0.5, 2.0, 6).astype(np.float32)))
    return dict(channels=6, x=x, w=w, state={k: v.clone() for k, v in bn.state_dict().items()})


@pytest.fixture(scope="module")
def tp_inputs():
    inputs = model_inputs(batch=4, hw=HW, seed=2)
    model, variables = jax_model_and_variables(TINY, inputs, seed=3)
    return dict(model=model, variables=variables, inputs=inputs,
                state_dict=_torch_state_dict(variables))


def _pipeline_inputs(root):
    """A tiny run config (tests/test_torch_data.py's) and lists of global
    batches: 2 train batches of 4, valid batches of 4 and of 3 (ragged)."""
    from tests.test_torch_data import config_dict

    d = config_dict(root)
    d["training"].update(checkpoint_min_interval_epochs=1)
    batches = [{k: v[:n] for k, v in _batch(seed=s, hw=(32, 32)).items()}
               for s, n in ((20, 4), (21, 4), (22, 4), (23, 3))]
    return dict(cfg=d, train=batches[:2], valid=batches[2:])


@pytest.fixture(scope="module")
def pipeline_inputs(tmp_path_factory):
    return _pipeline_inputs(str(tmp_path_factory.mktemp("torch_parallel_pipeline")))


@pytest.fixture(scope="module")
def ranks(jax_dp, bn_inputs, tp_inputs, pipeline_inputs):
    """Both ranks' results of every check of the module (one launch, ~20 s)."""
    tz = _jax_draws(jax.random.PRNGKey(11), (GLOBAL, *HW, 1))
    payload = {
        "dp": dict(spec=TINY, state_dict=_torch_state_dict(jax_dp["variables"]), train=TRAIN,
                   batch=jax_dp["batch"], t=jax_dp["t"], z=jax_dp["z"]),
        "bn": bn_inputs,
        "ensemble": dict(seed=4),
        "tp": dict(spec=TINY, state_dict=tp_inputs["state_dict"], inputs=tp_inputs["inputs"],
                   train=TRAIN, batch=_batch(seed=3), t=tz[0], z=tz[1]),
        "pipeline": pipeline_inputs,
    }
    return spawn("tests.torch_parallel_cases:parallel_module", 2, payload, backend="gloo",
                 device="cpu", timeout=400)


def _single_device_step(variables, batch, t, z):
    """The port's single-device step on the global batch (and its eval loss)."""
    with torch.backends.mkldnn.flags(enabled=False):
        model = build_score_model(ModelSpec(**TINY))
        model.load_state_dict(_torch_state_dict(variables))
        state = create_train_state(from_dict({"training": TRAIN}), model)
        tt, zz = torch.from_numpy(t), torch.from_numpy(z)
        loss = float(make_train_step(model, VESDE())(state, _tensors(batch), t=tt, z=zz)["loss"])
        ev = float(make_eval_step(model, VESDE())(state, _tensors(batch), t=tt, z=zz)["loss"])
    return loss, ev, {k: v.clone() for k, v in model.state_dict().items()}, state


def _params_close(got: dict, want: dict, model, lr: float = LR, stray: float = 1e-4):
    """rtol 1e-4 / atol 1e-6, but where Adam's step sign is noise: the entries
    whose gradient is 0 in exact arithmetic (``_zero_gradient_entries``: the
    key third of a qkv bias, a decoder conv bias under a one-channel-a-group
    norm) within 2.5 lr, and at most ``stray`` of the others (a gradient
    that is float noise near 0) within 2.5 lr."""
    strays = total = 0
    for key, w in want.items():
        g = got[key].numpy().astype(np.float64)
        w = w.numpy().astype(np.float64)
        tight = np.abs(g - w) <= 1e-6 + 1e-4 * np.abs(w)
        assert (np.abs(g - w)[~tight] <= 2.5 * lr).all(), (key, np.abs(g - w).max())
        if key in dict(model.named_parameters()):
            tight |= _zero_gradient_entries(model, key, g.shape)
        strays += int((~tight).sum())
        total += g.size
    assert strays <= stray * total, (strays, total)
    return strays


class TestMesh:
    def test_shape_check_rows_and_replicate(self, ranks):
        """JAX's shape check ("needs n devices"), each rank its 4 of 8 rows,
        None kept, rank 0's values everywhere after ``replicate``."""
        x = torch.arange(8 * 3, dtype=torch.float32).reshape(8, 3)
        for rank, out in enumerate(r["mesh"] for r in ranks):
            assert out["rank"] == rank and out["coords"] == {"data": rank}
            assert torch.equal(out["rows"], x[4 * rank:4 * rank + 4]) and out["none_kept"]
            assert "needs 3 devices, have 2" in out["shape_error"]
            assert torch.equal(out["replicated"], torch.zeros(3, 3, 8, 64))
            assert out["route"] == "gloo" and out["backend"] == "gloo" and out["world"] == 2

    def test_replicate_makes_k1_packs_stale(self, ranks):
        """A K1 weight pack made before ``replicate`` wrote the parameter is
        stale after it (the version counter moved), on every rank."""
        for out in (r["mesh"] for r in ranks):
            assert out["stale_before"] == 0 and out["stale_after"] == 1

    def test_one_process_mesh(self, monkeypatch):
        """No launcher variables: 1 process, a one-rank mesh with no group;
        {data: 2} needs more ranks than exist."""
        for key in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "COORDINATOR_ADDRESS",
                    "NUM_PROCESSES", "PROCESS_ID"):
            monkeypatch.delenv(key, raising=False)
        assert pmesh.initialize_distributed(device="cpu") == 1
        mesh = pmesh.make_mesh(device="cpu")
        assert mesh.shape == {"data": 1, "model": 1} and mesh.group() is None
        assert mesh.route() == "local" and mesh.size == 1
        with pytest.raises(ValueError, match="needs 2 devices, have 1"):
            pmesh.make_mesh({"data": 2}, device="cpu")

    @pytest.mark.parametrize("contract", ["torchrun", "jax"])
    def test_initialize_reads_the_launcher_variables(self, monkeypatch, contract):
        """torchrun's MASTER_ADDR / MASTER_PORT / WORLD_SIZE / RANK, or JAX's
        COORDINATOR_ADDRESS / NUM_PROCESSES / PROCESS_ID, reach
        ``init_process_group`` (not called here: a one-process group would
        stay for the rest of the test process)."""
        seen = {}
        monkeypatch.setattr(pmesh.dist, "is_initialized", lambda: False)
        monkeypatch.setattr(pmesh.dist, "init_process_group",
                            lambda backend, **kw: seen.update(backend=backend, **kw))
        for key in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "COORDINATOR_ADDRESS",
                    "NUM_PROCESSES", "PROCESS_ID"):
            monkeypatch.delenv(key, raising=False)
        if contract == "torchrun":
            for key, value in (("MASTER_ADDR", "host"), ("MASTER_PORT", "1234"),
                               ("WORLD_SIZE", "4"), ("RANK", "3")):
                monkeypatch.setenv(key, value)
        else:
            for key, value in (("COORDINATOR_ADDRESS", "host:1234"), ("NUM_PROCESSES", "4"),
                               ("PROCESS_ID", "3")):
                monkeypatch.setenv(key, value)
        assert pmesh.initialize_distributed(device="cpu") == 4
        assert seen == {"backend": "gloo", "init_method": "tcp://host:1234", "world_size": 4,
                        "rank": 3}


class TestDataParallel:
    def test_two_rank_step_matches_jax_on_eight_devices(self, ranks, jax_dp):
        """The port's 2-rank step against JAX's make_parallel_steps on {data: 8},
        same weights, batch, t and z: loss at 1e-4 relative, parameters, EMA
        and BatchNorm running statistics (global batch, biased variance) at
        rtol 1e-4 / atol 1e-6 (see the module's notes on Adam's sign flips)."""
        for out in (r["dp"] for r in ranks):
            assert out["rows"] == GLOBAL // 2
            assert out["route"] == {"collectives": "gloo", "graphs": False}
            assert out["loss"] == pytest.approx(jax_dp["loss"], rel=1e-4)
            model = build_score_model(ModelSpec(**TINY))
            params = {k: v for k, v in out["params"].items() if not k.endswith("W")}
            _params_close(params, {k: jax_dp["params"][k] for k in params}, model)
            stats = [k for k in params if k.endswith(("running_mean", "running_var"))]
            assert stats
            for k in stats:
                np.testing.assert_allclose(out["params"][k].numpy(), jax_dp["params"][k].numpy(),
                                           rtol=1e-4, atol=1e-6, err_msg=k)
            _params_close(out["ema"], {k: jax_dp["ema"][k] for k in out["ema"]}, model,
                          lr=0.1 * LR)

    def test_ranks_agree_and_match_the_single_device_step(self, ranks, jax_dp):
        """Both ranks hold the same state after the step, equal to the port's
        one-device step on the global batch; the 2-rank eval loss is the
        one-device eval loss."""
        loss, ev, params, _ = _single_device_step(jax_dp["variables"], jax_dp["batch"],
                                                  jax_dp["t"], jax_dp["z"])
        a, b = (r["dp"] for r in ranks)
        for key in a["params"]:
            assert torch.equal(a["params"][key], b["params"][key]), key
        assert a["loss"] == b["loss"] == pytest.approx(loss, rel=1e-5)
        _params_close(a["params"], params, build_score_model(ModelSpec(**TINY)))
        assert a["eval_loss"] == b["eval_loss"] == pytest.approx(ev, rel=1e-5)
        assert a["generator_loss"] == b["generator_loss"]

    def test_a_nonfinite_row_on_one_rank_drops_the_update_on_both(self, ranks):
        """``skip_nonfinite_updates`` with a NaN in rank 1's rows only: the
        finite flag comes after the all-reduce, so both ranks drop the step
        and keep their state (the step counter too)."""
        for out in (r["dp"]["nonfinite"] for r in ranks):
            assert out == {"finite": False, "step": 0, "kept": True}

    def test_one_rank_mesh_in_process_is_the_single_device_step(self, jax_dp):
        """A one-process mesh (no group: every collective the identity) runs
        the same step as the trainer without one."""
        loss, ev, params, _ = _single_device_step(jax_dp["variables"], jax_dp["batch"],
                                                  jax_dp["t"], jax_dp["z"])
        with torch.backends.mkldnn.flags(enabled=False):
            model = build_score_model(ModelSpec(**TINY))
            model.load_state_dict(_torch_state_dict(jax_dp["variables"]))
            cfg = from_dict({"training": TRAIN})
            state = create_train_state(cfg, model)
            mesh = pmesh.make_mesh(device="cpu")
            step, evaluate, state, shard = make_parallel_steps(model, VESDE(), cfg, state, mesh)
            batch = shard(_tensors(jax_dp["batch"]))
            tt, zz = torch.from_numpy(jax_dp["t"]), torch.from_numpy(jax_dp["z"])
            got = float(step(state, batch, t=tt, z=zz)["loss"])
        assert got == loss
        for key, want in params.items():
            assert torch.equal(model.state_dict()[key], want), key


class TestTrainingPipeline:
    def test_two_rank_epochs_match_one_device_and_rank_0_saves(self, ranks, pipeline_inputs,
                                                               tmp_path):
        """``TrainingPipeline(mesh=...)``, two epochs: the train and validation
        losses (the ragged valid batch of 3 dropped, as JAX drops it) equal
        the one-device pipeline's on the same lists without that batch; only
        rank 0 writes checkpoints, and both ranks end on the same weights."""
        from sbgm_danra_tpu_torch.training.pipeline import TrainingPipeline

        d = dict(pipeline_inputs["cfg"], paths={**pipeline_inputs["cfg"]["paths"],
                                                "checkpoint_dir": str(tmp_path / "ckpt"),
                                                "sample_dir": str(tmp_path / "samples")})
        with torch.backends.mkldnn.flags(enabled=False):
            one = TrainingPipeline(from_dict(d), pipeline_inputs["train"],
                                   pipeline_inputs["valid"][:1], device="cpu")
            want = one.train(epochs=2, steps_per_epoch=2)
        a, b = (r["pipeline"] for r in ranks)
        assert a["step"] == b["step"] == one.state.step == 4
        assert a["history"] == b["history"]
        for key in ("train_loss", "val_loss"):
            np.testing.assert_allclose(a["history"][key], want[key], rtol=1e-4)
        assert len(a["saves"]) >= 1 and b["saves"] == []
        for key in a["params"]:
            assert torch.equal(a["params"][key], b["params"][key]), key


class TestGlobalBatchNorm:
    def test_forward_and_backward_match_batch_norm_over_the_whole_batch(self, ranks,
                                                                        bn_inputs):
        """Each rank's rows normalised with the global batch's statistics; the
        input's gradient is the whole batch's autograd gradient at the rank's
        rows, the scale's and shift's add up over the ranks to the whole
        batch's; running statistics from the global batch, biased variance."""
        bn = BatchNorm(6)
        bn.load_state_dict(bn_inputs["state"])
        x = torch.from_numpy(bn_inputs["x"]).requires_grad_(True)
        y = bn(x, train=True)
        (y * torch.from_numpy(bn_inputs["w"])).sum().backward()
        bn.update_running_stats()
        mean = bn_inputs["x"].mean(axis=(0, 2, 3))
        biased = bn_inputs["x"].var(axis=(0, 2, 3))
        np.testing.assert_allclose(bn.running_var.numpy(), 0.9 * bn_inputs["state"][
            "running_var"].numpy() + 0.1 * biased, rtol=1e-5)
        outs = [r["bn"] for r in ranks]
        for rank, out in enumerate(outs):
            rows = slice(4 * rank, 4 * rank + 4)
            np.testing.assert_allclose(out["y"].numpy(), y.detach()[rows].numpy(), atol=1e-5)
            np.testing.assert_allclose(out["x_grad"].numpy(), x.grad[rows].numpy(), atol=1e-5)
            np.testing.assert_allclose(out["running_mean"].numpy(), bn.running_mean.numpy(),
                                       rtol=1e-6, atol=1e-6)
            np.testing.assert_allclose(out["running_var"].numpy(), bn.running_var.numpy(),
                                       rtol=1e-5)
        for name in ("weight_grad", "bias_grad"):
            total = outs[0][name] + outs[1][name]
            want = (bn.weight if name == "weight_grad" else bn.bias).grad
            np.testing.assert_allclose(total.numpy(), want.numpy(), rtol=1e-5, atol=1e-4)
        assert abs(mean).max() > 1.0  # the statistics are not trivial

    def test_sync_batch_norm_is_not_used(self):
        import inspect

        from sbgm_danra_tpu_torch.parallel import train

        assert "SyncBatchNorm(" not in inspect.getsource(train)
        assert not any(isinstance(m, torch.nn.SyncBatchNorm)
                       for m in build_score_model(ModelSpec(**TINY)).modules())


def _analytic(mu=1.0, s0=2.0):
    sde = VESDE()

    def score(x, t, **kw):
        var = s0 ** 2 + sde.marginal_prob_std(t).reshape(-1, 1, 1, 1) ** 2
        return -(x - mu) / var

    return score


def _jax_analytic(mu=1.0, s0=2.0):
    sde = JaxVESDE()

    def score(x, t, **kw):
        var = s0 ** 2 + sde.marginal_prob_std(t).reshape(-1, 1, 1, 1) ** 2
        return -(x - mu) / var

    return score


class TestEnsemble:
    """JAX's TestEnsemble, TestEnsemblePadding and TestEnsembleEDM, and the
    sharded rows against the port's unsharded call."""

    @pytest.mark.parametrize("name, sampler, config, n", [
        ("em", "em_sampler", SamplerConfig(num_steps=50), 16),
        ("edm", "edm_sampler", SamplerConfig(num_steps=18, s_churn=4.0), 16),
    ])
    def test_sharded_rows_equal_the_unsharded_call(self, ranks, name, sampler, config, n):
        """Each rank ran n/2 members as one call; the gathered rows equal the
        one-card call's (same generator) to float rounding."""
        want = generate_ensemble(_analytic(), torch.Generator().manual_seed(4), n, (8, 8, 1),
                                 sampler=sampler, config=config)
        for out in (r["ensemble"][name] for r in ranks):
            assert out["rows_per_call"] == [n // 2]
            np.testing.assert_allclose(out["samples"].numpy(), want.numpy(), atol=1e-6)
        arr = ranks[0]["ensemble"][name]["samples"].numpy()
        assert np.isfinite(arr).all() and np.std(arr.mean(axis=(1, 2, 3))) > 0.05

    def test_members_differ_and_match_jax_statistics(self, ranks, devices):
        """JAX's member-sharded ensemble on 8 devices and the port's on 2 ranks
        draw from the same stationary law (JAX's own bounds)."""
        arr = ranks[0]["ensemble"]["em"]["samples"].numpy()
        want = np.asarray(jax_ensemble(_jax_analytic(), jax.random.PRNGKey(0), 16, (8, 8, 1),
                                       sampler="em_sampler",
                                       config=JaxSamplerConfig(num_steps=50),
                                       mesh=jax_make_mesh({"data": 8})))
        assert arr.shape == want.shape == (16, 8, 8, 1)
        assert np.std(arr.mean(axis=(1, 2, 3))) > 0.05
        assert arr.mean() == pytest.approx(1.0, abs=0.6)
        assert arr.mean() == pytest.approx(want.mean(), abs=0.4)
        assert arr.std() == pytest.approx(want.std(), rel=0.3)

    def test_padding_of_a_member_count_that_does_not_divide(self, ranks):
        """7 members on 2 ranks: padded to 8 (4 a rank), trimmed to 7: the
        first 7 rows of the one-card call of 8."""
        want = generate_ensemble(_analytic(), torch.Generator().manual_seed(4), 8, (8, 8, 1),
                                 sampler="em_sampler", config=SamplerConfig(num_steps=50))
        for out in (r["ensemble"]["em_padded"] for r in ranks):
            assert out["rows_per_call"] == [4] and out["samples"].shape == (7, 8, 8, 1)
            np.testing.assert_allclose(out["samples"].numpy(), want[:7].numpy(), atol=1e-6)

    def test_the_condition_is_repeated_to_the_rank_members(self, ranks):
        """6 members of one condition on 2 ranks: 3 condition rows a call."""
        for out in (r["ensemble"]["cond"] for r in ranks):
            assert out["cond_rows"] == [3] and out["samples"].shape == (6, 8, 8, 1)
        assert torch.equal(ranks[0]["ensemble"]["cond"]["samples"],
                           ranks[1]["ensemble"]["cond"]["samples"])


def _port_dim_of(path: str, leaf_shape, jax_spec):
    """The port's sharded dim for a Flax leaf's spec, through the bridge's layouts."""
    if jax_spec == jax.sharding.PartitionSpec():
        return None
    j = list(jax_spec).index("model")
    mods = path.split("/")
    if len(leaf_shape) == 4:
        perm = (2, 3, 0, 1) if mods[-2] == "transpose" else (3, 2, 0, 1)
    elif mods[-1] == "kernel":
        perm = (1, 0)
    else:
        perm = (0, 1)
    return perm.index(j)


def _jax_specs_by_port_name(params):
    flat = jax.tree_util.tree_flatten_with_path(params)[0]
    specs = jax.tree.leaves(jax_tp.partition_specs(params),
                            is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    out = {}
    for (key_path, leaf), spec in zip(flat, specs):
        path = "params/" + "/".join(k.key for k in key_path)
        name, _ = _convert_leaf(path, np.zeros(leaf.shape, np.float32))
        out[name] = _port_dim_of(path, leaf.shape, spec)
    return out


class TestTensorParallel:
    @pytest.mark.parametrize("width", [64, 512, "flagship"])
    def test_partition_specs_and_fraction_match_jax(self, width):
        """The rules, name for name through the bridge's map, and the sharded
        fraction equal JAX's on the same model (JAX's flagship-width test:
        more than half of the 512-channel model's bytes); the flagship's
        fraction is the number chip_smoke.py's parallel phase checks on the
        card."""
        spec = dict(in_channels=6, num_classes=4, last_fmap_channels=width, time_embedding=64,
                    num_heads=2, block_layers=(1, 1, 1, 1))
        if width == "flagship":
            spec = dict(in_channels=6, num_classes=4)
        inputs = model_inputs(batch=1, hw=HW)
        jmodel = jax_build(JaxSpec(**spec))
        abstract = jax.eval_shape(lambda: jmodel.init(
            {"params": jax.random.PRNGKey(0)}, **{k: jnp.asarray(v) for k, v in inputs.items()},
            train=False))
        want = _jax_specs_by_port_name(abstract["params"])
        model = build_score_model(ModelSpec(**spec))
        got = {k: (v.index("model") if v else None) for k, v in tp.partition_specs(model).items()}
        assert got == want
        assert any(v is not None for v in got.values())
        mesh = jax_make_mesh({"data": 4, "model": 2})
        frac = jax_tp.sharded_param_fraction(abstract["params"], mesh)
        assert tp.sharded_param_fraction(model) == pytest.approx(frac, rel=1e-12)
        assert frac > (0.03 if width == 64 else 0.5)
        if width == "flagship":
            import chip_smoke

            assert chip_smoke.TP_FLAGSHIP_FRACTION == pytest.approx(frac, rel=1e-12)

    def test_forward_with_sharded_parameters(self, ranks, tp_inputs):
        """{model: 2}: each rank keeps half of every sharded weight; the forward
        (weights all-gathered at use) equals the unsharded one and JAX's."""
        from tests.torch_parity import jax_apply

        want = jax_apply(tp_inputs["model"], tp_inputs["variables"], tp_inputs["inputs"])
        for out in (r["tp"] for r in ranks):
            specs = out["specs"]
            sharded = [k for k, v in specs.items() if v]
            assert sharded
            for k in sharded:
                dim = specs[k].index("model")
                full = tp_inputs["state_dict"][k].shape
                assert out["local_shapes"][tp.sharded_name(k)][dim] == full[dim] // 2
            np.testing.assert_allclose(out["sharded"].numpy(), out["ref"].numpy(), rtol=2e-4,
                                       atol=2e-5)
            np.testing.assert_allclose(out["sharded"].numpy(), want, rtol=2e-4, atol=2e-4)

    def test_the_gather_makes_k1_packs_stale(self, ranks):
        """A K1 pack made from a gathered weight (keyed on its persistent
        buffer) is stale once the weight is gathered again."""
        for out in (r["tp"] for r in ranks):
            assert out["gathered_again"] == (128, 8, 3, 3)
            assert out["gather_stale_before"] == 0 and out["gather_stale_after"] == 1

    def test_dimensions_that_do_not_divide_stay_replicated(self, ranks):
        for out in (r["tp"] for r in ranks):
            assert out["fallback"] == {"0.weight": (), "0.bias": (), "1.weight": ("model", None),
                                       "1.bias": ()}

    def test_dp_tp_step_matches_flat_dp(self, ranks):
        """JAX's TestTwoDMesh: {data: 1, model: 2} with TP against {data: 2}
        flat DP on the same weights and global batch: the eval loss before the
        step (JAX's rel 1e-3; here 1e-5), the step's loss, the weights after
        it, all-gathered (Adam's sign flips aside), the eval loss after it;
        the Adam moments and EMA of a sharded weight are half its size."""
        for out in (r["tp"] for r in ranks):
            flat, dptp = out["flat"], out["dp_tp"]
            assert dptp["eval_before"] == pytest.approx(flat["eval_before"], rel=1e-5)
            assert dptp["loss"] == pytest.approx(flat["loss"], rel=1e-5)
            assert dptp["eval_after"] == pytest.approx(flat["eval_after"], rel=1e-3)
            assert np.isfinite(dptp["loss"])
            model = build_score_model(ModelSpec(**TINY))
            _params_close({f"{k}.weight": v for k, v in dptp["full_weights"].items()},
                          {f"{k}.weight": v for k, v in flat["full_weights"].items()}, model)
            sharded = [k for k in dptp["moments"] if "parametrizations" in k]
            assert sharded
            for k in sharded:
                assert dptp["ema_shapes"][k] == dptp["moments"][k]
                base = k.replace(".parametrizations.weight.original", ".weight")
                assert np.prod(dptp["moments"][k]) * 2 == np.prod(flat["moments"][base])

"""Rank bodies of the port's parallel CPU tests (``tests/test_torch_parallel.py``,
``tests/test_torch_ring_attention.py``, ``tests/test_torch_windowed_dp.py``).

Not collected by pytest. Each function runs on every rank of a two-process
gloo group (``sbgm_danra_tpu_torch.parallel.launch.spawn``), does all of
one test module's checks there, and returns numbers and tensors for the
test process, which holds them against the JAX package. The workers import
the port and numpy only: no JAX, no JAX package (one torch thread each,
oneDNN off wherever they train, ROADMAP F5).
"""

from __future__ import annotations

import numpy as np
import torch

from sbgm_danra_tpu_torch.config import from_dict
from sbgm_danra_tpu_torch.models.unet import ModelSpec, build_score_model
from sbgm_danra_tpu_torch.parallel import collectives as C
from sbgm_danra_tpu_torch.parallel.mesh import DATA_AXIS, make_mesh, replicate, shard_batch
from sbgm_danra_tpu_torch.sde import VESDE
from sbgm_danra_tpu_torch.training.state import create_train_state


def _model(spec_kw: dict, state_dict=None, **extra):
    model = build_score_model(ModelSpec(**spec_kw, **extra))
    if state_dict is not None:
        model.load_state_dict(state_dict)
    return model


def _tensors(batch: dict) -> dict:
    return {k: torch.as_tensor(np.asarray(v)) for k, v in batch.items()}


def _state_out(state) -> dict:
    return {"params": {k: v.detach().clone() for k, v in state.model.state_dict().items()},
            "ema": {k: v.clone() for k, v in state.ema_params.items()}}


# -- tests/test_torch_parallel.py ------------------------------------------------


def parallel_module(p: dict) -> dict:
    out = {}
    with torch.backends.mkldnn.flags(enabled=False):
        out["mesh"] = _mesh_checks()
        out["dp"] = _dp(p["dp"])
        out["bn"] = _bn(p["bn"])
        out["ensemble"] = _ensemble(p["ensemble"])
        out["tp"] = _tp(p["tp"])
        out["pipeline"] = _pipeline(p["pipeline"])
    return out


def _pipeline(p: dict) -> dict:
    """``TrainingPipeline.train`` on a {data: 2} mesh: two epochs over lists
    of global batches (the valid list ends with a ragged one), rank 0 saving."""
    from sbgm_danra_tpu_torch.training.pipeline import TrainingPipeline

    mesh = make_mesh({"data": 2})
    cfg = from_dict(p["cfg"])
    pipe = TrainingPipeline(cfg, p["train"], p["valid"], device="cpu", mesh=mesh)
    saves = []
    save = pipe.checkpoints.save
    pipe.checkpoints.save = lambda *a, **kw: saves.append(a[0]) or save(*a, **kw)
    history = pipe.train(epochs=2, steps_per_epoch=len(p["train"]))
    return {"history": history, "saves": saves, "step": pipe.state.step,
            "params": {k: v.detach().clone() for k, v in pipe.model.state_dict().items()}}


def _mesh_checks() -> dict:
    from sbgm_danra_tpu_torch.ops import fused_conv_gn as k1

    mesh = make_mesh({"data": 2})
    x = torch.arange(8 * 3, dtype=torch.float32).reshape(8, 3)
    rows = shard_batch(mesh, {"x": x, "none": None})
    try:
        make_mesh({"data": 3})
        shape_error = None
    except ValueError as e:
        shape_error = str(e)
    # replicate: every rank gets rank 0's values, and a K1 pack made before goes stale
    w = torch.nn.Parameter(torch.full((3, 3, 8, 64), float(mesh.rank)))
    k1.clear_packs()
    k1.tiled_weights(w, torch.bfloat16)
    stale_before = k1.stale_packs()
    replicate(mesh, [w])
    stale_after = k1.stale_packs()
    k1.clear_packs()
    return {"rank": mesh.rank, "coords": mesh.coords, "rows": rows["x"],
            "none_kept": rows["none"] is None, "shape_error": shape_error,
            "replicated": w.detach().clone(), "stale_before": stale_before,
            "stale_after": stale_after, "route": mesh.route(), "backend": mesh.backend,
            "world": mesh.size}


def _dp(p: dict) -> dict:
    from sbgm_danra_tpu_torch.parallel.train import make_parallel_steps

    model = _model(p["spec"], p["state_dict"])
    cfg = from_dict({"training": p["train"]})
    state = create_train_state(cfg, model)
    mesh = make_mesh({"data": 2})
    train_step, eval_step, state, shard = make_parallel_steps(model, VESDE(), cfg, state, mesh)
    batch = shard(_tensors(p["batch"]))
    t, z = torch.from_numpy(p["t"]), torch.from_numpy(p["z"])
    metrics = train_step(state, batch, t=t, z=z)
    out = {"loss": float(metrics["loss"]), **_state_out(state), "route": train_step.route,
           "rows": int(batch["x"].shape[0])}
    out["eval_loss"] = float(eval_step(state, batch, t=t, z=z)["loss"])
    # skip_nonfinite_updates: a NaN in rank 1's rows only; the flag is taken
    # after the all-reduce, so both ranks drop the update
    cfg = from_dict({"training": {**p["train"], "skip_nonfinite_updates": True}})
    model = _model(p["spec"], p["state_dict"])
    state = create_train_state(cfg, model)
    train_step, _, state, shard = make_parallel_steps(model, VESDE(), cfg, state, mesh)
    poisoned = _tensors(p["batch"])
    poisoned["x"] = poisoned["x"].clone()
    poisoned["x"][-1] = float("nan")
    before = {k: v.clone() for k, v in model.state_dict().items()}
    metrics = train_step(state, shard(poisoned), t=t, z=z)
    out["nonfinite"] = {"finite": bool(metrics["finite"]), "step": state.step,
                        "kept": all(torch.equal(v, before[k])
                                    for k, v in model.state_dict().items())}
    # the draws from a generator: the global batch's, this rank's rows
    g = torch.Generator().manual_seed(3)
    out["generator_loss"] = float(eval_step(state, batch, generator=g)["loss"])
    return out


def _bn(p: dict) -> dict:
    """Global-batch BatchNorm's forward and backward on this rank's rows."""
    from sbgm_danra_tpu_torch.models.layers import BatchNorm

    mesh = make_mesh({"data": 2})
    bn = BatchNorm(p["channels"])
    bn.load_state_dict(p["state"])
    bn.group = mesh.group(DATA_AXIS)
    x = shard_batch(mesh, {"x": torch.from_numpy(p["x"])})["x"].clone().requires_grad_(True)
    w = shard_batch(mesh, {"w": torch.from_numpy(p["w"])})["w"]
    y = bn(x, train=True)
    (y * w).sum().backward()
    bn.update_running_stats()
    return {"y": y.detach(), "x_grad": x.grad, "weight_grad": bn.weight.grad,
            "bias_grad": bn.bias.grad, "running_mean": bn.running_mean.clone(),
            "running_var": bn.running_var.clone()}


def _analytic_score(mu=1.0, s0=2.0):
    sde = VESDE()

    def score(x, t, **kw):
        var = s0 ** 2 + sde.marginal_prob_std(t).reshape(-1, 1, 1, 1) ** 2
        return -(x - mu) / var

    return score


def _ensemble(p: dict) -> dict:
    from sbgm_danra_tpu_torch.parallel.ensemble import generate_ensemble
    from sbgm_danra_tpu_torch.sampling.samplers import SamplerConfig

    mesh = make_mesh({"data": 2})
    score = _analytic_score()
    out = {}
    for name, sampler, config, n in (
            ("em", "em_sampler", SamplerConfig(num_steps=50), 16),
            ("em_padded", "em_sampler", SamplerConfig(num_steps=50), 7),
            ("edm", "edm_sampler", SamplerConfig(num_steps=18, s_churn=4.0), 16)):
        seen = []

        def counted(x, t, **kw):
            seen.append(x.shape[0])
            return score(x, t, **kw)

        rng = torch.Generator().manual_seed(p["seed"])
        out[name] = {"samples": generate_ensemble(counted, rng, n, (8, 8, 1), sampler=sampler,
                                                  config=config, mesh=mesh),
                     "rows_per_call": sorted(set(seen))}
    cond = {"cond_img": torch.ones(1, 8, 8, 1)}
    seen_cond = []

    def cond_score(x, t, cond_img=None, **kw):
        seen_cond.append(cond_img.shape[0])
        return score(x, t) + 0.0 * cond_img

    rng = torch.Generator().manual_seed(p["seed"])
    out["cond"] = {"samples": generate_ensemble(cond_score, rng, 6, (8, 8, 1), cond=cond,
                                                sampler="dpmpp_sampler",
                                                config=SamplerConfig(num_steps=5), mesh=mesh),
                   "cond_rows": sorted(set(seen_cond))}
    return out


def _tp(p: dict) -> dict:
    """TP on {model: 2}: the forward with sharded parameters, and a DP+TP step
    against a flat DP step on the same weights and batch."""
    from sbgm_danra_tpu_torch.parallel import tp
    from sbgm_danra_tpu_torch.parallel.train import make_parallel_steps

    out = {}
    tp_mesh = make_mesh({"data": 1, "model": 2})
    model = _model(p["spec"], p["state_dict"])
    inputs = _tensors(p["inputs"])
    t = inputs.pop("t")
    with torch.no_grad():
        out["ref"] = model(inputs["x"], t, **{k: v for k, v in inputs.items() if k != "x"})
    specs = tp.shard_params(model, tp_mesh)
    out["specs"] = specs
    out["local_shapes"] = {k: tuple(v.shape) for k, v in model.named_parameters()}
    with torch.no_grad():
        out["sharded"] = model(inputs["x"], t, **{k: v for k, v in inputs.items() if k != "x"})

    # K1's weight pack of a gathered weight goes stale at the next gather into
    # the same buffer (its version counter moves)
    from sbgm_danra_tpu_torch.ops import fused_conv_gn as k1

    conv = torch.nn.Conv2d(8, 128, 3)
    tp.shard_params(conv, tp_mesh)
    k1.clear_packs()
    k1.tiled_weights(conv.weight.permute(2, 3, 1, 0), torch.bfloat16)
    out["gather_stale_before"] = k1.stale_packs()
    out["gathered_again"] = tuple(conv.weight.shape)
    out["gather_stale_after"] = k1.stale_packs()
    k1.clear_packs()

    # the divisibility fallback: 129 output channels do not split over 2
    odd = torch.nn.Sequential(torch.nn.Linear(4, 129), torch.nn.Linear(129, 256))
    out["fallback"] = tp.shard_params(odd, tp_mesh)

    cfg = from_dict({"training": p["train"]})
    batch = _tensors(p["batch"])
    tz = torch.from_numpy(p["t"]), torch.from_numpy(p["z"])
    for name, shape, use_tp in (("flat", {"data": 2}, False),
                                ("dp_tp", {"data": 1, "model": 2}, True)):
        mesh = make_mesh(shape)
        model = _model(p["spec"], p["state_dict"])
        state = create_train_state(cfg, model)
        train_step, eval_step, state, shard = make_parallel_steps(model, VESDE(), cfg, state,
                                                                  mesh, tp=use_tp)
        local = shard(batch)
        before = float(eval_step(state, local, t=tz[0], z=tz[1])["loss"])
        loss = float(train_step(state, local, t=tz[0], z=tz[1])["loss"])
        after = float(eval_step(state, local, t=tz[0], z=tz[1])["loss"])
        moments = {k: tuple(v["exp_avg"].shape) for k, v in
                   ((n, state.optimizer.state[q]) for n, q in model.named_parameters())}
        with torch.no_grad():
            full = {n: m.weight.detach().clone() if hasattr(m, "weight") else None
                    for n, m in model.named_modules() if isinstance(
                        m, (torch.nn.Conv2d, torch.nn.Linear, torch.nn.Embedding))}
        out[name] = {"eval_before": before, "loss": loss, "eval_after": after,
                     "moments": moments, "full_weights": full,
                     "ema_shapes": {k: tuple(v.shape) for k, v in state.ema_params.items()}}
    return out


# -- tests/test_torch_ring_attention.py --------------------------------------------


def ring_module(p: dict) -> dict:
    from sbgm_danra_tpu_torch.models.attention import SpatialSelfAttention
    from sbgm_danra_tpu_torch.parallel import ring_attention as ra

    mesh = make_mesh({"data": 2})
    q, k, v = (torch.from_numpy(a) for a in p["qkv"])
    out = {"rank": mesh.rank, "route": C.route(mesh.group(DATA_AXIS), q)}
    out["blocks"] = ra.ring_self_attention(q, k, v, mesh)
    try:
        odd = torch.zeros(1, 101, 2, 16)
        ra.ring_self_attention(odd, odd, odd, mesh)
        out["odd_error"] = None
    except ValueError as e:
        out["odd_error"] = str(e)
    with ra.ring_context(mesh):
        out["inline"] = ra.ring_attention_inline(q, k, v)
        odd_q = torch.from_numpy(p["odd_qkv"][0])
        out["inline_odd"] = ra.ring_attention_inline(odd_q, odd_q, odd_q)
    out["no_context"] = ra.ring_attention_inline(q, k, v)
    # the gradient through the ring, the token split and the gather
    qg, kg, vg = (t.clone().requires_grad_(True) for t in (q, k, v))
    with ra.ring_context(mesh):
        y = ra.ring_attention_inline(qg, kg, vg)
    (y * torch.from_numpy(p["cotangent"])).sum().backward()
    out["grads"] = (qg.grad, kg.grad, vg.grad)

    module = SpatialSelfAttention(p["channels"], 2, "ring")
    module.load_state_dict(p["attention_state"])
    x = torch.from_numpy(p["attention_x"])
    with torch.no_grad(), ra.ring_context(mesh):
        out["module"] = module(x)
    out["module_calls"] = (module.ring_calls, module.dense_calls)

    model = _model(p["spec"], p["model_state"], attention_backend="ring")
    inputs = _tensors(p["model_inputs"])
    t = inputs.pop("t")
    ra.reset_ring_stats(model)
    with torch.no_grad(), ra.ring_context(mesh):
        out["model"] = model(inputs["x"], t, **{k: v for k, v in inputs.items() if k != "x"})
    out["ring_stats"] = ra.ring_stats(model)
    return out


# -- tests/test_torch_windowed_dp.py -------------------------------------------------


def windowed_module(p: dict) -> dict:
    from sbgm_danra_tpu_torch.parallel import windowed_dp as wdp

    mesh = make_mesh({"data": 2})
    toy = tuple(torch.from_numpy(a) for a in p["toy"])
    out = {"rank": mesh.rank}
    fields, statics, classifier = wdp.day_sharded_buffers(toy, mesh)
    out["shapes"] = (tuple(fields.shape), tuple(statics.shape), tuple(classifier.shape))
    out["statics_same"] = torch.equal(statics, toy[1])
    trimmed = wdp.day_sharded_buffers((toy[0][:29], toy[1], toy[2][:29]), mesh)
    out["trimmed_days"] = trimmed[0].shape[0]
    try:
        wdp.day_sharded_buffers((toy[0][:1], toy[1], toy[2][:1]), mesh)
        out["few_days_error"] = None
    except ValueError as e:
        out["few_days_error"] = str(e)
    d, h, w = toy[0].shape[:3]
    sampler = wdp.make_dp_batch_sampler(mesh, d, (h, w), p["crop"], None, p["batch"],
                                        with_sdf=False)
    out["batch"] = sampler(0, 0, fields, statics, classifier)
    out["batch_step1"] = sampler(0, 1, fields, statics, classifier)
    try:
        wdp.make_dp_batch_sampler(mesh, d, (h, w), p["crop"], None, 7)
        out["odd_batch_error"] = None
    except ValueError as e:
        out["odd_batch_error"] = str(e)
    # the batch function at local dims on JAX's draws
    draws = tuple(torch.from_numpy(a) for a in p["local_draws"][mesh.rank])
    out["from_draws"] = sampler.sample_fn(*draws, fields, statics, classifier)
    with torch.backends.mkldnn.flags(enabled=False):
        out["step"] = _windowed_step(p["step"], mesh)
    return out


def _windowed_step(p: dict, mesh) -> dict:
    """A windowed loader's window, day-sharded, sampled per rank and fed to
    the data-parallel train step."""
    from sbgm_danra_tpu_torch.data.factory import make_dataset
    from sbgm_danra_tpu_torch.data.windowed_data import WindowedDeviceLoader
    from sbgm_danra_tpu_torch.models.unet import model_spec_from_config
    from sbgm_danra_tpu_torch.parallel import windowed_dp as wdp
    from sbgm_danra_tpu_torch.parallel.train import make_parallel_steps

    cfg = from_dict(p["cfg"])
    loader = WindowedDeviceLoader(make_dataset(cfg, "train"), batch_size=8, window_days=16,
                                  seed=0, layout="strided", device="cpu")
    fields, statics, classifier = wdp.day_sharded_buffers(loader.buffers(), mesh)
    ds = loader.dataset
    sampler = wdp.make_dp_batch_sampler(
        mesh, fields.shape[0] * mesh.axis_size(DATA_AXIS), tuple(statics.shape[:2]),
        tuple(ds.hr_data_size), ds.cutout_domains if ds.cutouts else None, batch_size=8,
        cfg_dropout_prob=0.1, with_sdf=ds.sdf_weighted_loss, seed=3)
    batch = sampler(0, 0, fields, statics, classifier)
    keys = ("x", "y", "cond_img", "lsm_cond", "topo_cond", "sdf")
    batch = {k: batch[k] for k in keys if k in batch}
    model = build_score_model(model_spec_from_config(cfg))
    state = create_train_state(cfg, model)
    train_step, _, state, _ = make_parallel_steps(model, VESDE(), cfg, state, mesh)
    metrics = train_step(state, batch, generator=torch.Generator().manual_seed(1))
    return {"loss": float(metrics["loss"]), "rows": int(batch["x"].shape[0]),
            "local_days": int(fields.shape[0]), "window_days": int(loader.window_days),
            "first_param": next(model.parameters()).detach().clone()}

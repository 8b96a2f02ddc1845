"""Training on the fused device-loader route: the port's
``TrainingPipeline.train_batches`` over the resident train split, each epoch
``steps_per_epoch`` steps in chunks of ``fused_steps``, the crops, the SDF and
the CFG dropout drawn on the card inside each step's graph.

Set-up builds the one trainer the window uses, with the benchmark's weights
(and its EMA copy equal to them), and drives it through its first three steps
on the fused route's own call (one step a call, on draws the benchmark makes
and hands to both sides: day, crop, keep, t, z). The reference follows those
three steps from the same weights, days and draws, and the check compares
the gradient of step 1 as Adam took it (read back from its first moment,
m = (1 - beta1) g) and the change of every leaf after the three (parameters,
EMA, BatchNorm's running statistics), each by the worst leaf:
| ||program|| - ||reference|| | over the larger of the reference leaf's norm
and the median leaf's (``readings``). Each step's loss gap is printed beside
them and not compared: neither the fp8 control nor the half-batch fault
reads it apart from the program's on every seed.

Workload parameters: ``limits`` (the numbers compared: ``grad1``, ``change``),
``trace_seconds``. The sizes are the configuration's ``training``.
"""

from __future__ import annotations

import ast
import gc
import inspect
import os
import sys
import tempfile
import textwrap
import time

import numpy as np
import torch

from portbench import inputs, program
from portbench.harness import Result
from portbench.reference import train as ref_train
from portbench.reference.unet import exact, fake_bf16, fake_fp8, identity
from portbench.trace import span

LR_NAMES = ("prcp", "temp")  # the LR channels' variables, sorted by name
SET_UP_STEPS = 3


def port_config(cfg: dict, root: str):
    """The flagship's run config (``configs/flagship_synth.yaml``'s sections)
    through the port's own reader, its paths under ``root``."""
    from sbgm_danra_tpu_torch.config import from_dict

    m, tr, s = cfg["model"], cfg["training"], cfg["sampler"]
    return from_dict({
        "experiment": {"config_name": cfg["name"]},
        "paths": {"data_dir": root, "checkpoint_dir": os.path.join(root, "ckpt"),
                  "sample_dir": os.path.join(root, "samples"),
                  "path_save": os.path.join(root, "samples"),
                  "stats_load_dir": os.path.join(root, "stats")},
        "highres": {"model": "DANRA", "variable": "prcp", "data_size": cfg["image_hw"],
                    "scaling_method": "log_zscore", "full_domain_dims": cfg["full_domain_dims"],
                    "cutout_domains": cfg["crop"], "buffer_frac": 0.5},
        "lowres": {"model": "ERA5", "condition_variables": ["temp", "prcp"],
                   "scaling_methods": ["zscore", "log_zscore"],
                   "full_domain_dims": cfg["full_domain_dims"], "buffer_frac": 0.5},
        "sampler": {"sampler_type": s["name"], "n_timesteps": s["num_steps"],
                    "time_embedding": m["time_embedding"],
                    "last_fmap_channels": m["last_fmap_channels"], "num_heads": m["num_heads"],
                    "block_layers": m["block_layers"], "t_eps": tr["t_eps"]},
        "model": {"compute_dtype": m["compute_dtype"], "attention_backend": m["attention_backend"],
                  "decoder_gn_groups": m["decoder_gn_groups"],
                  "decoder_activation": m["decoder_activation"]},
        "data_handling": {"device_dataset": True, "num_workers": 1},
        "training": {"seed": 0, "batch_size": tr["batch_size"],
                     "learning_rate": tr["learning_rate"], "min_lr": tr["min_lr"],
                     "lr_scheduler": tr["lr_scheduler"],
                     "lr_scheduler_params": {"t_max": tr["t_max"]}, "epochs": tr["epochs"],
                     "steps_per_epoch": tr["steps_per_epoch"], "with_ema": True,
                     "ema_decay": tr["ema_decay"], "weight_decay": tr["weight_decay"],
                     "optimizer": tr["optimizer"], "sdf_weighted_loss": tr["sdf_weighted_loss"],
                     "fused_steps": tr["fused_steps"], "early_stopping": False,
                     "monitor_extremes": False, "verbose": False},
        "classifier_free_guidance": {"enabled": True, "drop_prob": tr["cfg_dropout"],
                                     "guidance_scale": s["guidance_scale"]},
    })


def resident_loader(cfg: dict, stacks, seed: int, device):
    """The port's device loader over stacks the benchmark made (in place of
    ``build_device_stacks`` reading an archive), set as its constructor sets it."""
    from sbgm_danra_tpu_torch.data.device_data import DeviceDataLoader, make_sample_fn

    tr = cfg["training"]
    loader = DeviceDataLoader.__new__(DeviceDataLoader)
    loader.dataset, loader.stacks = None, stacks
    loader.batch_size, loader.steps_per_epoch = tr["batch_size"], tr["steps_per_epoch"]
    loader.device = torch.device(device)
    loader.crop_hw = tuple(cfg["image_hw"])
    loader.cutout_domains = list(cfg["crop"])
    loader.cfg_dropout_prob = tr["cfg_dropout"]
    loader._sample = make_sample_fn(loader.crop_hw, with_sdf=tr["sdf_weighted_loss"])
    loader.seed, loader.epoch = seed, 0
    differ = constructor_fields(DeviceDataLoader) ^ set(vars(loader))
    if differ:
        raise RuntimeError(f"DeviceDataLoader's constructor and the benchmark's copy of it set "
                           f"different fields: {sorted(differ)}")
    return loader


def constructor_fields(cls) -> set:
    """The names ``cls.__init__`` assigns on ``self``, read from its source."""
    tree = ast.parse(textwrap.dedent(inspect.getsource(cls.__init__)))
    return {node.attr for node in ast.walk(tree) if isinstance(node, ast.Attribute)
            and isinstance(node.ctx, ast.Store) and isinstance(node.value, ast.Name)
            and node.value.id == "self"}


def set_up_draws(cfg: dict, seed: int, n_days: int, device) -> list:
    """The first steps' draws, made by the benchmark: (day, ox, oy, keep, t, z)
    each step, every row a crop of its own."""
    tr = cfg["training"]
    b, (ch, cw) = tr["batch_size"], cfg["image_hw"]
    x1, x2, y1, y2 = cfg["crop"]
    gen = torch.Generator(device).manual_seed(inputs.sub_seed(seed, 12))
    out = []
    for _ in range(SET_UP_STEPS):
        day = torch.randint(0, n_days, (b,), generator=gen, device=device)
        ox = x1 + torch.randint(0, x2 - x1 - ch + 1, (b,), generator=gen, device=device)
        oy = y1 + torch.randint(0, y2 - y1 - cw + 1, (b,), generator=gen, device=device)
        keep = (torch.rand(b, generator=gen, device=device) >= tr["cfg_dropout"]).float()
        t = torch.rand(b, generator=gen, device=device) * (1 - tr["t_eps"]) + tr["t_eps"]
        z = torch.randn(b, ch, cw, 1, generator=gen, device=device)
        out.append((day, ox, oy, keep, t, z))
    return out


def run(ctx) -> Result:
    from sbgm_danra_tpu_torch.data.device_data import DeviceStacks
    from sbgm_danra_tpu_torch.models.unet import model_spec_from_config
    from sbgm_danra_tpu_torch.training.pipeline import TrainingPipeline

    cfg, dev = ctx.cfg, torch.device(ctx.device)
    tr = cfg["training"]
    weights = inputs.make_weights(cfg, ctx.seed, dev)
    fields, statics, classes = inputs.make_days(ctx.seed, tr["train_days"],
                                                *cfg["full_domain_dims"], cfg["lr_channels"],
                                                cfg["model"]["num_classes"], dev)
    stacks = DeviceStacks(fields=fields, lr_names=LR_NAMES, statics=statics,
                          classifier=classes, dates=tuple(map(str, range(len(classes)))))
    loader = resident_loader(cfg, stacks, ctx.seed, dev)
    port_cfg = port_config(cfg, os.path.join(tempfile.gettempdir(), "portbench-train"))
    if model_spec_from_config(port_cfg) != program.spec(cfg):
        raise RuntimeError("the port's reading of the run config is not the configuration's model")
    pipe = TrainingPipeline(port_cfg, loader, device=str(dev))
    with torch.no_grad():
        pipe.model.load_state_dict(weights)
        for k, v in pipe.state.ema_params.items():
            v.copy_(weights[k])

    draws = set_up_draws(cfg, ctx.seed, tr["train_days"], dev)
    losses, grad1 = [], None
    for day, ox, oy, keep, t, z in draws:  # the first steps, on the fused route's call
        _, out = pipe._fused(pipe.state, [v[None] for v in (day, ox, oy, keep)],
                             (t[None], z[None]), loader.buffers())
        losses.append(float(out["loss"][0]))
        if grad1 is None:
            grad1 = _moments(pipe)
    after = _leaves(pipe)
    loader.set_epoch(1)

    calls = 0
    t0 = ctx.window_opened()
    while True:
        ctx.tracer.begin_call()
        with span("call"):
            pipe.train_batches()
        ctx.tracer.end_call()
        calls += 1
        if ctx.window_closed(t0):
            break
    elapsed = time.perf_counter() - t0
    ctx.tracer.stop()
    peak = program.memory_peak(dev)
    steps = calls * len(loader)
    del pipe
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    result = train_check(cfg, weights, (fields, statics, classes), draws,
                         dict(loss=losses, grad1=grad1, after=after), ctx.params["limits"],
                         ctx.control)
    b = tr["batch_size"]
    return Result(
        e2e={"train_samples_per_s": steps * b / elapsed},
        attempted=steps * b, failed=0, checks=result, memory_peak_bytes=peak,
        counts=dict(hw=tuple(cfg["image_hw"]), rows_per_eval=b,
                    traced_steps=ctx.tracer.calls * len(loader)))


def _moments(pipe) -> dict:
    """Step 1's gradient as Adam took it, from its first moment m = (1 - beta1) g
    (zero where Adam holds no moment: it took no gradient)."""
    opt = pipe.state.optimizer
    out = {}
    for k, p in pipe.model.named_parameters():
        m = opt.state.get(p, {}).get("exp_avg")
        out[k] = torch.zeros_like(p, dtype=torch.float32) if m is None else \
            m.detach().float() / (1 - ref_train.BETAS[0])
    return out


def _leaves(pipe) -> dict:
    """Copies of every tensor the steps update: parameters, EMA, BatchNorm's
    running statistics."""
    out = {f"param/{k}": p.detach().float().clone() for k, p in pipe.model.named_parameters()}
    out.update({f"ema/{k}": v.detach().float().clone() for k, v in pipe.state.ema_params.items()})
    out.update({f"bn/{k}": v.detach().float().clone() for k, v in pipe.state.batch_stats().items()})
    return out


def reference_run(cfg, weights, days, draws, quant=identity, rows=None) -> dict:
    """The reference's three steps; ``rows`` keeps only the first rows of each
    batch (the half-batch fault)."""
    fields, statics, classes = days
    trainer = ref_train.Trainer(weights, cfg, quant)
    losses = []
    with exact():
        for day, ox, oy, keep, t, z in draws:
            b = ref_train.batch(fields, statics, classes, day, ox, oy, keep, cfg["image_hw"])
            if rows is not None:
                b = {k: v[:rows] for k, v in b.items()}
                t, z = t[:rows], z[:rows]
            losses.append(trainer.step(b, t, z))
    after = {f"param/{k}": v for k, v in trainer.params.items()}
    after.update({f"ema/{k}": v for k, v in trainer.ema.items()})
    after.update({f"bn/{k}": v for k, v in trainer.buffers.items()
                  if k.endswith((".running_mean", ".running_var"))})
    return dict(loss=losses, grad1=trainer.grads[0], after=after)


def readings(got: dict, want: dict, weights: dict, label: str = "program") -> dict:
    """Step 1's loss gap, step 1's gradient by the worst leaf, the change by
    the worst leaf (see the module's notes). An element of
    a leaf whose reference gradient is under a thousandth of the median leaf's
    root-mean-square element (a key's bias under softmax, a conv bias before a
    GroupNorm) moves under Adam by round-off alone: it is left out of the
    change, and a leaf with no element left goes out whole."""
    losses = [abs(g - w) / abs(w) for g, w in zip(got["loss"], want["loss"])]
    g_ref = want["grad1"]
    gn = {k: float(torch.linalg.vector_norm(v)) for k, v in g_ref.items()}
    median_g = float(np.median(list(gn.values())))
    gaps = {k: abs(float(torch.linalg.vector_norm(got["grad1"][k])) - gn[k])
            / max(gn[k], median_g) for k in gn}
    rms = float(np.median([gn[k] / g_ref[k].numel() ** 0.5 for k in gn]))
    moved = {k: g.abs() >= 1e-3 * rms for k, g in g_ref.items()}
    change = 0.0
    for group in ("param", "ema", "bn"):
        dw, dg = {}, {}
        for k in want["after"]:
            if not k.startswith(group + "/"):
                continue
            name = k.split("/", 1)[1]
            start = weights[name].float()
            mask = moved[name] if group != "bn" else torch.ones_like(start, dtype=torch.bool)
            if not bool(mask.any()):
                continue
            dw[k] = float(torch.linalg.vector_norm((want["after"][k] - start)[mask]))
            dg[k] = float(torch.linalg.vector_norm(
                (got["after"][k].to(start.device) - start)[mask]))
        median = float(np.median(list(dw.values())))
        change = max([change] + [abs(dg[k] - dw[k]) / max(dw[k], median) for k in dw])
    worst = sorted(gaps, key=gaps.get)[-3:]
    print(f"{label}: each step's loss gap {losses}; step 1's gradient, its worst leaves: "
          + ", ".join(f"{k} {gaps[k]:.4g} (norm {gn[k] / median_g:.3g} of the median)"
                      for k in worst), file=sys.stderr)
    return dict(loss1=losses[0], grad1=max(gaps.values()), change=change)


def train_check(cfg, weights, days, draws, got, limits, control) -> dict:
    """The checks of the numbers ``limits`` names; with ``control`` also the
    fp8 reference's, the bf16-emulating reference's and the half-batch
    fault's readings of them, each in the program's place."""
    want = reference_run(cfg, weights, days, draws)
    runs = {"": got}
    if control:
        runs.update(control=reference_run(cfg, weights, days, draws, quant=fake_fp8),
                    emulated_bf16=reference_run(cfg, weights, days, draws, quant=fake_bf16),
                    half_batch=reference_run(cfg, weights, days, draws,
                                             rows=cfg["training"]["batch_size"] // 2))
    out = {}
    for name, run in runs.items():
        r = readings(run, want, weights, name or "program")
        out.update({(f"{name}_" if name else "") + f"train_{k}": {"value": r[k], "limit": v}
                    for k, v in limits.items()})
    return out

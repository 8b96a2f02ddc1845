"""Epoch-level training engine (counterpart of ``sbgm_danra_tpu/training/pipeline.py``,
cut to what the port trains with today).

``TrainingPipeline`` owns the model, its ``TrainState``, the train and eval
steps, the scheduler, early stopping and the port's checkpoints:

- ``train_batches`` / ``validate_batches``: one epoch of steps / validation
  losses over the loaders;
- ``train``: the epoch loop: scheduler stepped on the validation loss (the
  training loss where there is none), the best checkpoint written on an
  improvement at most every ``training.checkpoint_min_interval_epochs``
  epochs (an improvement inside the window held as a ``snapshot_state`` on
  the device and written at the next eligible epoch or at the loop's end,
  early stopping included), early stopping, and the loss history written to
  ``{paths.sample_dir}/losses_{model_string}.json``;
- ``save`` / ``load``: the port's checkpoints with an exact resume; with
  ``training.async_checkpointing`` each write runs on the checkpoint
  manager's worker thread from a snapshot on the device (``save(...,
  block=False)``), and the trainer waits for it before ``load`` and at the
  end of ``train``;
- ``score_fn(use_ema, image_hw)``: the sampling closure over the (EMA)
  weights; with ``image_hw`` on a model built for that size (``inference_spec``)
  that shares this model's tensors;
- ``generate_previews``: a preview batch sampled from ``gen_loader`` on the
  live EMA weights every ``visualization.preview_every`` epochs, and its
  figure;
- the extreme-precipitation sentinel (``training.monitor_extremes``) on the
  back-transformed HR batch every ``MONITOR_EVERY`` steps.
- instrumentation, as in JAX: with ``training.profile_dir`` the first
  epoch runs under ``utils/profiling.trace`` (a ``torch.profiler`` Chrome
  trace, the card's kernels included; the train step's capture and its
  replays are inside it), and every epoch logs ``epoch N throughput: S
  steps/s (I samples/s)`` from a ``StepTimer``.

``train_loader`` and ``valid_loader`` come from ``data/factory.py::make_loaders``
or are any iterables of batch dicts. A device loader's batches
(``is_device_loader``: ``data/device_data.py``) are model kwargs already on
the card and are used as they come, less ``lsm_hr``. Any other loader's
batches, model kwargs (``x``, ``y``, ``cond_img``, ``lsm_cond``, ``topo_cond``,
``sdf``) or the dataset's collated samples, which ``extract_batch`` maps onto
them, go through ``device_prefetch`` at ``data_handling.prefetch_depth``:
pinned and copied to the card ahead of the step. A loader with ``set_epoch``
is told the epoch. A float32 model's steps and score function run with TF32
off (``precision.exact_fp32``).

On a CUDA device the train and eval steps replay their CUDA graphs
(``train_step.CapturedStep``; the optimizer made capturable, the learning
rate a tensor on the card) unless ``capture=False`` asks for the eager steps;
on the CPU they run eagerly.

With a ``mesh`` (``parallel/mesh.py``; JAX's mesh routes,
``sbgm_danra_tpu/training/pipeline.py:106-117``, ``:153-157``, ``:197-211``)
the steps come from ``parallel/train.make_parallel_steps`` (the state
replicated from rank 0, global-batch BatchNorm, the gradients all-reduced;
graphs over NCCL, eager over gloo), a host loader's batch that does not
split over the ``data`` ranks is dropped (the valid loader's ragged tail),
``device_prefetch`` copies each rank its rows, and a device loader's batch
is cut to the rank's rows. Every rank steps alike (the losses are global
means, so the scheduler and early stopping decide alike); checkpoints, the
loss history and previews are written by rank 0 only, and the other ranks
wait for it at a barrier.

``training.fused_steps = K > 0`` (a device train loader, no mesh: JAX's
guards) runs K steps per dispatch (``training/fused.py``), as JAX's
``_run_train_fused``: per chunk of the loader's ``iter_chunks``
(``DeviceDataLoader``'s, or ``WindowedDeviceLoader``'s, whose swaps fall
between chunks), the K
steps' DSM draws from the trainer's generator in the eager order, one
``fused`` call (each step's batch drawn on the card), one read of the K
losses (and, with ``detect_anomaly``, of the K finite flags, naming the
step offsets that failed). An epoch of ``steps_per_epoch`` steps runs
ceil(steps / K) chunks; the sentinel is skipped there (the batches are
drawn inside the graph), with a warning, as in JAX. The read of each chunk's
losses is also the windowed loader's backpressure: without it the host would
run ahead of the card and pace the window swaps on host time. A mesh
with ``fused_steps`` raises, as in JAX.
"""

from __future__ import annotations

import itertools
import json
import logging
import math
import os
import time
from typing import Callable, Dict, Iterable, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from sbgm_danra_tpu_torch.capture import use_graphs
from sbgm_danra_tpu_torch.config import get_model_string
from sbgm_danra_tpu_torch.data.loader import device_prefetch, extract_batch
from sbgm_danra_tpu_torch.evaluate.generation import condition_tensors
from sbgm_danra_tpu_torch.models.unet import (build_score_model, inference_spec,
                                              model_spec_from_config)
from sbgm_danra_tpu_torch.precision import exact_fp32
from sbgm_danra_tpu_torch.sampling import graphs
from sbgm_danra_tpu_torch.sampling.samplers import config_from_run
from sbgm_danra_tpu_torch.sde import VESDE
from sbgm_danra_tpu_torch.training.checkpointing import CheckpointManager, snapshot_state
from sbgm_danra_tpu_torch.training.fused import make_fused_train_step, step_draws
from sbgm_danra_tpu_torch.training.schedulers import EarlyStopping, make_scheduler
from sbgm_danra_tpu_torch.training.state import create_train_state
from sbgm_danra_tpu_torch.training.train_step import (
    CapturedStep,
    make_eval_step,
    make_score_fn,
    make_train_step,
)
from sbgm_danra_tpu_torch.utils.plotting import plot_or_skip, plot_samples_and_generated
from sbgm_danra_tpu_torch.utils.profiling import StepTimer, span, trace
from sbgm_danra_tpu_torch.utils.sentinels import clamp_extremes, report_precip_extremes

logger = logging.getLogger(__name__)

_MODEL_KEYS = ("x", "y", "cond_img", "lsm_cond", "topo_cond", "sdf")
MONITOR_EVERY = 50  # steps between two sentinel reads of the HR batch, as in JAX


def share_tensors(model: torch.nn.Module, source: torch.nn.Module) -> torch.nn.Module:
    """Point every parameter and buffer of ``model`` at ``source``'s tensor of
    the same name (the same objects: updates of ``source`` are seen, nothing is
    copied)."""
    modules = dict(source.named_modules())
    for name, module in model.named_modules():
        src = modules[name]
        for key in module._parameters:
            module._parameters[key] = src._parameters[key]
        for key in module._buffers:
            module._buffers[key] = src._buffers[key]
    return model


class TrainingPipeline:
    """Owns the model, state and steps, and runs the epoch loop."""

    def __init__(self, cfg, train_loader: Iterable[Dict],
                 valid_loader: Optional[Iterable[Dict]] = None, device: str = "cuda",
                 capture: Optional[bool] = None, back_transforms: Optional[Dict] = None,
                 gen_loader: Optional[Iterable[Dict]] = None, mesh=None):
        self.cfg = cfg
        self.mesh = mesh
        self.shard = None
        self.train_loader = train_loader
        self.valid_loader = valid_loader
        self.back_transforms = back_transforms or {}
        self.gen_loader = gen_loader
        self.device = torch.device(device)
        self.sde = VESDE()
        self.spec = model_spec_from_config(cfg)
        t = cfg.training
        init = torch.Generator().manual_seed(t.seed)
        self.model = build_score_model(self.spec, self.sde, generator=init)
        self.state = create_train_state(cfg, self.model, init)
        self.model.to(self.device)
        # the optimizer was built on the CPU tensors: .to moved them in place
        self.state.to(self.device)
        self.model_string = get_model_string(cfg)
        self.generator = torch.Generator(self.device).manual_seed(t.seed)
        eps = cfg.sampler.t_eps
        precision = exact_fp32(self.spec.compute_dtype)
        if mesh is not None:
            from sbgm_danra_tpu_torch.parallel.train import make_parallel_steps, route

            self.capture = route(mesh, capture)["graphs"]
            if self.capture:
                self.state.make_capturable()
            self._train_step, self._eval_step, self.state, self.shard = make_parallel_steps(
                self.model, self.sde, cfg, self.state, mesh, capture=self.capture)
            self.eager_train_step = None
        else:
            self.capture = use_graphs(capture, self.device)
            if self.capture:
                self.state.make_capturable()
            step = make_train_step(
                self.model, self.sde, t_eps=eps, use_sdf_weights=t.sdf_weighted_loss,
                detect_anomaly=t.detect_anomaly, remat=t.remat,
                skip_nonfinite_updates=t.skip_nonfinite_updates)
            # the eager step stays at hand: the card check's reference and the A/B
            self.eager_train_step = precision(step)
            self._train_step = (precision(CapturedStep(step, eps, "train step"))
                                if self.capture else self.eager_train_step)
            self._eval_step = precision(make_eval_step(self.model, self.sde, t_eps=eps,
                                                       use_sdf_weights=t.sdf_weighted_loss,
                                                       capture=self.capture))
        self._fused = None
        if t.fused_steps > 0:
            if not getattr(train_loader, "is_device_loader", False):
                raise ValueError(
                    "training.fused_steps requires a device-resident train "
                    "loader (data_handling.device_dataset: true)")
            if mesh is not None or cfg.parallel.mesh_shape is not None:
                raise ValueError(
                    "training.fused_steps is a single-device path; mesh "
                    "training already amortizes dispatch via parallel steps")
            if t.monitor_extremes:
                logger.warning("fused_steps > 0: extreme-value monitoring is skipped "
                               "(batches are drawn inside the graph)")
            self._fused = precision(make_fused_train_step(
                self.model, self.sde, train_loader.sample_fn, t_eps=eps,
                use_sdf_weights=t.sdf_weighted_loss, remat=t.remat,
                skip_nonfinite_updates=t.skip_nonfinite_updates, track_finite=t.detect_anomaly,
                capture=self.capture))
        self.scheduler = make_scheduler(cfg)
        es = t.early_stopping_params
        self.early_stopping = EarlyStopping(es.patience, es.min_delta) if t.early_stopping \
            else None
        self.checkpoints = CheckpointManager(
            os.path.join(cfg.paths.checkpoint_dir, self.model_string))
        self.history: Dict[str, List[float]] = {"train_loss": [], "val_loss": [], "lr": []}
        self.epoch = 0

    @property
    def is_main(self) -> bool:
        """Whether this process writes the run's files: rank 0, or no mesh."""
        return self.mesh is None or self.mesh.rank == 0

    def _wait_for_main(self) -> None:
        """The other ranks wait here while rank 0 writes."""
        if self.mesh is not None and self.mesh.world is not None:
            dist.barrier(group=self.mesh.world)

    def _batches(self, loader: Iterable[Dict]) -> Iterable[Dict[str, torch.Tensor]]:
        if getattr(loader, "is_device_loader", False):
            for batch in loader:
                batch = {k: batch[k] for k in _MODEL_KEYS if batch.get(k) is not None}
                yield batch if self.shard is None else self.shard(batch)
            return
        hr_var = self.cfg.highres.variable
        kwargs = ({k: batch[k] for k in _MODEL_KEYS if batch.get(k) is not None}
                  for batch in (raw if "x" in raw else extract_batch(raw, hr_var)
                                for raw in loader))
        if self.mesh is not None:
            kwargs = self._divisible(kwargs)
        for batch in device_prefetch(kwargs, self.cfg.data_handling.prefetch_depth,
                                     self.device, shard=self.shard):
            yield {k: torch.as_tensor(v).to(self.device) for k, v in batch.items()}

    def _divisible(self, batches):
        """The batches that split over the data ranks: a ragged one (the valid
        loader keeps its partial last batch) is dropped, as in JAX."""
        from sbgm_danra_tpu_torch.parallel.mesh import DATA_AXIS

        n = self.mesh.axis_size(DATA_AXIS)
        for b in batches:
            if b["x"].shape[0] % n:
                logger.debug("dropping ragged batch of %d (mesh size %d)", b["x"].shape[0], n)
                continue
            yield b

    def train_batches(self, max_steps: Optional[int] = None) -> float:
        """One epoch of optimizer steps; the mean training loss. Epoch 0 runs
        under ``utils.profiling.trace`` when ``training.profile_dir`` is set;
        each epoch logs its throughput from a ``StepTimer`` ticked once a step
        (once a chunk of ``fused_steps``, folded back into steps), as JAX does."""
        t = self.cfg.training
        losses = []
        timer = StepTimer()
        t0 = time.perf_counter()
        with trace(t.profile_dir if self.epoch == 0 else "", self.device):
            if self._fused is not None:
                self._run_fused(max_steps, losses, timer)
            else:
                self._run_steps(max_steps, losses, timer)
        k = t.fused_steps if self._fused is not None else 1
        if timer.steps_per_sec > 0:
            logger.info("epoch %d throughput: %.2f steps/s (%.1f samples/s)", self.epoch,
                        timer.steps_per_sec * k, timer.items_per_sec(t.batch_size * k))
        if not losses:
            return float("nan")
        mean = float(torch.stack(losses).mean())
        dt = time.perf_counter() - t0
        logger.info("epoch %d: %d steps in %s s (%.2f steps/s)", self.epoch, len(losses), dt,
                    len(losses) / dt)
        return mean

    def _run_steps(self, max_steps: Optional[int], losses: List[torch.Tensor],
                   timer: StepTimer) -> None:
        for i, batch in enumerate(self._batches(self.train_loader)):
            if max_steps is not None and i >= max_steps:
                break
            timer.tick()
            metrics = self._train_step(self.state, batch, self.generator)
            if self.cfg.training.detect_anomaly and not bool(metrics["finite"]):
                raise FloatingPointError(
                    f"Non-finite loss/gradients at step {self.state.step}")
            losses.append(metrics["loss"])
            if i % MONITOR_EVERY == 0:
                self._monitor_extremes(batch["x"])

    def _monitor_extremes(self, x: torch.Tensor) -> None:
        """The sentinel on the back-transformed HR batch (prcp only)."""
        t = self.cfg.training
        if (t.monitor_extremes and self.cfg.highres.variable == "prcp"
                and "generated" in self.back_transforms):
            hr_bt = self.back_transforms["generated"](x.float().cpu().numpy())
            report_precip_extremes(hr_bt, "train-HR", t.extreme_cap)

    def _run_fused(self, max_steps: Optional[int], losses: List[torch.Tensor],
                   timer: StepTimer) -> None:
        """K steps per ``fused`` call over ``iter_chunks``; one read of each
        chunk's losses (and finite flags) on the host.

        Spans: ``train.chunk`` a chunk, holding ``train.draw`` (the loader's
        chunk draws and the DSM draws), ``train.replay`` (the fused call) and
        ``train.sync`` (the loss read). The loader's end of the epoch, found
        by one more draw, closes a last ``train.chunk`` that holds only its
        ``train.draw``."""
        k = self.cfg.training.fused_steps
        loader = self.train_loader
        n_chunks = -(-max_steps // k) if max_steps else None
        x_shape = (loader.batch_size, *loader.crop_hw, 1)
        chunks = loader.iter_chunks(k, n_chunks)
        for ci in itertools.count():
            with span("train.chunk"):
                with span("train.draw"):
                    chunk = next(chunks, None)
                    if chunk is None:
                        return
                    stacks, draws = chunk
                    timer.tick()
                    sdraws = step_draws(self.generator, x_shape, k, stacks[0].dtype,
                                        self.device, self.cfg.sampler.t_eps)
                with span("train.replay"):
                    _, traces = self._fused(self.state, draws, sdraws, stacks)
                with span("train.sync"):
                    trace = traces["loss"].cpu()
            if self.cfg.training.detect_anomaly:
                finite = traces["finite"].cpu()
                if not bool(finite.all()):
                    raise FloatingPointError(
                        f"Non-finite loss/gradients in fused chunk {ci} (step offsets "
                        f"{torch.nonzero(~finite).flatten().tolist()})")
            losses.extend(trace)

    def validate_batches(self, max_steps: Optional[int] = None) -> float:
        if self.valid_loader is None:
            return float("nan")
        losses = []
        for i, batch in enumerate(self._batches(self.valid_loader)):
            if max_steps is not None and i >= max_steps:
                break
            losses.append(self._eval_step(self.state, batch, self.generator)["loss"])
        return float(torch.stack(losses).mean()) if losses else float("nan")

    def _meta(self, val_loss: float) -> Dict:
        """The checkpoint's metadata as it is now (the history copied, so a
        deferred save records its own epoch's)."""
        return {"epoch": self.epoch, "val_loss": val_loss,
                "history": {k: list(v) for k, v in self.history.items()},
                "model_string": self.model_string}

    def _blocking_saves(self) -> bool:
        # a mesh's saves block: the barrier after one means "on disk"
        return self.mesh is not None or not self.cfg.training.async_checkpointing

    def save(self, val_loss: float) -> Optional[str]:
        """The checkpoint (rank 0 only; the other ranks wait for it)."""
        path = None
        if self.is_main:
            path = self.checkpoints.save(self.state.step, self.state, self._meta(val_loss),
                                         self.scheduler, self.early_stopping,
                                         block=self._blocking_saves())
        self._wait_for_main()
        return path

    def _flush_pending(self, pending: tuple) -> None:
        step, snapshot, meta = pending
        if self.is_main:
            logger.info("flushing rate-limited best checkpoint (epoch %d, val %.4f)",
                        meta["epoch"], meta["val_loss"])
            self.checkpoints.save(step, snapshot, meta, block=self._blocking_saves())
        self._wait_for_main()

    def _dump_history(self) -> None:
        if self.is_main:
            path = os.path.join(self.cfg.paths.sample_dir, f"losses_{self.model_string}.json")
            os.makedirs(os.path.dirname(path), exist_ok=True)
            with open(path, "w") as f:
                json.dump(self.history, f)
        self._wait_for_main()

    def load(self, best: bool = False) -> None:
        meta = self.checkpoints.restore(self.state, best=best, scheduler=self.scheduler,
                                        early_stop=self.early_stopping)
        self.epoch = meta.get("epoch", 0)
        self.history = meta.get("history", self.history)
        if self.capture:
            self.state.make_capturable()
        else:
            self.state.make_eager()
        self.state.with_learning_rate(self.scheduler.lr)

    def train(self, epochs: Optional[int] = None, steps_per_epoch: Optional[int] = None,
              on_epoch_end: Optional[Callable[["TrainingPipeline", int, float, float], None]]
              = None) -> Dict[str, List[float]]:
        cfg = self.cfg
        epochs = epochs or cfg.training.epochs
        steps_per_epoch = steps_per_epoch or cfg.training.steps_per_epoch
        best_val = min(self.history["val_loss"], default=math.inf)
        save_interval = max(1, cfg.training.checkpoint_min_interval_epochs)
        last_save_epoch = -save_interval  # the first improvement always saves
        pending = None  # a rate-limited best: (step, snapshot_state, meta)
        for _ in range(epochs):
            t0 = time.time()
            if hasattr(self.train_loader, "set_epoch"):
                self.train_loader.set_epoch(self.epoch)
            train_loss = self.train_batches(steps_per_epoch)
            val_loss = self.validate_batches(steps_per_epoch)
            self.history["train_loss"].append(train_loss)
            self.history["val_loss"].append(val_loss)
            self.history["lr"].append(self.scheduler.lr)
            logger.info("epoch %d: train %.4f  val %.4f  lr %.2e  (%.1fs)", self.epoch,
                        train_loss, val_loss, self.scheduler.lr, time.time() - t0)
            monitored = val_loss if np.isfinite(val_loss) else train_loss
            self.epoch += 1  # epochs completed; the checkpoint's metadata records it
            eligible = self.epoch - last_save_epoch >= save_interval
            if monitored < best_val:
                best_val = monitored
                if eligible:
                    self.save(monitored)
                    last_save_epoch = self.epoch
                    pending = None
                else:
                    pending = (self.state.step,
                               snapshot_state(self.state, self.scheduler, self.early_stopping),
                               self._meta(monitored))
            elif pending is not None and eligible:
                self._flush_pending(pending)
                last_save_epoch = self.epoch
                pending = None
            self.state.with_learning_rate(self.scheduler.step(monitored))
            every = cfg.visualization.preview_every
            if every and self.epoch % every == 0 and self.is_main:
                self.generate_previews()
            if on_epoch_end is not None:
                on_epoch_end(self, self.epoch, train_loss, val_loss)
            if self.early_stopping is not None and self.early_stopping.update(monitored):
                logger.info("early stopping at epoch %d", self.epoch)
                break
        if pending is not None:  # held past the last eligible epoch, or an early stop
            self._flush_pending(pending)
        self.checkpoints.wait()  # an asynchronous save is on disk when train returns
        self._dump_history()
        return self.history

    def score_fn(self, use_ema: Optional[bool] = None, image_hw: Optional[tuple] = None):
        """Sampling closure over the EMA weights (``training.with_ema``) or the parameters.

        ``image_hw``: the inference image size, if known: the model is built
        from ``inference_spec(spec, image_hw)`` (at the full domain, K2 on
        decoder block 1) and shares every tensor of the trained model
        (``share_tensors``). None keeps the training model.
        """
        use_ema = self.cfg.training.with_ema if use_ema is None else use_ema
        model = self.model
        if image_hw is not None:
            spec = inference_spec(self.spec, image_hw)
            model = share_tensors(build_score_model(spec, self.sde), self.model)
        return exact_fp32(self.spec.compute_dtype)(
            make_score_fn(model, self.state, use_ema=use_ema))

    def generate_previews(self, n_steps: Optional[int] = None,
                          rng: Optional[torch.Generator] = None,
                          capture: bool = False) -> Optional[np.ndarray]:
        """Preview sampling: one gen-loader batch sampled with the configured
        sampler at ``n_steps`` (``min(sampler.n_timesteps, 200)``) on the live
        EMA weights, the sentinel on the back-transformed prcp, and with
        ``visualization.save_figs`` the figure
        ``{paths.sample_dir}/preview_{model_string}_epoch{epoch}.png`` (a
        failed or skipped figure never stops training). Returns the (N, H, W)
        normalised fields, or None without a gen loader.

        The noise comes from ``rng`` (the trainer's generator by default). The
        sampler runs its eager loop: the train steps between two previews
        write the EMA weights, so a graph of the preview would be captured
        anew each time, which costs more than the eager loop (PERF.md §6).
        ``capture=True`` takes the graph route all the same: a fresh capture,
        freed with the call.
        """
        if self.gen_loader is None:
            return None
        cfg = self.cfg
        batch = extract_batch(next(iter(self.gen_loader)), cfg.highres.variable)
        cond = condition_tensors(batch, self.device)
        shape = (*batch["x"].shape[:3], 1)
        config = config_from_run(cfg, n_steps or min(cfg.sampler.n_timesteps, 200))
        rng = self.generator if rng is None else rng
        with exact_fp32(self.spec.compute_dtype), torch.no_grad():
            out = graphs.call(cfg.sampler.sampler_type, self.score_fn(), rng, shape,
                              self.sde, config, cond=cond,
                              graph=use_graphs(capture, self.device))
        generated = out[..., 0].float().cpu().numpy()
        if cfg.highres.variable == "prcp" and "generated" in self.back_transforms:
            gen_bt = np.asarray(self.back_transforms["generated"](generated))
            report_precip_extremes(gen_bt, f"epoch{self.epoch}-preview", cfg.training.extreme_cap)
            generated = np.asarray(clamp_extremes(generated, generated.max()))
        if cfg.visualization.save_figs:
            name = f"preview_{self.model_string}_epoch{self.epoch}"
            try:
                os.makedirs(cfg.paths.sample_dir, exist_ok=True)
                plot_or_skip(name, plot_samples_and_generated, batch, generated, cfg,
                             path=os.path.join(cfg.paths.sample_dir, f"{name}.png"), dpi=120)
            except Exception as e:  # previews must never kill training
                logger.warning("preview plotting failed: %s", e)
        return generated

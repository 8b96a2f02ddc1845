"""Mode entry functions of the port's CLI (counterpart of
``sbgm_danra_tpu/cli/entries.py``).

- ``train_main(cfg, device)`` sets up the run's log file under
  ``{paths.sample_dir}/logs`` and writes the frozen config
  ``{paths.sample_dir}/config_{model_string}.yaml``, builds the loaders
  (``data/factory.py``), probes the train loader when ``training.verbose``,
  plots a first batch (``visualization.plot_initial_sample``), builds
  ``TrainingPipeline`` on ``device`` with the back-transforms (the extreme
  sentinel) and, when ``visualization.preview_every``, the gen loader (the
  previews), resumes from the latest checkpoint when
  ``training.load_checkpoint``, trains, and plots the losses
  (``visualization.plot_losses``).
- ``generation_main(cfg, device)`` loads the best checkpoint and runs each of
  ``evaluation.gen_type`` through ``evaluate/generation.py::SampleGenerator``:
  ``multiple``, ``single`` and ``repeated`` on the gen loader with one score
  function, ``full_domain`` on a loader of whole-domain test samples with the
  score function built for the domain (``TrainingPipeline.score_fn(image_hw=
  highres.full_domain_dims)``).
- ``evaluation_main(cfg)`` computes ``evaluation.eval_stat_methods`` on the
  artifacts of each gen type (numpy on the host).

``device`` is the card unless the caller asks for the CPU; a CUDA device on a
machine without one raises.

Meshes (``_maybe_mesh``, JAX's ``sbgm_danra_tpu/cli/entries.py:60-77``): the
process group is joined from the launcher's variables
(``parallel/mesh.initialize_distributed``), and a mesh exists when the run
has more than one process or ``parallel.mesh_shape`` is set. A batch that
does not divide, or a shape that needs other ranks than the run has, logs a
warning and runs on one device, as JAX does, in a one-process run; a
multi-process run raises instead (each rank would train alone). Training
takes the mesh (``TrainingPipeline(mesh=...)``, rank 0 writing the files);
generation passes it to ``SampleGenerator`` (member-sharded ensembles).
Launch several ranks with ``python -m torch.distributed.run --nproc_per_node
N -m sbgm_danra_tpu_torch.cli.main_app --mode train|generate ...``.

A figure needs matplotlib and the frozen config PyYAML, both imported only
when used: where one is missing (the card machine has no matplotlib) that
file is skipped with a log line.
"""

from __future__ import annotations

import copy
import logging
import os
import time
from typing import Dict

from sbgm_danra_tpu_torch.config import get_model_string
from sbgm_danra_tpu_torch.data.device_data import require_device
from sbgm_danra_tpu_torch.data.factory import make_dataset, make_gen_loader, make_loaders
from sbgm_danra_tpu_torch.data.loader import DataLoader
from sbgm_danra_tpu_torch.evaluate.evaluation import Evaluation
from sbgm_danra_tpu_torch.evaluate.generation import SampleGenerator
from sbgm_danra_tpu_torch.parallel.mesh import initialize_distributed, mesh_from_config, rank_device
from sbgm_danra_tpu_torch.training.pipeline import TrainingPipeline
from sbgm_danra_tpu_torch.transforms import back_transforms_for_config
from sbgm_danra_tpu_torch.utils.logging_utils import setup_logger
from sbgm_danra_tpu_torch.utils.plotting import plot_batch_grid, plot_losses, plot_or_skip

logger = logging.getLogger(__name__)

GEN_MODES = {"multiple": "generate_multiple", "single": "generate_single",
             "repeated": "generate_repeated"}


def _gen_types(cfg):
    gen_types = cfg.evaluation.gen_type
    return (gen_types,) if isinstance(gen_types, str) else tuple(gen_types)


def _maybe_mesh(cfg, device):
    """The run's mesh, or None for one device (see the module's notes)."""
    n = initialize_distributed(device=device)
    if cfg.parallel.mesh_shape is None and n <= 1:
        return None
    if cfg.training.batch_size % n != 0:
        if n > 1:
            raise ValueError(f"batch_size {cfg.training.batch_size} does not split over "
                             f"{n} processes")
        logger.warning(
            "batch_size %d not divisible by %d devices; running single-device "
            "(set parallel.mesh_shape or a divisible batch for DP)",
            cfg.training.batch_size, n)
        return None
    try:
        return mesh_from_config(cfg, rank_device(device))
    except ValueError as e:
        if n > 1:
            raise
        logger.warning("Mesh construction failed (%s); running single-device.", e)
        return None


def train_main(cfg, device="cuda") -> TrainingPipeline:
    device = require_device(device)
    mesh = _maybe_mesh(cfg, device)
    if mesh is not None:
        device = mesh.device
    main = mesh is None or mesh.rank == 0
    if main:  # the run's files are rank 0's
        setup_logger(log_dir=os.path.join(cfg.paths.sample_dir, "logs"))
        cfg.dump(os.path.join(cfg.paths.sample_dir, f"config_{get_model_string(cfg)}.yaml"))
    train_loader, valid_loader, gen_loader = make_loaders(cfg, device=device)

    if cfg.training.verbose:
        t0 = time.time()
        n_probe = 0
        for _ in zip(range(5), iter(train_loader)):
            n_probe += 1
        if n_probe:
            logger.info("loader probe: %.3f s/batch over %d batches",
                        (time.time() - t0) / n_probe, n_probe)
    vis = cfg.visualization
    if vis.plot_initial_sample and main:
        # the loader's first batch as it comes: {var}_hr, {var}_lr, lsm, topo, sdf columns
        fig_dir = os.path.join(cfg.paths.sample_dir, "figures")
        os.makedirs(fig_dir, exist_ok=True)
        path = os.path.join(fig_dir, "initial_sample_plot.png")
        if plot_or_skip("initial_sample_plot", plot_batch_grid, next(iter(train_loader)),
                        hr_var=cfg.highres.variable, path=path) is not None:
            logger.info("Saved initial sample plot to %s", path)

    pipeline = TrainingPipeline(cfg, train_loader, valid_loader, device=device,
                                back_transforms=back_transforms_for_config(cfg),
                                gen_loader=gen_loader if vis.preview_every else None,
                                mesh=mesh)
    n_params = sum(p.numel() for p in pipeline.model.parameters())
    logger.info("model %s: %s params", pipeline.model_string, f"{n_params:,}")
    if cfg.training.load_checkpoint:
        try:
            pipeline.load()
            logger.info("resumed from epoch %d", pipeline.epoch)
        except FileNotFoundError:
            logger.info("no checkpoint to resume from; training from scratch")
    pipeline.train()
    if vis.plot_losses and main:
        plot_or_skip("losses", plot_losses, pipeline.history,
                     os.path.join(cfg.paths.sample_dir, f"losses_{pipeline.model_string}.png"))
    return pipeline


def _load_pipeline_for_sampling(cfg, device):
    """The model with the best checkpoint's weights, and the gen loader.

    A deep copy of the config with ``fused_steps`` 0 (sampling never runs the
    fused steps). JAX builds the train loader here (its state is made from a
    first batch), with ``device_dataset`` the device-resident train stacks;
    the port's state needs no batch, so it builds no train or valid loader.
    """
    cfg = copy.deepcopy(cfg)
    cfg.training.fused_steps = 0
    pipeline = TrainingPipeline(cfg, [], None, device=device)
    pipeline.load(best=True)
    return pipeline, make_gen_loader(cfg)


def generation_main(cfg, device="cuda") -> Dict:
    """Each gen type of ``evaluation.gen_type`` once; returns the pipeline,
    its load seconds, each gen type's wall seconds (the mode's first call:
    on the card its warm-ups, capture and one replay) and ``SampleGenerator``
    (each keeps its graphs while it lives: call a mode again to replay)."""
    device = require_device(device)
    mesh = _maybe_mesh(cfg, device)
    if mesh is not None:
        device = mesh.device
    if mesh is None or mesh.rank == 0:
        setup_logger(log_dir=os.path.join(cfg.paths.sample_dir, "logs"))
    t0 = time.perf_counter()
    pipeline, gen_loader = _load_pipeline_for_sampling(cfg, device)
    load_s = time.perf_counter() - t0
    logger.info("checkpoint loaded in %.2f s", load_s)
    back_transforms = back_transforms_for_config(cfg)
    use_ema = cfg.training.load_ema
    generator = SampleGenerator(cfg, pipeline.score_fn(use_ema=use_ema), gen_loader,
                                back_transforms=back_transforms, device=device, mesh=mesh)
    generators, mode_s = {}, {}
    for gen_type in _gen_types(cfg):
        logger.info("generation mode: %s", gen_type)
        t0 = time.perf_counter()
        if gen_type in GEN_MODES:
            getattr(generator, GEN_MODES[gen_type])()
            generators[gen_type] = generator
        elif gen_type == "full_domain":
            # a dedicated loader: full-field conditioning, training-crop statistics
            fd_loader = DataLoader(
                make_dataset(cfg, "test", full_domain=True),
                batch_size=cfg.evaluation.n_full_domain_samples,
                shuffle=False,
                drop_last=False,
                num_workers=cfg.data_handling.num_workers,
                seed=cfg.evaluation.seed,
            )
            score = pipeline.score_fn(use_ema=use_ema,
                                      image_hw=tuple(cfg.highres.full_domain_dims))
            generators[gen_type] = SampleGenerator(cfg, score, fd_loader,
                                                   back_transforms=back_transforms, device=device,
                                                   mesh=mesh)
            generators[gen_type].generate_full_domain()
        else:
            raise ValueError(f"Unknown gen_type: {gen_type}")
        mode_s[gen_type] = time.perf_counter() - t0
        logger.info("%s: %.3f s", gen_type, mode_s[gen_type])
    return {"pipeline": pipeline, "load_s": load_s, "mode_s": mode_s, "generators": generators,
            "mesh": mesh}


def evaluation_main(cfg) -> Dict[str, Dict[str, Dict]]:
    """``evaluation.eval_stat_methods`` on each gen type's artifacts; returns
    the statistics by gen type and method."""
    setup_logger(log_dir=os.path.join(cfg.paths.sample_dir, "logs"))
    results: Dict[str, Dict[str, Dict]] = {}
    for gen_type in _gen_types(cfg):
        if gen_type == "repeated":
            n = cfg.evaluation.n_repeats
        elif gen_type == "multiple":
            n = cfg.data_handling.n_gen_samples
        else:
            n = 1
        ev = Evaluation(cfg, generated_sample_type=gen_type, n_samples=n)
        out = results[gen_type] = {}
        for method in cfg.evaluation.eval_stat_methods:
            if method == "pixel_stats":
                stats = out[method] = ev.full_pixel_statistics()
                logger.info("%s pixel stats: rmse %.4f mae %.4f", gen_type,
                            stats["rmse_per_sample"].mean(), stats["abs_error_per_sample"].mean())
            elif method == "spatial_stats":
                out[method] = ev.spatial_statistics()
            elif method == "power_spectrum":
                sp = out[method] = ev.power_spectrum_comparison()
                logger.info("%s spectrum: logMSE %.4f (ratio at finest resolved scale %.3f)",
                            gen_type, sp["log_mse"], sp["ratio"][-2])
            elif method == "crps" and gen_type == "repeated":
                scores = out[method] = ev.ensemble_crps()
                logger.info("ensemble CRPS %.4f rmse %.4f spread %.4f", scores["crps"],
                            scores["ensemble_mean_rmse"], scores["spread"])
        ev.plot_example_images(mask_ocean=cfg.evaluation.mask_ocean)
    return results

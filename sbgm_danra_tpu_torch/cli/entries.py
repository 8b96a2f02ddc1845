"""Mode entry functions of the port's CLI (counterpart of
``sbgm_danra_tpu/cli/entries.py``, cut to ``train_main``).

``train_main(cfg, device)`` builds the loaders (``data/factory.py``), probes
the train loader when ``training.verbose``, builds ``TrainingPipeline`` on
``device`` (the card unless the caller asks for the CPU; a CUDA device on a
machine without one raises), resumes from the latest checkpoint when
``training.load_checkpoint``, and trains. Plotting options are skipped with a
log line (no plotting on the card machine). Generation and evaluation wait
for ROADMAP Queue 1 (orchestration).
"""

from __future__ import annotations

import logging
import time

from sbgm_danra_tpu_torch.data.device_data import require_device
from sbgm_danra_tpu_torch.data.factory import make_loaders
from sbgm_danra_tpu_torch.training.pipeline import TrainingPipeline

logger = logging.getLogger(__name__)


def train_main(cfg, device="cuda") -> TrainingPipeline:
    device = require_device(device)
    train_loader, valid_loader, _ = make_loaders(cfg, device=device)

    if cfg.training.verbose:
        t0 = time.time()
        n_probe = 0
        for _ in zip(range(5), iter(train_loader)):
            n_probe += 1
        if n_probe:
            logger.info("loader probe: %.3f s/batch over %d batches",
                        (time.time() - t0) / n_probe, n_probe)
    vis = cfg.visualization
    for name in ("plot_initial_sample", "plot_losses", "preview_every"):
        if getattr(vis, name):
            logger.info("visualization.%s skipped: the port does not plot", name)

    pipeline = TrainingPipeline(cfg, train_loader, valid_loader, device=device)
    n_params = sum(p.numel() for p in pipeline.model.parameters())
    logger.info("model %s: %s params", pipeline.model_string, f"{n_params:,}")
    if cfg.training.load_checkpoint:
        try:
            pipeline.load()
            logger.info("resumed from epoch %d", pipeline.epoch)
        except FileNotFoundError:
            logger.info("no checkpoint to resume from; training from scratch")
    pipeline.train()
    return pipeline

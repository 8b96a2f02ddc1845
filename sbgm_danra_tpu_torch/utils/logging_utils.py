"""Run logging: timestamped file + stream handlers (a copy of
``sbgm_danra_tpu/utils/logging_utils.py``). ``generation_main`` and
``evaluation_main`` call it, as the JAX package's do.
"""

from __future__ import annotations

import logging
import os
import time
from logging.handlers import RotatingFileHandler
from typing import Optional


def setup_logger(
    name: str = "sbgm_danra_tpu_torch",
    log_dir: Optional[str] = None,
    level: int = logging.INFO,
    rotating: bool = False,
) -> logging.Logger:
    logger = logging.getLogger(name)
    logger.setLevel(level)
    if logger.handlers:
        return logger
    fmt = logging.Formatter("%(asctime)s %(levelname)s %(name)s: %(message)s")
    stream = logging.StreamHandler()
    stream.setFormatter(fmt)
    logger.addHandler(stream)
    if log_dir:
        os.makedirs(log_dir, exist_ok=True)
        stamp = time.strftime("%Y%m%d_%H%M%S")
        path = os.path.join(log_dir, f"{name.split('.')[-1]}_log_{stamp}.log")
        if rotating:
            fh: logging.Handler = RotatingFileHandler(path, maxBytes=10_000_000, backupCount=3)
        else:
            fh = logging.FileHandler(path)
        fh.setFormatter(fmt)
        logger.addHandler(fh)
    return logger

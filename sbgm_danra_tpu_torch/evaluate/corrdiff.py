"""CorrDiff generation: the regression mean plus an EDM sample of the residual.

``generate(model, cond, members, rng)`` downscales each date of ``cond``
into ``members`` fields: the regression net's mean, once a date (eagerly),
plus ``members`` residuals sampled by ``edm_sampler`` on the residual net's
score under ``sde.EDMSDE`` (CorrDiff's grid: 18 points from sigma 800 to
0.002, rho 7, no churn, no guidance: 34 evaluations), on the card as one
replay of the sampler's captured CUDA graph (``sampling/graphs.py``), on the
CPU as the eager loop. A graph is kept per model: pass the same model to
replay it. No JAX counterpart.

Spans (``utils/profiling.span``): ``corrdiff.call`` a call, holding
``corrdiff.regression`` (the mean), the sampler's ``sample.inputs`` /
``sample.replay``, ``corrdiff.sync`` (the host blocked until the card has
finished) and ``corrdiff.fetch`` (the sum's copy out).
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from sbgm_danra_tpu_torch.capture import use_graphs
from sbgm_danra_tpu_torch.models.songunet import CorrDiff
from sbgm_danra_tpu_torch.precision import exact_fp32
from sbgm_danra_tpu_torch.sampling import graphs
from sbgm_danra_tpu_torch.sampling.samplers import Rng, SamplerConfig, edm_sampler
from sbgm_danra_tpu_torch.sde import EDMSDE
from sbgm_danra_tpu_torch.utils.profiling import span

# CorrDiff's sampler (PhysicsNeMo's corrdiff generation config): EDM's Heun
# over 18 points from sigma_max (the SDE's) down to eps = sigma_min, rho 7
SAMPLER = SamplerConfig(num_steps=18, eps=0.002, edm_rho=7.0)


def generate(model: CorrDiff, cond: Dict[str, Optional[torch.Tensor]], members: int, rng: Rng,
             sde=EDMSDE(), config: SamplerConfig = SAMPLER,
             capture: Optional[bool] = None) -> np.ndarray:
    """Fields [dates x members, H, W] (float32, on the host), date-major, from
    ``cond`` (NHWC ``cond_img``, ``lsm_cond``, ``topo_cond`` of each date, on
    the model's device). The residuals' noise is drawn on ``rng`` (one
    generator, or one per row) on that device. ``capture``: None takes the
    sampler's CUDA graph on the card and the eager loop on the CPU; False the
    eager loop (``capture.use_graphs``)."""
    if config.guidance_scale is not None:
        raise ValueError("CorrDiff samples without classifier-free guidance")
    with span("corrdiff.call"):
        first = next(v for v in cond.values() if v is not None)
        device = first.device
        dates, h, w = first.shape[:3]
        shape = (dates * members, h, w, model.spec.out_channels)
        rows = {k: None if v is None else v.repeat_interleave(members, dim=0)
                for k, v in cond.items()}
        with exact_fp32(model.spec.compute_dtype), torch.inference_mode():
            with span("corrdiff.regression"):
                mean = model.mean(**cond)
            residual = graphs.call(edm_sampler, model, rng, shape, sde, config, cond=rows,
                                   graph=use_graphs(capture, device))
            out = mean.repeat_interleave(members, dim=0) + residual
        with span("corrdiff.sync"):
            if device.type == "cuda":
                torch.cuda.current_stream(device).synchronize()
        with span("corrdiff.fetch"):
            return out[..., 0].cpu().numpy()

"""Auxiliary losses (counterpart of ``sbgm_danra_tpu/losses.py``).

A plain MSE, a trajectory MSE over T stacked predictions, and an SDF-weighted
MSE whose weighting rule is the one ``sde.dsm_loss`` uses. The DSM path does
not call them; they are kept for parity with the JAX package.
"""

from __future__ import annotations

import torch

from sbgm_danra_tpu_torch.sde import sdf_weights


def simple_loss(predicted: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Mean squared error."""
    return torch.mean((predicted - target) ** 2)


def hybrid_loss(predictions: torch.Tensor, targets: torch.Tensor,
                alpha: float = 0.5) -> torch.Tensor:
    """Trajectory MSE over stacked (T, ...) trajectories: the last prediction
    against the first target, and each earlier prediction t - 1 against
    target t weighted by ``alpha``, as the JAX function orders them."""
    loss = simple_loss(predictions[-1], targets[0])
    for t in range(1, predictions.shape[0]):
        loss = loss + alpha * simple_loss(predictions[t - 1], targets[t])
    return loss


def sdf_weighted_mse(predicted: torch.Tensor, target: torch.Tensor, sdf: torch.Tensor,
                     max_land_weight: float = 1.0, min_sea_weight: float = 0.5) -> torch.Tensor:
    """Mean of w (predicted - target)^2 with w = ``sde.sdf_weights``."""
    w = sdf_weights(sdf, predicted, max_land_weight, min_sea_weight)
    return torch.mean(w * (predicted - target) ** 2)

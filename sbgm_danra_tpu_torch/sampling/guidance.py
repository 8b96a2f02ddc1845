"""Classifier-free guidance (counterpart of ``sbgm_danra_tpu/sampling/guidance.py:31-79``).

The null protocol: the LR conditioning image becomes zeros; a geo map
(value||mask, 2 channels) keeps its value channel and zeroes only its mask
channel; the class label becomes the null token 0. The conditional and null
branches run as one forward over a doubled batch.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

NULL_TOKEN = 0


def strip_mask_channel(geo: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    """Zero the mask channel (last of 2, NHWC) leaving the value channel intact."""
    if geo is None or geo.shape[-1] != 2:
        return geo
    out = geo.clone()
    out[..., 1] = 0.0
    return out


def null_conditioning(cond: Dict[str, Optional[torch.Tensor]]) -> Dict[str, Optional[torch.Tensor]]:
    """Build the unconditional branch's inputs from conditional ones."""
    out = dict(cond)
    if out.get("cond_img") is not None:
        out["cond_img"] = torch.zeros_like(out["cond_img"])
    out["lsm_cond"] = strip_mask_channel(out.get("lsm_cond"))
    out["topo_cond"] = strip_mask_channel(out.get("topo_cond"))
    if out.get("y") is not None:
        out["y"] = torch.full_like(out["y"], NULL_TOKEN)
    return out


def apply_guidance(
    score_fn: Callable[..., torch.Tensor],
    scale: Optional[float],
    max_scale: Optional[float] = None,
) -> Callable[..., torch.Tensor]:
    """guided = (1 + w) s_cond - w s_uncond; ``scale=None`` returns ``score_fn``."""
    if scale is None:
        return score_fn
    w = float(scale)
    if max_scale is not None:
        w = min(w, float(max_scale))

    def guided(x: torch.Tensor, t: torch.Tensor, **cond) -> torch.Tensor:
        ncond = null_conditioning(cond)
        merged = {
            key: None if cond[key] is None else torch.cat([cond[key], ncond[key]], dim=0)
            for key in cond
        }
        scores = score_fn(torch.cat([x, x], dim=0), torch.cat([t, t], dim=0), **merged)
        s_cond, s_uncond = scores.chunk(2, dim=0)
        return (1.0 + w) * s_cond - w * s_uncond

    return guided

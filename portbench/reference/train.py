"""Plain reference of the flagship's training step, from the resident days to
the updated state.

- The batch: for each row a day, a 128x128 crop inside the cutout window and
  a keep flag (CFG dropout), all given. x is the crop's HR channel; the LR
  channels are multiplied by keep; the land-sea mask (> 0.5) and the
  topography each carry keep as their second channel; the class is the
  day's times keep; the signed-distance field is 10 * land - EDT(sea), the
  exact Euclidean distance of each sea pixel to the nearest land pixel,
  min-max normalised to [0, 1] per crop (zeros for a constant field).
- The DSM loss (Song et al. 2021) with SDF weights: x_t = x + std(t) z, the
  mean over rows of the sum over pixels of w (score * std(t) + z)^2, w =
  sigmoid(sdf) (1 - 0.5) + 0.5; the UNet in training mode (BatchNorm on the
  batch's statistics).
- Adam (Kingma and Ba 2015) with the L2 term added to the gradient first:
  g = grad + wd * p, betas 0.9 and 0.999, eps 1e-8, bias-corrected; a
  parameter the loss never reads has gradient 0, so its L2 term still moves it.
- EMA e = d e + (1 - d) p after each update; BatchNorm's running statistics
  r = 0.9 r + 0.1 (batch mean, biased variance) once a step.

Everything in float32 with TF32 off (``unet.exact``). Imports nothing of the port.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence

import numpy as np
import torch

from portbench.reference.unet import UNet, identity

BETAS, ADAM_EPS, BN_MOMENTUM = (0.9, 0.999), 1e-8, 0.9


def sdf(land: np.ndarray) -> np.ndarray:
    """Normalised signed distance of one binary crop [H, W]."""
    from scipy.ndimage import distance_transform_edt

    field = 10.0 * land - distance_transform_edt(~land)
    lo, hi = field.min(), field.max()
    return np.zeros_like(field) if hi == lo else (field - lo) / (hi - lo)


def batch(fields: torch.Tensor, statics: torch.Tensor, classes: torch.Tensor,
          day, ox, oy, keep, crop: Sequence[int]) -> Dict[str, torch.Tensor]:
    """One step's batch from the resident days and its draws (each [B])."""
    ch, cw = crop
    rows = [fields[int(d), int(r): int(r) + ch, int(c): int(c) + cw] for d, r, c in
            zip(day.tolist(), ox.tolist(), oy.tolist())]
    geo = [statics[int(r): int(r) + ch, int(c): int(c) + cw] for r, c in
           zip(ox.tolist(), oy.tolist())]
    crops, geo = torch.stack(rows).float(), torch.stack(geo).float()
    keep = keep.float()[:, None, None, None].expand(-1, ch, cw, 1)
    land = (geo[..., :1] > 0.5).float()
    dist = np.stack([sdf(m) for m in (land[..., 0].cpu().numpy() > 0)])
    return {
        "x": crops[..., :1],
        "cond_img": crops[..., 1:] * keep,
        "lsm_cond": torch.cat([land, keep], dim=-1),
        "topo_cond": torch.cat([geo[..., 1:], keep], dim=-1),
        "y": classes[day.long()].long() * keep[:, 0, 0, 0].long(),
        "sdf": torch.from_numpy(dist).float().to(fields.device)[..., None],
    }


def dsm_loss(net: UNet, b: Dict[str, torch.Tensor], t: torch.Tensor, z: torch.Tensor,
             sigma: float) -> torch.Tensor:
    t = t.float()
    std = torch.sqrt((sigma ** (2.0 * t.double()) - 1.0) / (2.0 * math.log(sigma)))
    std = std.clamp(min=1e-5).float().reshape(-1, 1, 1, 1)
    x_t = b["x"] + std * z
    score = net(x_t, t, y=b["y"], cond_img=b["cond_img"], lsm_cond=b["lsm_cond"],
                topo_cond=b["topo_cond"])
    w = torch.sigmoid(b["sdf"]) * 0.5 + 0.5
    return (w * (score * std + z) ** 2).sum(dim=(1, 2, 3)).mean()


class Trainer:
    """The reference's train state: parameters, Adam's moments, the EMA copy and
    BatchNorm's running statistics, by the port's state_dict names."""

    def __init__(self, weights: Dict[str, torch.Tensor], cfg: dict, quant=identity):
        self.cfg, self.quant = cfg, quant
        tr = cfg["training"]
        self.lr, self.wd, self.decay = tr["learning_rate"], tr["weight_decay"], tr["ema_decay"]
        self.buffers = {k: v.detach().float().clone() for k, v in weights.items()
                        if k.endswith((".running_mean", ".running_var", ".W"))}
        self.params = {k: v.detach().float().clone() for k, v in weights.items()
                       if k not in self.buffers}
        self.m = {k: torch.zeros_like(v) for k, v in self.params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in self.params.items()}
        self.ema = {k: v.clone() for k, v in self.params.items()}
        self.steps = 0
        self.grads: List[Dict[str, torch.Tensor]] = []  # the optimizer's g of each step

    def step(self, b: Dict[str, torch.Tensor], t: torch.Tensor, z: torch.Tensor) -> float:
        leaves = {k: v.clone().requires_grad_(True) for k, v in self.params.items()}
        net = UNet({**leaves, **self.buffers}, self.cfg, self.quant, train=True)
        loss = dsm_loss(net, b, t, z, self.cfg["sde"]["sigma"])
        grads = torch.autograd.grad(loss, list(leaves.values()), allow_unused=True)
        self.steps += 1
        b1, b2 = BETAS
        g_all = {}
        for (k, p), g in zip(self.params.items(), grads):
            g = (torch.zeros_like(p) if g is None else g) + self.wd * p
            g_all[k] = g
            self.m[k] = b1 * self.m[k] + (1 - b1) * g
            self.v[k] = b2 * self.v[k] + (1 - b2) * g * g
            m_hat = self.m[k] / (1 - b1 ** self.steps)
            v_hat = self.v[k] / (1 - b2 ** self.steps)
            self.params[k] = p - self.lr * m_hat / (v_hat.sqrt() + ADAM_EPS)
            self.ema[k] = self.decay * self.ema[k] + (1 - self.decay) * self.params[k]
        for name, (mean, var) in net.batch_stats.items():
            for key, stat in (("running_mean", mean), ("running_var", var)):
                r = self.buffers[f"{name}.{key}"]
                self.buffers[f"{name}.{key}"] = BN_MOMENTUM * r + (1 - BN_MOMENTUM) * stat
        self.grads.append(g_all)
        return float(loss.detach())

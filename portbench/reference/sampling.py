"""Plain reference of the samplers the cells time, with classifier-free
guidance and the full-domain padding.

- VE SDE (sigma 25): std(t) = sqrt((sigma^(2t) - 1) / (2 ln sigma)), mean
  coefficient 1, so the hat coordinates of the samplers are x itself.
- The Karras rho-grid of stds from std(1) down to std(eps) (Karras et al.
  2022, eq. 5), t at each node by the exact inverse of std(t).
- EDM: Heun's method on dx/dsigma = -sigma * score over the grid, no churn;
  2 (n - 1) score evaluations.
- DPM-Solver++(2M) (Lu et al. 2022) on the same grid: first order on the
  first interval, then second order; n - 1 evaluations.
- CFG: guided = (1 + w) s(cond) - w s(null), the null conditioning being a
  zero LR image, the geo maps' mask channel zeroed and the class 0.
- Full domain: the conditioning padded to the next multiple of 32 (values
  edge-replicated, mask channels zero), sampled whole, cropped back.

Schedules are worked out in float64; the state is float32. Imports nothing
of the port.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

Cond = Dict[str, Optional[torch.Tensor]]


def std_of_t(t: float, sigma: float) -> float:
    return max(math.sqrt((sigma ** (2.0 * t) - 1.0) / (2.0 * math.log(sigma))), 1e-5)


def t_of_std(std: float, sigma: float) -> float:
    return math.log1p(2.0 * math.log(sigma) * std * std) / (2.0 * math.log(sigma))


def karras_grid(n: int, smin: float, smax: float, rho: float) -> np.ndarray:
    i = np.linspace(0.0, 1.0, n)
    return (smax ** (1 / rho) + i * (smin ** (1 / rho) - smax ** (1 / rho))) ** rho


def grid(sampler: dict, sigma: float) -> Tuple[np.ndarray, np.ndarray]:
    """(stds, times) of the sampler's nodes, from the prior down to t = eps."""
    stds = karras_grid(sampler["num_steps"], std_of_t(sampler["eps"], sigma),
                       std_of_t(1.0, sigma), sampler.get("edm_rho", 7.0))
    return stds, np.array([t_of_std(s, sigma) for s in stds])


def null_conditioning(cond: Cond) -> Cond:
    out = dict(cond)
    if out.get("cond_img") is not None:
        out["cond_img"] = torch.zeros_like(out["cond_img"])
    for key in ("lsm_cond", "topo_cond"):
        v = out.get(key)
        if v is not None and v.shape[-1] == 2:
            out[key] = torch.cat([v[..., :1], torch.zeros_like(v[..., 1:])], dim=-1)
    if out.get("y") is not None:
        out["y"] = torch.zeros_like(out["y"])
    return out


def guided(score: Callable, w: Optional[float]) -> Callable:
    if w is None:
        return score

    def fn(x, t, **cond):
        null = null_conditioning(cond)
        both = {k: None if v is None else torch.cat([v, null[k]]) for k, v in cond.items()}
        s_cond, s_null = score(torch.cat([x, x]), torch.cat([t, t]), **both).chunk(2)
        return (1.0 + w) * s_cond - w * s_null

    return fn


def edm(score: Callable, z: torch.Tensor, cond: Cond, sampler: dict, sigma: float) -> torch.Tensor:
    """Heun over the grid from x = z * std(1); ``z`` the latent N(0, 1) draw."""
    s = guided(score, sampler.get("guidance_scale"))
    stds, ts = grid(sampler, sigma)
    b = z.shape[0]
    x = z.float() * float(stds[0])

    def drift(x, i):
        t = torch.full((b,), float(ts[i]), device=x.device)
        return -float(stds[i]) * s(x, t, **cond)

    for i in range(len(stds) - 1):
        ds = float(stds[i + 1] - stds[i])
        k1 = drift(x, i)
        k2 = drift(x + ds * k1, i + 1)
        x = x + 0.5 * ds * (k1 + k2)
    return x


def dpmpp(score: Callable, z: torch.Tensor, cond: Cond, sampler: dict,
          sigma: float) -> torch.Tensor:
    """DPM-Solver++(2M) over the grid from x = z * std(1)."""
    s = guided(score, sampler.get("guidance_scale"))
    stds, ts = grid(sampler, sigma)
    lam = -np.log(stds)
    h = np.maximum(lam[1:] - lam[:-1], 1e-12)
    b = z.shape[0]
    x = z.float() * float(stds[0])

    def denoise(x, i):
        t = torch.full((b,), float(ts[i]), device=x.device)
        return x + float(stds[i]) ** 2 * s(x, t, **cond)

    d_prev = None
    for i in range(len(stds) - 1):
        d = denoise(x, i)
        if d_prev is None:
            d_bar = d
        else:
            r = h[i - 1] / h[i]
            d_bar = (1.0 + 1.0 / (2.0 * r)) * d - (1.0 / (2.0 * r)) * d_prev
        ratio = float(stds[i + 1] / stds[i])
        x = ratio * x + (1.0 - ratio) * d_bar
        d_prev = d
    return x


SAMPLERS = {"edm_sampler": edm, "dpmpp_sampler": dpmpp}


def padded_hw(h: int, w: int, multiple: int = 32) -> Tuple[int, int]:
    return -(-h // multiple) * multiple, -(-w // multiple) * multiple


def pad_conditioning(cond: Cond, hw: Tuple[int, int]) -> Cond:
    """NHWC fields padded at the bottom and right to ``hw``: values by edge
    replication, the geo maps' mask channel (the last of 2) with zeros."""
    out = {}
    for key, v in cond.items():
        if v is None or v.dim() < 4:
            out[key] = v
            continue
        ph, pw = hw[0] - v.shape[1], hw[1] - v.shape[2]
        nchw = v.permute(0, 3, 1, 2)
        padded = F.pad(nchw, (0, pw, 0, ph), mode="replicate")
        if key in ("lsm_cond", "topo_cond") and v.shape[-1] == 2:
            mask = F.pad(nchw[:, 1:], (0, pw, 0, ph))
            padded = torch.cat([padded[:, :1], mask], dim=1)
        out[key] = padded.permute(0, 2, 3, 1)
    return out


def member_seed(seed: int, member: int) -> int:
    """The serving API's seed of member ``member`` of a request with ``seed``:
    numpy's SeedSequence([seed, member]), first 64-bit word."""
    return int(np.random.SeedSequence([seed, member]).generate_state(1, np.uint64)[0])

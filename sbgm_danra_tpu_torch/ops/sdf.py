"""Signed-distance fields from land-sea masks (counterpart of ``sbgm_danra_tpu/ops/sdf.py``).

With land = mask > 0, sdf = 10 * land - EDT(sea), where EDT(sea) is each sea
pixel's Euclidean distance to the nearest land pixel (0 on land), then min-max
normalised to [0, 1] per mask.

- ``generate_sdf`` / ``normalize_sdf`` / ``sdf_from_mask``: host numpy with
  scipy's EDT, as the dataset's worker threads compute it (copied);
- ``generate_sdf_device``: the jump flood of the JAX module on a batch of
  masks ``[B, H, W]`` in one call, on the masks' device.

The jump flood keeps the JAX module's arithmetic so that the two agree to
rounding and not only to the EDT: float32 coordinates, the round schedule
``[1] + [top, top/2, ..., 1] + [2, 1]`` with ``top`` the power of two at or
above max(H, W) (11 rounds of 8 neighbours at 128x128), the neighbours of a
round taken one after another in JAX's order, each taken where it is strictly
nearer (ties keep the earlier seed). Where JAX rolls the field and marks the
rows and columns that wrapped around, the port pads the field once with the
sentinel ``BIG`` and reads each neighbour as a shifted view of the padded
buffer: a neighbour off the field is never nearer in either form. A neighbour
whose shift reaches past the whole field (the round of step ``top`` at
128x128) can never be nearer, so it is not computed. Each taken neighbour is
six launches (difference, square, sum, compare, two selects), written into
the second of two padded buffers in turn.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

BIG = 1e9  # unreached / off-field sentinel coordinate, as in JAX


def generate_sdf(mask: np.ndarray) -> np.ndarray:
    """sdf = 10 * land - EDT(sea) on the host."""
    from scipy.ndimage import distance_transform_edt

    binary = np.asarray(mask) > 0
    dist_sea = distance_transform_edt(~binary)
    return 10.0 * binary.astype(np.float32) - dist_sea.astype(np.float32)


def normalize_sdf(sdf: np.ndarray) -> np.ndarray:
    """Per-sample min-max to [0, 1]."""
    mn, mx = sdf.min(), sdf.max()
    if mx == mn:
        return np.zeros_like(sdf)
    return (sdf - mn) / (mx - mn)


def sdf_from_mask(mask: np.ndarray) -> np.ndarray:
    """Full pipeline: EDT SDF + normalization."""
    return normalize_sdf(generate_sdf(mask))


def jump_flood_steps(h: int, w: int) -> List[int]:
    """JAX's round schedule for an H x W field."""
    top = 1 << max(int(np.ceil(np.log2(max(h, w)))), 0)
    return [1] + [s for s in (top >> i for i in range(top.bit_length())) if s >= 1] + [2, 1]


def jump_flood_neighbours(h: int, w: int) -> List[Tuple[int, int]]:
    """The (dr, dc) shifts the flood computes, in JAX's order, less those that
    reach past the field (never nearer)."""
    return [(dr, dc) for step in jump_flood_steps(h, w)
            for dr in (-step, 0, step) for dc in (-step, 0, step)
            if (dr or dc) and abs(dr) < h and abs(dc) < w]


def jump_flood_nearest_land(land: torch.Tensor) -> torch.Tensor:
    """Squared distance from every pixel to its nearest land pixel (0 on land,
    ``BIG`` where a mask holds no land), by jump flooding: ``land`` is a bool
    ``[B, H, W]``; the result is float32 ``[B, H, W]``."""
    b, h, w = land.shape
    shifts = jump_flood_neighbours(h, w)
    pr = max((abs(dr) for dr, _ in shifts), default=0)
    pc = max((abs(dc) for _, dc in shifts), default=0)
    dev = land.device
    f32 = torch.float32
    coords = torch.stack(torch.meshgrid(torch.arange(h, dtype=f32, device=dev),
                                        torch.arange(w, dtype=f32, device=dev), indexing="ij"))
    # two padded buffers of the best-known nearest land (row, col) per pixel;
    # the border stays BIG, the interior is the field
    pads = [torch.full((b, 2, h + 2 * pr, w + 2 * pc), BIG, dtype=f32, device=dev)
            for _ in range(2)]

    def interior(pad):
        return pad[:, :, pr:pr + h, pc:pc + w]

    interior(pads[0]).copy_(torch.where(land[:, None], coords, BIG))
    dist = torch.where(land, 0.0, BIG).to(f32)  # squared distance of the best seed
    spare = torch.empty_like(dist)
    for dr, dc in shifts:
        src, dst = pads
        cand = src[:, :, pr - dr:pr - dr + h, pc - dc:pc - dc + w]  # best[i - dr, j - dc]
        cand_dist = (cand - coords).square_().sum(1)
        better = cand_dist < dist
        torch.where(better[:, None], cand, interior(src), out=interior(dst))
        torch.where(better, cand_dist, dist, out=spare)
        pads.reverse()
        dist, spare = spare, dist
    return torch.where(land, 0.0, dist)


def generate_sdf_device(mask: torch.Tensor) -> torch.Tensor:
    """sdf = 10 * land - sqrt(d2(sea)), min-max normalised per mask, for a
    batch ``[B, H, W]`` of masks on their device (zeros where a mask is all
    land or all sea)."""
    land = mask > 0
    d2 = jump_flood_nearest_land(land)
    sdf = 10.0 * land.to(torch.float32) - torch.sqrt(d2)
    mn = sdf.amin(dim=(1, 2), keepdim=True)
    mx = sdf.amax(dim=(1, 2), keepdim=True)
    return torch.where(mx > mn, (sdf - mn) / (mx - mn), torch.zeros_like(sdf))

"""Everything a run feeds the program, made by the benchmark from ``--seed``:
the UNet's weights, the conditioning of each date, per-call seeds and the
serving traffic. The same seed gives the same inputs; both the program and
the reference take them from here.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch
import torch.nn.functional as F

from portbench.reference.unet import param_shapes


def sub_seed(seed: int, *path: int) -> int:
    """A 63-bit seed for the item at ``path`` of the run with ``seed``."""
    seed %= 1 << 64
    words = [seed & 0xFFFFFFFF, seed >> 32, *path]
    return int(np.random.SeedSequence(words).generate_state(1, np.uint64)[0] >> 1)


def _leaf_law(name: str, shape) -> tuple:
    """(mean, std) of a leaf's normal draw, clipped at two stds. Kernels:
    lecun-normal (1 / fan-in); the label embedding N(0, 1); the Fourier
    frequencies N(0, 30^2); biases, norm shifts and running means small and
    nonzero; norm scales and running variances near 1."""
    if name.endswith(".W"):
        return 0.0, 30.0
    if name.endswith("label_emb.weight"):
        return 0.0, 1.0
    if name.endswith(".weight") and len(shape) >= 2:
        fan_in = int(np.prod(shape[1:]))
        return 0.0, (1.0 / fan_in) ** 0.5 / 0.8796256610342398
    if name.endswith((".weight", ".running_var")):
        return 1.0, 0.05
    return 0.0, 0.05  # biases, norm shifts, running means


def make_weights(cfg: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """Every parameter and buffer of the UNet by its state_dict name, float32
    on ``device``: one normal draw for all of them on a generator there,
    scaled leaf by leaf through two vectors, in a few large calls. The CFG
    null token (row 0 of the label embedding) is zero."""
    shapes = param_shapes(cfg)
    names = list(shapes)
    sizes = [int(np.prod(shapes[n])) for n in names]
    laws = np.array([_leaf_law(n, shapes[n]) for n in names], np.float32)
    gen = torch.Generator(device).manual_seed(sub_seed(seed, 0))
    flat = torch.randn(sum(sizes), generator=gen, device=device).clamp_(-2.0, 2.0)
    counts = torch.tensor(sizes, device=device)
    law = torch.from_numpy(laws).to(device)
    flat.mul_(law[:, 1].repeat_interleave(counts)).add_(law[:, 0].repeat_interleave(counts))
    out = dict(zip(names, (t.view(shapes[n]) for n, t in zip(names, flat.split(sizes)))))
    out["encoder.label_emb.weight"][0].zero_()
    return out


def _smooth(gen: torch.Generator, n: int, c: int, h: int, w: int, device,
            cell: int = 16) -> torch.Tensor:
    """[n, h, w, c] fields with unit variance correlated over ``cell`` pixels:
    coarse normal noise upsampled bicubically."""
    coarse = torch.randn(n, c, -(-h // cell) + 3, -(-w // cell) + 3, generator=gen,
                         device=device)
    fine = F.interpolate(coarse, scale_factor=cell, mode="bicubic", align_corners=False)
    fine = fine[:, :, cell: cell + h, cell: cell + w]
    fine = fine / fine.std(dim=(2, 3), keepdim=True).clamp(min=1e-6)
    return fine.permute(0, 2, 3, 1).contiguous()


def make_conditions(seed: int, n: int, h: int, w: int, n_lr: int, num_classes: int,
                    device, stream: int = 1) -> Dict[str, torch.Tensor]:
    """``n`` dates of conditioning at (h, w): LR fields (``n_lr`` smooth
    normalised channels), the land-sea mask and the topography as value and
    in-domain mask channels, and the season class in 1..num_classes."""
    gen = torch.Generator(device).manual_seed(sub_seed(seed, stream))
    lr = _smooth(gen, n, n_lr, h, w, device, cell=32)
    geo = _smooth(gen, n, 2, h, w, device, cell=16)
    ones = torch.ones(n, h, w, 1, device=device)
    lsm = torch.cat([(geo[..., :1] > 0).float(), ones], dim=-1)
    topo = torch.cat([torch.relu(geo[..., 1:]), ones], dim=-1)
    y = torch.randint(1, num_classes + 1, (n,), generator=gen, device=device)
    return {"y": y, "cond_img": lr, "lsm_cond": lsm, "topo_cond": topo}


def take(cond: Dict[str, torch.Tensor], rows) -> Dict[str, torch.Tensor]:
    return {k: v[rows] for k, v in cond.items()}


def open_loop(n: int, rate: float, sizes: List[int], schedule_seed: int,
              seed: int) -> tuple:
    """The due times (seconds from the window's start) and sizes of ``n``
    requests at ``rate`` per second. One schedule for every run: the
    exponential gaps' n quantiles and the sizes in equal shares, each in the
    order of ``schedule_seed``. A run's ``seed`` rotates both together, so
    that every seed sends the same requests with the same bursts, from
    another point of the cycle."""
    q = (np.arange(n) + 0.5) / n
    order = np.random.default_rng(sub_seed(schedule_seed, 2))
    gaps = (-np.log1p(-q) / rate)[order.permutation(n)]
    sizes = order.permutation(np.resize(np.asarray(sizes), n))
    shift = int(np.random.default_rng(sub_seed(seed, 2)).integers(n))
    gaps, sizes = np.roll(gaps, shift), np.roll(sizes, shift)
    return np.concatenate([[0.0], np.cumsum(gaps)[:-1]]), sizes


def make_days(seed: int, n: int, h: int, w: int, n_lr: int, num_classes: int, device,
              chunk: int = 32) -> tuple:
    """``n`` days on the full grid as the trainer keeps them resident:
    fields [n, h, w, 1 + n_lr] (the normalised HR target, then the LR
    channels), the static maps [h, w, 2] (a binary land-sea mask and a
    topography) and each day's class in 1..num_classes (int32), made
    ``chunk`` days at a time on a generator on ``device``."""
    gen = torch.Generator(device).manual_seed(sub_seed(seed, 11))
    fields = torch.empty(n, h, w, 1 + n_lr, device=device)
    for d in range(0, n, chunk):
        k = min(chunk, n - d)
        fields[d: d + k, ..., :1] = _smooth(gen, k, 1, h, w, device, cell=8)
        fields[d: d + k, ..., 1:] = _smooth(gen, k, n_lr, h, w, device, cell=32)
    geo = _smooth(gen, 1, 2, h, w, device, cell=24)[0]
    statics = torch.stack([(geo[..., 0] > 0).float(), torch.relu(geo[..., 1])], dim=-1)
    classes = torch.randint(1, num_classes + 1, (n,), generator=gen, device=device,
                            dtype=torch.int32)
    return fields, statics, classes

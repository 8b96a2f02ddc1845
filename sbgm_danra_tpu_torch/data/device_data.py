"""Card-resident dataset: the whole split lives on the card and each batch is
put together there (counterpart of ``sbgm_danra_tpu/data/device_data.py``).

The host loader's per-sample zarr read, numpy transform, collate and copy
become one gather from resident stacks, the jump-flood SDF and CFG dropout,
all on the card. Semantics as ``DanraDataset.__getitem__``:

- the per-variable transforms are elementwise with global statistics, so they
  commute with cropping: fields are unit-corrected and transformed once, over
  the full domain, at load time (``load_days``, the dataset's own loader);
- crops are rows-first uniform draws inside ``cutout_domains`` [x1, x2, y1, y2];
- the SDF is the jump flood of ``ops/sdf.py`` (the host EDT to 1e-4);
- CFG dropout zeroes the LR conditions, the geo mask channels and the class
  with probability p.

``make_sample_fn`` returns the batch function of explicit draws ``(day, ox,
oy, keep)`` and the stacks: one gather of the day stack (HR and LR fields in
one ``[D, H, W, 1 + C]`` tensor) and one of the static maps (lsm and topo as
``[H, W, 2]``) for every crop of the batch. ``draw`` makes the draws from a
``torch.Generator`` on the stacks' device; tests hand JAX's draws to the
batch function instead (the two packages' random streams never agree).
``DeviceDataLoader`` draws each step's batch from a generator seeded by
(seed, epoch, step), so an epoch repeats; ``iter_chunks(k)`` hands out the
same steps' draws K at a time, stacked, with the stacks, for the fused train
step (``training/fused.py``), which draws each batch inside its graph.

Restrictions (checked at build, as JAX checks them): resize_factor 1, the LR
conditions on the HR grid with the HR crop window, and lsm + topo present.
The host loader remains the general path. Asked for a CUDA device on a
machine without one, the stacks are not built on the CPU instead: it raises.
"""

from __future__ import annotations

import dataclasses
import logging
import time
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from sbgm_danra_tpu_torch.data.dataset import DanraDataset
from sbgm_danra_tpu_torch.ops.sdf import generate_sdf_device
from sbgm_danra_tpu_torch.utils.dates import classifier_from_date

logger = logging.getLogger(__name__)


def require_device(device) -> torch.device:
    """``device`` as a ``torch.device``; a CUDA device on a machine without
    one raises rather than falling back to the CPU."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} requested, but torch.cuda.is_available() is False")
    return device


@dataclasses.dataclass
class DeviceStacks:
    """All days of a split on one device (transformed, ready to crop)."""

    fields: torch.Tensor  # [D, H, W, 1 + C]: the HR target, then the LR conditions
    lr_names: Tuple[str, ...]  # the LR channels' variables, sorted by name
    statics: torch.Tensor  # [H, W, 2]: binary land-sea mask, scaled topography
    classifier: torch.Tensor  # [D] int32 class indices (0 reserved for CFG null)
    dates: Tuple[str, ...]
    load_s: float = 0.0  # host seconds to read and transform the split
    upload_s: float = 0.0  # seconds to copy it to the device

    @property
    def n_days(self) -> int:
        return self.fields.shape[0]

    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size() for t in (self.fields, self.statics))


def check_device_compatible(dataset: DanraDataset) -> Tuple[int, int]:
    """Validate the card-resident restrictions; returns the full domain HW."""
    if dataset.resize_factor != 1:
        raise ValueError("device dataset requires resize_factor == 1")
    if dataset.lr_data_size is not None and dataset.lr_cutout_domains is not None:
        raise ValueError(
            "device dataset requires LR conditions on the HR grid with a "
            "shared crop window (the production DANRA configuration)"
        )
    if dataset.lsm_full_domain is None or dataset.topo_full_domain is None:
        raise ValueError("device dataset requires lsm+topo geography")

    full_hw = tuple(dataset.lsm_full_domain.shape)
    if not dataset.cutouts and tuple(dataset.hr_data_size) != full_hw:
        # the host path resizes the whole domain to data_size when cutouts are
        # off; the card sampler only crops, which would train on other data
        raise ValueError(
            "device dataset requires sample_w_cutouts=true unless data_size "
            f"equals the full domain {full_hw}; use the host loader for "
            "whole-domain-resize sampling"
        )
    return full_hw


def load_days(
    dataset: DanraDataset, dates: Sequence[str]
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Host-load the given dates full-domain, transformed: (hr, lr, classes),
    through the dataset's own store, date and transform machinery."""
    full_hw = tuple(dataset.lsm_full_domain.shape)
    d = len(dates)
    hr_np = np.empty((d, *full_hw), np.float32)
    lr_names = tuple(sorted(c.name for c in dataset.lr_conditions))
    by_name = {c.name: c for c in dataset.lr_conditions}
    lr_np = np.empty((d, *full_hw, len(lr_names)), np.float32)
    for i, date in enumerate(dates):
        hr_np[i] = dataset._load_field(
            dataset.hr, dataset._hr_group, dataset._hr_map[date], None, full_hw
        )
        for ci, name in enumerate(lr_names):
            lr_np[i, ..., ci] = dataset._load_field(
                by_name[name], dataset._lr_groups[name], dataset._lr_maps[name][date], None,
                full_hw,
            )
    if dataset.conditional_seasons:
        classes = np.asarray(
            [classifier_from_date(date, dataset.n_classes) for date in dates], np.int32
        )
    else:
        classes = np.zeros((d,), np.int32)
    return hr_np, lr_np, classes


def load_static_geo(dataset: DanraDataset) -> Tuple[np.ndarray, np.ndarray]:
    """Binary lsm + scaled topo over the full domain (host arrays)."""
    lsm = (np.asarray(dataset.lsm_full_domain, np.float32) > 0.5).astype(np.float32)
    topo = np.asarray(dataset.topo_full_domain, np.float32)
    if dataset._topo_scale is not None:
        topo = np.asarray(dataset._topo_scale(topo), np.float32)
    return lsm, topo


def build_device_stacks(dataset: DanraDataset, device="cuda",
                        dtype: torch.dtype = torch.float32) -> DeviceStacks:
    """Load every common date of ``dataset`` full-domain, transform, upload."""
    device = require_device(device)
    full_hw = check_device_compatible(dataset)
    dates = tuple(dataset.common_dates)
    t0 = time.perf_counter()
    hr_np, lr_np, classes = load_days(dataset, dates)
    lr_names = tuple(sorted(c.name for c in dataset.lr_conditions))
    lsm, topo = load_static_geo(dataset)
    fields = np.concatenate([hr_np[..., None], lr_np], axis=-1)
    t1 = time.perf_counter()
    stacks = DeviceStacks(
        fields=torch.from_numpy(fields).to(device, dtype),
        lr_names=lr_names,
        statics=torch.from_numpy(np.stack([lsm, topo], axis=-1)).to(device, dtype),
        classifier=torch.from_numpy(classes).to(device),
        dates=dates,
    )
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    stacks.load_s, stacks.upload_s = t1 - t0, time.perf_counter() - t1
    logger.info(
        "device stacks: %d days at %dx%d, %d LR conds, %.2f GiB resident on %s "
        "(load %s s, upload %s s)", len(dates), full_hw[0], full_hw[1], len(lr_names),
        stacks.nbytes() / 2**30, device, stacks.load_s, stacks.upload_s,
    )
    return stacks


def draw(generator: torch.Generator, n_days: int, full_hw: Tuple[int, int],
         crop_hw: Tuple[int, int], cutout_domains: Optional[Sequence[int]], batch_size: int,
         cfg_dropout_prob: float = 0.0):
    """One batch's draws ``(day, ox, oy, keep)`` on the generator's device: a
    day, the crop's top row and left column per sample, and keep = 0 where CFG
    dropout drops the sample's conditions (1 elsewhere). Crops lie inside
    ``cutout_domains`` [x1, x2, y1, y2], or the full domain."""
    ch, cw = crop_hw
    if cutout_domains is not None:
        x1, x2, y1, y2 = (int(v) for v in cutout_domains)
    else:
        x1, x2, y1, y2 = 0, full_hw[0], 0, full_hw[1]
    if ch > x2 - x1 or cw > y2 - y1:
        raise ValueError("Crop size is larger than the rectangle dimensions.")
    dev = generator.device
    b = batch_size
    day = torch.randint(0, n_days, (b,), generator=generator, device=dev)
    ox = x1 + torch.randint(0, x2 - x1 - ch + 1, (b,), generator=generator, device=dev)
    oy = y1 + torch.randint(0, y2 - y1 - cw + 1, (b,), generator=generator, device=dev)
    if cfg_dropout_prob > 0.0:
        keep = (torch.rand((b,), generator=generator, device=dev) >= cfg_dropout_prob).float()
    else:
        keep = torch.ones((b,), device=dev)
    return day, ox, oy, keep


def make_sample_fn(crop_hw: Tuple[int, int], with_sdf: bool = True):
    """The batch function ``(day, ox, oy, keep, fields, statics, classifier) ->
    batch`` in the score-model kwargs contract ({x, cond_img, lsm_cond,
    topo_cond, y, lsm_hr, sdf}), computed on the stacks' device."""
    ch, cw = crop_hw

    def sample(day, ox, oy, keep, fields, statics, classifier) -> Dict[str, torch.Tensor]:
        dev = fields.device
        keep = keep.to(fields.dtype)
        rows = (ox.to(dev, torch.long)[:, None] + torch.arange(ch, device=dev))[:, :, None]
        cols = (oy.to(dev, torch.long)[:, None] + torch.arange(cw, device=dev))[:, None, :]
        day = day.to(dev, torch.long)
        crops = fields[day[:, None, None], rows, cols]  # [B, ch, cw, 1 + C]
        geo = statics[rows, cols]  # [B, ch, cw, 2]
        b = day.shape[0]
        lsm_bin = (geo[..., :1] > 0.5).to(fields.dtype)
        mask = keep[:, None, None, None].expand(b, ch, cw, 1)
        out = {
            "x": crops[..., :1],
            "cond_img": crops[..., 1:] * keep[:, None, None, None],
            "lsm_cond": torch.cat([lsm_bin, mask], dim=-1),
            "topo_cond": torch.cat([geo[..., 1:], mask], dim=-1),
            "y": classifier[day] * keep.to(torch.int32),
            "lsm_hr": lsm_bin,
        }
        if with_sdf:
            out["sdf"] = generate_sdf_device(lsm_bin[..., 0])[..., None].to(fields.dtype)
        return out

    return sample


def step_generator(device: torch.device, seed: int, epoch: int, step: int,
                   *stream: int) -> torch.Generator:
    """A generator on ``device`` seeded by (seed, epoch, step) alone, and by
    ``stream`` where given (a data-parallel rank, ``parallel/windowed_dp.py``)."""
    state = np.random.SeedSequence((seed, epoch, step, *stream)).generate_state(2, np.uint32)
    return torch.Generator(device).manual_seed(int(state[0]) << 32 | int(state[1]))


class DeviceDataLoader:
    """Loader-shaped front of the card sampler: ``len`` / ``set_epoch`` /
    iteration like ``data/loader.py``'s ``DataLoader``, yielding batches
    already on the card in model-kwargs form (the trainer sees
    ``is_device_loader`` and uses them as they come)."""

    is_device_loader = True

    def __init__(
        self,
        dataset: DanraDataset,
        batch_size: int,
        steps_per_epoch: Optional[int] = None,
        seed: int = 0,
        cfg_dropout_prob: float = 0.0,
        with_sdf: Optional[bool] = None,
        dtype: torch.dtype = torch.float32,
        device="cuda",
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.device = require_device(device)
        self.stacks = build_device_stacks(dataset, self.device, dtype)
        if with_sdf is None:
            # the host __getitem__'s gate (training.sdf_weighted_loss and
            # geo.sample_w_sdf): no flood for a loss that does not read it
            with_sdf = dataset.sdf_weighted_loss
        self.crop_hw = tuple(dataset.hr_data_size)
        self.cutout_domains = dataset.cutout_domains if dataset.cutouts else None
        self.cfg_dropout_prob = cfg_dropout_prob if dataset.cfg_dropout_enabled else 0.0
        self._sample = make_sample_fn(self.crop_hw, with_sdf=with_sdf)
        self.seed = seed
        self.epoch = 0
        self.steps_per_epoch = steps_per_epoch

    def draws(self, generator: torch.Generator):
        s = self.stacks
        return draw(generator, s.n_days, tuple(s.fields.shape[1:3]), self.crop_hw,
                    self.cutout_domains, self.batch_size, self.cfg_dropout_prob)

    def sample_from(self, day, ox, oy, keep) -> Dict[str, torch.Tensor]:
        """The batch for the given draws."""
        s = self.stacks
        return self._sample(day, ox, oy, keep, s.fields, s.statics, s.classifier)

    def sample(self, generator: torch.Generator) -> Dict[str, torch.Tensor]:
        return self.sample_from(*self.draws(generator))

    @property
    def sample_fn(self):
        """The batch function ``(day, ox, oy, keep, fields, statics,
        classifier) -> batch`` (``make_sample_fn``'s)."""
        return self._sample

    def buffers(self) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """The resident stacks, in ``sample_fn``'s argument order."""
        s = self.stacks
        return s.fields, s.statics, s.classifier

    def chunk_draws(self, epoch: int, start: int, k: int) -> Tuple[torch.Tensor, ...]:
        """The draws of steps [start, start + k) of ``epoch``, each from its
        ``step_generator``, as the iterator makes them: (day, ox, oy, keep),
        each [k, batch]."""
        steps = [self.draws(step_generator(self.device, self.seed, epoch, start + i))
                 for i in range(k)]
        return tuple(torch.stack(parts) for parts in zip(*steps))

    def iter_chunks(self, chunk_steps: int, n_chunks: Optional[int] = None):
        """Chunks of ``chunk_steps`` steps (counterpart of JAX's ``iter_chunks``):
        yields ``(buffers, draws)``, the stacks and the chunk's draws
        (``chunk_draws``), the same steps' streams as ``__iter__``; ``n_chunks``
        defaults to ``len(self) // chunk_steps`` (at least 1). Ends the epoch."""
        if chunk_steps <= 0:
            raise ValueError("chunk_steps must be positive")
        epoch = self.epoch
        if n_chunks is None:
            n_chunks = max(1, len(self) // chunk_steps)
        for c in range(n_chunks):
            yield self.buffers(), self.chunk_draws(epoch, c * chunk_steps, chunk_steps)
        self.epoch += 1

    def __len__(self) -> int:
        if self.steps_per_epoch:
            return self.steps_per_epoch
        return max(1, len(self.dataset) // self.batch_size)

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def __iter__(self):
        epoch = self.epoch
        for step in range(len(self)):
            yield self.sample(step_generator(self.device, self.seed, epoch, step))
        self.epoch += 1

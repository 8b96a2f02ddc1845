"""Rotating-window card-resident loader: train at card speed on archives
larger than the card's memory (counterpart of
``sbgm_danra_tpu/data/windowed_data.py``).

The fully resident path (``data/device_data.py``) caps at the card's memory;
a 30-year 3-field DANRA archive (~10.9K days at 589x789) is ~60 GiB in fp32.
This module is the middle path:

- a WINDOW of ``window_days`` archive days lives on the card and feeds the
  same batch function as the resident path (``make_sample_fn``: one gather,
  the jump-flood SDF, CFG dropout);
- while the card trains on the current window, a background host thread
  loads the NEXT window from zarr, casts it to the staging dtype into one
  pinned host buffer and copies it to the card on a side stream
  (double-buffering at window granularity);
- an epoch is a seeded permutation of disjoint window blocks: over one epoch
  the whole archive is visited; within a window, (day, crop) draws are
  uniform (shuffle-buffer semantics, not global shuffling).

Two pacing modes (``window_steps``):
- ``0`` (swap-on-ready, the throughput mode): train on the current window
  until the staged one is on the card, then swap; the card never waits for
  the host. Step counts per window depend on host speed.
- ``k > 0`` (fixed, the reproducible mode): exactly k batches per window;
  blocks on the stager if the host is slower than k steps of training.

Two card slots, two graphs. The windows live in two slots allocated once
and used in turn, so the fused step's graph (keyed on the stacks' addresses,
``training/fused.py``) is captured once per slot: at most two fused graphs,
whatever the number of swaps, and no capture after the first epoch. The
slots are handed over with events, because replays run behind the host:
after the last replay on the outgoing slot an event is recorded on the
training stream; the copy into that slot waits on it on the copy stream; the
training stream waits on the copy's event before its first use of the new
slot. "Ready" (swap-on-ready) means the host load has finished and the
copy's event has completed. On the CPU the slots are plain tensors and the
copy is synchronous.

Per-step draws come from ``step_generator(device, seed, epoch, step)``, the
day index in window coordinates: a single window that covers the archive,
staged in fp32, gives the resident loader's batches bit for bit.

Peak card memory = 2 windows + model/optimizer state. Asked for a CUDA device
on a machine without one, it raises (``require_device``).
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from sbgm_danra_tpu_torch.data.dataset import DanraDataset
from sbgm_danra_tpu_torch.data.device_data import (
    check_device_compatible,
    draw,
    load_days,
    load_static_geo,
    make_sample_fn,
    require_device,
    step_generator,
)

logger = logging.getLogger(__name__)


class WindowedDeviceLoader:
    """Loader-shaped front of rotating card windows over a larger archive,
    refilled asynchronously by the host. Quacks like ``DeviceDataLoader``
    (``is_device_loader``, ``len`` / ``set_epoch`` / iteration yielding
    card batches in model-kwargs form, ``iter_chunks`` for the fused step)."""

    is_device_loader = True

    def __init__(
        self,
        dataset: DanraDataset,
        batch_size: int,
        window_days: int,
        steps_per_epoch: Optional[int] = None,
        window_steps: int = 0,
        min_window_steps: int = 8,
        seed: int = 0,
        cfg_dropout_prob: float = 0.0,
        with_sdf: Optional[bool] = None,
        dtype: torch.dtype = torch.float32,
        layout: str = "consecutive",
        device="cuda",
    ):
        self.device = require_device(device)
        full_hw = check_device_compatible(dataset)
        self.dataset = dataset
        self.batch_size = batch_size
        self.dates: Tuple[str, ...] = tuple(dataset.common_dates)
        if window_days <= 0:
            raise ValueError("window_days must be positive")
        if layout not in ("consecutive", "strided"):
            raise ValueError(f"layout must be 'consecutive' or 'strided', got {layout!r}")
        self.layout = layout
        self.window_days = min(window_days, len(self.dates))
        self.n_windows = max(1, -(-len(self.dates) // self.window_days))
        self.window_steps = int(window_steps)
        self.min_window_steps = max(1, int(min_window_steps))
        self.steps_per_epoch = steps_per_epoch
        self.seed = seed
        self.epoch = 0
        self.dtype = dtype
        # refill observability (read by chip_smoke.py and the tests)
        self.n_swaps = 0
        self.stall_s = 0.0
        self.load_s: List[float] = []  # host seconds to decode and cast each staged window

        if with_sdf is None:
            with_sdf = dataset.sdf_weighted_loss
        self.crop_hw = tuple(dataset.hr_data_size)
        self.cutout_domains = dataset.cutout_domains if dataset.cutouts else None
        self.cfg_dropout_prob = cfg_dropout_prob if dataset.cfg_dropout_enabled else 0.0
        self._sample = make_sample_fn(self.crop_hw, with_sdf=with_sdf)
        self.full_hw = full_hw

        lsm, topo = load_static_geo(dataset)
        self._statics = torch.from_numpy(np.stack([lsm, topo], axis=-1)).to(self.device, dtype)
        n_lr = len(dataset.lr_conditions)
        shape = (self.window_days, *full_hw, 1 + n_lr)
        cuda = self.device.type == "cuda"
        self._slots = [torch.empty(shape, dtype=dtype, device=self.device) for _ in range(2)]
        self._slot_classes = [torch.empty((self.window_days,), dtype=torch.int32,
                                          device=self.device) for _ in range(2)]
        # one host buffer of a window's size, pinned on a CUDA machine
        self._host = torch.empty(shape, dtype=dtype, pin_memory=cuda)
        self._host_classes = torch.empty((self.window_days,), dtype=torch.int32,
                                         pin_memory=cuda)
        self._copy_stream = torch.cuda.Stream(self.device) if cuda else None
        self._free = [torch.cuda.Event() if cuda else None for _ in range(2)]
        self._ready = [torch.cuda.Event() if cuda else None for _ in range(2)]
        self._host_slot: Optional[int] = None  # the slot the host buffer was last copied to

        # the first window (block 0) is staged synchronously into slot 0
        self._slot_block = [-1, -1]
        self._stage_into(0, 0)
        self._use(0)

        # stager thread state: at most one window in flight, into the other slot
        self._staged: Optional[int] = None
        self._stage_err: Optional[BaseException] = None
        self._stage_done = threading.Event()
        self._stage_thread: Optional[threading.Thread] = None

        gib = (self._slots[0].numel() * self._slots[0].element_size()) / 2**30
        logger.info(
            "windowed device loader: %d days total, %d windows of %d days "
            "(%.3f GiB/window x2 resident, %s), mode=%s", len(self.dates), self.n_windows,
            self.window_days, gib, dtype,
            f"fixed {self.window_steps} steps" if self.window_steps else "swap-on-ready")

    # -- window plumbing ----------------------------------------------------

    def _block_dates(self, block: int) -> List[str]:
        """Window ``block``'s dates; wrap-around keeps every window exactly
        window_days long (one shape, one graph per slot).

        Layouts:
        - ``consecutive``: block b = days [b*W, (b+1)*W): contiguous archive
          reads, but a window is seasonally correlated by construction;
        - ``strided``: block b = days {b, b + n_windows, b + 2*n_windows, ...}:
          every window spans the whole archive uniformly.
        """
        n = len(self.dates)
        if self.layout == "strided":
            return [self.dates[(block + i * self.n_windows) % n]
                    for i in range(self.window_days)]
        start = block * self.window_days
        return [self.dates[(start + i) % n] for i in range(self.window_days)]

    def _load_window_host(self, block: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """Decode window ``block`` into the host buffer, cast to the staging
        dtype by torch (round to nearest even for bf16): (fields [W, H, W',
        1 + C], classes [W]). The buffer is overwritten by the next load."""
        hr, lr, classes = load_days(self.dataset, self._block_dates(block))
        self._host[..., 0].copy_(torch.from_numpy(hr))
        self._host[..., 1:].copy_(torch.from_numpy(lr))
        self._host_classes.copy_(torch.from_numpy(classes))
        return self._host, self._host_classes

    def _stage_into(self, block: int, slot: int) -> None:
        """Load ``block`` on the host and copy it into card slot ``slot``: on
        the copy stream after the slot's last reader (``_free``), recording
        ``_ready``. The host buffer is reused only once its last copy is done."""
        if self._host_slot is not None and self._ready[self._host_slot] is not None:
            self._ready[self._host_slot].synchronize()  # the last copy left the host buffer
        t0 = time.perf_counter()
        fields, classes = self._load_window_host(block)
        t1 = time.perf_counter()
        if self._copy_stream is None:
            self._slots[slot].copy_(fields)
            self._slot_classes[slot].copy_(classes)
        else:
            with torch.cuda.stream(self._copy_stream):
                self._copy_stream.wait_event(self._free[slot])
                self._slots[slot].copy_(fields, non_blocking=True)
                self._slot_classes[slot].copy_(classes, non_blocking=True)
                self._ready[slot].record(self._copy_stream)
        self.load_s.append(t1 - t0)
        self._host_slot = slot
        self._slot_block[slot] = block

    def _use(self, slot: int) -> None:
        """Make ``slot`` current: the training stream waits for its copy."""
        self._cur = slot
        if self._ready[slot] is not None:
            torch.cuda.current_stream(self.device).wait_event(self._ready[slot])

    def _release(self, slot: int) -> None:
        """Mark everything enqueued so far as ``slot``'s last readers."""
        if self._free[slot] is not None:
            self._free[slot].record(torch.cuda.current_stream(self.device))

    @property
    def current_block(self) -> int:
        return self._slot_block[self._cur]

    def _stage_async(self, block: int) -> None:
        # serialize stagers: an abandoned iterator (e.g. a probe's
        # next(iter(loader))) may still have one in flight into the same slot
        if self._stage_thread is not None and self._stage_thread.is_alive():
            self._stage_thread.join()
        self._stage_done.clear()
        self._staged = None
        self._stage_err = None
        slot = 1 - self._cur

        def work():
            try:
                self._stage_into(block, slot)
                self._staged = slot
            except BaseException as e:  # surfaced on the training thread
                self._stage_err = e
            finally:
                self._stage_done.set()

        self._stage_thread = threading.Thread(target=work, daemon=True,
                                              name=f"window-stager-{block}")
        self._stage_thread.start()

    def staged_ready(self) -> bool:
        """The staged window is on the card: host load done and copy complete."""
        if not self._stage_done.is_set():
            return False
        slot = self._staged
        return slot is None or self._ready[slot] is None or self._ready[slot].query()

    def _take_staged(self, block: int) -> None:
        t0 = time.perf_counter()
        self._stage_done.wait()
        self.stall_s += time.perf_counter() - t0
        if self._stage_err is not None:
            raise RuntimeError("window staging failed") from self._stage_err
        slot = self._staged
        assert slot is not None and self._slot_block[slot] == block
        self._staged = None
        self._release(self._cur)
        self._use(slot)
        self.n_swaps += 1

    # -- loader protocol ------------------------------------------------------

    def buffers(self) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """The current window's card tensors, in ``sample_fn``'s argument order."""
        return self._slots[self._cur], self._statics, self._slot_classes[self._cur]

    @property
    def sample_fn(self):
        """The batch function ``(day, ox, oy, keep, fields, statics,
        classifier) -> batch`` (``make_sample_fn``'s)."""
        return self._sample

    def draws(self, generator: torch.Generator):
        return draw(generator, self.window_days, self.full_hw, self.crop_hw,
                    self.cutout_domains, self.batch_size, self.cfg_dropout_prob)

    def sample_from(self, day, ox, oy, keep) -> Dict[str, torch.Tensor]:
        """The batch for the given draws (``day`` in window coordinates) from
        the current window."""
        return self._sample(day, ox, oy, keep, *self.buffers())

    def sample(self, generator: torch.Generator) -> Dict[str, torch.Tensor]:
        return self.sample_from(*self.draws(generator))

    def chunk_draws(self, epoch: int, start: int, k: int) -> Tuple[torch.Tensor, ...]:
        """The draws of steps [start, start + k) of ``epoch``, each from its
        ``step_generator``: (day, ox, oy, keep), each [k, batch]."""
        steps = [self.draws(step_generator(self.device, self.seed, epoch, start + i))
                 for i in range(k)]
        return tuple(torch.stack(parts) for parts in zip(*steps))

    def iter_chunks(self, chunk_steps: int, n_chunks: Optional[int] = None):
        """Chunked consumption for the fused step: yields ``(buffers, draws)``
        per chunk of ``chunk_steps`` train steps, with the same window
        schedule and swap pacing as ``__iter__`` and the same per-step draws.

        Swap pacing at chunk granularity: swap-on-ready swaps when the staged
        window is ready and >= max(1, min_window_steps // chunk_steps)
        chunks ran on this window; fixed mode runs ceil(window_steps /
        chunk_steps) chunks per window.

        Backpressure is the CONSUMER's: the fused replays are asynchronous,
        so the caller must read each chunk's losses (``TrainingPipeline``
        does) or the host races ahead of the card and the swap schedule runs
        on host time.
        """
        if chunk_steps <= 0:
            raise ValueError("chunk_steps must be positive")
        if n_chunks is None and self.steps_per_epoch:
            n_chunks = -(-self.steps_per_epoch // chunk_steps)
        fixed = -(-self.window_steps // chunk_steps) if self.window_steps > 0 else 0
        minimum = max(1, self.min_window_steps // chunk_steps)
        for epoch, chunk in self._walk(n_chunks, fixed, minimum):
            yield self.buffers(), self.chunk_draws(epoch, chunk * chunk_steps, chunk_steps)

    def _walk(self, budget: Optional[int], fixed: int, minimum: int, idle_wait: float = 0.0
              ) -> Iterator[Tuple[int, int]]:
        """One epoch's walk over the window schedule in units (a step or a
        chunk): yields ``(epoch, i)`` for the epoch's i-th unit once its
        window is current, staging the next window while the current one is
        in use. It leaves a window after ``fixed`` units (fixed mode), or,
        with ``fixed`` 0 (swap-on-ready), once ``minimum`` units ran on it and
        the staged window is ready (or none is left), waiting ``idle_wait``
        seconds on the stager after each unit it stays only for the stager;
        it stops after ``budget`` units (None: the whole schedule)."""
        epoch = self.epoch
        done = 0
        schedule = self._schedule(epoch)
        for wi, block in enumerate(schedule):
            if budget is not None and done >= budget:
                break
            if self.current_block != block:
                self._take_staged(block)
            has_next = wi + 1 < len(schedule)
            if has_next:
                self._stage_async(schedule[wi + 1])
            units = 0
            while True:
                yield epoch, done
                units += 1
                done += 1
                if budget is not None and done >= budget:
                    break
                if fixed:
                    if units >= fixed:
                        break
                elif units >= minimum:
                    if not has_next or self.staged_ready():
                        break
                    if idle_wait:
                        self._stage_done.wait(idle_wait)
        self.epoch += 1

    def _schedule(self, epoch: int) -> List[int]:
        order = [int(v) for v in np.random.default_rng((self.seed, epoch))
                 .permutation(self.n_windows)]
        # rotate so the window already resident (from construction or the
        # previous epoch's tail) comes first: no redundant reload
        if self.current_block in order:
            i = order.index(self.current_block)
            order = order[i:] + order[:i]
        return order

    def __len__(self) -> int:
        if self.steps_per_epoch:
            return self.steps_per_epoch
        if self.window_steps:
            return self.n_windows * self.window_steps
        return max(1, len(self.dates) // self.batch_size)

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def __iter__(self) -> Iterator[Dict[str, torch.Tensor]]:
        # swap-on-ready waits 5 ms on the stager after each step it stays only
        # for it: a hot eager loop can starve the loader thread of the GIL,
        # and the steps already enqueued keep the card busy meanwhile
        walk = self._walk(self.steps_per_epoch or None, max(self.window_steps, 0),
                          self.min_window_steps, idle_wait=0.005)
        for epoch, step in walk:
            yield self.sample(step_generator(self.device, self.seed, epoch, step))

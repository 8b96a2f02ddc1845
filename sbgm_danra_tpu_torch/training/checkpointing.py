"""The port's own training checkpoints: best-validation and latest, with an
exact resume (counterpart of ``sbgm_danra_tpu/training/checkpointing.py``).

The JAX package writes Orbax, which the card machine cannot read (no JAX, no
orbax there). A checkpoint here is one ``torch.save`` file per step,
``ckpt_<step>.pt``, holding

    {"step", "params", "batch_stats", "buffers", "optimizer", "ema_params",
     "scheduler", "early_stop", "meta"}

with the tensors on the CPU: the parameters, the BatchNorm running statistics
and the fixed buffers (the Fourier frequencies) by state_dict key, the
optimizer's ``state_dict`` (its state and the learning rate), the EMA copy,
the scheduler's and early stopping's state, and host metadata (epoch,
validation loss, history, model string). ``index.json`` keeps each step's
validation loss; the manager keeps the ``max_to_keep`` newest files and the
best one. A file is written beside its final name and renamed into place.

``snapshot_state`` clones every tensor of the state on its device, with the
scheduler's and early stopping's states: a rate-limited best checkpoint
(``training.checkpoint_min_interval_epochs``) is held so until it is written,
and ``CheckpointManager.save`` takes it in place of the state. It must be a
copy: the train step, captured or not, writes the state's tensors in place.

``save(..., block=False)`` (``training.async_checkpointing``) keeps the write
out of the training loop: the state is snapshotted on its device (one clone
of each tensor on the training stream, then an event recorded after the
clones), and a single worker thread waits on that event, copies the snapshot
to the host on a side stream and writes it. The event matters: the clones are
asynchronous, and the next replay writes the live state in place
(``capture.Graph.writes``), so a worker that read before the clones ran would
write a later step's weights. At most one save is in flight (a second waits
for the first, bounding the extra card memory at one snapshot); ``wait()``
re-raises the worker's error (a checkpoint the caller believes written must
not vanish silently). Reading the index or a checkpoint waits first.
"""

from __future__ import annotations

import concurrent.futures
import copy
import json
import os
from typing import Dict, Optional, Tuple, Union

import torch

from sbgm_danra_tpu_torch.training.state import TrainState

_STATS = ("running_mean", "running_var")


def _cpu(tensors: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {k: v.detach().to("cpu", copy=True) for k, v in tensors.items()}


_CPU_ENTRIES = ("params", "batch_stats", "buffers", "ema_params")


def _entries(state: TrainState, scheduler=None, early_stop=None) -> Dict:
    """The checkpoint's entries of ``state``: its live tensors, not copies."""
    buffers = dict(state.model.named_buffers())
    return {
        "step": state.step,
        "params": dict(state.model.named_parameters()),
        "batch_stats": {k: v for k, v in buffers.items() if k.endswith(_STATS)},
        "buffers": {k: v for k, v in buffers.items() if not k.endswith(_STATS)},
        "optimizer": state.optimizer.state_dict(),
        "ema_params": dict(state.ema_params),
        "scheduler": scheduler.state_dict() if scheduler is not None else None,
        "early_stop": early_stop.state_dict() if early_stop is not None else None,
    }


def _clone(tree):
    if isinstance(tree, torch.Tensor):
        return tree.detach().clone()
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_clone(v) for v in tree)
    return copy.deepcopy(tree)


@torch.no_grad()
def snapshot_state(state: TrainState, scheduler=None, early_stop=None) -> Dict:
    """Every tensor of ``state`` cloned on its device (parameters, BatchNorm
    statistics, buffers, the optimizer's moments, step counts and tensor
    learning rate, the EMA copy) with the step and the scheduler's and early
    stopping's states as they are now."""
    return _clone(_entries(state, scheduler, early_stop))


def state_tree(state: Union[TrainState, Dict], scheduler=None, early_stop=None,
               meta: Optional[Dict] = None) -> Dict:
    """The checkpoint's contents for ``state`` or a ``snapshot_state`` of one
    (which holds its scheduler's and early stopping's states), the weights
    copied to the CPU."""
    tree = state if isinstance(state, dict) else _entries(state, scheduler, early_stop)
    out = {k: _cpu(v) if k in _CPU_ENTRIES else v for k, v in tree.items()}
    out["meta"] = dict(meta or {})
    return out


def model_state_dict(tree: Dict, use_ema: bool = False) -> Dict[str, torch.Tensor]:
    """A checkpoint's weights as a model state_dict: its parameters (or, with
    ``use_ema``, its EMA copy), statistics and buffers."""
    if use_ema and not tree.get("ema_params"):
        raise KeyError("the checkpoint holds no EMA weights to load with load_ema")
    params = tree["ema_params"] if use_ema else tree["params"]
    return {**params, **tree["batch_stats"], **tree["buffers"]}


@torch.no_grad()
def restore_into(state: TrainState, tree: Dict, scheduler=None, early_stop=None) -> Dict:
    """Load a checkpoint's tree into ``state`` (and the scheduler and early
    stopping, when given); returns its metadata."""
    state.model.load_state_dict(model_state_dict(tree))
    state.optimizer.load_state_dict(tree["optimizer"])
    for name, ema in state.ema_params.items():
        ema.copy_(tree["ema_params"][name])
    state.step = int(tree["step"])
    if scheduler is not None and tree.get("scheduler"):
        scheduler.load_state_dict(tree["scheduler"])
    if early_stop is not None and tree.get("early_stop"):
        early_stop.load_state_dict(tree["early_stop"])
    return dict(tree.get("meta") or {})


def _device(tree: Dict) -> torch.device:
    """The device of a snapshot's tensors (the CPU for an empty one)."""
    for entry in _CPU_ENTRIES:
        for v in (tree.get(entry) or {}).values():
            return v.device
    return torch.device("cpu")


class CheckpointManager:
    """Writes ``ckpt_<step>.pt`` under ``directory`` and tracks the best
    validation loss; keeps the ``max_to_keep`` newest and the best. Saves
    block unless asked not to (see the module's notes)."""

    def __init__(self, directory: str, max_to_keep: int = 3):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        os.makedirs(self.directory, exist_ok=True)
        self._index_path = os.path.join(self.directory, "index.json")
        self._index: Dict[int, float] = {}
        if os.path.exists(self._index_path):
            with open(self._index_path) as f:
                self._index = {int(k): float(v) for k, v in json.load(f).items()}
        self._executor: Optional[concurrent.futures.ThreadPoolExecutor] = None
        self._pending: Optional[concurrent.futures.Future] = None
        self._stream = None  # the worker's copy stream on a CUDA device

    def path(self, step: int) -> str:
        return os.path.join(self.directory, f"ckpt_{step:08d}.pt")

    def save(self, step: int, state: Union[TrainState, Dict], meta: Optional[Dict] = None,
             scheduler=None, early_stop=None, block: bool = True) -> str:
        """Write ``state`` (or a ``snapshot_state``) as step ``step``; with
        ``block=False`` on the worker thread, from a snapshot taken now."""
        meta = dict(meta or {})
        self.wait()
        if block:
            return self._write(step, state_tree(state, scheduler, early_stop, meta), meta)
        snap = state if isinstance(state, dict) else snapshot_state(state, scheduler, early_stop)
        device = _device(snap)
        done = None
        if device.type == "cuda":  # the clones are queued on the training stream
            done = torch.cuda.Event()
            done.record(torch.cuda.current_stream(device))
        if self._executor is None:
            self._executor = concurrent.futures.ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="ckpt-save")
        self._pending = self._executor.submit(self._write_snapshot, step, snap, meta, done,
                                              device)
        return self.path(step)

    def _write_snapshot(self, step: int, snap: Dict, meta: Dict, done, device) -> str:
        """The worker's part: wait for the snapshot's clones, copy it to the
        host off the training stream, write it."""
        if done is None:
            return self._write(step, state_tree(snap, meta=meta), meta)
        if self._stream is None:
            self._stream = torch.cuda.Stream(device)
        with torch.cuda.stream(self._stream):  # torch.save copies the optimizer's tensors
            self._stream.wait_event(done)
            return self._write(step, state_tree(snap, meta=meta), meta)

    def _write(self, step: int, tree: Dict, meta: Dict) -> str:
        final = self.path(step)
        tmp = final + ".tmp"
        torch.save(tree, tmp)
        os.replace(tmp, final)
        self._index[step] = float(meta.get("val_loss", float("inf")))
        best = self._best()
        for old in sorted(self._index)[:-self.max_to_keep]:
            if old != best:
                self._index.pop(old)
                if os.path.exists(self.path(old)):
                    os.remove(self.path(old))
        with open(self._index_path + ".tmp", "w") as f:
            json.dump({str(k): v for k, v in self._index.items()}, f)
        os.replace(self._index_path + ".tmp", self._index_path)
        return final

    def wait(self) -> None:
        """Block until an in-flight ``block=False`` save is written; re-raises
        the worker's error."""
        if self._pending is not None:
            pending, self._pending = self._pending, None
            pending.result()

    def close(self) -> None:
        self.wait()
        if self._executor is not None:
            self._executor.shutdown(wait=True)
            self._executor = None

    def _best(self) -> Optional[int]:
        if not self._index:
            return None
        return min(self._index, key=lambda s: (self._index[s], -s))

    def latest_step(self) -> Optional[int]:
        self.wait()
        return max(self._index) if self._index else None

    def best_step(self) -> Optional[int]:
        self.wait()
        return self._best()

    def load_tree(self, step: Optional[int] = None, best: bool = False) -> Tuple[int, Dict]:
        self.wait()
        if step is None:
            step = self.best_step() if best else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"No checkpoints under {self.directory}")
        return step, torch.load(self.path(step), map_location="cpu", weights_only=True)

    def restore(self, state: TrainState, step: Optional[int] = None, best: bool = False,
                scheduler=None, early_stop=None) -> Dict:
        """Restore into ``state`` (built like the saved one); returns the metadata."""
        _, tree = self.load_tree(step, best)
        return restore_into(state, tree, scheduler, early_stop)

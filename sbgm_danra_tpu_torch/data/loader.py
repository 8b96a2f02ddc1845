"""Batched, thread-prefetched host loading and the copy to the card
(counterpart of ``sbgm_danra_tpu/data/loader.py``).

- ``DataLoader``: a thread pool assembles the dataset's numpy samples (zarr
  reads and numpy transforms release the GIL in zlib and BLAS) and ``collate``
  stacks them to NHWC numpy. The index order and the per-(epoch, index)
  ``numpy.random.Generator`` are JAX's, so that both packages give the same
  batches at the same seed, whatever the number of workers.
- ``extract_batch``: a collated sample dict -> score-model kwargs.
- ``device_prefetch``: keeps the next ``depth`` batches on their way to the
  card while the current step runs. On a CUDA device a producer thread pins
  each host array and copies it with ``non_blocking=True`` on a side stream,
  then records an event; the consumer's stream waits on the event, and each
  tensor is marked with ``record_stream`` so that its memory is not reused
  before the step that reads it has run. On a CPU device the batches pass
  through as they are.
"""

from __future__ import annotations

import concurrent.futures as cf
import queue
import threading
from typing import Dict, Iterator, Sequence

import numpy as np
import torch


def collate(samples: Sequence[Dict[str, np.ndarray]]) -> Dict[str, np.ndarray]:
    """Stack sample dicts along a new batch axis."""
    keys = samples[0].keys()
    return {k: np.stack([np.asarray(s[k]) for s in samples], axis=0) for k in keys}


class DataLoader:
    """Map-style loader: shuffling, thread-parallel assembly, drop_last batching."""

    def __init__(
        self,
        dataset,
        batch_size: int,
        shuffle: bool = False,
        drop_last: bool = True,
        num_workers: int = 4,
        seed: int = 0,
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.num_workers = max(1, num_workers)
        self.seed = seed
        self.epoch = 0

    def __len__(self) -> int:
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return -(-n // self.batch_size)

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def _index_order(self) -> np.ndarray:
        order = np.arange(len(self.dataset))
        if self.shuffle:
            np.random.default_rng((self.seed, self.epoch)).shuffle(order)
        return order

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        order = self._index_order()
        n_batches = len(self)
        epoch = self.epoch

        def fetch(idx: int) -> Dict[str, np.ndarray]:
            rng = np.random.default_rng((self.seed, epoch, int(idx)))
            return self.dataset.__getitem__(int(idx), rng=rng)

        with cf.ThreadPoolExecutor(max_workers=self.num_workers) as pool:
            for b in range(n_batches):
                chunk = order[b * self.batch_size : (b + 1) * self.batch_size]
                samples = list(pool.map(fetch, chunk))
                yield collate(samples)
        self.epoch += 1


def _to_device(batch: Dict, device: torch.device) -> Dict[str, torch.Tensor]:
    """Pinned host copies, sent with ``non_blocking`` on the current stream;
    tensors already on ``device`` are kept."""
    out = {}
    for k, v in batch.items():
        t = torch.as_tensor(v)
        out[k] = t if t.device == device else t.pin_memory().to(device, non_blocking=True)
    return out


def device_prefetch(iterator: Iterator[Dict], depth: int = 2,
                    device="cuda", shard=None) -> Iterator[Dict]:
    """Copy each batch of ``iterator`` to ``device`` ``depth`` batches ahead of
    the consumer (see the module's notes); on a CPU device, the batches as
    they come. ``shard``: a function of a global batch giving this rank's
    rows (``parallel/mesh.shard_batch``; JAX's batch sharding), applied
    before the copy, so a rank copies only its rows."""
    device = torch.device(device)
    if shard is not None:
        iterator = (shard(batch) for batch in iterator)
    if device.type != "cuda":
        yield from iterator
        return
    if device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    q: "queue.Queue" = queue.Queue(maxsize=max(1, depth))
    sentinel = object()
    err: list = []
    stop = threading.Event()

    def producer():
        stream = torch.cuda.Stream(device)
        try:
            with torch.cuda.stream(stream):
                for item in iterator:
                    if stop.is_set():
                        return
                    batch = _to_device(item, device)
                    event = torch.cuda.Event()
                    event.record(stream)
                    q.put((batch, event))
        except Exception as e:  # surfaced on the consumer's side
            err.append(e)
        finally:
            q.put(sentinel)

    thread = threading.Thread(target=producer, daemon=True)
    thread.start()
    try:
        while True:
            item = q.get()
            if item is sentinel:
                if err:
                    raise err[0]
                return
            batch, event = item
            current = torch.cuda.current_stream(device)
            current.wait_event(event)
            for t in batch.values():
                t.record_stream(current)
            yield batch
    finally:
        # a consumer that stops early (max_steps) releases the producer
        stop.set()
        while thread.is_alive():
            try:
                q.get(timeout=0.1)
            except queue.Empty:
                pass
        thread.join()


def extract_batch(batch: Dict, hr_var: str) -> Dict:
    """Map a collated sample dict to score-model kwargs: the HR target -> x,
    the sorted LR channels concatenated -> cond_img, the geo maps -> lsm_cond
    / topo_cond, plus sdf, the class y and lsm_hr; numpy arrays or tensors."""
    out: Dict = {}
    hr_key = f"{hr_var}_hr"
    if hr_key not in batch:
        hr_keys = [k for k in batch if k.endswith("_hr") and k != "lsm_hr"]
        if not hr_keys:
            raise ValueError("No HR image found in batch")
        hr_key = hr_keys[0]
    out["x"] = batch[hr_key]
    lr_keys = sorted(k for k in batch if k.endswith("_lr"))
    if lr_keys:
        parts = [batch[k] for k in lr_keys]
        cat = torch.cat if isinstance(parts[0], torch.Tensor) else np.concatenate
        out["cond_img"] = cat(parts, -1)
    if "lsm" in batch:
        out["lsm_cond"] = batch["lsm"]
    if "topo" in batch:
        out["topo_cond"] = batch["topo"]
    if "classifier" in batch:
        y = batch["classifier"]
        out["y"] = y.to(torch.int32) if isinstance(y, torch.Tensor) else y.astype(np.int32)
    if "sdf" in batch:
        out["sdf"] = batch["sdf"]
    if "lsm_hr" in batch:
        out["lsm_hr"] = batch["lsm_hr"]
    return out

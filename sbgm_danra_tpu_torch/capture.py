"""CUDA graphs: the port's counterpart of the JAX package's one-program calls.

JAX traces a sampler, a train step or a chunk of fused steps into one XLA
program and dispatches it once. Here such a call is captured once into a CUDA
graph (``torch.cuda.CUDAGraph``) and replayed: one launch from the host for
the whole call, with the hand-written kernels (K1, K2, the upsample) among its nodes.

``Graph(fn, inputs)`` follows PyTorch's recipe: ``warmup`` eager calls of
``fn(*inputs)`` on the device's capture stream (``capture_stream``: one
side stream shared by every capture; cuDNN's algorithm choice, the kernels'
packed weights and ticket counters, the allocator's blocks all happen there),
then the capture of one call on that stream into the graph's private memory
pool. ``inputs`` are the graph's static input tensors: the caller copies each
call's values into them before ``replay``, which returns the static outputs
of the captured call (overwritten by the next replay). A replay reads
tensors by address, so every tensor made for the call before its capture
is one of ``inputs`` (the graph keeps them alive); the rest it reads (a
model's parameters, a train state, resident data) its owner keeps alive.

- A capture that fails raises (``CaptureError``, with PyTorch's or CUDA's
  error as its cause): a host sync (``.item()``, ``bool`` of a device
  tensor), a copy from pageable host memory, or an op that does not capture.
  Nothing falls back to the eager call.
- Launch counts (``ops/launches.py``). A kernel wrapper called during a
  capture records its launch instead of counting it; the graph keeps what its
  capture recorded (``launches``, by kernel name) and each replay adds that
  to the counts, so they stay the number of kernel launches on the card.
- Staleness. The graph reads every tensor at the address it had at capture.
  K1's cached weight packs are checked on every replay (``valid``): a
  parameter updated in place since the capture makes ``valid`` False, and
  the owner captures again. ``signature`` (any value the caller computes,
  compared by ``==``) covers the rest, e.g. the addresses of a train state.
  A replay runs no ATen op, so it moves no version counter: the owner of a
  graph that writes tensors in place (a train step's parameters, optimizer
  state and EMA) lists them in its ``writes``, and each replay advances
  their counters, so that every K1 pack made from them before the replay
  (cached for eager calls, or held by another graph) goes stale.
- ``use_graphs(capture, device)``: the route rule of every entry point: graphs
  on a CUDA device unless the caller asks for the eager loop
  (``capture=False``); the eager loop on the CPU, where ``capture=True``
  raises.
- ``stats()``: name, launches per replay, replays, capture and instantiate
  seconds and pool bytes of every live graph, for ``chip_smoke.py`` and
  ``profile_port.py``.
"""

from __future__ import annotations

import time
import weakref
from typing import Any, Callable, Dict, List, Optional, Sequence

import torch

from sbgm_danra_tpu_torch.ops import fused_conv_gn as k1
from sbgm_danra_tpu_torch.ops import launches

WARMUP_CALLS = 2
_live = weakref.WeakSet()  # every Graph not yet collected, for stats()


class CaptureError(RuntimeError):
    """Capturing a call into a CUDA graph failed."""


def use_graphs(capture: Optional[bool], device) -> bool:
    """Whether an entry point on ``device`` runs its captured graphs: on a CUDA
    device unless ``capture`` is False; never on the CPU, where asking for
    them (``capture=True``) raises."""
    device = torch.device(device)
    if device.type != "cuda":
        if capture:
            raise ValueError(f"CUDA graphs need a CUDA device; got {device}")
        return False
    return capture is None or bool(capture)


_capture_streams: Dict[int, "torch.cuda.Stream"] = {}


def capture_stream(dev) -> "torch.cuda.Stream":
    """The side stream every capture on ``dev`` runs on, one a device (as
    ``torch.cuda.graph``'s default capture stream): cuBLAS keeps a workspace
    for each stream it has run on, so a stream of its own per capture would
    leave a workspace on the card behind every graph (a sweep's trials grew
    the card's memory so)."""
    index = torch.device(dev).index
    index = torch.cuda.current_device() if index is None else index
    stream = _capture_streams.get(index)
    if stream is None:
        stream = _capture_streams[index] = torch.cuda.Stream(index)
    return stream


class Graph:
    """One captured call of ``fn(*inputs)``; see the module's notes.

    ``reset`` runs after the warm-up calls, before the capture: a call that
    updates state (a train step) puts the state back there. The owner sets
    ``signature`` (kept for its staleness check) and ``writes`` (the tensors
    the call updates in place, see the module's notes on staleness) once the
    capture has made whatever state the call creates. The graph does not
    keep ``fn``.
    """

    signature: Any = None
    writes: Sequence[torch.Tensor] = ()

    def __init__(self, name: str, fn: Callable[..., Any], inputs: Sequence[torch.Tensor],
                 warmup: int = WARMUP_CALLS, reset: Optional[Callable[[], None]] = None):
        self.name = name
        self.inputs = list(inputs)
        dev = self.inputs[0].device
        if dev.type != "cuda":
            raise ValueError(f"a CUDA graph needs CUDA inputs; {name} got {dev}")
        self._tickets: dict = {}
        self._hits: List[tuple] = []
        current = torch.cuda.current_stream(dev)
        stream = capture_stream(dev)
        try:
            stream.wait_stream(current)
            with torch.cuda.stream(stream), k1.capture_scope(self._tickets, None):
                for _ in range(warmup):
                    fn(*self.inputs)
            current.wait_stream(stream)
            if reset is not None:
                reset()
            stream.wait_stream(current)
            torch.cuda.synchronize(dev)
            before = launches.recorded.copy()
            self.graph = torch.cuda.CUDAGraph()
            torch.cuda.empty_cache()
            reserved = torch.cuda.memory_reserved(dev)
            t0 = time.perf_counter()
            with torch.cuda.stream(stream), k1.capture_scope(self._tickets, self._hits):
                self.graph.capture_begin(capture_error_mode="thread_local")
                try:
                    self.outputs = fn(*self.inputs)
                except BaseException:
                    try:
                        self.graph.capture_end()
                    except BaseException:
                        pass  # the body's error is the one to report
                    raise
                t1 = time.perf_counter()
                self.graph.capture_end()  # ends the capture and instantiates the graph
            t2 = time.perf_counter()
        except CaptureError:
            raise
        except Exception as e:
            raise CaptureError(f"capturing {name} into a CUDA graph failed: {e}") from e
        self.launches = dict(launches.recorded - before)
        self.capture_s, self.instantiate_s = t1 - t0, t2 - t1
        self.pool_bytes = torch.cuda.memory_reserved(dev) - reserved
        self.replays = 0
        _live.add(self)

    def valid(self, signature: Any = None) -> bool:
        """False once a cached K1 pack the graph reads went stale, or the
        owner's ``signature`` differs from the one given at capture."""
        return signature == self.signature and k1.packs_current(self._hits)

    def replay(self):
        """Replay the graph on the current stream; returns the static outputs."""
        self.graph.replay()
        if self.writes:
            torch.autograd.graph.increment_version(self.writes)
        self.replays += 1
        launches.add_replay(self.launches)
        return self.outputs

    def stats(self) -> dict:
        return dict(name=self.name, launches_per_replay=dict(self.launches),
                    replays=self.replays, capture_s=self.capture_s,
                    instantiate_s=self.instantiate_s, pool_bytes=self.pool_bytes)


def stats() -> List[dict]:
    """``Graph.stats()`` of every live graph."""
    return [g.stats() for g in list(_live)]


def static_like(t: torch.Tensor) -> torch.Tensor:
    """An uninitialised tensor of ``t``'s shape, dtype and device (contiguous)."""
    return torch.empty(t.shape, dtype=t.dtype, device=t.device)


def tensor_signature(tensors) -> tuple:
    """Shape, dtype and device of each tensor (None kept): a graph's key part."""
    return tuple(None if t is None else (tuple(t.shape), t.dtype, t.device) for t in tensors)


def flags() -> tuple:
    """The process-wide flags that change what a capture records (TF32 for
    cuDNN and cuBLAS, cuDNN's determinism and autotuning)."""
    b = torch.backends
    return (b.cudnn.allow_tf32, b.cuda.matmul.allow_tf32, b.cudnn.deterministic,
            b.cudnn.benchmark)

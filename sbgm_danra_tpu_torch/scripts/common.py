"""What the port's quality scripts share: the route and bookkeeping of one
sampler run.

- ``CountedScore``: a score function that counts its Python calls. A fresh
  one per run is also the run's graph key (``sampling/graphs.py`` keeps a
  graph per score function), so the run's graph and its pool go with it.
- ``Run``: one sampler run's record: route (``graph`` or ``eager``), sampler
  calls, UNet evaluations executed on the device (a graph's warm-up calls,
  replays and eager calls alike; the capture records and executes nothing),
  K1 / K2 launches, and, on the graph route, the capture and instantiate
  seconds and the pool bytes of the run's graph.
- ``chunk_generator``: a ``torch.Generator`` on the device seeded from
  ``(seed, index)``, the port's counterpart of JAX's
  ``jax.random.fold_in(PRNGKey(seed), index)`` per chunk. The streams differ
  (ROADMAP F4): the scripts' numbers agree with JAX's in distribution only.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from sbgm_danra_tpu_torch import capture
from sbgm_danra_tpu_torch.ops import cuda_attention as k2
from sbgm_danra_tpu_torch.ops import launches
from sbgm_danra_tpu_torch.sampling import graphs


class CountedScore:
    """``score_fn`` counting its Python calls (``calls``)."""

    def __init__(self, score_fn: Callable):
        self.score_fn, self.calls = score_fn, 0

    def __call__(self, x, t, **cond):
        self.calls += 1
        return self.score_fn(x, t, **cond)


def chunk_generator(device, seed: int, index: int) -> torch.Generator:
    """A generator on ``device`` seeded from ``(seed, index)``."""
    state = np.random.SeedSequence((int(seed), int(index))).generate_state(2, np.uint32)
    return torch.Generator(device).manual_seed(int(state[0]) << 32 | int(state[1]))


@dataclasses.dataclass
class Run:
    """One sampler run's record (see the module's notes)."""

    route: str
    sampler_calls: int = 0
    unet_evaluations: int = 0
    k1_launches: List[int] = dataclasses.field(default_factory=lambda: [0, 0])
    k2_launches_by_variant: Dict[str, int] = dataclasses.field(default_factory=dict)
    capture_s: Optional[float] = None
    instantiate_s: Optional[float] = None
    pool_bytes: Optional[int] = None
    graphs: int = 0

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


class RunMeter:
    """Counts one run: ``start`` before its first sampler call, ``call`` around
    each, ``finish`` after its last (while ``score`` lives)."""

    def __init__(self, score: CountedScore, graph: bool):
        self.score, self.graph = score, graph
        self.run = Run(route="graph" if graph else "eager")
        self._before = launches.snapshot()

    def call(self, fn: Callable[[], torch.Tensor]) -> torch.Tensor:
        out = fn()
        self.run.sampler_calls += 1
        return out

    def finish(self) -> Run:
        run = self.run
        if self.graph:
            held = graphs.captured(self.score)
            run.graphs = len(held)
            # each capture traced the loop WARMUP_CALLS + 1 times and each
            # call replayed once: executions = warm-ups of every graph + calls
            traced = capture.WARMUP_CALLS + 1
            per_call = self.score.calls // (traced * max(1, run.graphs))
            run.unet_evaluations = per_call * (capture.WARMUP_CALLS * run.graphs
                                               + run.sampler_calls)
            if held:
                run.capture_s = sum(g.capture_s for g in held)
                run.instantiate_s = sum(g.instantiate_s for g in held)
                run.pool_bytes = sum(g.pool_bytes for g in held)
        else:
            run.unet_evaluations = self.score.calls
        ran = launches.since(self._before)
        run.k1_launches = [ran["conv3x3_stats"], ran["gn_apply"]]
        run.k2_launches_by_variant = {v: ran[f"flash_attention_fwd_{v}"]
                                      for v in k2.VARIANTS.values()}
        return run

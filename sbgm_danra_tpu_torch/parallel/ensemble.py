"""Ensembles of one condition on one card (counterpart of
``sbgm_danra_tpu/parallel/ensemble.py``).

JAX runs an N-member ensemble as one compiled reverse-SDE scan, its member
axis sharded over the mesh. Here the members are the batch of one sampler
call on one card: on a CUDA device one replay of the sampler's graph
(``sampling/graphs.py``), on the CPU the eager loop. One ``torch.Generator``
draws the noise of the whole batch, as JAX draws it from one key. A mesh
(member sharding over cards) waits for ROADMAP Queue 1 item 7 (``parallel/``
on ``torch.distributed``): ``mesh`` not None raises and never runs on one card
in its place.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence

import torch

from sbgm_danra_tpu_torch.capture import use_graphs
from sbgm_danra_tpu_torch.sampling import graphs
from sbgm_danra_tpu_torch.sampling.samplers import SamplerConfig
from sbgm_danra_tpu_torch.sde import VESDE


def repeat_condition(cond: Dict[str, Optional[torch.Tensor]],
                     n_members: int) -> Dict[str, Optional[torch.Tensor]]:
    """Tile a single condition (its first row) to the member axis."""
    out = {}
    for k, v in cond.items():
        if v is None:
            out[k] = None
            continue
        v = torch.as_tensor(v)
        out[k] = v[:1].repeat((n_members,) + (1,) * (v.dim() - 1))
    return out


def generate_ensemble(
    score_fn: Callable,
    rng: torch.Generator,
    n_members: int,
    sample_shape: Sequence[int],
    cond: Optional[Dict[str, Optional[torch.Tensor]]] = None,
    sampler: str = "pc_sampler",
    sde=VESDE(),
    config: SamplerConfig = SamplerConfig(),
    mesh=None,
    capture: Optional[bool] = None,
) -> torch.Tensor:
    """``n_members`` samples of one condition, as one sampler call of
    ``n_members`` rows. sample_shape: per member (H, W, C); returns
    (n_members, H, W, C) on ``rng``'s device. ``capture``: see
    ``capture.use_graphs``."""
    if mesh is not None:
        raise NotImplementedError(
            "generate_ensemble(mesh=...) shards members over cards, which is not ported to "
            "sbgm_danra_tpu_torch yet: ROADMAP Queue 1 item 7 (parallel/ on torch.distributed)")
    shape = (n_members, *sample_shape)
    full_cond = repeat_condition(cond or {}, n_members)
    with torch.no_grad():
        return graphs.call(sampler, score_fn, rng, shape, sde, config, cond=full_cond,
                           graph=use_graphs(capture, rng.device))

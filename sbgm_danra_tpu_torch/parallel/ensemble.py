"""Member-sharded ensembles of one condition (counterpart of
``sbgm_danra_tpu/parallel/ensemble.py``).

JAX runs an N-member ensemble as one compiled reverse-SDE scan, its member
axis sharded over the mesh's ``data`` axis. Here the members are the batch of
one sampler call: on a CUDA device one replay of the sampler's graph
(``sampling/graphs.py``), on the CPU the eager loop. One ``torch.Generator``
draws the noise of the whole batch, as JAX draws it from one key.

With a mesh (``parallel/mesh.py``) the members are padded to a multiple of
the mesh's ranks (so that ANY member count takes the sharded route), and
every rank draws the whole padded call's noise from the same generator
(``samplers.draw_noise``, the single call's numbers), keeps its rows, runs
them as one sampler call, and the members are all-gathered over ``data``
and trimmed: the rows are the single call's rows, up to the sampler's
batch-size rounding (cuDNN picks its algorithm by batch).
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence

import torch

from sbgm_danra_tpu_torch.capture import use_graphs
from sbgm_danra_tpu_torch.parallel import collectives as C
from sbgm_danra_tpu_torch.parallel.mesh import DATA_AXIS
from sbgm_danra_tpu_torch.sampling import graphs
from sbgm_danra_tpu_torch.sampling import samplers as S
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


def member_draws(sampler, rng: torch.Generator, n_run: int, sample_shape: Sequence[int],
                 config: SamplerConfig) -> torch.Tensor:
    """The noise of one call of ``n_run`` members: ``[n_draws, n_run, *sample_shape]``."""
    fn = S.get_sampler(sampler) if isinstance(sampler, str) else sampler
    rk45 = fn is S.ode_sampler and config.ode_method == "rk45"
    n = 1 if rk45 else S.n_draws(fn, config)
    return S.draw_noise(rng, (n_run, *sample_shape), n)


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
    """``n_members`` samples of one condition. sample_shape: per member (H, W,
    C); returns (n_members, H, W, C) on ``rng``'s device, on every rank of a
    mesh. ``capture``: see ``capture.use_graphs``."""
    graph = use_graphs(capture, rng.device)
    if mesh is None:
        shape = (n_members, *sample_shape)
        with torch.no_grad():
            return graphs.call(sampler, score_fn, rng, shape, sde, config,
                               cond=repeat_condition(cond or {}, n_members), graph=graph)
    n_dev = mesh.size
    n_run = ((n_members + n_dev - 1) // n_dev) * n_dev
    n_data, i = mesh.axis_size(DATA_AXIS), mesh.axis_index(DATA_AXIS)
    per = n_run // n_data
    draws = member_draws(sampler, rng, n_run, sample_shape, config)[:, i * per:(i + 1) * per]
    with torch.no_grad():
        mine = graphs.call(sampler, score_fn, None, (per, *sample_shape), sde, config,
                           cond=repeat_condition(cond or {}, per), graph=graph,
                           draws=draws.contiguous())
        out = C.all_gather(mine, mesh.group(DATA_AXIS), 0)
    return out[:n_members] if n_run != n_members else out

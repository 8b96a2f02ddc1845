"""Full-DANRA-domain sampling (counterpart of ``sbgm_danra_tpu/evaluate/full_domain.py:33-87``).

The 589x789 HR grid is padded to 608x800, the next multiples of 32 for the
five-stage pyramid, sampled whole, and cropped back. Continuous fields and the
geo value channels are edge-replicated; the CFG mask channels are
zero-padded, so that padding does not claim conditioning outside the domain.
At 608x800 decoder block 1 attends over 76x100 = 7,600 tokens, which sends
that layer to the CUDA flash kernel when the model's attention backend is
'pallas'. A float32 model (``compute_dtype="float32"``) samples with TF32 off
(``precision.exact_fp32``). On the card the sampler runs as one replay of its
captured CUDA graph (``sampling/graphs.py``), unless the caller asks for the
eager loop (``capture=False``); on the CPU it runs the eager loop.

Spans (``utils/profiling.span``): ``domain.field`` a call, holding
``domain.pad``, the sampler's ``sample.inputs`` / ``sample.replay``
(``sampling/graphs.py``), ``domain.sync`` (the host blocked until the card
has finished) and ``domain.fetch`` (the crop and the copy out).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from sbgm_danra_tpu_torch.capture import use_graphs
from sbgm_danra_tpu_torch.precision import exact_fp32
from sbgm_danra_tpu_torch.sampling import graphs
from sbgm_danra_tpu_torch.sampling.samplers import Rng, SamplerConfig, get_sampler
from sbgm_danra_tpu_torch.sde import VESDE
from sbgm_danra_tpu_torch.utils.profiling import span

PYRAMID_MULTIPLE = 32  # stride of the deepest encoder stage


def padded_dims(h: int, w: int, multiple: int = PYRAMID_MULTIPLE) -> Tuple[int, int]:
    return (-(-h // multiple) * multiple, -(-w // multiple) * multiple)


def pad_field(x: torch.Tensor, target_hw: Tuple[int, int], mode: str = "edge") -> torch.Tensor:
    """Pad NHWC (or NHW) spatial dims up to ``target_hw``; 'edge' or 'constant' (zeros)."""
    h, w = x.shape[1], x.shape[2]
    ph, pw = target_hw[0] - h, target_hw[1] - w
    if ph < 0 or pw < 0:
        raise ValueError(f"target {target_hw} smaller than field {(h, w)}")
    if ph == 0 and pw == 0:
        return x
    nchw = x.unsqueeze(1) if x.dim() == 3 else x.permute(0, 3, 1, 2)
    torch_mode = {"edge": "replicate", "constant": "constant"}[mode]
    out = F.pad(nchw, (0, pw, 0, ph), mode=torch_mode)
    return out[:, 0] if x.dim() == 3 else out.permute(0, 2, 3, 1)


def pad_conditioning(
    cond: Dict[str, Optional[torch.Tensor]], target_hw: Tuple[int, int]
) -> Dict[str, Optional[torch.Tensor]]:
    """Pad each spatial conditioning field; a geo map's value channel is
    edge-padded and its mask channel zero-padded."""
    out: Dict[str, Optional[torch.Tensor]] = {}
    for key, v in cond.items():
        if v is None or v.dim() < 3:
            out[key] = v
        elif key in ("lsm_cond", "topo_cond") and v.shape[-1] == 2:
            value = pad_field(v[..., :1], target_hw, "edge")
            mask = pad_field(v[..., 1:], target_hw, "constant")
            out[key] = torch.cat([value, mask], dim=-1)
        else:
            out[key] = pad_field(v, target_hw, "edge")
    return out


def sample_full_domain(
    score_fn,
    rng: Rng,
    cond: Dict[str, torch.Tensor],
    domain_hw: Tuple[int, int] = (589, 789),
    batch: int = 1,
    sde=VESDE(),
    config: SamplerConfig = SamplerConfig(),
    sampler: str = "pc_sampler",
    compute_dtype: Optional[str] = None,
    capture: Optional[bool] = None,
) -> np.ndarray:
    """Generate full-domain HR fields; returns (batch, H, W) cropped to the domain.

    Noise is drawn on ``rng``'s device, which must be the device of ``cond``
    and of the model behind ``score_fn``. ``compute_dtype`` is the model's
    (``ModelSpec.compute_dtype``): "float32" turns TF32 off for the sampler's call.
    ``capture``: None takes the sampler's CUDA graph on the card and the eager
    loop on the CPU; False the eager loop (``capture.use_graphs``). A graph is
    kept per ``score_fn``: pass the same callable to replay it.
    """
    with span("domain.field"):
        target = padded_dims(*domain_hw)
        with span("domain.pad"):
            padded = pad_conditioning(cond, target)
        sampler_fn = get_sampler(sampler)
        shape = (batch, target[0], target[1], 1)
        device = rng.device if isinstance(rng, torch.Generator) else rng[0].device
        with exact_fp32(compute_dtype), torch.inference_mode():
            out = graphs.call(sampler_fn, score_fn, rng, shape, sde, config, cond=padded,
                              graph=use_graphs(capture, device))
        with span("domain.sync"):
            if device.type == "cuda":
                torch.cuda.current_stream(device).synchronize()
        with span("domain.fetch"):
            return out[:, : domain_hw[0], : domain_hw[1], 0].float().cpu().numpy()

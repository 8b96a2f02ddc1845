"""What decides ``correct``: the program's fields against the plain reference's.

Each field the check samples is worked out again by ``portbench/reference``
from the same inputs (weights, conditioning, latent noise), in float32 with
TF32 off, and the number compared is the relative L2 gap of the sampled
fields taken together, sqrt(sum ||program - reference||^2 / sum
||reference||^2), steadier from seed to seed than the worst field's, which
swings with the one field whose trajectory parts most. With ``control`` the
reference also runs with every product's operands rounded to fp8 e4m3, the
precision below the bf16 that the configurations state, in the program's
place: that reading has to fail the limit.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from portbench.reference import sampling as ref_sampling
from portbench.reference.unet import UNet, exact, fake_bf16, fake_fp8, identity


def sq_norms(got, want: torch.Tensor) -> tuple:
    """(||got - want||^2, ||want||^2) in float64."""
    got = torch.as_tensor(np.asarray(got), dtype=torch.float64)
    want = want.detach().double().cpu().reshape(got.shape)
    return float(((got - want) ** 2).sum()), float((want ** 2).sum())


def reference_fields(cfg: dict, weights: Dict[str, torch.Tensor], z: torch.Tensor,
                     cond: Dict[str, torch.Tensor], quant=identity,
                     domain_hw: Optional[tuple] = None) -> torch.Tensor:
    """The configuration's sampler on the reference UNet from latent ``z``
    ([B, H, W, 1] at the sampled size) and ``cond`` (at ``domain_hw`` when the
    field is padded to the pyramid and cropped back); [B, h, w] float32."""
    params = {k: v.float() for k, v in weights.items()}
    net = UNet(params, cfg, quant)
    sampler = cfg["sampler"]
    if domain_hw is not None:
        cond = ref_sampling.pad_conditioning(cond, tuple(z.shape[1:3]))
    fn = ref_sampling.SAMPLERS[sampler["name"]]
    with exact(), torch.no_grad():
        out = fn(net, z, cond, sampler, cfg["sde"]["sigma"])
    if domain_hw is not None:
        out = out[:, : domain_hw[0], : domain_hw[1]]
    return out[..., 0]


def field_check(cfg: dict, weights, items: List[dict], limit: float, control: bool,
                domain_hw: Optional[tuple] = None) -> Dict[str, dict]:
    """``items``: dicts of the program's ``got`` fields [b, h, w], their latent
    ``z`` and their ``cond``. Returns the checks: the items' relative gap
    against ``limit``; with ``control`` also the fp8 reference's (the control)
    and the bf16-emulating reference's (a check of the emulation)."""
    others = {"control": fake_fp8, "emulated_bf16": fake_bf16} if control else {}
    gaps = {name: np.zeros(2) for name in ("", *others)}
    for it in items:
        want = reference_fields(cfg, weights, it["z"], it["cond"], domain_hw=domain_hw)
        gaps[""] += sq_norms(it["got"], want)
        for name, quant in others.items():
            got = reference_fields(cfg, weights, it["z"], it["cond"], quant, domain_hw)
            gaps[name] += sq_norms(got.cpu().numpy(), want)
    return {(f"{name}_" if name else "") + "fields_rel_l2":
            {"value": float(np.sqrt(g[0] / g[1])), "limit": limit} for name, g in gaps.items()}


def free_program() -> None:
    """Drop the program's CUDA graphs and cached blocks before the reference runs."""
    from sbgm_danra_tpu_torch.sampling import graphs

    graphs.clear()
    if torch.cuda.is_available():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()

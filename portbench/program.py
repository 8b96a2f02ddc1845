"""The system under test, built from a configuration and the benchmark's
weights: the port's score UNet and its sampler settings. Only the port's
public entry points are used."""

from __future__ import annotations

from typing import Dict

import torch


def spec(cfg: dict):
    from sbgm_danra_tpu_torch.models.unet import ModelSpec

    m = cfg["model"]
    return ModelSpec(
        in_channels=m["in_channels"], output_channels=1, time_embedding=m["time_embedding"],
        last_fmap_channels=m["last_fmap_channels"], num_heads=m["num_heads"],
        block_layers=tuple(m["block_layers"]), num_classes=m["num_classes"],
        decoder_gn_groups=m["decoder_gn_groups"], decoder_activation=m["decoder_activation"],
        attention_backend=m["attention_backend"], compute_dtype=m["compute_dtype"],
        encoder_attn_stages=m["encoder_attn_stages"],
        decoder_attn_blocks=m["decoder_attn_blocks"])


def model(cfg: dict, weights: Dict[str, torch.Tensor], device) -> torch.nn.Module:
    """The port's ScoreUNet on ``device`` with ``weights`` loaded (built there
    with the port's own initialisation, then overwritten)."""
    from sbgm_danra_tpu_torch.models.unet import build_score_model
    from sbgm_danra_tpu_torch.sde import VESDE

    dev = torch.device(device)
    with torch.device(dev):
        net = build_score_model(spec(cfg), VESDE(sigma=cfg["sde"]["sigma"]),
                                generator=torch.Generator(dev).manual_seed(0))
    net.load_state_dict(weights)
    return net.eval()


def sampler_config(cfg: dict):
    from sbgm_danra_tpu_torch.sampling.samplers import SamplerConfig

    s = cfg["sampler"]
    return SamplerConfig(num_steps=s["num_steps"], eps=s["eps"], snr=s.get("snr", 0.16),
                         guidance_scale=s["guidance_scale"], edm_rho=s["edm_rho"])


def sde(cfg: dict):
    from sbgm_danra_tpu_torch.sde import VESDE

    return VESDE(sigma=cfg["sde"]["sigma"])


def memory_peak(device) -> int:
    dev = torch.device(device)
    return int(torch.cuda.max_memory_allocated(dev)) if dev.type == "cuda" else 0

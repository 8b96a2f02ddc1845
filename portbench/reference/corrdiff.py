"""Plain PyTorch reference of CorrDiff (arXiv:2309.15214) as a function of a
parameter dict: the regression SongUNet, the EDM-preconditioned residual
SongUNet, and EDM's Heun sampler (Algorithm 1 of Karras et al. 2022, no
churn) over the rho-grid from sigma_max to sigma_min, summed.

It follows NVlabs/edm ``training/networks.py`` (``SongUNet``, ``UNetBlock``,
``PositionalEmbedding``, ``Conv2d`` with the [1, 1] resample filter,
``GroupNorm``, ``AttentionOp``) with SongUNet's DDPM++ settings, and
PhysicsNeMo's ``EDMPrecondSR`` for the preconditioning, written out here with
plain ``torch`` operations in float32 and NCHW:

- a block: ``h = conv0(resample(silu(GN0(x))))``, ``h = silu(GN1(h +
  affine(emb)))``, ``h = conv1(h)``, ``x = (h + skip(resample(x))) / sqrt(2)``
  (skip: a 1x1 conv where the channels change or the block resamples), then
  with attention ``x = (proj(attend(qkv(GN2(x)))) + x) / sqrt(2)``: one head,
  q, k, v interleaved in qkv's channels, the softmax of q^T k / sqrt(C);
  GroupNorm with min(32, C / 4) groups and eps 1e-6; resampling by a 2x2
  mean (down) and nearest neighbour (up);
- the nets' input is [x, lsm, topo, cond_img, grid] (the system's
  conditioning; grid: sin and cos of pi u and of pi v over [-1, 1], u along
  the rows, v along the columns); the regression net's x is 0 and its
  embedding 0; the residual net's input is [c_in x, cond, grid] at
  c_noise = ln(sigma) / 4 with the positional embedding (sin, cos) of 128
  channels and two SiLU linears; ``D = c_skip x + c_out F``;
- Heun from x = 800 z: ``d = (x - D(x; s_i)) / s_i``, a predictor to
  s_{i+1} and the trapezoid, over every interval of the 18-point grid (it
  stops at sigma_min, as the program's ``edm_sampler`` does).

Parameter names are the program's state_dict names (``regression.enc.448x448_
block0.conv0.weight``), so one dict of weights from ``make_weights`` feeds
both. ``quant`` rounds every tensor that the program keeps in its compute
dtype: every product's operands and result, each norm's, activation's and
sum's result (the embedding's sinusoids and the preconditioning stay fp32):
``fake_fp8`` for the control, ``fake_bf16`` for the emulation. The caller
turns TF32 off (``exact``). Rows are independent, so ``sample`` works through
the batch in blocks of rows. Imports nothing of the port.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from portbench.inputs import sub_seed
from portbench.reference.sampling import karras_grid
from portbench.reference.unet import Params, Quant, identity

NETS = ("regression", "residual")


def arch(cfg: dict) -> dict:
    """The sizes the nets need from a configuration file's ``model``."""
    m = cfg["model"]
    return dict(
        in_channels=m["out_channels"] + m["cond_channels"] + m["grid_channels"],
        out_channels=m["out_channels"], res=m["img_resolution"], mc=m["model_channels"],
        mult=list(m["channel_mult"]), emb=m["model_channels"] * m["channel_mult_emb"],
        noise=m["model_channels"] * m["channel_mult_noise"], blocks=m["num_blocks"],
        attn=list(m["attn_resolutions"]), sigma_data=m["sigma_data"])


def blocks(cfg: dict) -> list:
    """Every layer of one net in order, as (section, name, kind, cin, cout,
    resolution, flags): kind "conv" (the first 3x3), "block", "aux_norm",
    "aux_conv"; flags of a block: up, down, attention."""
    a = arch(cfg)
    out, cout = [], a["in_channels"]
    for level, mult in enumerate(a["mult"]):
        res = a["res"] >> level
        if level == 0:
            out.append(("enc", f"{res}x{res}_conv", "conv", cout, a["mc"], res, {}))
            cout = a["mc"]
        else:
            out.append(("enc", f"{res}x{res}_down", "block", cout, cout, res, dict(down=True)))
        for idx in range(a["blocks"]):
            cin, cout = cout, a["mc"] * mult
            out.append(("enc", f"{res}x{res}_block{idx}", "block", cin, cout, res,
                        dict(attention=res in a["attn"])))
    skips = [c for _, _, _, _, c, _, _ in out]
    last = len(a["mult"]) - 1
    for level, mult in reversed(list(enumerate(a["mult"]))):
        res = a["res"] >> level
        if level == last:
            out.append(("dec", f"{res}x{res}_in0", "block", cout, cout, res, dict(attention=True)))
            out.append(("dec", f"{res}x{res}_in1", "block", cout, cout, res, {}))
        else:
            out.append(("dec", f"{res}x{res}_up", "block", cout, cout, res, dict(up=True)))
        for idx in range(a["blocks"] + 1):
            cin, cout = cout + skips.pop(), a["mc"] * mult
            attn = idx == a["blocks"] and res in a["attn"]
            out.append(("dec", f"{res}x{res}_block{idx}", "block", cin, cout, res,
                        dict(attention=attn, cat=True)))
    res = a["res"]
    out.append(("dec", f"{res}x{res}_aux_norm", "aux_norm", cout, cout, res, {}))
    out.append(("dec", f"{res}x{res}_aux_conv", "aux_conv", cout, a["out_channels"], res, {}))
    return out


def param_shapes(cfg: dict) -> Dict[str, Tuple[int, ...]]:
    """Every parameter of both nets by name, with its shape."""
    a = arch(cfg)
    out: Dict[str, Tuple[int, ...]] = {}

    def conv(name, cin, cout, k):
        out[f"{name}.weight"] = (cout, cin, k, k)
        out[f"{name}.bias"] = (cout,)

    def vec(name, c, *leaves):
        for leaf in leaves:
            out[f"{name}.{leaf}"] = (c,)

    for net in NETS:
        if net == "residual":
            out[f"{net}.map_layer0.weight"] = (a["emb"], a["noise"])
            vec(f"{net}.map_layer0", a["emb"], "bias")
            out[f"{net}.map_layer1.weight"] = (a["emb"], a["emb"])
            vec(f"{net}.map_layer1", a["emb"], "bias")
        for section, name, kind, cin, cout, _, flags in blocks(cfg):
            p = f"{net}.{section}.{name}"
            if kind in ("conv", "aux_conv"):
                conv(p, cin, cout, 3)
            elif kind == "aux_norm":
                vec(p, cout, "weight", "bias")
                continue
            else:
                vec(f"{p}.norm0", cin, "weight", "bias")
                conv(f"{p}.conv0", cin, cout, 3)
                out[f"{p}.affine.weight"] = (cout, a["emb"])
                vec(f"{p}.affine", cout, "bias")
                vec(f"{p}.norm1", cout, "weight", "bias")
                conv(f"{p}.conv1", cout, cout, 3)
                if cin != cout or flags.get("up") or flags.get("down"):
                    conv(f"{p}.skip", cin, cout, 1)
                if flags.get("attention"):
                    vec(f"{p}.norm2", cout, "weight", "bias")
                    conv(f"{p}.qkv", cout, 3 * cout, 1)
                    conv(f"{p}.proj", cout, cout, 1)
    return out


def make_weights(cfg: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """Every parameter of both nets, float32 on ``device``, from one normal
    draw on a generator there (clipped at two stds): weights of products
    lecun-normal (1 / fan-in, as if untruncated), norm scales 1 +- 0.05,
    biases and norm shifts 0 +- 0.05. No weight is zero: EDM's own
    initialisation scales the blocks' conv1 and proj and the output conv by
    1e-5, which would leave the nets' outputs at their biases."""
    shapes = param_shapes(cfg)
    names = list(shapes)
    sizes = [int(np.prod(shapes[n])) for n in names]
    laws = np.array([((0.0, (1.0 / np.prod(shapes[n][1:])) ** 0.5 / 0.8796256610342398)
                      if len(shapes[n]) >= 2 else
                      (1.0, 0.05) if n.endswith(".weight") else (0.0, 0.05)) for n in names],
                    np.float32)
    gen = torch.Generator(device).manual_seed(sub_seed(seed, 0))
    flat = torch.randn(sum(sizes), generator=gen, device=device).clamp_(-2.0, 2.0)
    counts = torch.tensor(sizes, device=device)
    law = torch.from_numpy(laws).to(device)
    flat.mul_(law[:, 1].repeat_interleave(counts)).add_(law[:, 0].repeat_interleave(counts))
    return dict(zip(names, (t.view(shapes[n]) for n, t in zip(names, flat.split(sizes)))))


def grid_channels(h: int, w: int, device) -> torch.Tensor:
    """[1, 4, h, w]: sin(pi u), cos(pi u), sin(pi v), cos(pi v)."""
    u = torch.linspace(-1.0, 1.0, h, device=device)[:, None].expand(h, w)
    v = torch.linspace(-1.0, 1.0, w, device=device)[None, :].expand(h, w)
    return torch.stack([torch.sin(math.pi * u), torch.cos(math.pi * u),
                        torch.sin(math.pi * v), torch.cos(math.pi * v)])[None]


class SongUNet:
    """``SongUNet(params, net, cfg, quant)(x, noise_labels)``: one net, NCHW float32."""

    def __init__(self, params: Params, net: str, cfg: dict, quant: Quant = identity):
        self.p, self.net, self.cfg, self.a, self.q = params, net, cfg, arch(cfg), quant

    def w(self, name: str) -> torch.Tensor:
        return self.p[f"{self.net}.{name}"]

    def conv(self, name: str, x: torch.Tensor) -> torch.Tensor:
        w = self.w(f"{name}.weight")
        return self.q(F.conv2d(self.q(x), self.q(w), self.w(f"{name}.bias"),
                               padding=w.shape[-1] // 2))

    def linear(self, name: str, x: torch.Tensor) -> torch.Tensor:
        return self.q(F.linear(self.q(x), self.q(self.w(f"{name}.weight")),
                               self.w(f"{name}.bias")))

    def gn(self, name: str, x: torch.Tensor) -> torch.Tensor:
        groups = min(32, x.shape[1] // 4)
        return self.q(F.group_norm(x, groups, self.w(f"{name}.weight"), self.w(f"{name}.bias"),
                                   1e-6))

    def silu(self, x: torch.Tensor) -> torch.Tensor:
        return self.q(F.silu(x))

    def embed(self, noise_labels: torch.Tensor) -> torch.Tensor:
        a = self.a
        if self.net == "regression":
            return torch.zeros((noise_labels.shape[0], a["emb"]), device=noise_labels.device)
        half = a["noise"] // 2
        freqs = (1.0 / 10000) ** (torch.arange(half, dtype=torch.float32,
                                               device=noise_labels.device) / (half - 1))
        x = torch.outer(noise_labels.float(), freqs)
        emb = torch.cat([x.cos(), x.sin()], dim=1)
        emb = emb.reshape(emb.shape[0], 2, -1).flip(1).reshape(emb.shape)  # swap to (sin, cos)
        emb = self.silu(self.linear("map_layer0", emb))
        return self.silu(self.linear("map_layer1", emb))

    def block(self, name: str, x: torch.Tensor, emb: torch.Tensor, flags: dict) -> torch.Tensor:
        def resample(t):
            if flags.get("up"):
                return t.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)
            if flags.get("down"):
                return F.avg_pool2d(t, 2)
            return t

        h = self.conv(f"{name}.conv0", resample(self.silu(self.gn(f"{name}.norm0", x))))
        h = self.silu(self.gn(f"{name}.norm1", h + self.linear(f"{name}.affine", emb)[:, :, None,
                                                                                    None]))
        h = self.conv(f"{name}.conv1", h)
        skip = resample(x)
        if f"{self.net}.{name}.skip.weight" in self.p:
            skip = self.conv(f"{name}.skip", skip)
        x = self.q(self.q(h + skip) / math.sqrt(2.0))
        if flags.get("attention"):
            n, c, hh, ww = x.shape
            qkv = self.conv(f"{name}.qkv", self.gn(f"{name}.norm2", x))
            q, k, v = qkv.reshape(n, c, 3, hh * ww).unbind(2)
            w = torch.softmax(torch.einsum("ncq,nck->nqk", q, k / math.sqrt(c)), dim=2)
            a = self.q(torch.einsum("nqk,nck->ncq", self.q(w), v))
            x = self.q(self.q(self.conv(f"{name}.proj", a.reshape(n, c, hh, ww)) + x)
                       / math.sqrt(2.0))
        return x

    def __call__(self, x: torch.Tensor, noise_labels: torch.Tensor) -> torch.Tensor:
        emb = self.embed(noise_labels)
        skips, tmp = [], None
        for section, name, kind, _, _, _, flags in blocks(self.cfg):
            path = f"{section}.{name}"
            if kind == "conv":
                x = self.conv(path, x)
            elif kind == "aux_norm":
                tmp = self.gn(path, x)
            elif kind == "aux_conv":
                x = self.conv(path, self.silu(tmp))
            else:
                if flags.get("cat"):
                    x = torch.cat([x, skips.pop()], dim=1)
                x = self.block(path, x, emb, flags)
            if section == "enc":
                skips.append(x)
        return x


def _inputs(x: torch.Tensor, cond: Dict[str, Optional[torch.Tensor]]) -> torch.Tensor:
    """NCHW [x, lsm, topo, cond_img, grid] from NHWC parts."""
    parts = [x] + [cond[k] for k in ("lsm_cond", "topo_cond", "cond_img")
                   if cond.get(k) is not None]
    h = torch.cat([t.float() for t in parts], dim=-1).permute(0, 3, 1, 2)
    grid = grid_channels(h.shape[2], h.shape[3], h.device).expand(h.shape[0], -1, -1, -1)
    return torch.cat([h, grid], dim=1)


def mean(params: Params, cfg: dict, cond, quant: Quant = identity) -> torch.Tensor:
    """The regression net's field, NHWC float32."""
    first = next(v for v in cond.values() if v is not None)
    b, h, w, _ = first.shape
    zeros = torch.zeros((b, h, w, cfg["model"]["out_channels"]), device=first.device)
    out = SongUNet(params, "regression", cfg, quant)(_inputs(zeros, cond),
                                                       torch.zeros(b, device=first.device))
    return out.permute(0, 2, 3, 1)


def denoise(net: SongUNet, x: torch.Tensor, sigma: float, cond) -> torch.Tensor:
    """EDMPrecondSR's D(x; sigma), NHWC float32."""
    sd = net.a["sigma_data"]
    c_skip = sd * sd / (sigma * sigma + sd * sd)
    c_out = sigma * sd / math.sqrt(sigma * sigma + sd * sd)
    c_in = 1.0 / math.sqrt(sd * sd + sigma * sigma)
    labels = torch.full((x.shape[0],), math.log(sigma) / 4.0, device=x.device)
    f = net(_inputs(c_in * x, cond), labels).permute(0, 2, 3, 1)
    return c_skip * x + c_out * f


def residual(params: Params, cfg: dict, z: torch.Tensor, cond, quant: Quant = identity):
    """EDM's Heun sampler on the residual net from x = sigma_max z, NHWC float32."""
    s = cfg["sampler"]
    sigmas = karras_grid(s["num_steps"], s["sigma_min"], cfg["sde"]["sigma_max"], s["edm_rho"])
    net = SongUNet(params, "residual", cfg, quant)
    x = z.float() * float(sigmas[0])
    for i in range(len(sigmas) - 1):
        s0, s1 = float(sigmas[i]), float(sigmas[i + 1])
        d = (x - denoise(net, x, s0, cond)) / s0
        x_pred = x + (s1 - s0) * d
        d_pred = (x_pred - denoise(net, x_pred, s1, cond)) / s1
        x = x + (s1 - s0) * 0.5 * (d + d_pred)
    return x


def sample(params: Params, cfg: dict, z: torch.Tensor, cond, quant: Quant = identity,
           rows: int = 4) -> torch.Tensor:
    """CorrDiff's fields, mean + residual, [B, H, W] float32, from the latent
    ``z`` [B, H, W, 1] and each row's conditioning ``cond`` (NHWC), ``rows``
    rows at a time."""
    params = {k: v.float() for k, v in params.items()}
    out = []
    with torch.no_grad():
        for i in range(0, z.shape[0], rows):
            part = {k: None if v is None else v[i: i + rows] for k, v in cond.items()}
            field = mean(params, cfg, part, quant) + residual(params, cfg, z[i: i + rows],
                                                               part, quant)
            out.append(field[..., 0])
    return torch.cat(out)

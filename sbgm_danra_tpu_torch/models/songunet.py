"""CorrDiff: a regression SongUNet and an EDM-preconditioned residual SongUNet.

"Residual Corrective Diffusion Modeling for Km-scale Atmospheric Downscaling"
(Mardani et al., arXiv:2309.15214), as NVIDIA PhysicsNeMo releases it
(``examples/generative/corrdiff``): two UNets of one shape, SongUNet in its
DDPM++ form (NVlabs/edm ``training/networks.py``). The regression net gives
the conditional mean from the coarse inputs; the residual net, under EDM's
preconditioning, is sampled for ``y - mean`` with EDM's Heun sampler
(``evaluate/corrdiff.py``), and the two are added. No JAX counterpart.

Notation: ``G = min(32, C / 4)`` GroupNorm groups, eps 1e-6; ``s`` = sqrt(1/2).

- Embedding (residual net): EDM's positional embedding of ``c_noise`` with
  ``model_channels * channel_mult_noise`` channels, ``freqs = (1/10000) **
  (arange(n/2) / (n/2 - 1))``, as (sin, cos); then ``SiLU(Linear)`` twice to
  ``model_channels * channel_mult_emb``. The regression net's embedding is 0.
- ``UNetBlock(cin, cout)``: ``h = conv0(resample(SiLU(GN0(x))))``;
  ``h = SiLU(GN1(h + affine(emb)[n, c]))``; ``h = conv1(dropout(h))``;
  ``x = s (h + skip(resample(x)))``, the skip a 1x1 conv where cin != cout or
  the block resamples (2x2 mean pool down, nearest 2x up); with attention,
  one head of ``cout`` channels over the map's pixels from a 1x1 ``qkv`` of
  ``GN2(x)`` (EDM's channel layout: q, k, v interleaved), ``x = s (proj(a) +
  x)``.
- Encoder, per level ``l`` (resolution ``img_resolution / 2^l``): a 3x3 conv
  (level 0) or a down block, then ``num_blocks`` blocks, attention at the
  ``attn_resolutions``; every output is a skip. Decoder from the coarsest
  level: two blocks (the first with attention) at the coarsest, an up block
  at each finer one, then ``num_blocks + 1`` blocks on ``cat(x, skip)``, the
  last of a level with attention at the ``attn_resolutions``; the output
  ``conv3x3(SiLU(GN(x)))``. Module names are EDM's (``enc.448x448_block0``).
- Preconditioning (sigma_data 0.5): ``D(x; sigma) = c_skip x + c_out
  F(cat(c_in x, cond), ln(sigma) / 4)``; the samplers read the score
  ``(D - x) / sigma^2`` (``CorrDiff.forward``), at t = sigma (``sde.EDMSDE``).
- Conditioning: the system's own, NHWC ``[x, lsm, topo, cond_img, grid]``,
  where grid holds 4 sinusoidal channels (PhysicsNeMo's ``gridtype:
  sinusoidal``, ``N_grid_channels: 4``): sin and cos of pi u and of pi v, u
  along the rows and v along the columns, each over [-1, 1].

Numerics: the nets compute in ``compute_dtype`` (convs, linears, the blocks'
sums) with GroupNorm statistics in fp32; the embedding's sinusoids, the
preconditioning and the score are fp32. In evaluation (``train=False``) each
block's ``conv0 -> + emb -> GN1 -> SiLU`` is one K1 call
(``ops/fused_conv_gn.py``) with the embedding as its per-sample bias: on the
card the CUDA kernels, on the CPU the plain chain; ``train=True`` takes the
plain differentiable chain (``reference_chain``), as the flagship's decoder
does. The standalone GroupNorms (each block's GN0 -> SiLU, the attention's
GN2, the output's GN -> SiLU) take the port's NHWC GroupNorm kernels in
evaluation on the card (``fused_conv_gn.group_norm_cuda``: fp32 statistics of
the map in one reduction, then the normalise pass with the SiLU folded in) and
``F.group_norm`` in fp32 on the CPU and in training. The public layout is
NHWC; inside, NCHW views of channels-last memory.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from sbgm_danra_tpu_torch.models.layers import Conv2d, Linear
from sbgm_danra_tpu_torch.ops.fused_conv_gn import (
    conv3x3_gn_relu,
    group_norm_cuda,
    reference_chain,
)

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
SKIP_SCALE = math.sqrt(0.5)
GN_EPS = 1e-6
GRID_CHANNELS = 4  # sinusoidal_grid's


@dataclasses.dataclass(frozen=True)
class SongUNetSpec:
    """Static hyperparameters of CorrDiff's two nets (PhysicsNeMo's names)."""

    cond_channels: int  # the system's conditioning: LR fields, lsm and topo (value, mask)
    out_channels: int = 1
    img_resolution: int = 448
    model_channels: int = 128
    channel_mult: Tuple[int, ...] = (1, 2, 2, 2, 2)
    channel_mult_emb: int = 4
    channel_mult_noise: int = 1
    num_blocks: int = 4
    attn_resolutions: Tuple[int, ...] = (28,)
    dropout: float = 0.13
    sigma_data: float = 0.5
    compute_dtype: str = "float32"

    @property
    def in_channels(self) -> int:
        """The nets' input: the (noisy or zero) field, the conditioning, the grid."""
        return self.out_channels + self.cond_channels + GRID_CHANNELS


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def uses_kernels(device, train: bool) -> bool:
    """Whether a GroupNorm on ``device`` takes the card's kernels: on CUDA, in
    evaluation (they have no backward)."""
    return torch.device(device).type == "cuda" and not train


class GroupNorm(nn.Module):
    """EDM's GroupNorm: min(32, C / 4) groups, eps 1e-6; fp32 statistics, the
    result in ``out_dtype``, then SiLU where ``silu`` (GN0, the output's norm).

    ``forward(x, train)``: NCHW x. Where ``uses_kernels``, the NHWC kernels on
    the channels-last map (``fused_conv_gn.group_norm_cuda``), with the result
    channels-last in x's dtype; else ``F.group_norm`` of x in fp32."""

    def __init__(self, channels: int, out_dtype: torch.dtype = torch.float32,
                 silu: bool = False):
        super().__init__()
        self.num_groups, self.out_dtype, self.silu = min(32, channels // 4), out_dtype, silu
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        if uses_kernels(x.device, train):
            y = group_norm_cuda(_nhwc(x), self.weight, self.bias, self.num_groups, GN_EPS,
                                "silu" if self.silu else False)
            return _nchw(y).to(self.out_dtype)
        y = F.group_norm(x.float(), self.num_groups, self.weight, self.bias, GN_EPS)
        y = y.to(self.out_dtype)
        return F.silu(y) if self.silu else y


def resample(x: torch.Tensor, up: bool, down: bool) -> torch.Tensor:
    """EDM's [1, 1] resample filter: nearest 2x up (its transposed conv with
    the filter x 4) or a 2x2 mean pool down; NCHW."""
    if up:
        return F.interpolate(x, scale_factor=2, mode="nearest")
    if down:
        return F.avg_pool2d(x, 2)
    return x


class UNetBlock(nn.Module):
    """EDM's ``UNetBlock`` with SongUNet's settings (one attention head,
    ``skip_scale`` sqrt(1/2), ``resample_proj``, no adaptive scale)."""

    def __init__(self, in_channels: int, out_channels: int, emb_channels: int,
                 up: bool = False, down: bool = False, attention: bool = False,
                 dropout: float = 0.0, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.in_channels, self.out_channels = in_channels, out_channels
        self.up, self.down, self.dropout = up, down, dropout
        self.norm0 = GroupNorm(in_channels, dtype, silu=True)
        self.conv0 = Conv2d(in_channels, out_channels, 3, padding=1, compute_dtype=dtype)
        self.affine = Linear(emb_channels, out_channels, dtype)
        self.norm1 = GroupNorm(out_channels, dtype)
        self.conv1 = Conv2d(out_channels, out_channels, 3, padding=1, compute_dtype=dtype)
        self.skip = (Conv2d(in_channels, out_channels, 1, compute_dtype=dtype)
                     if out_channels != in_channels or up or down else None)
        self.attention = attention
        if attention:
            self.norm2 = GroupNorm(out_channels, dtype)
            self.qkv = Conv2d(out_channels, 3 * out_channels, 1, compute_dtype=dtype)
            self.proj = Conv2d(out_channels, out_channels, 1, compute_dtype=dtype)

    def forward(self, x: torch.Tensor, emb: torch.Tensor, train: bool = False) -> torch.Tensor:
        orig = x
        h = resample(self.norm0(x, train), self.up, self.down)
        params = self.affine(emb)  # [N, cout], the chain's per-sample bias
        chain = reference_chain if train else conv3x3_gn_relu
        h = chain(_nhwc(h), self.conv0.weight.permute(2, 3, 1, 0), self.conv0.bias,
                  self.norm1.weight, self.norm1.bias, groups=self.norm1.num_groups, eps=GN_EPS,
                  activation="silu", sample_bias=params)
        h = F.dropout(_nchw(h), self.dropout, training=train)
        h = self.conv1(h)
        skip = resample(orig, self.up, self.down)
        x = (h + (self.skip(skip) if self.skip is not None else skip)) * SKIP_SCALE
        if self.attention:
            n, c, hh, ww = x.shape
            q, k, v = (t.transpose(1, 2)[:, None]  # [N, 1, HW, C]
                       for t in self.qkv(self.norm2(x, train)).reshape(n, c, 3, hh * ww)
                       .unbind(2))
            a = F.scaled_dot_product_attention(q, k, v)[:, 0].transpose(1, 2)
            x = (self.proj(a.reshape(n, c, hh, ww)) + x) * SKIP_SCALE
        return x


def positional_embedding(c_noise: torch.Tensor, channels: int) -> torch.Tensor:
    """EDM's ``PositionalEmbedding(endpoint=True)`` as SongUNet uses it, with
    its halves swapped: [sin, cos] of c_noise x (1/10000)^(i / (n/2 - 1)), fp32."""
    half = channels // 2
    freqs = torch.arange(half, dtype=torch.float32, device=c_noise.device) / (half - 1)
    freqs = (1.0 / 10000) ** freqs
    x = c_noise.float()[:, None] * freqs[None, :]
    return torch.cat([x.sin(), x.cos()], dim=1)


class SongUNet(nn.Module):
    """SongUNet (DDPM++, standard encoder and decoder): NCHW ``x`` [N,
    in_channels, H, W] and ``noise_labels`` [N] -> [N, out_channels, H, W] in
    the compute dtype. ``embedding``: "positional" (the residual net) or
    "zero" (the regression net)."""

    def __init__(self, spec: SongUNetSpec, embedding: str = "positional"):
        super().__init__()
        if embedding not in ("positional", "zero"):
            raise ValueError(f"unknown embedding {embedding!r}; positional or zero")
        dtype = self.dtype = _DTYPES[spec.compute_dtype]
        mc = spec.model_channels
        self.emb_channels = mc * spec.channel_mult_emb
        self.noise_channels = mc * spec.channel_mult_noise
        self.embedding = embedding
        if embedding == "positional":
            self.map_layer0 = Linear(self.noise_channels, self.emb_channels, dtype)
            self.map_layer1 = Linear(self.emb_channels, self.emb_channels, dtype)
        block = dict(emb_channels=self.emb_channels, dropout=spec.dropout, dtype=dtype)

        self.enc = nn.ModuleDict()
        cout = spec.in_channels
        for level, mult in enumerate(spec.channel_mult):
            res = spec.img_resolution >> level
            if level == 0:
                self.enc[f"{res}x{res}_conv"] = Conv2d(cout, mc, 3, padding=1,
                                                       compute_dtype=dtype)
                cout = mc
            else:
                self.enc[f"{res}x{res}_down"] = UNetBlock(cout, cout, down=True, **block)
            for idx in range(spec.num_blocks):
                cin, cout = cout, mc * mult
                self.enc[f"{res}x{res}_block{idx}"] = UNetBlock(
                    cin, cout, attention=res in spec.attn_resolutions, **block)
        skips = [m.out_channels for m in self.enc.values()]

        self.dec = nn.ModuleDict()
        last = len(spec.channel_mult) - 1
        for level, mult in reversed(list(enumerate(spec.channel_mult))):
            res = spec.img_resolution >> level
            if level == last:
                self.dec[f"{res}x{res}_in0"] = UNetBlock(cout, cout, attention=True, **block)
                self.dec[f"{res}x{res}_in1"] = UNetBlock(cout, cout, **block)
            else:
                self.dec[f"{res}x{res}_up"] = UNetBlock(cout, cout, up=True, **block)
            for idx in range(spec.num_blocks + 1):
                cin, cout = cout + skips.pop(), mc * mult
                attn = idx == spec.num_blocks and res in spec.attn_resolutions
                self.dec[f"{res}x{res}_block{idx}"] = UNetBlock(cin, cout, attention=attn, **block)
        res = spec.img_resolution
        self.dec[f"{res}x{res}_aux_norm"] = GroupNorm(cout, dtype, silu=True)
        self.dec[f"{res}x{res}_aux_conv"] = Conv2d(cout, spec.out_channels, 3, padding=1,
                                                   compute_dtype=dtype)

    def embed(self, noise_labels: torch.Tensor) -> torch.Tensor:
        """The blocks' embedding [N, emb_channels] in the compute dtype."""
        if self.embedding == "zero":
            return torch.zeros((noise_labels.shape[0], self.emb_channels), dtype=self.dtype,
                               device=noise_labels.device)
        emb = positional_embedding(noise_labels, self.noise_channels)
        emb = F.silu(self.map_layer0(emb))
        return F.silu(self.map_layer1(emb))

    def forward(self, x: torch.Tensor, noise_labels: torch.Tensor,
                train: bool = False) -> torch.Tensor:
        emb = self.embed(noise_labels)
        x = x.to(self.dtype)
        skips = []
        for block in self.enc.values():
            x = block(x, emb, train) if isinstance(block, UNetBlock) else block(x)
            skips.append(x)
        for block in self.dec.values():
            if isinstance(block, UNetBlock):
                if x.shape[1] != block.in_channels:
                    x = torch.cat([x, skips.pop()], dim=1)
                x = block(x, emb, train)
            elif isinstance(block, GroupNorm):  # the output's aux_norm (+ SiLU), then its aux_conv
                x = block(x, train)
            else:
                x = block(x)
        return x


def sinusoidal_grid(h: int, w: int, device) -> torch.Tensor:
    """[1, h, w, 4] fp32: sin(pi u), cos(pi u), sin(pi v), cos(pi v), with u
    over the rows and v over the columns, each from -1 to 1."""
    u = torch.linspace(-1.0, 1.0, h, device=device)[:, None].expand(h, w)
    v = torch.linspace(-1.0, 1.0, w, device=device)[None, :].expand(h, w)
    return torch.stack([torch.sin(math.pi * u), torch.cos(math.pi * u),
                        torch.sin(math.pi * v), torch.cos(math.pi * v)], dim=-1)[None]


class CorrDiff(nn.Module):
    """The regression net, the residual net and the preconditioning.

    ``mean(**cond)``: the regression net on [0, cond, grid], fp32 NHWC.
    ``forward(x, t, **cond)``: the residual's score at sigma = t, ``(D(x; t) -
    x) / t^2`` in fp32, for the samplers (``sampling/samplers.py``) under
    ``sde.EDMSDE``. ``cond``: ``cond_img``, ``lsm_cond``, ``topo_cond`` (NHWC;
    any of them None), as the flagship takes them.
    """

    def __init__(self, spec: SongUNetSpec):
        super().__init__()
        self.spec = spec
        self.regression = SongUNet(spec, "zero")
        self.residual = SongUNet(spec, "positional")

    def _inputs(self, x: torch.Tensor, cond_img=None, lsm_cond=None,
                topo_cond=None) -> torch.Tensor:
        """NCHW (channels-last) [x, lsm, topo, cond_img, grid] in fp32."""
        b, h, w, _ = x.shape
        grid = sinusoidal_grid(h, w, x.device).expand(b, h, w, GRID_CHANNELS)
        parts = [x] + [c for c in (lsm_cond, topo_cond, cond_img) if c is not None] + [grid]
        return _nchw(torch.cat([p.float() for p in parts], dim=-1))

    def mean(self, cond_img=None, lsm_cond=None, topo_cond=None,
             train: bool = False) -> torch.Tensor:
        first = next(c for c in (cond_img, lsm_cond, topo_cond) if c is not None)
        b, h, w, _ = first.shape
        zeros = torch.zeros((b, h, w, self.spec.out_channels), device=first.device)
        labels = torch.zeros((b,), device=first.device)
        out = self.regression(self._inputs(zeros, cond_img, lsm_cond, topo_cond), labels, train)
        return _nhwc(out).float()

    def denoise(self, x: torch.Tensor, sigma: torch.Tensor, cond_img=None, lsm_cond=None,
                topo_cond=None, train: bool = False) -> torch.Tensor:
        """D(x; sigma), fp32 NHWC; ``sigma`` [N]."""
        sd2 = self.spec.sigma_data ** 2
        sigma = torch.as_tensor(sigma, dtype=torch.float32, device=x.device).reshape(-1)
        s = sigma.reshape(-1, 1, 1, 1)
        c_skip = sd2 / (s * s + sd2)
        c_out = s * self.spec.sigma_data / torch.sqrt(s * s + sd2)
        c_in = 1.0 / torch.sqrt(sd2 + s * s)
        c_noise = torch.log(sigma) / 4.0
        x = x.float()
        arg = self._inputs(c_in * x, cond_img, lsm_cond, topo_cond)
        f = _nhwc(self.residual(arg, c_noise, train)).float()
        return c_skip * x + c_out * f

    def forward(self, x: torch.Tensor, t: torch.Tensor, cond_img=None, lsm_cond=None,
                topo_cond=None, train: bool = False) -> torch.Tensor:
        sigma = torch.as_tensor(t, dtype=torch.float32, device=x.device).reshape(-1)
        d = self.denoise(x, sigma, cond_img, lsm_cond, topo_cond, train)
        return (d - x.float()) / (sigma * sigma).reshape(-1, 1, 1, 1)


def spec_from_config(cfg) -> SongUNetSpec:
    """A port ``Config`` with ``model.arch: corrdiff`` -> SongUNetSpec."""
    m = cfg.model
    if m.arch != "corrdiff":
        raise ValueError(f"model.arch is {m.arch!r}, not 'corrdiff'")
    return SongUNetSpec(
        cond_channels=cfg.in_channels(), out_channels=1, img_resolution=m.img_resolution,
        model_channels=m.model_channels, channel_mult=tuple(m.channel_mult),
        channel_mult_emb=m.channel_mult_emb, channel_mult_noise=m.channel_mult_noise,
        num_blocks=m.num_blocks, attn_resolutions=tuple(m.attn_resolutions), dropout=m.dropout,
        sigma_data=m.sigma_data, compute_dtype=m.compute_dtype)


@torch.no_grad()
def init_like_edm(model: nn.Module, generator: Optional[torch.Generator] = None) -> nn.Module:
    """SongUNet's DDPM++ initialisation: Xavier-uniform weights (the blocks'
    conv1 and proj and the output conv scaled by 1e-5, qkv by sqrt(0.2)), zero
    biases, norms at scale 1 and shift 0. Seed 0 when ``generator`` is None."""
    g = generator if generator is not None else torch.Generator().manual_seed(0)
    for name, module in model.named_modules():
        if not isinstance(module, (nn.Conv2d, nn.Linear)):
            continue
        nn.init.xavier_uniform_(module.weight, generator=g)
        leaf = name.rsplit(".", 1)[-1]
        if leaf in ("conv1", "proj") or leaf.endswith("aux_conv"):
            module.weight.mul_(1e-5)
        elif leaf == "qkv":
            module.weight.mul_(math.sqrt(0.2))
        module.bias.zero_()
    return model


def build_corrdiff(spec: SongUNetSpec, generator: Optional[torch.Generator] = None) -> CorrDiff:
    """SongUNetSpec -> CorrDiff on the current default device, initialised as
    EDM's DDPM++ from ``generator``, in eval mode."""
    if spec.compute_dtype not in _DTYPES:
        raise ValueError(f"unknown compute_dtype {spec.compute_dtype!r}")
    return init_like_edm(CorrDiff(spec), generator).eval()

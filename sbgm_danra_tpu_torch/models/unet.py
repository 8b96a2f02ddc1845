"""Conditional score UNet (counterpart of ``sbgm_danra_tpu/models/unet.py:81-586``).

Same topology, parameter names and numerics as the Flax model: a
ResNet-18-style encoder over the channel concat [x, lsm, topo, cond_img] with
8x8/s2 stems, per-stage time projections and attention on the coarsest
stages; a resize-conv decoder ``upsample -> conv_up -> norm -> conv -> norm
-> +skip -> +time -> act (-> attention)``; a linear final block; the output
divided by sigma(t) in fp32.

The public layout is NHWC, as in JAX. Inside, the NHWC input is viewed as
NCHW once (a channels_last tensor, so no copy) and the result viewed back once.
The decoder's conv3x3 -> GroupNorm chains run through K1
(``ops/fused_conv_gn.py``): on the card its CUDA kernels, on the CPU their
plain version.
``stem_impl``, ``fuse_upsample`` and ``fuse_head`` are accepted for
``ModelSpec`` parity: they are TPU lowerings of the same math, so every value
computes the one unfused chain.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from sbgm_danra_tpu_torch.models.attention import SpatialSelfAttention
from sbgm_danra_tpu_torch.models.embeddings import GaussianFourierEmbedding
from sbgm_danra_tpu_torch.models.layers import (
    ACTIVATIONS,
    BatchNorm,
    Conv2d,
    ConvTranspose2d,
    GroupNorm,
    Linear,
    init_like_flax,
)
from sbgm_danra_tpu_torch.models.resnet import ResNetStage
from sbgm_danra_tpu_torch.ops.fused_conv_gn import conv3x3_gn_relu
from sbgm_danra_tpu_torch.ops.stem_conv import conv8x8s2
from sbgm_danra_tpu_torch.ops.upsample import upsample2x_bilinear
from sbgm_danra_tpu_torch.sde import VESDE

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


class Stride2Conv8(Conv2d):
    """Conv2d(k=8, s=2, p=3, bias=False) stem."""

    def __init__(self, in_ch: int, features: int, dtype: torch.dtype = torch.float32):
        super().__init__(in_ch, features, 8, 2, 3, bias=False, compute_dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return conv8x8s2(x.to(self.compute_dtype), self.weight.to(self.compute_dtype))


class Encoder(nn.Module):
    """ResNet-backbone encoder returning 5 feature maps (NCHW)."""

    def __init__(
        self,
        in_channels: int,
        time_embedding: int = 256,
        block_layers: Sequence[int] = (2, 2, 2, 2),
        n_heads: int = 4,
        num_classes: Optional[int] = None,
        fmap_channels: Sequence[int] = (64, 64, 128, 256, 512),
        attention_backend: str = "xla",
        compute_dtype: torch.dtype = torch.float32,
        attn_stages: int = 2,
    ):
        super().__init__()
        chans = list(fmap_channels)
        dtype = self.dtype = compute_dtype
        self.time_embed = GaussianFourierEmbedding(time_embedding)
        # num_classes + 1 rows; row 0 is the CFG null token
        self.label_emb = (
            nn.Embedding(num_classes + 1, time_embedding) if num_classes is not None else None
        )
        self.conv1 = Stride2Conv8(in_channels, chans[0], dtype)
        self.conv2 = Stride2Conv8(chans[0], chans[1], dtype)
        self.bn1 = BatchNorm(chans[1], dtype)
        for i, (blocks, stride) in enumerate(zip(block_layers, (1, 2, 2, 2))):
            self.add_module(
                f"layer{i + 1}", ResNetStage(chans[i], chans[i + 1], blocks, stride, dtype)
            )
        for i, c in enumerate(chans):
            self.add_module(f"time_proj{i}", Linear(time_embedding, c, dtype))
        self.attn_idx = [i for i in range(len(chans)) if i >= len(chans) - attn_stages]
        for i in self.attn_idx:
            self.add_module(
                f"attn{i}", SpatialSelfAttention(chans[i], n_heads, attention_backend, dtype)
            )

    def _stage_out(self, h: torch.Tensor, temb: torch.Tensor, idx: int) -> torch.Tensor:
        proj = getattr(self, f"time_proj{idx}")(F.silu(temb))
        h = h + proj[:, :, None, None].to(h.dtype)
        if idx in self.attn_idx:
            h = _nchw(getattr(self, f"attn{idx}")(_nhwc(h)))
        return h

    def forward(self, x, t, y=None, cond_img=None, lsm_cond=None, topo_cond=None):
        parts = [x] + [c for c in (lsm_cond, topo_cond, cond_img) if c is not None]
        x = torch.cat(parts, dim=-1) if len(parts) > 1 else x
        temb = self.time_embed(t)
        if self.label_emb is not None and y is not None:
            temb = temb + self.label_emb(y.long())

        fmaps = []
        h = self.conv1(_nchw(x.to(self.dtype)))
        fmaps.append(self._stage_out(h, temb, 0))
        h = torch.relu(self.bn1(self.conv2(fmaps[-1])))
        for i in range(4):
            h = getattr(self, f"layer{i + 1}")(h)
            h = self._stage_out(h, temb, i + 1)
            fmaps.append(h)
        return tuple(fmaps)


def _make_norm(kind: str, channels: int, gn_groups: int, dtype: torch.dtype) -> Optional[nn.Module]:
    """'group' | 'instance' | 'none' (JAX unet.py:220-239)."""
    if kind == "group":
        return GroupNorm(max(1, min(gn_groups, channels)), channels, True, dtype)
    if kind == "instance":
        return GroupNorm(channels, channels, False, dtype)
    if kind in ("none", None):
        return None
    raise ValueError(f"Unknown norm kind: {kind}")


class DecoderBlock(nn.Module):
    """Upsample x2 (bilinear + 3x3 conv, or ConvTranspose), norm, 3x3 conv, norm,
    +skip, +time, activation, optional attention.

    The time embedding and projection exist even where ``t`` is never given
    (the final block), as in the JAX module's parameter tree.
    """

    def __init__(
        self,
        in_channels: int,
        output_channels: int,
        time_embedding: int = 256,
        activation: str = "relu",
        compute_attn: bool = False,
        n_heads: int = 4,
        use_resize_conv: bool = True,
        norm: str = "group",
        gn_groups: int = 8,
        attention_backend: str = "xla",
        compute_dtype: torch.dtype = torch.float32,
    ):
        super().__init__()
        c, dtype = in_channels, compute_dtype
        self.activation = ACTIVATIONS[activation]
        self.use_resize_conv = use_resize_conv
        if use_resize_conv:
            self.conv_up = Conv2d(c, c, 3, 1, 1, compute_dtype=dtype)
        else:
            self.transpose = ConvTranspose2d(c, 2, dtype)
        self.norm1 = _make_norm(norm, c, gn_groups, dtype)
        self.conv = Conv2d(c, output_channels, 3, 1, 1, compute_dtype=dtype)
        self.norm2 = _make_norm(norm, output_channels, gn_groups, dtype)
        self.time_embed = GaussianFourierEmbedding(time_embedding)
        self.time_proj = Linear(time_embedding, output_channels, dtype)
        self.attention = (
            SpatialSelfAttention(output_channels, n_heads, attention_backend, dtype)
            if compute_attn else None
        )

    def _conv_norm(self, x: torch.Tensor, conv: Conv2d, norm: Optional[GroupNorm]) -> torch.Tensor:
        """NHWC ``x`` -> conv -> norm -> NCHW. A conv followed by a norm is one K1
        call without activation: the same function as the two modules, with
        their parameters."""
        if norm is None:
            return conv(_nchw(x))
        c = conv.out_channels
        gamma = norm.weight if norm.weight is not None else torch.ones(c, device=x.device)
        beta = norm.bias if norm.bias is not None else torch.zeros(c, device=x.device)
        out = conv3x3_gn_relu(x.to(conv.compute_dtype), conv.weight.permute(2, 3, 1, 0),
                              conv.bias, gamma, beta, groups=norm.num_groups, activation=False)
        return _nchw(out)

    def forward(self, fmap: torch.Tensor, skip: Optional[torch.Tensor] = None,
                t: Optional[torch.Tensor] = None) -> torch.Tensor:
        if self.use_resize_conv:
            x = self._conv_norm(upsample2x_bilinear(_nhwc(fmap)), self.conv_up, self.norm1)
        else:
            x = self.transpose(fmap)
            if self.norm1 is not None:
                x = self.norm1(x)
        x = self._conv_norm(_nhwc(x), self.conv, self.norm2)
        if skip is not None:
            if skip.shape != x.shape:
                raise ValueError(f"skip shape {tuple(skip.shape)} must match {tuple(x.shape)}")
            x = x + skip
        if t is not None:
            proj = self.time_proj(F.silu(self.time_embed(t)))
            x = x + proj[:, :, None, None].to(x.dtype)
        x = self.activation(x)
        if self.attention is not None:
            x = _nchw(self.attention(_nhwc(x)))
        return x


class Decoder(nn.Module):
    """Four residual decoder blocks halving channels to ``first_fmap_channels``,
    then a norm/activation-free final block."""

    def __init__(
        self,
        last_fmap_channels: int = 512,
        output_channels: int = 1,
        time_embedding: int = 256,
        first_fmap_channels: int = 64,
        n_heads: int = 4,
        n_blocks: int = 4,
        use_resize_conv: bool = True,
        norm: str = "group",
        gn_groups: int = 8,
        activation: str = "relu",
        attention_backend: str = "xla",
        compute_dtype: torch.dtype = torch.float32,
        attn_blocks: int = 2,
    ):
        super().__init__()
        self.n_blocks = n_blocks
        common = dict(time_embedding=time_embedding, n_heads=n_heads,
                      use_resize_conv=use_resize_conv, gn_groups=gn_groups,
                      attention_backend=attention_backend, compute_dtype=compute_dtype)
        in_ch = last_fmap_channels
        for i in range(n_blocks):
            out_ch = in_ch // 2 if i != n_blocks - 1 else first_fmap_channels
            self.add_module(f"block{i}", DecoderBlock(
                in_ch, out_ch, activation=activation, compute_attn=i < attn_blocks,
                norm=norm, **common,
            ))
            in_ch = out_ch
        self.final = DecoderBlock(in_ch, output_channels, activation="identity",
                                  compute_attn=False, norm="none", **common)

    def forward(self, fmaps: Sequence[torch.Tensor], t: Optional[torch.Tensor] = None):
        if len(fmaps) != self.n_blocks + 1:
            raise ValueError(f"Decoder expected {self.n_blocks + 1} feature maps, got {len(fmaps)}")
        rev = list(reversed(fmaps))
        out = rev[0]
        for i in range(self.n_blocks):
            out = getattr(self, f"block{i}")(out, rev[i + 1], t)
        return self.final(out, None, None)


class ScoreUNet(nn.Module):
    """Encoder -> decoder -> divide by the SDE's marginal std; NHWC in and out."""

    def __init__(self, encoder: Encoder, decoder: Decoder, sde=None):
        super().__init__()
        self.encoder, self.decoder = encoder, decoder
        self.sde = sde or VESDE()

    def forward(self, x, t, y=None, cond_img=None, lsm_cond=None, topo_cond=None,
                train: bool = False):
        if train:
            raise NotImplementedError(
                "training mode (BatchNorm statistics) lands with the training port")
        t = torch.as_tensor(t, dtype=torch.float32, device=x.device)
        fmaps = self.encoder(x, t, y=y, cond_img=cond_img, lsm_cond=lsm_cond, topo_cond=topo_cond)
        score = _nhwc(self.decoder(fmaps, t=t))
        std = self.sde.marginal_prob_std(t).reshape(-1, 1, 1, 1)
        return (score.float() / std).to(x.dtype)


@dataclasses.dataclass(frozen=True)
class ModelSpec:
    """Static hyperparameters of the network; the JAX ``ModelSpec``'s fields."""

    in_channels: int
    output_channels: int = 1
    time_embedding: int = 256
    last_fmap_channels: int = 512
    num_heads: int = 4
    block_layers: Tuple[int, ...] = (2, 2, 2, 2)
    num_classes: Optional[int] = None
    use_resize_conv: bool = True
    decoder_norm: str = "group"
    decoder_gn_groups: int = 8
    decoder_activation: str = "silu"
    attention_backend: str = "xla"
    compute_dtype: str = "float32"
    bn_axis_name: Optional[str] = None
    encoder_attn_stages: int = 2
    decoder_attn_blocks: int = 2
    stem_impl: str = "direct"
    fuse_upsample: str = "none"
    fuse_head: bool = False


def inference_spec(spec: ModelSpec, image_hw: Optional[Tuple[int, int]] = None) -> ModelSpec:
    """The JAX package's per-shape lowering choice: ``fuse_head`` at >= 512 px.

    The knobs change no output here; the function is kept so that a spec made
    for a given image size is the same object on both sides.
    """
    full_domain = image_hw is not None and min(image_hw) >= 512
    return dataclasses.replace(spec, stem_impl="direct", fuse_upsample="none",
                               fuse_head=bool(full_domain))


def model_spec_from_config(cfg) -> ModelSpec:
    """Config -> ModelSpec, as ``sbgm_danra_tpu/training/pipeline.py:46-62``."""
    return ModelSpec(
        in_channels=cfg.in_channels(),
        output_channels=1,
        time_embedding=cfg.sampler.time_embedding,
        last_fmap_channels=cfg.sampler.last_fmap_channels,
        num_heads=cfg.sampler.num_heads,
        block_layers=tuple(cfg.sampler.block_layers),
        num_classes=cfg.num_classes(),
        use_resize_conv=cfg.model.use_resize_conv,
        decoder_norm=cfg.model.decoder_norm,
        decoder_gn_groups=cfg.model.decoder_gn_groups,
        decoder_activation=cfg.model.decoder_activation,
        attention_backend=cfg.model.attention_backend,
        compute_dtype=cfg.model.compute_dtype,
    )


def build_score_model(spec: ModelSpec, sde=None,
                      generator: Optional[torch.Generator] = None) -> ScoreUNet:
    """ModelSpec -> ScoreUNet on the CPU, initialised like Flax from ``generator``
    (seed 0 when None). Move it with ``.to(device)``."""
    if spec.last_fmap_channels % 8 != 0:
        raise ValueError("last_fmap_channels must be divisible by 8")
    if spec.compute_dtype not in _DTYPES:
        raise ValueError(f"unknown compute_dtype {spec.compute_dtype!r}")
    # TPU lowerings of the same maps: accepted, and the one chain is computed
    if spec.stem_impl not in ("direct", "s2d"):
        raise ValueError(f"unknown stem_impl {spec.stem_impl!r}")
    if spec.fuse_upsample not in ("none", "dilated", "phases"):
        raise ValueError(f"unknown fuse_upsample {spec.fuse_upsample!r}")
    dtype = _DTYPES[spec.compute_dtype]
    base = spec.last_fmap_channels // 8
    encoder = Encoder(
        in_channels=spec.in_channels + spec.output_channels,
        time_embedding=spec.time_embedding,
        block_layers=tuple(spec.block_layers),
        n_heads=spec.num_heads,
        num_classes=spec.num_classes,
        fmap_channels=(base, base, 2 * base, 4 * base, 8 * base),
        attention_backend=spec.attention_backend,
        compute_dtype=dtype,
        attn_stages=spec.encoder_attn_stages,
    )
    decoder = Decoder(
        last_fmap_channels=spec.last_fmap_channels,
        output_channels=spec.output_channels,
        time_embedding=spec.time_embedding,
        first_fmap_channels=base,
        n_heads=spec.num_heads,
        use_resize_conv=spec.use_resize_conv,
        norm=spec.decoder_norm,
        gn_groups=spec.decoder_gn_groups,
        activation=spec.decoder_activation,
        attention_backend=spec.attention_backend,
        compute_dtype=dtype,
        attn_blocks=spec.decoder_attn_blocks,
    )
    model = ScoreUNet(encoder, decoder, sde or VESDE())
    init_like_flax(model, generator)
    return model.eval()

"""Layers that compute the way Flax's do in the JAX package.

Flax keeps parameters in float32 and casts them, with the input, to the
module's ``dtype`` on every call; norms compute their statistics in float32
and round once to the result dtype. These classes do the same, so one bf16
forward of the port rounds where the JAX one rounds. Their parameter names
are the ones ``convert.py`` maps the Flax tree onto.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from sbgm_danra_tpu_torch.models.embeddings import GaussianFourierEmbedding
from sbgm_danra_tpu_torch.parallel.collectives import GlobalSum


class Conv2d(nn.Conv2d):
    """nn.Conv2d over NCHW (any memory format), computing in ``compute_dtype``."""

    def __init__(self, in_ch, out_ch, kernel_size, stride=1, padding=0, bias=True,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__(in_ch, out_ch, kernel_size, stride=stride, padding=padding, bias=bias)
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        bias = None if self.bias is None else self.bias.to(dt)
        return self._conv_forward(x.to(dt), self.weight.to(dt), bias)


class ConvTranspose2d(nn.ConvTranspose2d):
    """Stride == kernel transposed conv (the decoder's ConvTranspose ablation)."""

    def __init__(self, channels: int, scale: int, compute_dtype: torch.dtype = torch.float32):
        super().__init__(channels, channels, scale, stride=scale)
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        return F.conv_transpose2d(x.to(dt), self.weight.to(dt), self.bias.to(dt),
                                  stride=self.stride)


class Linear(nn.Linear):
    def __init__(self, in_features: int, out_features: int,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__(in_features, out_features)
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        return F.linear(x.to(dt), self.weight.to(dt), self.bias.to(dt))


class GroupNorm(nn.Module):
    """Flax ``nn.GroupNorm`` (eps 1e-5): fp32 statistics, result in ``out_dtype``.

    ``affine=False`` is the instance norm of the decoder (one group per
    channel, no scale or bias).
    """

    def __init__(self, num_groups: int, channels: int, affine: bool = True,
                 out_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_groups, self.out_dtype = num_groups, out_dtype
        self.weight = nn.Parameter(torch.ones(channels)) if affine else None
        self.bias = nn.Parameter(torch.zeros(channels)) if affine else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.group_norm(x.float(), self.num_groups, self.weight, self.bias, 1e-5)
        return y.to(self.out_dtype)


class BatchNorm(nn.Module):
    """Flax ``nn.BatchNorm`` (eps 1e-5, momentum 0.9) in fp32, result in ``out_dtype``.

    ``train=False`` normalises with the running statistics. ``train=True``
    normalises with the batch's mean and biased variance, taken in one pass
    as Flax takes them (E[x^2] - mean^2, clamped at 0), and records them in
    ``batch_stats`` (detached) without touching the running statistics: the
    train step folds them in once, after the backward, with
    ``update_running_stats`` (ra = 0.9 ra + 0.1 batch, the biased variance
    as Flax uses; ``F.batch_norm`` would take the unbiased one). A remat
    recompute of the forward records the same statistics again, and nothing
    is updated twice.

    ``group`` (a process group, None by default): the statistics of the
    global batch, every rank's rows, as JAX's data-parallel step takes them
    (GSPMD's mean crosses the shards; Flax's ``axis_name``). Each rank's
    [sum, sum of squares, count] per channel go through one differentiable
    all-reduce (``parallel/collectives.GlobalSum``, whose backward all-reduces
    the gradient), and the running update keeps the biased variance
    (``torch.nn.SyncBatchNorm`` would fold in the unbiased one, F2).
    ``parallel/train.py`` sets it on every BatchNorm of a data-parallel model.
    """

    momentum = 0.9  # Flax's: the running statistics keep 0.9 of themselves

    def __init__(self, channels: int, out_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.out_dtype = out_dtype
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))
        self.batch_stats = None  # (mean, var) of the last train-mode forward
        self.group = None  # a process group: global-batch statistics

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        if not train:
            y = F.batch_norm(x.float(), self.running_mean, self.running_var, self.weight,
                             self.bias, False, 0.0, 1e-5)
            return y.to(self.out_dtype)
        xf = x.float()
        if self.group is None:
            mean = xf.mean(dim=(0, 2, 3))
            var = torch.clamp((xf * xf).mean(dim=(0, 2, 3)) - mean * mean, min=0.0)
        else:
            mean, var = self._global_moments(xf)
        self.batch_stats = (mean.detach(), var.detach())
        mul = torch.rsqrt(var + 1e-5) * self.weight
        y = (xf - mean[:, None, None]) * mul[:, None, None] + self.bias[:, None, None]
        return y.to(self.out_dtype)

    def _global_moments(self, xf: torch.Tensor):
        """Mean and biased one-pass variance over every rank's rows of ``group``."""
        c = xf.shape[1]
        count = torch.full((1,), xf.numel() // c, dtype=xf.dtype, device=xf.device)
        local = torch.cat([xf.sum(dim=(0, 2, 3)), (xf * xf).sum(dim=(0, 2, 3)), count])
        total = GlobalSum.apply(local, self.group)
        n = total[-1]
        mean = total[:c] / n
        return mean, torch.clamp(total[c:2 * c] / n - mean * mean, min=0.0)

    @torch.no_grad()
    def update_running_stats(self) -> None:
        """Fold the recorded batch statistics into the running ones, once."""
        if self.batch_stats is None:
            raise RuntimeError("no train-mode forward recorded batch statistics")
        mean, var = self.batch_stats
        self.running_mean.copy_(self.momentum * self.running_mean + (1 - self.momentum) * mean)
        self.running_var.copy_(self.momentum * self.running_var + (1 - self.momentum) * var)
        self.batch_stats = None


class LayerNorm(nn.Module):
    """Flax ``nn.LayerNorm`` with ``dtype=float32``: eps 1e-6, fp32 result."""

    def __init__(self, channels: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x.float(), self.weight.shape, self.weight, self.bias, 1e-6)


def flax_gelu(x: torch.Tensor) -> torch.Tensor:
    """Flax ``nn.gelu`` defaults to the tanh approximation."""
    return F.gelu(x, approximate="tanh")


ACTIVATIONS = {
    "relu": F.relu,
    "silu": F.silu,
    "gelu": flax_gelu,
    "identity": lambda x: x,
}

# Flax's lecun_normal: a normal truncated at two standard deviations, scaled so
# that the truncated distribution has variance 1/fan_in.
_TRUNC_STD = 0.87962566103423978


def _lecun_normal_(w: torch.Tensor, fan_in: int, generator: torch.Generator) -> None:
    std = (1.0 / fan_in) ** 0.5 / _TRUNC_STD
    nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)


@torch.no_grad()
def init_like_flax(model: nn.Module, generator: Optional[torch.Generator] = None) -> nn.Module:
    """Draw every parameter from the family Flax initialises it with.

    Kernels lecun-normal (fan-in over the kernel's spatial and input axes),
    biases zero, norm scales one, the label embedding N(0, 1) with row 0 (the
    CFG null token) zero, the Fourier frequencies N(0, 30^2). With a seeded
    generator a model is reproducible; it is not JAX's draw (ROADMAP F4).
    """
    g = generator if generator is not None else torch.Generator().manual_seed(0)
    for module in model.modules():
        if isinstance(module, nn.ConvTranspose2d):
            cin, _, kh, kw = module.weight.shape
            _lecun_normal_(module.weight, cin * kh * kw, g)
        elif isinstance(module, nn.Conv2d):
            _lecun_normal_(module.weight, module.weight[0].numel(), g)
        elif isinstance(module, nn.Linear):
            _lecun_normal_(module.weight, module.in_features, g)
        elif isinstance(module, nn.Embedding):
            module.weight.normal_(0.0, 1.0, generator=g)
            module.weight[0].zero_()
        elif isinstance(module, GaussianFourierEmbedding):
            module.W.normal_(0.0, 1.0, generator=g).mul_(module.scale)
        else:
            continue
        bias = getattr(module, "bias", None)
        if bias is not None:
            bias.zero_()
    return model

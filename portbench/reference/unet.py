"""Plain PyTorch reference of the flagship score UNet, as a function of a
parameter dict.

It follows the architecture of SBGM_DANRA's conditional score UNet as the
port states it (``configs/flagship_synth.yaml``): a ResNet-18-style encoder
over the channel concat [x, lsm, topo, cond_img] with 8x8 / stride-2 stems,
a time projection after every stage and pre-LN attention blocks on the two
coarsest stages; a decoder of bilinear x2 upsample -> 3x3 conv -> GroupNorm
-> 3x3 conv -> GroupNorm -> + skip -> + time -> SiLU (-> attention) blocks,
a norm-free final block, and the output divided by the VE SDE's marginal
std. Parameter names are the port's state_dict names, so one dict of
weights made by the benchmark feeds both.

Everything is computed in float32 with no kernel, cache or batching trick;
the caller turns TF32 off (``exact``). ``quant`` rounds every tensor that the
program keeps in its compute dtype (``UNet``): the identity for the reference,
a lower precision for the control (``fake_fp8``). Imports nothing of the port.
"""

from __future__ import annotations

import contextlib
import math
from typing import Callable, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

Params = Dict[str, torch.Tensor]
Quant = Callable[[torch.Tensor], torch.Tensor]

FP8_MAX = 448.0  # largest finite float8_e4m3fn


def identity(t: torch.Tensor) -> torch.Tensor:
    return t


def fake_fp8(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to float8 e4m3 with one scale for the tensor (its absolute
    maximum onto 448), returned in float32: an fp8 operand of an fp32
    accumulation. The gradient passes the rounding unchanged (the backward's
    products take the rounded operands and float32 gradients)."""
    scale = t.detach().abs().amax().clamp(min=1e-30) / FP8_MAX
    q = (t.detach() / scale).to(torch.float8_e4m3fn).float() * scale
    return t + (q - t.detach())


def fake_bf16(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to bfloat16, returned in float32 (the program's own
    precision, emulated: a check of the emulation, not a control)."""
    return t + (t.detach().to(torch.bfloat16).float() - t.detach())


@contextlib.contextmanager
def exact():
    """TF32 off for cuDNN and cuBLAS inside the block; the flags put back after."""
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


def arch(cfg: dict) -> dict:
    """The sizes the forward needs from a configuration file's ``model``."""
    m = cfg["model"]
    base = m["last_fmap_channels"] // 8
    return dict(
        in_channels=m["in_channels"] + 1,  # the noisy field is the first channel
        chans=[base, base, 2 * base, 4 * base, 8 * base],
        temb=m["time_embedding"],
        heads=m["num_heads"],
        blocks=list(m["block_layers"]),
        num_classes=m["num_classes"],
        gn_groups=m["decoder_gn_groups"],
        enc_attn=m["encoder_attn_stages"],
        dec_attn=m["decoder_attn_blocks"],
        sigma=cfg["sde"]["sigma"],
    )


def param_shapes(cfg: dict) -> Dict[str, Tuple[int, ...]]:
    """Every parameter and buffer of the UNet by name, with its shape."""
    a = arch(cfg)
    c, e = a["chans"], a["temb"]
    out: Dict[str, Tuple[int, ...]] = {}

    def conv(name, cin, cout, k, bias):
        out[f"{name}.weight"] = (cout, cin, k, k)
        if bias:
            out[f"{name}.bias"] = (cout,)

    def linear(name, cin, cout):
        out[f"{name}.weight"] = (cout, cin)
        out[f"{name}.bias"] = (cout,)

    def norm(name, ch, running=False):
        out[f"{name}.weight"] = (ch,)
        out[f"{name}.bias"] = (ch,)
        if running:
            out[f"{name}.running_mean"] = (ch,)
            out[f"{name}.running_var"] = (ch,)

    def attention(name, ch):
        norm(f"{name}.ln1", ch)
        linear(f"{name}.qkv", ch, 3 * ch)
        linear(f"{name}.out_proj", ch, ch)
        norm(f"{name}.ln2", ch)
        linear(f"{name}.ff1", ch, ch)
        linear(f"{name}.ff2", ch, ch)

    out["encoder.time_embed.W"] = (e // 2,)
    out["encoder.label_emb.weight"] = (a["num_classes"] + 1, e)
    conv("encoder.conv1", a["in_channels"], c[0], 8, False)
    conv("encoder.conv2", c[0], c[1], 8, False)
    norm("encoder.bn1", c[1], running=True)
    for i, (n, stride) in enumerate(zip(a["blocks"], (1, 2, 2, 2))):
        for b in range(n):
            cin = c[i] if b == 0 else c[i + 1]
            p = f"encoder.layer{i + 1}.block{b}"
            conv(f"{p}.conv1", cin, c[i + 1], 3, False)
            norm(f"{p}.bn1", c[i + 1], running=True)
            conv(f"{p}.conv2", c[i + 1], c[i + 1], 3, False)
            norm(f"{p}.bn2", c[i + 1], running=True)
            if b == 0 and (stride != 1 or cin != c[i + 1]):
                conv(f"{p}.down_conv", cin, c[i + 1], 1, False)
                norm(f"{p}.down_bn", c[i + 1], running=True)
    for i, ch in enumerate(c):
        linear(f"encoder.time_proj{i}", e, ch)
    for i in _enc_attn_idx(a):
        attention(f"encoder.attn{i}", c[i])
    ch = c[-1]
    for i, (cin, cout) in enumerate(_dec_channels(a)):
        p = f"decoder.block{i}"
        conv(f"{p}.conv_up", cin, cin, 3, True)
        norm(f"{p}.norm1", cin)
        conv(f"{p}.conv", cin, cout, 3, True)
        norm(f"{p}.norm2", cout)
        out[f"{p}.time_embed.W"] = (e // 2,)
        linear(f"{p}.time_proj", e, cout)
        if i < a["dec_attn"]:
            attention(f"{p}.attention", cout)
        ch = cout
    conv("decoder.final.conv_up", ch, ch, 3, True)
    conv("decoder.final.conv", ch, 1, 3, True)
    out["decoder.final.time_embed.W"] = (e // 2,)
    linear("decoder.final.time_proj", e, 1)
    return out


def _enc_attn_idx(a: dict) -> List[int]:
    n = len(a["chans"])
    return [i for i in range(n) if i >= n - a["enc_attn"]]


def _dec_channels(a: dict) -> List[Tuple[int, int]]:
    """(in, out) channels of the four residual decoder blocks."""
    c = a["chans"][-1]
    out = []
    for i in range(4):
        nxt = c // 2 if i != 3 else a["chans"][0]
        out.append((c, nxt))
        c = nxt
    return out


def marginal_std(t: torch.Tensor, sigma: float) -> torch.Tensor:
    """The VE SDE's std(t) = sqrt((sigma^(2t) - 1) / (2 ln sigma)), at least 1e-5."""
    t = t.double()
    std = torch.sqrt((sigma ** (2.0 * t) - 1.0) / (2.0 * math.log(sigma)))
    return torch.clamp(std, min=1e-5).float()


class UNet:
    """``UNet(params, cfg)(x, t, y, cond_img, lsm_cond, topo_cond)`` -> the score,
    NHWC float32. ``quant`` rounds every tensor the network keeps, where the
    program keeps it in its compute dtype: every product's operands and result,
    each norm's, activation's, sum's and upsample's result (the time embedding
    and the output's division by std stay float32, as in the program).
    ``train``: BatchNorm normalises with the batch's mean and biased variance
    (E[x^2] - mean^2, at least 0) and records them in ``batch_stats`` by name."""

    def __init__(self, params: Params, cfg: dict, quant: Quant = identity, train: bool = False):
        self.p, self.a, self.q, self.train = params, arch(cfg), quant, train
        self.batch_stats: Dict[str, Tuple[torch.Tensor, torch.Tensor]] = {}

    def conv(self, name: str, x: torch.Tensor, stride: int = 1, padding: int = 1) -> torch.Tensor:
        w, b = self.p[f"{name}.weight"], self.p.get(f"{name}.bias")
        return self.q(F.conv2d(self.q(x), self.q(w), b, stride=stride, padding=padding))

    def linear(self, name: str, x: torch.Tensor) -> torch.Tensor:
        return self.q(F.linear(self.q(x), self.q(self.p[f"{name}.weight"]),
                               self.p[f"{name}.bias"]))

    def bn(self, name: str, x: torch.Tensor) -> torch.Tensor:
        p = self.p
        if not self.train:
            return self.q(F.batch_norm(x, p[f"{name}.running_mean"], p[f"{name}.running_var"],
                                       p[f"{name}.weight"], p[f"{name}.bias"], False, 0.0, 1e-5))
        mean = x.mean(dim=(0, 2, 3))
        var = torch.clamp((x * x).mean(dim=(0, 2, 3)) - mean * mean, min=0.0)
        self.batch_stats[name] = (mean.detach(), var.detach())
        scale = torch.rsqrt(var + 1e-5) * p[f"{name}.weight"]
        return self.q((x - mean[:, None, None]) * scale[:, None, None]
                      + p[f"{name}.bias"][:, None, None])

    def gn(self, name: str, x: torch.Tensor) -> torch.Tensor:
        ch = x.shape[1]
        groups = max(1, min(self.a["gn_groups"], ch))
        return self.q(F.group_norm(x, groups, self.p[f"{name}.weight"], self.p[f"{name}.bias"],
                                   1e-5))

    def fourier(self, name: str, t: torch.Tensor) -> torch.Tensor:
        proj = t[:, None] * self.p[f"{name}.W"][None, :] * (2.0 * math.pi)
        return torch.cat([torch.sin(proj), torch.cos(proj)], dim=-1)

    def attention(self, name: str, x: torch.Tensor) -> torch.Tensor:
        """Pre-LN MHA + GELU(tanh) MLP over the H*W tokens of NCHW ``x``."""
        b, c, h, w = x.shape
        heads = self.a["heads"]
        d = c // heads
        tok = x.permute(0, 2, 3, 1).reshape(b, h * w, c)
        ln = F.layer_norm(tok, (c,), self.p[f"{name}.ln1.weight"], self.p[f"{name}.ln1.bias"],
                          1e-6)  # float32 in the program too
        q, k, v = (u.reshape(b, h * w, heads, d).transpose(1, 2)
                   for u in self.linear(f"{name}.qkv", ln).chunk(3, dim=-1))
        scores = torch.matmul(self.q(q) * (1.0 / math.sqrt(d)), self.q(k).transpose(-1, -2))
        probs = torch.softmax(scores, dim=-1)
        del scores
        att = self.q(torch.matmul(self.q(probs), self.q(v))).transpose(1, 2).reshape(b, h * w, c)
        tok = tok + self.linear(f"{name}.out_proj", att)
        ln2 = F.layer_norm(tok, (c,), self.p[f"{name}.ln2.weight"], self.p[f"{name}.ln2.bias"],
                           1e-6)
        ff = self.linear(f"{name}.ff2", self.q(F.gelu(self.linear(f"{name}.ff1", ln2),
                                                       approximate="tanh")))
        tok = tok + ff
        return self.q(tok.reshape(b, h, w, c).permute(0, 3, 1, 2))

    def basic_block(self, name: str, x: torch.Tensor, stride: int) -> torch.Tensor:
        out = self.q(F.relu(self.bn(f"{name}.bn1", self.conv(f"{name}.conv1", x, stride, 1))))
        out = self.bn(f"{name}.bn2", self.conv(f"{name}.conv2", out, 1, 1))
        if f"{name}.down_conv.weight" in self.p:
            x = self.bn(f"{name}.down_bn", self.conv(f"{name}.down_conv", x, stride, 0))
        return self.q(F.relu(out + x))

    def decoder_block(self, name: str, x: torch.Tensor, skip: Optional[torch.Tensor],
                      temb_t: Optional[torch.Tensor], attn: bool, final: bool) -> torch.Tensor:
        x = self.q(F.interpolate(x, scale_factor=2, mode="bilinear", align_corners=False))
        x = self.conv(f"{name}.conv_up", x)
        if not final:
            x = self.gn(f"{name}.norm1", x)
        x = self.conv(f"{name}.conv", x)
        if final:
            return x
        x = self.q(self.gn(f"{name}.norm2", x) + skip)
        proj = self.linear(f"{name}.time_proj", F.silu(self.fourier(f"{name}.time_embed", temb_t)))
        x = self.q(F.silu(self.q(x + proj[:, :, None, None])))
        return self.attention(f"{name}.attention", x) if attn else x

    def __call__(self, x, t, y=None, cond_img=None, lsm_cond=None, topo_cond=None):
        a = self.a
        t = t.reshape(-1).float()
        parts = [x] + [c for c in (lsm_cond, topo_cond, cond_img) if c is not None]
        h = torch.cat(parts, dim=-1).float().permute(0, 3, 1, 2)
        temb = self.fourier("encoder.time_embed", t)
        if y is not None:
            temb = temb + self.p["encoder.label_emb.weight"][y.long()]
        attn_idx = _enc_attn_idx(a)

        def stage_out(h, i):
            proj = self.linear(f"encoder.time_proj{i}", F.silu(temb))
            h = self.q(h + proj[:, :, None, None])
            return self.attention(f"encoder.attn{i}", h) if i in attn_idx else h

        fmaps = [stage_out(self.conv("encoder.conv1", h, 2, 3), 0)]
        h = self.q(F.relu(self.bn("encoder.bn1", self.conv("encoder.conv2", fmaps[0], 2, 3))))
        for i, n in enumerate(a["blocks"]):
            for b in range(n):
                h = self.basic_block(f"encoder.layer{i + 1}.block{b}", h,
                                     (1, 2, 2, 2)[i] if b == 0 else 1)
            h = stage_out(h, i + 1)
            fmaps.append(h)
        rev = fmaps[::-1]
        out = rev[0]
        for i in range(4):
            out = self.decoder_block(f"decoder.block{i}", out, rev[i + 1], t,
                                     i < a["dec_attn"], False)
        out = self.decoder_block("decoder.final", out, None, None, False, True)
        std = marginal_std(t, a["sigma"]).to(out.device).reshape(-1, 1, 1, 1)
        return out.permute(0, 2, 3, 1) / std

"""The yardstick's arithmetic: the chip's peaks, the UNet's operations per row,
and the operations and bytes of the kernels K1 (conv3x3 + GroupNorm chain)
and K2 (flash attention), worked out from a configuration's sizes.

Operations are multiply-adds counted twice, for the convolutions, the dense
layers and the two products of attention, the same whatever implements
them (``torch.utils.flop_counter`` counts the same set). A kernel's least
time is the larger of its operations at the bf16 peak and its bytes at the
memory rate, each input byte read once and each output byte written once.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

# One NVIDIA H100 SXM (data sheet, dense, at 700 W): bf16 tensor cores, HBM3.
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
PEAK_BYTES = 3.35e12
ITEMSIZE = {"bfloat16": 2, "float32": 4}

# The port sends attention of at least this many tokens to K2 (dense below).
K2_MIN_TOKENS = 4096


def _sizes(cfg: dict) -> dict:
    m = cfg["model"]
    base = m["last_fmap_channels"] // 8
    return dict(chans=[base, base, 2 * base, 4 * base, 8 * base], temb=m["time_embedding"],
                blocks=list(m["block_layers"]), enc_attn=m["encoder_attn_stages"],
                dec_attn=m["decoder_attn_blocks"], cin=m["in_channels"] + 1)


def _conv(h: int, w: int, cin: int, cout: int, k: int) -> float:
    return 2.0 * h * w * cin * cout * k * k


def _attention(tokens: int, c: int) -> float:
    """qkv, the two products, out_proj and the two MLP layers, one row."""
    return 2.0 * tokens * c * (3 * c + c + 2 * c) + 4.0 * tokens * tokens * c


def attention_layers(cfg: dict, h: int, w: int) -> List[Tuple[int, int]]:
    """(tokens, channels) of every attention layer at an (h, w) input."""
    s = _sizes(cfg)
    c, n = s["chans"], len(s["chans"])
    res = [(h // 2 ** (i + 1), w // 2 ** (i + 1)) for i in range(n)]  # fmap i's size
    out = [(res[i][0] * res[i][1], c[i]) for i in range(n) if i >= n - s["enc_attn"]]
    for i, (_, cout, rh, rw) in enumerate(decoder_blocks(cfg, h, w)):
        if i < s["dec_attn"]:
            out.append((rh * rw, cout))
    return out


def decoder_blocks(cfg: dict, h: int, w: int) -> List[Tuple[int, int, int, int]]:
    """(cin, cout, out_h, out_w) of the four residual decoder blocks."""
    c = _sizes(cfg)["chans"]
    out, ch = [], c[-1]
    for i in range(4):
        nxt = ch // 2 if i != 3 else c[0]
        f = 2 ** (4 - i)
        out.append((ch, nxt, h // f, w // f))
        ch = nxt
    return out


def unet_flops(cfg: dict, h: int, w: int) -> float:
    """Operations of one row of the UNet's forward at an (h, w) input."""
    s = _sizes(cfg)
    c, e = s["chans"], s["temb"]
    total = _conv(h // 2, w // 2, s["cin"], c[0], 8) + _conv(h // 4, w // 4, c[0], c[1], 8)
    rh, rw = h // 4, w // 4
    for i, (n, stride) in enumerate(zip(s["blocks"], (1, 2, 2, 2))):
        rh, rw = rh // stride, rw // stride
        for b in range(n):
            cin = c[i] if b == 0 else c[i + 1]
            total += _conv(rh, rw, cin, c[i + 1], 3) + _conv(rh, rw, c[i + 1], c[i + 1], 3)
            if b == 0 and (stride != 1 or cin != c[i + 1]):
                total += _conv(rh, rw, cin, c[i + 1], 1)
    total += sum(2.0 * e * ch for ch in c)  # the stages' time projections
    for cin, cout, oh, ow in decoder_blocks(cfg, h, w):
        total += _conv(oh, ow, cin, cin, 3) + _conv(oh, ow, cin, cout, 3) + 2.0 * e * cout
    ch = c[0]
    total += _conv(h, w, ch, ch, 3) + _conv(h, w, ch, 1, 3)  # the final block, untimed
    total += sum(_attention(tokens, ch) for tokens, ch in attention_layers(cfg, h, w))
    return total


def least_s(flops: float, nbytes: float, dtype: str) -> float:
    return max(flops / PEAK_FLOPS[dtype], nbytes / PEAK_BYTES)


def k1_chains(cfg: dict, h: int, w: int) -> List[Tuple[int, int, int, int]]:
    """(out_h, out_w, cin, cout) of every conv3x3 -> GroupNorm chain of one
    evaluation: conv_up + norm1 and conv + norm2 of each residual decoder block."""
    out = []
    for cin, cout, oh, ow in decoder_blocks(cfg, h, w):
        out += [(oh, ow, cin, cin), (oh, ow, cin, cout)]
    return out


def k1_work(rows: int, oh: int, ow: int, cin: int, cout: int, dtype: str) -> Dict[str, float]:
    """One chain on ``rows`` rows: the conv's operations plus GroupNorm's (a
    subtract, a multiply, a scale and a shift a value, and the two sums);
    x, the weights, bias, gamma and beta read, the result written."""
    isz = ITEMSIZE[dtype]
    px = rows * oh * ow
    flops = _conv(oh, ow, cin, cout, 3) * rows + 6.0 * px * cout
    nbytes = isz * (px * cin + 9 * cin * cout + 3 * cout + px * cout)
    return dict(flops=flops, bytes=nbytes)


def k1_least_s(cfg: dict, h: int, w: int, rows: int) -> float:
    """K1's least time over one evaluation's chains."""
    dtype = cfg["model"]["compute_dtype"]
    return sum(least_s(**_fb(k1_work(rows, *chain, dtype)), dtype=dtype)
               for chain in k1_chains(cfg, h, w))


def k2_work(rows: int, tokens: int, channels: int, dtype: str) -> Dict[str, float]:
    """One forward of attention over [rows, tokens, heads, channels / heads]:
    4 B H S^2 D operations; q, k, v read and o written once."""
    return dict(flops=4.0 * rows * tokens * tokens * channels,
                bytes=4.0 * rows * tokens * channels * ITEMSIZE[dtype])


def k2_least_s(cfg: dict, h: int, w: int, rows: int) -> float:
    """K2's least time over one evaluation's attention layers that K2 runs."""
    dtype = cfg["model"]["compute_dtype"]
    return sum(least_s(**_fb(k2_work(rows, tokens, ch, dtype)), dtype=dtype)
               for tokens, ch in attention_layers(cfg, h, w) if tokens >= K2_MIN_TOKENS)


def _fb(work: Dict[str, float]) -> Dict[str, float]:
    return dict(flops=work["flops"], nbytes=work["bytes"])


def evals_per_call(sampler: dict) -> int:
    """UNet evaluations of one sampler call (each over the CFG-doubled batch)."""
    n = sampler["num_steps"]
    return {"edm_sampler": 2 * (n - 1), "dpmpp_sampler": n - 1}[sampler["name"]]


def cfg_rows(sampler: dict, batch: int) -> int:
    """Rows of each UNet evaluation: the batch, doubled under guidance."""
    return 2 * batch if sampler.get("guidance_scale") is not None else batch

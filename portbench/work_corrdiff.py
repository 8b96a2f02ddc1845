"""CorrDiff's arithmetic for the yardstick: the operations of one row of a
SongUNet's forward, and K1's chains in it (each block's ``conv0 -> + emb ->
GroupNorm -> SiLU``), from a configuration's sizes and the layers that
``portbench/reference/corrdiff.blocks`` lists.

Operations are multiply-adds counted twice, for the convolutions (3x3 and
1x1), the dense layers (the blocks' ``affine`` and the embedding's two) and
the two products of attention, as ``portbench/work.py`` counts the
flagship's; norms, activations, resampling and sums are not counted.
"""

from __future__ import annotations

from typing import List, Tuple

from portbench import work
from portbench.reference.corrdiff import arch, blocks


def _scale(res: int, h: int, w: int, nominal: int) -> Tuple[int, int]:
    """The map's size at a layer of nominal resolution ``res`` for an (h, w)
    input at ``nominal``."""
    f = nominal // res
    return h // f, w // f


def block_flops(cin: int, cout: int, emb: int, oh: int, ow: int, up: bool = False,
                down: bool = False, attention: bool = False) -> float:
    """One row of one UNetBlock with an (oh, ow) output: conv0, affine, conv1,
    the 1x1 skip where there is one, and attention's qkv, products and proj."""
    px = oh * ow
    total = 2.0 * 9 * cin * cout * px + 2.0 * emb * cout + 2.0 * 9 * cout * cout * px
    if cin != cout or up or down:
        total += 2.0 * cin * cout * px
    if attention:
        total += 2.0 * cout * 3 * cout * px + 4.0 * px * px * cout + 2.0 * cout * cout * px
    return total


def net_flops(cfg: dict, h: int, w: int, positional: bool) -> float:
    """Operations of one row of one net's forward at an (h, w) input
    (``positional``: the residual net, with its embedding's two linears)."""
    a = arch(cfg)
    total = 2.0 * (a["noise"] * a["emb"] + a["emb"] * a["emb"]) if positional else 0.0
    for _, _, kind, cin, cout, res, flags in blocks(cfg):
        oh, ow = _scale(res, h, w, a["res"])
        if kind in ("conv", "aux_conv"):
            total += 2.0 * 9 * cin * cout * oh * ow
        elif kind == "block":
            total += block_flops(cin, cout, a["emb"], oh, ow, flags.get("up", False),
                                 flags.get("down", False), flags.get("attention", False))
    return total


def call_flops(cfg: dict, h: int, w: int, dates: int, members: int) -> float:
    """One call: the regression once a date, the residual's 2 (n - 1) Heun
    evaluations on every member."""
    evals = work.evals_per_call(cfg["sampler"])
    return (dates * net_flops(cfg, h, w, False)
            + evals * dates * members * net_flops(cfg, h, w, True))


def k1_chains(cfg: dict, h: int, w: int) -> List[Tuple[int, int, int, int]]:
    """(out_h, out_w, cin, cout) of every K1 chain of one net's forward: each
    block's conv0 on its resampled input, at the block's output size."""
    a = arch(cfg)
    return [(*_scale(res, h, w, a["res"]), cin, cout)
            for _, _, kind, cin, cout, res, _ in blocks(cfg) if kind == "block"]


def k1_least_s(cfg: dict, h: int, w: int, rows: int) -> float:
    """K1's least time over one net's chains at ``rows`` rows: the
    flagship's count of a chain (``work.k1_work``) and the per-sample bias's
    fp32 read."""
    dtype = cfg["model"]["compute_dtype"]
    total = 0.0
    for chain in k1_chains(cfg, h, w):
        wk = work.k1_work(rows, *chain, dtype)
        total += work.least_s(wk["flops"], wk["bytes"] + 4.0 * rows * chain[3], dtype)
    return total


def k1_least_s_per_call(cfg: dict, h: int, w: int, dates: int, members: int) -> float:
    """K1's least time over one call's chains: the regression's at ``dates``
    rows, the residual's evaluations' at ``dates x members``."""
    evals = work.evals_per_call(cfg["sampler"])
    return (k1_least_s(cfg, h, w, dates)
            + evals * k1_least_s(cfg, h, w, dates * members))

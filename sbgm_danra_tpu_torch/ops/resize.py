"""2-D resize with torch's ``F.interpolate`` semantics on host numpy (a copy of
``sbgm_danra_tpu/ops/resize.py``).

Bilinear with align_corners=False (half-pixel centres) for continuous fields,
legacy 'nearest' (floor of the source index) for masks. On numpy so that the
loader's worker threads run it without touching the device.
"""

from __future__ import annotations

import numpy as np


def resize_bilinear(data: np.ndarray, out_hw) -> np.ndarray:
    """Bilinear resize of the last two axes, align_corners=False."""
    h_in, w_in = data.shape[-2:]
    h_out, w_out = out_hw
    if (h_in, w_in) == (h_out, w_out):
        return np.asarray(data, dtype=np.float32)
    data = np.asarray(data, dtype=np.float32)

    def coords(n_out, n_in):
        scale = n_in / n_out
        src = (np.arange(n_out, dtype=np.float64) + 0.5) * scale - 0.5
        src = np.clip(src, 0, n_in - 1)
        lo = np.floor(src).astype(np.int64)
        hi = np.minimum(lo + 1, n_in - 1)
        frac = (src - lo).astype(np.float32)
        return lo, hi, frac

    ylo, yhi, fy = coords(h_out, h_in)
    xlo, xhi, fx = coords(w_out, w_in)
    top = data[..., ylo, :][..., :, xlo] * (1 - fx) + data[..., ylo, :][..., :, xhi] * fx
    bot = data[..., yhi, :][..., :, xlo] * (1 - fx) + data[..., yhi, :][..., :, xhi] * fx
    return top * (1 - fy[:, None]) + bot * fy[:, None]


def resize_nearest(data: np.ndarray, out_hw) -> np.ndarray:
    """Legacy 'nearest' resize (floor of the source index)."""
    h_in, w_in = data.shape[-2:]
    h_out, w_out = out_hw
    if (h_in, w_in) == (h_out, w_out):
        return np.asarray(data)
    ys = np.minimum((np.arange(h_out) * (h_in / h_out)).astype(np.int64), h_in - 1)
    xs = np.minimum((np.arange(w_out) * (w_in / w_out)).astype(np.int64), w_in - 1)
    return np.asarray(data)[..., ys, :][..., :, xs]


def resize(data: np.ndarray, out_hw, mode: str = "bilinear") -> np.ndarray:
    if mode == "bilinear":
        return resize_bilinear(data, out_hw)
    if mode == "nearest":
        return resize_nearest(data, out_hw)
    raise ValueError(f"Unsupported resize mode: {mode}")

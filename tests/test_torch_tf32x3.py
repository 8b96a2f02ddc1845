"""3xTF32, the fp32 route of the port's conv (K1) and attention (K2) kernels,
emulated in numpy on the CPU against an fp64 reference.

The kernels split every fp32 operand x into hi = x rounded to TF32 (10
mantissa bits, to nearest, ties away from zero) and lo = x - hi, which the
tensor cores read truncated to TF32 (the conv's weights have their lo rounded
once per parameter), and take each product as a_lo b_hi + a_hi b_lo + a_hi
b_hi with fp32 sums. These tests run that arithmetic at small shapes, with the
rounding done on the bits as ``ops/fused_conv_gn.round_tf32`` does it, and
hold it to the tolerances the card holds the kernels to (``chip_smoke.py``):
K1's conv within 1e-4 max|ref|, K2 within 2e-5 + 2e-5 |ref|; both also within
the JAX kernel tests' 2e-5 abs + 2e-5 rel. One TF32 pass misses them, which
is why the kernels take three.
"""

import numpy as np
import pytest
import torch

from sbgm_danra_tpu_torch.ops import fused_conv_gn as k1


def _tf32(x):
    bits = np.asarray(x, np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def _truncate(x):
    return (np.asarray(x, np.float32).view(np.uint32) & np.uint32(0xFFFFE000)).view(np.float32)


def _split(x, lo_rounded=False):
    """hi and lo as the tensor cores see them: lo = x - hi truncated to TF32
    (activations), or rounded (the conv's weights, split once per parameter)."""
    hi = _tf32(x)
    lo = (x - hi).astype(np.float32)
    return hi, _tf32(lo) if lo_rounded else _truncate(lo)


def _product(a, b, passes, b_lo_rounded=False):
    """a @ b in fp32 from TF32 operands: one pass (hi hi) or three."""
    (ah, al), (bh, bl) = _split(a), _split(b, b_lo_rounded)
    if passes == 1:
        return np.matmul(ah, bh)
    return (np.matmul(al, bh) + np.matmul(ah, bl) + np.matmul(ah, bh)).astype(np.float32)


def _patches(x):
    """SAME 3x3 im2col of NHWC x: [N H W, 9 Cin], taps major."""
    n, h, w, c = x.shape
    xp = np.pad(x, ((0, 0), (1, 1), (1, 1), (0, 0)))
    taps = [xp[:, dy:dy + h, dx:dx + w] for dy in range(3) for dx in range(3)]
    return np.concatenate(taps, axis=-1).reshape(n * h * w, 9 * c)


def _conv_inputs(shape, cout, seed):
    rng = np.random.default_rng(seed)
    cin = shape[-1]
    x = rng.normal(size=shape).astype(np.float32)
    kernel = (rng.normal(size=(3, 3, cin, cout)) / (3 * cin**0.5)).astype(np.float32)
    return x, kernel


@pytest.mark.parametrize("shape, cout", [((2, 12, 10, 64), 64), ((1, 6, 9, 200), 72),
                                         ((2, 5, 5, 512), 64)], ids=str)
def test_conv_in_3xtf32_meets_the_fp32_tolerances(shape, cout):
    x, kernel = _conv_inputs(shape, cout, seed=sum(shape))
    a, b = _patches(x), kernel.reshape(-1, cout)
    ref = _patches(x.astype(np.float64)) @ kernel.astype(np.float64).reshape(-1, cout)
    got = _product(a, b, passes=3, b_lo_rounded=True)
    err = np.abs(got - ref)
    assert err.max() <= 1e-4 * np.abs(ref).max()
    assert (err <= 2e-5 + 2e-5 * np.abs(ref)).all()
    one = np.abs(_product(a, b, passes=1) - ref)
    assert not (one <= 2e-5 + 2e-5 * np.abs(ref)).all()  # one TF32 pass does not do


def _attention(q, k, v, passes):
    """The kernel's arithmetic for one head: scores and P.V in TF32 products,
    softmax by exp2 with the scale folded into the exponent, fp32 sums."""
    c = np.float32(np.log2(np.e) / np.sqrt(q.shape[-1]))
    s = _product(q, k.T, passes)
    m = s.max(axis=-1, keepdims=True)
    p = np.exp2(s * c - m * c).astype(np.float32)
    return _product(p, v, passes) / p.sum(axis=-1, keepdims=True, dtype=np.float32)


def _attention_ref(q, k, v):
    q, k, v = (t.astype(np.float64) for t in (q, k, v))
    s = q @ k.T / np.sqrt(q.shape[-1])
    p = np.exp(s - s.max(axis=-1, keepdims=True))
    return p @ v / p.sum(axis=-1, keepdims=True)


@pytest.mark.parametrize("s_len, d, late_scale", [(300, 32, 1.0), (200, 64, 1.0),
                                                  (130, 128, 1.0), (300, 32, 8.0)],
                         ids=["d32", "d64", "d128", "late_large_keys"])
def test_attention_in_3xtf32_meets_the_fp32_tolerance(s_len, d, late_scale):
    """Per head; late_large_keys scales the keys past the middle by 8, as the
    card's fp32 test does, so that the row max sits far above the first
    keys'."""
    rng = np.random.default_rng(d + s_len)
    q, k, v = (rng.normal(size=(s_len, d)).astype(np.float32) for _ in range(3))
    k[s_len // 2:] *= np.float32(late_scale)
    ref = _attention_ref(q, k, v)
    tol = 2e-5 + 2e-5 * np.abs(ref)
    assert (np.abs(_attention(q, k, v, passes=3) - ref) <= tol).all()
    assert not (np.abs(_attention(q, k, v, passes=1) - ref) <= tol).all()


def test_scores_in_the_hundreds_are_at_fp32s_own_resolution():
    """Keys x 40 (the bf16 card test's scale) put scores in the hundreds,
    where one fp32 rounding of a score already moves p by about 1e-5: plain
    fp32 arithmetic takes more than half of the 2e-5 relative tolerance, and
    3xTF32, whose lo parts lose their last bits, about all of it. The fp32
    kernel is held to the tolerance at keys x 8 instead."""
    rng = np.random.default_rng(332)
    q, k, v = (rng.normal(size=(300, 32)).astype(np.float32) for _ in range(3))
    k[150:] *= np.float32(40)
    ref = _attention_ref(q, k, v)
    tol = 2e-5 + 2e-5 * np.abs(ref)
    c = np.float32(np.log2(np.e) / np.sqrt(32))
    s = (q @ k.T).astype(np.float32)
    p = np.exp2(s * c - s.max(axis=-1, keepdims=True) * c).astype(np.float32)
    plain = (p @ v) / p.sum(axis=-1, keepdims=True, dtype=np.float32)
    assert 0.5 <= (np.abs(plain - ref) / tol).max() <= 1.0
    assert (np.abs(_attention(q, k, v, passes=3) - ref) / tol).max() > 0.9


def test_emulation_rounds_as_the_port_does():
    x = np.random.default_rng(1).normal(size=1000).astype(np.float32)
    np.testing.assert_array_equal(_tf32(x).view(np.uint32),
                                  k1.round_tf32(torch.from_numpy(x)).numpy().view(np.uint32))

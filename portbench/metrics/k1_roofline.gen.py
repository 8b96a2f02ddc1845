"""K1 (conv3x3 + GroupNorm chains) against its roofline: the least time of the
traced evaluations' decoder chains over the device time of K1's kernels."""

from portbench.readers import k1_roofline as read  # noqa: F401

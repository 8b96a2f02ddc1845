"""K2 (flash attention forward) against its roofline: the least time of the
traced evaluations' attention layers that K2 runs over its kernels' device time."""

from portbench.readers import k2_roofline as read  # noqa: F401

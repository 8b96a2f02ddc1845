"""Model operations of the traced stretch's UNet evaluations over its
length, per cent of the bf16 peak."""

from portbench.readers import traced_mfu as read  # noqa: F401

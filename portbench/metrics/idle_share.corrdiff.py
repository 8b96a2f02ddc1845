"""Per cent of the traced window in which the device ran no kernel, copy or set."""

from portbench.readers import idle_share as read  # noqa: F401

"""The least time of the program's kernel launches in the traced stretch over
their device time (percent)."""

from perfbench.lib.readers import kernel_roofline_pct as read  # noqa: F401

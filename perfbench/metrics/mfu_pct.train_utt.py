"""2 x the MACs the window's served or trained inputs need, over the window,
over the dense bf16 peak (percent)."""

from perfbench.lib.readers import mfu_pct as read  # noqa: F401

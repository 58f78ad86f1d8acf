"""Share of an untraced step's wall time in which no kernel, copy or set
runs on the card: a traced step's device-busy time over an untraced step's
(percent)."""

from perfbench.lib.readers_dialogue import device_idle_pct as read  # noqa: F401

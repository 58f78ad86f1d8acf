"""Share of the traced stretch in which no kernel, copy or set runs on the card
(percent)."""

from perfbench.lib.readers import device_idle_pct as read  # noqa: F401

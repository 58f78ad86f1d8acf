"""2 x the MACs the window's dialogues need at their real tokens, frames and
rows (lib/flops_dialogue.py), over the window, over the dense bf16 peak
(percent)."""

from perfbench.lib.readers import mfu_pct as read  # noqa: F401

"""Valid utterances over the padded grid's utterance slots of the window's
batches, from the program's `fmmt.data.slots` counter (percent)."""

from perfbench.lib.readers_dialogue import slot_fill_pct as read  # noqa: F401

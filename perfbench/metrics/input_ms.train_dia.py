"""Host ms a step that the step waits for the loader's next batch and copies
it to the card, before the profiler records."""

from perfbench.lib.readers_dialogue import input_ms as read  # noqa: F401

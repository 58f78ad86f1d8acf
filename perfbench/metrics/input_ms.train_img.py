"""Host ms per step in fetch, copy and augment, from the benchmark's spans."""

from perfbench.lib.readers import input_ms as read  # noqa: F401

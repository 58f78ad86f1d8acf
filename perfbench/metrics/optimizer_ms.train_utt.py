"""Device ms per step launched under the benchmark's span around the optimizer
step."""

from perfbench.lib.readers import optimizer_ms as read  # noqa: F401

"""Device ms a traced dialogue step launches under `fmmt.train.backward`."""

from perfbench.lib.readers_dialogue import backward_device_ms as read  # noqa: F401

"""Device ms a traced dialogue step launches under `fmmt.model.crossmodal`
and `fmmt.model.head`: the four stack applications, multimodal_linear2,
the dropout and the classifier."""

from perfbench.lib.readers_dialogue import fusion_device_ms as read  # noqa: F401

"""Device ms a traced dialogue step launches under `fmmt.model.text`: the
BERT tower, text_linear and the [SEP] scatter."""

from perfbench.lib.readers_dialogue import text_device_ms as read  # noqa: F401

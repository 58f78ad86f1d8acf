"""Device ms a traced dialogue step launches under `fmmt.model.encoders`:
the audio and vision utterance streams over every slot, and their
pooling."""

from perfbench.lib.readers_dialogue import encoders_device_ms as read  # noqa: F401

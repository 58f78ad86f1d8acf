"""Host ms per pack in EmotionServer.build_pack, from the benchmark's span,
outside the traced stretch."""

from perfbench.lib.readers import build_pack_ms as read  # noqa: F401

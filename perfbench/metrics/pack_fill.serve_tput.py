"""Mean requests per pack of the front end (AsyncBatchServer.pack_sizes) over
the window."""

from perfbench.lib.readers import pack_fill as read  # noqa: F401

"""The data shard a forward runs under, and the random draws that follow it.

Under `data_shard(parts, index, group)` a forward sees this rank's rows of
a batch whose leading axes were split in `parts` equal shards
(parallel/mesh.py::shard_batch).  Inside it:
  * every random draw of the port (dropout masks, drop-path multipliers,
    gumbel noise; `rand`) is drawn at the GLOBAL shape, leading axis times
    `parts`, and this shard's rows are kept, so a data-parallel run draws
    what one process draws for the whole batch;
  * the Swin head's BatchNorm takes the statistics of the global batch and
    the pipeline gathers the FER distributions and the text features of the
    other shards (ops/swin.py, models/pipeline.py, models/multimodal.py),
    over `group`.
Outside it a forward is local: one process, or a pass every rank runs whole
(a batch whose size the data ranks do not divide).  The state is per
thread (a serving packer thread enters it around its own forward).
"""

from __future__ import annotations

import threading
from contextlib import contextmanager
from typing import Any, NamedTuple, Optional

import torch

_local = threading.local()


class DataShard(NamedTuple):
    parts: int
    index: int
    group: Any      # the torch.distributed group of the data ranks


def current() -> Optional[DataShard]:
    return getattr(_local, "shard", None)


@contextmanager
def data_shard(parts: int, index: int, group):
    """Run the block as shard `index` of `parts` (a no-op for parts == 1)."""
    with restore(DataShard(parts, index, group) if parts > 1 else None):
        yield


@contextmanager
def restore(shard: Optional[DataShard]):
    """Run the block under `shard` (None: local), whatever is current."""
    prev = current()
    _local.shard = shard
    try:
        yield
    finally:
        _local.shard = prev


def rand(shape, generator: Optional[torch.Generator], device,
         dtype: torch.dtype = torch.float32, split=None) -> torch.Tensor:
    """torch.rand(shape) from `generator`.  Under a data shard the draw is
    of the global shape (leading axis times the shard count) and this
    shard's rows are returned; `split` = (dim, parts, index) does the same
    for one more axis (the heads or hidden units a tensor-parallel rank
    holds).  Without either it is exactly torch.rand(shape)."""
    shape = tuple(shape)
    full = list(shape)
    shard = current()
    if shard is not None:
        full[0] *= shard.parts
    if split is not None:
        full[split[0]] *= split[1]
    u = torch.rand(full, generator=generator, device=device, dtype=dtype)
    if shard is not None:
        u = u.narrow(0, shard.index * shape[0], shape[0])
    if split is not None:
        dim, _, index = split
        u = u.narrow(dim, index * shape[dim], shape[dim])
    return u

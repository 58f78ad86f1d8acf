"""Collectives of the port's multi-device runs, over all_reduce and
all_gather only (NCCL has both; gloo has both for CPU tensors).

Differentiable forms (written here: torch.distributed.nn.functional is
deprecated, and its gather's backward needs a reduce-scatter or all-to-all):
  * all_reduce_sum: a sum whose backward sums the gradients over the group
    (torch.distributed.nn.functional.all_reduce's rule): the data ranks'
    losses are different terms of one global loss (the BatchNorm
    statistics);
  * gather_rows: the rows of every rank in rank order; the backward sums
    the gradient over the group and keeps this rank's rows (the FER
    distributions, the text features, under a data shard);
  * copy_to_model / reduce_from_model: the tensor-parallel pair (Megatron's
    f and g).  Every rank of a model group computes the SAME loss, so the
    sum after a row-parallel product has an identity backward and the input
    of a column-parallel product sums its gradient over the group; torch's
    all_reduce, whose backward sums too, would count that gradient tp times.

A serving front over a mesh (serving.py::AsyncBatchServer) feeds the other
ranks from the main one by broadcasts over a gloo group of the mesh's ranks
(MeshPlan.host_group, made by build_mesh), on CPU tensors: a header (op,
bucket index, requests), the pack's fixed-shape arrays and a picklable
object.  gloo, whatever the mesh runs on: a follower waits in the header's
broadcast while the server idles, and a blocked NCCL collective is killed
by its watchdog.  A wait there raises after HOST_TIMEOUT_S.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

PACK, IDLE, STOP = 0, 1, 2      # the ops of a front's header
HOST_TIMEOUT_S = 600.0          # the timeout of a mesh's host group


def group_size(group) -> int:
    return dist.get_world_size(group)


def _comm_device(t: torch.Tensor, group) -> torch.device:
    """Where `t` goes for a collective: NCCL takes CUDA tensors only."""
    if not t.is_cuda and dist.get_backend(group) == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return t.device


def all_gather_cat(t: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """Every rank's `t` (same shape on each) concatenated on `dim` in rank
    order; not differentiable."""
    n = group_size(group)
    if n == 1:
        return t
    home = t.device
    t = t.contiguous().to(_comm_device(t, group))
    parts = [torch.empty_like(t) for _ in range(n)]
    dist.all_gather(parts, t, group=group)
    return torch.cat(parts, dim).to(home)


def all_reduce_(t: torch.Tensor, group) -> torch.Tensor:
    """In-place sum over the group (any device); returns `t`."""
    dev = _comm_device(t, group)
    if dev == t.device:
        dist.all_reduce(t, group=group)
        return t
    wire = t.to(dev)
    dist.all_reduce(wire, group=group)
    return t.copy_(wire)


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce_(x.contiguous().clone(), group)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce_(grad.contiguous().clone(), ctx.group), None


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """The sum over the group; the backward sums the gradients too."""
    if group_size(group) == 1:
        return x
    if x.requires_grad and torch.is_grad_enabled():
        return _AllReduceSum.apply(x, group)
    return all_reduce_(x.contiguous().clone(), group)


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        ctx.rows = x.shape[0]
        ctx.index = dist.get_rank(group)
        return all_gather_cat(x, group)

    @staticmethod
    def backward(ctx, grad):
        grad = all_reduce_(grad.contiguous().clone(), ctx.group)
        return grad.narrow(0, ctx.index * ctx.rows, ctx.rows), None


def gather_rows(x: torch.Tensor, group) -> torch.Tensor:
    """(n, ...) on each of the group's ranks -> (n * ranks, ...)."""
    if group_size(group) == 1:
        return x
    if x.requires_grad and torch.is_grad_enabled():
        return _GatherRows.apply(x, group)
    return all_gather_cat(x, group)


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce_(grad.contiguous().clone(), ctx.group), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce_(x.contiguous().clone(), group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def copy_to_model(x: torch.Tensor, group) -> torch.Tensor:
    """Identity; the backward sums the gradient over the model group."""
    if x.requires_grad and torch.is_grad_enabled():
        return _CopyToModel.apply(x, group)
    return x


def reduce_from_model(x: torch.Tensor, group) -> torch.Tensor:
    """Sum of the model group's partial products; identity backward."""
    if x.requires_grad and torch.is_grad_enabled():
        return _ReduceFromModel.apply(x, group)
    return all_reduce_(x.contiguous().clone(), group)


class ModelShard:
    """A tensor-parallel layer's place in its model group: `size` ranks,
    this one at `index` (parallel/mesh.py::shard_model_ sets it on the
    layers it splits)."""

    def __init__(self, group, size: int, index: int):
        self.group = group
        self.size = size
        self.index = index

    def head_split(self, dim: int):
        """`split` argument of ops/layers.py::dropout for a tensor whose
        axis `dim` holds this rank's heads or hidden units."""
        return (dim, self.size, self.index)


# ---------------------------------------------------- a serving front's link --

def broadcast_header(header, group, src: int = 0):
    """(op, bucket index, requests) from global rank `src`; the other ranks
    pass None and get it."""
    t = torch.tensor(header if header is not None else (0, 0, 0),
                     dtype=torch.int64)
    dist.broadcast(t, src, group=group)
    return tuple(int(x) for x in t)


def broadcast_arrays(arrays, group, src: int = 0) -> None:
    """Numpy arrays (C-contiguous, of the same shapes and dtypes on every
    rank) from global rank `src`, received in place on the others."""
    for a in arrays:
        dist.broadcast(torch.from_numpy(a.reshape(-1).view(np.uint8)), src,
                       group=group)


def broadcast_object(obj, group, src: int = 0):
    """A picklable object of global rank `src`, on every rank of `group`."""
    box = [obj]
    dist.broadcast_object_list(box, src, group=group)
    return box[0]

"""The (data, model) device mesh of a multi-device run, over torch.distributed
(counterpart of facialmmt_tpu/parallel/mesh.py).

One process per rank (torchrun, or any launcher that sets RANK / WORLD_SIZE
/ LOCAL_RANK), dp x tp ranks laid out row-major as JAX reshapes its devices:
rank = dp_rank * tp + tp_rank.  `build_mesh` makes the DeviceMesh with dims
("data", "model") and takes its two process groups:
  * data: batches split on their leading axes (shard_batch); every rank
    builds the same global batch from the same seed and keeps its rows, as
    JAX's one host places a batch; gradients are summed over the data ranks
    (train/optim.py);
  * model: the Megatron rules of the JAX package's _TP_RULES, restated over
    the port's parameter names (the reference's state_dict names): in the
    text tower, the utterance encoders and the crossmodal stacks, the q / k
    / v and first FFN products are column-parallel (this rank's output
    rows), the attention output and second FFN products row-parallel (its
    input columns, summed over the group); embeddings, LayerNorms, the
    biases of row-parallel products and everything else stay whole.  The
    crossmodal stacks' packed (3E, E) in_proj splits each of its q, k and v
    blocks, not the packed rows.  A layer whose heads or widths tp does not
    divide stays whole (JAX drops a non-dividing leaf's spec; here the
    local-heads form needs the whole layer split or none of it).
ZeRO-1 (zero1_partition): AdamW moments of a leaf of at least min_size
elements split over the data ranks on its first dp-divisible axis, as
opt_state_shardings does.

Checkpoints hold whole tensors (full_state_dict / load_full_state_dict), so
a file written at one layout loads at any other.
"""

from __future__ import annotations

import os
import re
from dataclasses import dataclass
from typing import Any, Dict, List, NamedTuple, Optional

import numpy as np
import torch
import torch.distributed as dist

from facialmmt_tpu_torch.parallel import context
from facialmmt_tpu_torch.parallel.comm import (HOST_TIMEOUT_S, ModelShard,
                                               all_gather_cat)


@dataclass(frozen=True)
class MeshPlan:
    """dp x tp ranks; `mesh` is the DeviceMesh, None on a rank outside the
    mesh (dp shrunk: it leaves the run) and in an abstract plan (audits).
    `host_group`: a gloo group of the mesh's ranks for a serving front's
    host broadcasts (parallel/comm.py), None for a mesh of one rank."""

    mesh: Any
    dp: int
    tp: int
    rank: int = 0
    data_group: Any = None
    model_group: Any = None
    group: Any = None          # the mesh's ranks (None: the default group)
    host_group: Any = None

    @staticmethod
    def abstract(dp: int, tp: int) -> "MeshPlan":
        """A layout without processes: for param_plan / zero1_partition on
        shapes alone."""
        return MeshPlan(None, dp, tp)

    @property
    def member(self) -> bool:
        return self.rank < self.dp * self.tp

    @property
    def dp_rank(self) -> int:
        return self.rank // self.tp

    @property
    def tp_rank(self) -> int:
        return self.rank % self.tp

    @property
    def is_main(self) -> bool:
        return self.rank == 0

    def barrier(self) -> None:
        dist.barrier(group=self.group)

    def data_shard(self):
        """The context a sharded forward runs under (parallel/context.py)."""
        return context.data_shard(self.dp, self.dp_rank, self.data_group)

    def model_shard(self) -> Optional[ModelShard]:
        return (ModelShard(self.model_group, self.tp, self.tp_rank)
                if self.tp > 1 else None)


def init_distributed(device="cuda", backend: Optional[str] = None,
                     init_method: Optional[str] = None,
                     rank: Optional[int] = None,
                     world_size: Optional[int] = None) -> torch.device:
    """Join the process group and return this rank's device.  RANK /
    WORLD_SIZE / LOCAL_RANK come from torchrun's environment unless given;
    a CUDA rank takes card LOCAL_RANK modulo the cards visible (two ranks
    may share one).  The backend is NCCL for CUDA and gloo for the CPU
    unless `backend` says otherwise (gloo on CUDA tensors reduces and
    broadcasts but does not gather, which the port's gathers need).
    Without a world size (not under torchrun) it raises."""
    env = os.environ
    rank = int(env["RANK"]) if rank is None and "RANK" in env else rank
    if world_size is None and "WORLD_SIZE" in env:
        world_size = int(env["WORLD_SIZE"])
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        local = int(env.get("LOCAL_RANK", rank or 0))
        device = torch.device("cuda", local % max(torch.cuda.device_count(),
                                                   1))
    if device.type == "cuda":
        torch.cuda.set_device(device)
    if not dist.is_initialized():
        if world_size is None or rank is None:
            raise NotImplementedError(
                "a multi-device run needs a process group: launch it with "
                "torchrun (torchrun --nproc_per_node N -m "
                "facialmmt_tpu_torch.main ...), which sets RANK and "
                "WORLD_SIZE")
        dist.init_process_group(
            backend or ("nccl" if device.type == "cuda" else "gloo"),
            init_method=init_method or "env://", rank=rank,
            world_size=world_size)
    return device


def build_mesh(dp: int = -1, tp: int = 1, device="cuda") -> MeshPlan:
    """The (data, model) mesh over the first dp * tp ranks of the process
    group (dp = -1: all ranks / tp) on `device`'s kind: the card unless the
    caller asks for "cpu" (without a card "cuda" raises, as resolve_device
    does).  Every rank of the group calls it (the groups are made
    collectively, the host group of a serving front among them: made here,
    where every rank takes part, since a group made by the mesh's ranks
    alone is named from each process's count of groups, which ranks that
    ran different layouts do not share); a rank beyond dp * tp gets a plan
    whose `member` is False."""
    import datetime

    from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

    from facialmmt_tpu_torch.ops.kernels import resolve_device

    kind = resolve_device(device).type
    world = dist.get_world_size()
    rank = dist.get_rank()
    if dp == -1:
        dp = world // tp
    n = dp * tp
    if tp < 1 or dp < 1 or n > world:
        raise ValueError(f"dp({dp}) * tp({tp}) does not fit {world} ranks")
    names = ("data", "model")
    if n == world:
        mesh = init_device_mesh(kind, (dp, tp), mesh_dim_names=names)
        group = None
    else:
        mesh = DeviceMesh(kind, torch.arange(n).reshape(dp, tp),
                          mesh_dim_names=names)
        group = dist.new_group(list(range(n)))
    host = None
    if n > 1:
        host = dist.new_group(list(range(n)), backend="gloo",
                              timeout=datetime.timedelta(seconds=HOST_TIMEOUT_S))
    if rank >= n:
        return MeshPlan(None, dp, tp, rank)
    return MeshPlan(mesh, dp, tp, rank, mesh.get_group("data"),
                    mesh.get_group("model"), group, host)


def shard_batch(plan: MeshPlan, tree: Any, axis: int = 0) -> Any:
    """This rank's rows of a host or device batch: every leaf (numpy array
    or tensor, in dicts, lists and tuples) split in dp equal parts on
    `axis` (axis=1: the microbatch layout (M, batch, ...))."""
    if isinstance(tree, dict):
        return {k: shard_batch(plan, v, axis) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(shard_batch(plan, v, axis) for v in tree)
    n = tree.shape[axis]
    if n % plan.dp:
        raise ValueError(f"axis {axis} of size {n} does not split over "
                         f"dp={plan.dp}")
    k = n // plan.dp
    index = [slice(None)] * axis + [slice(plan.dp_rank * k,
                                          (plan.dp_rank + 1) * k)]
    return tree[tuple(index)]


# ------------------------------------------------------- tensor parallel --

class TPSpec(NamedTuple):
    dim: int          # the torch weight's axis split over the model group
    packed: bool      # the crossmodal in_proj: split each q / k / v block


COL, ROW, PACKED = TPSpec(0, False), TPSpec(1, False), TPSpec(0, True)

_TEXT = r"(?P<layer>.*(?:roberta|bert)\.encoder\.layer\.\d+)\."
_UTT = r"(?P<layer>.*utt_transformer\.layer\.\d+)\."
_CM = r"(?P<layer>.*CrossModalTrans_\w+\.layers\.\d+)\."
# (regex over the state_dict name, spec); facialmmt_tpu/parallel/mesh.py
# _TP_RULES with kernels (in, out) read as torch weights (out, in)
TP_RULES = [
    (_TEXT + r"attention\.self\.(query|key|value)\.(weight|bias)$", COL),
    (_TEXT + r"attention\.output\.dense\.weight$", ROW),
    (_TEXT + r"intermediate\.dense\.(weight|bias)$", COL),
    (_TEXT + r"output\.dense\.weight$", ROW),
    (_UTT + r"transformer_self_attention\.selfatt\.(query|key|value)\."
            r"(weight|bias)$", COL),
    (_UTT + r"transformer_self_attention\.dense_norm\.dense\.weight$", ROW),
    (_UTT + r"intermediate\.dense\.(weight|bias)$", COL),
    (_UTT + r"output\.dense\.weight$", ROW),
    (_CM + r"self_attn\.in_proj_(weight|bias)$", PACKED),
    (_CM + r"self_attn\.out_proj\.weight$", ROW),
    (_CM + r"fc1\.(weight|bias)$", COL),
    (_CM + r"fc2\.weight$", ROW),
]


def _rule(name: str):
    for pattern, spec in TP_RULES:
        m = re.match(pattern, name)
        if m:
            return m.group("layer"), spec
    return None, None


def _divides(shape, spec: TPSpec, tp: int) -> bool:
    size = shape[spec.dim]
    return size % (3 * tp if spec.packed else tp) == 0


def param_plan(plan: MeshPlan, model: torch.nn.Module) -> Dict[str, TPSpec]:
    """{parameter name: TPSpec} of the leaves tp splits; empty at tp = 1.
    A layer is split only when tp divides its heads and every ruled leaf's
    axis; otherwise all of it stays whole."""
    if plan.tp <= 1:
        return {}
    layers: Dict[str, Dict[str, TPSpec]] = {}
    for name, p in model.named_parameters():
        layer, spec = _rule(name)
        if layer is not None:
            layers.setdefault(layer, {})[name] = spec
    out: Dict[str, TPSpec] = {}
    params = dict(model.named_parameters())
    for layer, specs in layers.items():
        heads = model.get_submodule(layer).num_heads
        if heads % plan.tp == 0 and all(
                _divides(params[n].shape, s, plan.tp)
                for n, s in specs.items()):
            out.update(specs)
    return out


def shard_tensor(full: torch.Tensor, spec: TPSpec, tp: int,
                 index: int) -> torch.Tensor:
    """Rank `index`'s part of a whole tensor."""
    if spec.packed:
        return torch.cat([b.chunk(tp, 0)[index] for b in full.chunk(3, 0)])
    return full.chunk(tp, spec.dim)[index]


def unshard_tensor(local: torch.Tensor, spec: TPSpec, group) -> torch.Tensor:
    """The whole tensor from every model rank's part (collective)."""
    tp = dist.get_world_size(group)
    if not spec.packed:
        return all_gather_cat(local, group, spec.dim)
    parts = all_gather_cat(local, group, 0)          # [r: q_r | k_r | v_r]
    rest = tuple(local.shape[1:])
    return parts.reshape((tp, 3, local.shape[0] // 3) + rest).transpose(
        0, 1).reshape((-1,) + rest)


def shard_model_(model: torch.nn.Module, plan: MeshPlan) -> Dict[str, TPSpec]:
    """Split `model`'s tensor-parallel leaves in place (param_plan): each
    becomes this rank's part, a new Parameter carrying `tp_spec`, and each
    split layer gets its ModelShard as `tp`.  Call it on whole weights
    before the optimizer is made; returns the specs."""
    specs = param_plan(plan, model)
    shard = plan.model_shard()
    for name, spec in specs.items():
        owner, leaf = name.rsplit(".", 1)
        mod = model.get_submodule(owner)
        old = getattr(mod, leaf)
        new = torch.nn.Parameter(
            shard_tensor(old.detach(), spec, plan.tp, plan.tp_rank).clone(),
            requires_grad=old.requires_grad)
        new.tp_spec = spec
        setattr(mod, leaf, new)
    for layer in {_rule(n)[0] for n in specs}:
        mod = model.get_submodule(layer)
        mod.tp = shard
        if hasattr(mod, "self_attn"):       # the crossmodal layer's MHA
            mod.self_attn.tp = shard
    model._tp_specs = specs
    mark_jax_axes(model)
    return specs


def mark_jax_axes(model: torch.nn.Module) -> None:
    """Give each parameter whose JAX leaf is laid out otherwise its axes in
    the JAX leaf's order as `jax_axes`: a Linear weight (out, in) is the
    kernel (in, out), the packed in_proj (3E, E) is (E, 3E), the patch
    Conv2d weight (E, C, p, p) is (p, p, C, E) (checkpoint/from_jax.py's
    layouts).  ZeRO-1 searches the axes in that order, so a moment's slices
    are JAX's shards."""
    from facialmmt_tpu_torch.ops.crossmodal import PackedMultiheadAttention

    for mod in model.modules():
        if isinstance(mod, torch.nn.Linear):
            mod.weight.jax_axes = (1, 0)
        elif isinstance(mod, torch.nn.Conv2d):
            mod.weight.jax_axes = (2, 3, 1, 0)
        elif isinstance(mod, PackedMultiheadAttention):
            mod.in_proj_weight.jax_axes = (1, 0)


def full_state_dict(model: torch.nn.Module,
                    plan: Optional[MeshPlan]) -> Dict[str, torch.Tensor]:
    """model.state_dict() with every split leaf made whole again (a
    collective over the model group: every rank calls it)."""
    sd = model.state_dict()
    specs = getattr(model, "_tp_specs", {})
    if plan is None or not specs:
        return sd
    return {k: (unshard_tensor(v, specs[k], plan.model_group)
                if k in specs else v) for k, v in sd.items()}


def load_full_state_dict(model: torch.nn.Module, sd: Dict[str, Any],
                         plan: Optional[MeshPlan]) -> None:
    """Load whole tensors into a model split by shard_model_ (strict)."""
    specs = getattr(model, "_tp_specs", {})
    if plan is not None and specs:
        sd = {k: (shard_tensor(torch.as_tensor(v), specs[k], plan.tp,
                               plan.tp_rank) if k in specs else v)
              for k, v in sd.items()}
    model.load_state_dict(sd, strict=True)


# ----------------------------------------------------------------- ZeRO-1 --

def zero1_partition(plan: MeshPlan, tensors, min_size: int = 65536
                    ) -> List[Optional[int]]:
    """Per tensor (anything with .shape): the axis its AdamW moments split
    on over the dp data ranks, or None (replicated): the first axis dp
    divides, for a leaf of at least `min_size` elements
    (facialmmt_tpu/parallel/mesh.py::opt_state_shardings), searched in the
    tensor's `jax_axes` order where it has one (mark_jax_axes)."""
    out: List[Optional[int]] = []
    for t in tensors:
        shape = tuple(t.shape)
        size = int(np.prod(shape)) if shape else 1
        order = getattr(t, "jax_axes", range(len(shape)))
        axis = None
        if plan.dp > 1 and size >= min_size:
            axis = next((ax for ax in order
                         if shape[ax] % plan.dp == 0 and shape[ax] >= plan.dp),
                        None)
        out.append(axis)
    return out

"""Weight bridge between JAX pipeline variables and this port's state_dict.

Takes the JAX FacialMMTPipeline's `variables` as nested mappings of arrays
(`params` and `batch_stats`, each with `swin_model` and `multimodal`
branches), or those of the appendix's models (the utterance-level model's
modality subsets and concat fusion, the dialogue-level model), and returns
{name: np.ndarray} under the reference's torch names,
which is what the port's modules are built with, so the result loads with
load_state_dict(strict=True).  It is the numpy twin of
facialmmt_tpu/checkpoint/torch_export.py (that module needs the JAX Swin ops
for its geometry buffers).  Layout rules:
  * dense kernel (in, out)            -> Linear weight (out, in);
  * patch kernel (p, p, C, E)          -> Conv2d weight (E, C, p, p);
  * in_proj_kernel (E, 3E)             -> in_proj_weight (3E, E);
  * BatchNorm batch_stats mean / var   -> running_mean / running_var.

The mapping is a list of rules (path in the JAX tree, state_dict name,
layout), so it also runs backwards: `to_jax_tree` puts a state_dict, or the
port's gradients under the same names, back under the JAX tree's paths, and
`load_adamw_state` / `load_multitask_state` carry optax AdamW moments and the
update counts into the port's optimizers.
Everything here takes and returns numpy arrays; nothing imports JAX.
"""

from __future__ import annotations

from typing import Any, Dict, List, Mapping, Tuple

import numpy as np

from facialmmt_tpu_torch.ops.swin import (relative_position_index,
                                          shifted_window_mask)

StateDict = Dict[str, np.ndarray]
CROSSMODAL_STACKS = ("CrossModalTrans_TA", "CrossModalTrans_TA_V",
                     "CrossModalTrans_TV")
Path = Tuple[str, ...]
Rule = Tuple[Path, str, str]          # (JAX path, state_dict name, layout)

_TO_TORCH = {"copy": lambda a: a,
             "T": lambda a: a.T.copy(),
             "patch": lambda a: a.transpose(3, 2, 0, 1).copy()}
_TO_JAX = {"copy": lambda a: a,
           "T": lambda a: a.T.copy(),
           "patch": lambda a: a.transpose(2, 3, 1, 0).copy()}


def _np(x) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(x, dtype=np.float32))


def _get(tree, path: Path):
    for key in path:
        tree = tree[key]
    return tree


def _linear(tree: Mapping[str, Any], at: Path, prefix: str) -> List[Rule]:
    rules = [(at + ("kernel",), f"{prefix}.weight", "T")]
    if "bias" in _get(tree, at):
        rules.append((at + ("bias",), f"{prefix}.bias", "copy"))
    return rules


def _norm(tree: Mapping[str, Any], at: Path, prefix: str) -> List[Rule]:
    """LayerNormTF ('weight') and flax LayerNorm / BatchNorm ('scale')."""
    scale = "weight" if "weight" in _get(tree, at) else "scale"
    return [(at + (scale,), f"{prefix}.weight", "copy"),
            (at + ("bias",), f"{prefix}.bias", "copy")]


def _num_layers(tree) -> int:
    return sum(1 for k in tree if str(k).startswith("layer_"))


def _utt_encoder_rules(tree, at: Path, p: str) -> List[Rule]:
    rules = [(at + ("position_embeddings",),
              f"{p}.position_embeddings.weight", "copy")]
    for i in range(_num_layers(_get(tree, at))):
        la = at + (f"layer_{i}",)
        lp = f"{p}.layer.{i}"
        sa = f"{lp}.transformer_self_attention"
        for name in ("query", "key", "value"):
            rules += _linear(tree, la + ("selfatt", name), f"{sa}.selfatt.{name}")
        rules += _linear(tree, la + ("attn_dense",), f"{sa}.dense_norm.dense")
        rules += _norm(tree, la + ("attn_norm",), f"{sa}.dense_norm.LayerNorm")
        rules += _linear(tree, la + ("intermediate",), f"{lp}.intermediate.dense")
        rules += _linear(tree, la + ("output",), f"{lp}.output.dense")
        rules += _norm(tree, la + ("out_norm",), f"{lp}.output.LayerNorm")
    return rules


def _crossmodal_rules(tree, at: Path, p: str) -> List[Rule]:
    rules = _norm(tree, at + ("final_norm",), f"{p}.layer_norm")
    for i in range(_num_layers(_get(tree, at))):
        la = at + (f"layer_{i}",)
        lp = f"{p}.layers.{i}"
        rules += [(la + ("self_attn", "in_proj_kernel"),
                   f"{lp}.self_attn.in_proj_weight", "T"),
                  (la + ("self_attn", "in_proj_bias"),
                   f"{lp}.self_attn.in_proj_bias", "copy")]
        rules += _linear(tree, la + ("self_attn", "out_proj"),
                         f"{lp}.self_attn.out_proj")
        rules += _linear(tree, la + ("fc1",), f"{lp}.fc1")
        rules += _linear(tree, la + ("fc2",), f"{lp}.fc2")
        rules += _norm(tree, la + ("ln0",), f"{lp}.layer_norms.0")
        rules += _norm(tree, la + ("ln1",), f"{lp}.layer_norms.1")
    return rules


def _text_encoder_rules(tree, at: Path, p: str) -> List[Rule]:
    rules = [(at + (name, "embedding"), f"{p}.embeddings.{name}.weight", "copy")
             for name in ("word_embeddings", "position_embeddings",
                          "token_type_embeddings")]
    rules += _norm(tree, at + ("embeddings_norm",), f"{p}.embeddings.LayerNorm")
    for i in range(_num_layers(_get(tree, at))):
        la = at + (f"layer_{i}",)
        lp = f"{p}.encoder.layer.{i}"
        for name in ("query", "key", "value"):
            rules += _linear(tree, la + (name,), f"{lp}.attention.self.{name}")
        rules += _linear(tree, la + ("attn_out",), f"{lp}.attention.output.dense")
        rules += _norm(tree, la + ("attn_norm",),
                       f"{lp}.attention.output.LayerNorm")
        rules += _linear(tree, la + ("intermediate",), f"{lp}.intermediate.dense")
        rules += _linear(tree, la + ("output",), f"{lp}.output.dense")
        rules += _norm(tree, la + ("out_norm",), f"{lp}.output.LayerNorm")
    return rules


def _swin_depths(params) -> List[int]:
    depths: List[int] = []
    while f"stage_{len(depths)}_block_0" in params:
        d = 0
        while f"stage_{len(depths)}_block_{d}" in params:
            d += 1
        depths.append(d)
    return depths


def _swin_backbone_rules(tree, at: Path, p: str) -> List[Rule]:
    """Stage/block structure is read off the tree itself (as torch_export
    does)."""
    params = _get(tree, at)
    depths = _swin_depths(params)
    rules = [(at + ("patch_embed", "proj_kernel"),
              f"{p}.patch_embed.proj.weight", "patch"),
             (at + ("patch_embed", "proj_bias"),
              f"{p}.patch_embed.proj.bias", "copy")]
    if "norm" in params["patch_embed"]:
        rules += _norm(tree, at + ("patch_embed", "norm"), f"{p}.patch_embed.norm")
    for s, depth in enumerate(depths):
        for d in range(depth):
            ba = at + (f"stage_{s}_block_{d}",)
            bp = f"{p}.layers.{s}.blocks.{d}"
            rules += _norm(tree, ba + ("norm1",), f"{bp}.norm1")
            rules += _norm(tree, ba + ("norm2",), f"{bp}.norm2")
            rules += _linear(tree, ba + ("attn", "qkv"), f"{bp}.attn.qkv")
            rules += _linear(tree, ba + ("attn", "proj"), f"{bp}.attn.proj")
            rules.append((ba + ("attn", "relative_position_bias_table"),
                          f"{bp}.attn.relative_position_bias_table", "copy"))
            rules += _linear(tree, ba + ("mlp_fc1",), f"{bp}.mlp.fc1")
            rules += _linear(tree, ba + ("mlp_fc2",), f"{bp}.mlp.fc2")
        if s < len(depths) - 1:
            da = at + (f"stage_{s}_downsample",)
            rules += _norm(tree, da + ("norm",), f"{p}.layers.{s}.downsample.norm")
            rules += _linear(tree, da + ("reduction",),
                             f"{p}.layers.{s}.downsample.reduction")
    rules += _norm(tree, at + ("head_norm",), f"{p}.output_layer.0")
    rules += _linear(tree, at + ("head_linear",), f"{p}.output_layer.2")
    rules += _norm(tree, at + ("head_bn",), f"{p}.output_layer.3")
    return rules


def _swin_geometry(params, out: StateDict, p: str) -> None:
    """Index and mask buffers of the port's Swin, from the tree's shapes."""
    depths = _swin_depths(params)
    kernel_shape = np.asarray(params["patch_embed"]["proj_kernel"]).shape
    c_final = kernel_shape[3] * 2 ** (len(depths) - 1)
    head_in = np.asarray(params["head_linear"]["kernel"]).shape[0]
    final_res = int(round(np.sqrt(head_in // c_final)))
    for s, depth in enumerate(depths):
        res = final_res * 2 ** (len(depths) - 1 - s)
        for d in range(depth):
            table = params[f"stage_{s}_block_{d}"]["attn"][
                "relative_position_bias_table"]
            bp = f"{p}.layers.{s}.blocks.{d}"
            ws = (int(round(np.sqrt(np.asarray(table).shape[0]))) + 1) // 2
            ws_eff = min(ws, res)
            out[f"{bp}.attn.relative_position_index"] = \
                relative_position_index(ws_eff).astype(np.int64)
            if d % 2 == 1 and res > ws:
                out[f"{bp}.attn_mask"] = shifted_window_mask(
                    res, res, ws_eff, ws // 2)
    out[f"{p}.output_layer.3.num_batches_tracked"] = np.asarray(0, np.int64)


def _swin_fer_rules(tree, at: Path, prefix: str) -> List[Rule]:
    return (_swin_backbone_rules(tree, at + ("swin",), f"{prefix}swin")
            + _linear(tree, at + ("linear",), f"{prefix}linear")
            + _linear(tree, at + ("classifier",), f"{prefix}classifier"))


def _swin_stats_rules(at: Path, prefix: str) -> List[Rule]:
    bn = f"{prefix}swin.output_layer.3"
    return [(at + ("swin", "head_bn", "mean"), f"{bn}.running_mean", "copy"),
            (at + ("swin", "head_bn", "var"), f"{bn}.running_var", "copy")]


def _pooling_rules(tree, at: Path, p: str) -> List[Rule]:
    rules = [(at + ("query_vector",), f"{p}.query_vector", "copy")]
    for name in ("P", "Q", "value"):
        rules += _linear(tree, at + (name,), f"{p}.{name}")
    return rules


def _text_rules(tree, at: Path, plm_name: str, p: str) -> List[Rule]:
    text = p + ("roberta" if "roberta" in plm_name else "bert")
    return (_text_encoder_rules(tree, at + ("text_encoder",), text)
            + _linear(tree, at + ("text_linear",), f"{p}text_linear"))


def _feature_tower_rules(tree, at: Path, p: str) -> List[Rule]:
    """The audio and vision towers that the tree holds (a modality subset
    has only its own)."""
    rules: List[Rule] = []
    for stream in ("audio", "vision"):
        if f"{stream}_linear" in _get(tree, at):
            rules += _linear(tree, at + (f"{stream}_linear",),
                             f"{p}{stream}_linear")
            rules += _utt_encoder_rules(
                tree, at + (f"{stream}_utt_transformer",),
                f"{p}{stream}_utt_transformer")
    return rules


def _fusion_rules(tree, at: Path, p: str) -> List[Rule]:
    """The crossmodal stacks and fusion linears that the tree holds."""
    rules: List[Rule] = []
    for name in CROSSMODAL_STACKS:
        if name in _get(tree, at):
            rules += _crossmodal_rules(tree, at + (name,), f"{p}{name}")
    for name in ("multimodal_linear", "multimodal_linear2"):
        if name in _get(tree, at):
            rules += _linear(tree, at + (name,), f"{p}{name}")
    return rules


def _multimodal_rules(tree, at: Path, plm_name: str, p: str) -> List[Rule]:
    """The utterance-level model, T+A+V or a modality subset, crossmodal or
    concat fusion: the towers the tree holds."""
    return (_text_rules(tree, at, plm_name, p)
            + _feature_tower_rules(tree, at, p)
            + _pooling_rules(tree, at + ("attention",), f"{p}attention")
            + _fusion_rules(tree, at, p)
            + _linear(tree, at + ("classifier",), f"{p}classifier"))


def _dialogue_rules(tree, at: Path, plm_name: str, p: str) -> List[Rule]:
    return (_text_rules(tree, at, plm_name, p)
            + _feature_tower_rules(tree, at, p)
            + _pooling_rules(tree, at + ("attention_pooling",),
                             f"{p}attention_pooling")
            + _fusion_rules(tree, at, p)
            + _linear(tree, at + ("classifier",), f"{p}classifier"))


def _apply(rules: List[Rule], tree) -> StateDict:
    return {name: _TO_TORCH[layout](_np(_get(tree, path)))
            for path, name, layout in rules}


def _crossmodal_buffers(params, out: StateDict, p: str) -> None:
    out[f"{p}.version"] = np.asarray([2.0], np.float32)
    out[f"{p}.embed_positions._float_tensor"] = np.zeros((1,), np.float32)


# The helpers below write one sub-module into `out` under a prefix; the op
# tests bridge single modules with them.

def _utt_encoder(tree, out: StateDict, p: str) -> None:
    out.update(_apply(_utt_encoder_rules(tree, (), p), tree))


def _crossmodal(tree, out: StateDict, p: str) -> None:
    out.update(_apply(_crossmodal_rules(tree, (), p), tree))
    _crossmodal_buffers(tree, out, p)


def _text_encoder(tree, out: StateDict, p: str) -> None:
    out.update(_apply(_text_encoder_rules(tree, (), p), tree))


def swin_fer_state_dict(variables, prefix: str = "") -> StateDict:
    """JAX SwinForAffwildClassification variables -> state_dict."""
    params = variables["params"]
    out = _apply(_swin_fer_rules(params, (), prefix), params)
    out.update(_apply(_swin_stats_rules((), prefix), variables["batch_stats"]))
    _swin_geometry(params["swin"], out, f"{prefix}swin")
    return out


def multimodal_state_dict(variables, plm_name: str = "roberta-large",
                          prefix: str = "") -> StateDict:
    """JAX MultiModalTransformerForClassification variables (any modality
    subset, crossmodal or concat fusion) -> state_dict.  plm_name picks the
    text tower's attribute ('roberta' or 'bert')."""
    params = variables["params"]
    out = _apply(_multimodal_rules(params, (), plm_name, prefix), params)
    _stack_buffers(params, out, prefix)
    return out


def dialogue_state_dict(variables, plm_name: str = "roberta-large",
                        prefix: str = "") -> StateDict:
    """JAX DialogueMultiModalTransformer variables -> state_dict, under the
    names of the reference's (Appendix)CCAC2023/src/models.py, which the JAX
    module names mirror (attention_pooling, multimodal_linear2, ...)."""
    params = variables["params"]
    out = _apply(_dialogue_rules(params, (), plm_name, prefix), params)
    _stack_buffers(params, out, prefix)
    return out


def _stack_buffers(params, out: StateDict, prefix: str) -> None:
    for name in CROSSMODAL_STACKS:
        if name in params:
            _crossmodal_buffers(params[name], out, f"{prefix}{name}")


def pipeline_state_dict(variables, plm_name: str = "roberta-large") -> StateDict:
    """JAX FacialMMTPipeline variables -> the port pipeline's state_dict."""
    params, stats = variables["params"], variables["batch_stats"]
    out = swin_fer_state_dict({"params": params["swin_model"],
                               "batch_stats": stats["swin_model"]},
                              prefix="swin_model.")
    out.update(multimodal_state_dict({"params": params["multimodal"]},
                                     plm_name, prefix="multimodal."))
    return out


def _pipeline_rules(variables, plm_name: str) -> List[Rule]:
    """Rules over the whole {'params', 'batch_stats'} tree of the pipeline."""
    return (_swin_fer_rules(variables, ("params", "swin_model"), "swin_model.")
            + _swin_stats_rules(("batch_stats", "swin_model"), "swin_model.")
            + _multimodal_rules(variables, ("params", "multimodal"), plm_name,
                                "multimodal."))


def to_jax_tree(state_dict_or_grads: Mapping[str, Any], like,
                plm_name: str = "roberta-large"):
    """The inverse bridge: a pipeline state_dict, or gradients keyed by the
    same parameter names, as nested dicts of numpy arrays under the paths of
    the JAX variables `like` ({'params', 'batch_stats'}).  Names missing from
    the input (running statistics in a dict of gradients) are left out;
    geometry buffers have no JAX counterpart and are ignored."""
    out: Dict[str, Any] = {}
    for path, name, layout in _pipeline_rules(like, plm_name):
        if name not in state_dict_or_grads:
            continue
        node = out
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = _TO_JAX[layout](_np(state_dict_or_grads[name]))
    return out


def load_adamw_state(optimizer, named_params: Mapping[str, Any], mu, nu,
                     count: int, like, plm_name: str = "roberta-large"):
    """Carry optax AdamW moments into a torch.optim.AdamW.  `mu` and `nu` are
    numpy trees with the paths of `like['params']` restricted to the
    optimizer's branch (as optax keeps them for one of the two optimizers);
    `named_params` maps the pipeline's parameter names to the tensors that
    `optimizer` holds; `count` is optax's update count."""
    import torch

    rules = [r for r in _pipeline_rules(like, plm_name) if r[0][0] == "params"]
    held = {id(p) for group in optimizer.param_groups for p in group["params"]}
    for path, name, layout in rules:
        if id(named_params.get(name)) not in held:
            continue
        p = named_params[name]
        sub = path[2:]            # below ('params', branch)
        as_state = lambda tree: torch.tensor(
            _TO_TORCH[layout](_np(_get(tree, sub)))).to(p.device, p.dtype)
        optimizer.state[p] = {
            "step": torch.tensor(float(count)),
            "exp_avg": as_state(mu), "exp_avg_sq": as_state(nu)}


def load_multitask_state(state, swin_opt, mm_opt, swin_step: int, mm_step: int,
                         like, plm_name: str = "roberta-large"):
    """Carry a JAX MultiTaskState into the port's (train/optim.py).
    `swin_opt` and `mm_opt` are (mu, nu, count) of the two optax AdamW
    states as numpy trees; `swin_step` / `mm_step` the two step counters.
    Parameters and BatchNorm statistics travel through pipeline_state_dict."""
    named = dict(state.model.named_parameters())
    for opt, (mu, nu, count) in ((state.swin_opt, swin_opt),
                                 (state.mm_opt, mm_opt)):
        load_adamw_state(opt.adamw, named, mu, nu, int(count), like, plm_name)
        opt.set_count(int(count))
    state.swin_step, state.mm_step = int(swin_step), int(mm_step)
    return state

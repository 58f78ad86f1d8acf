"""Weight bridge: JAX pipeline variables -> this port's state_dict.

Takes the JAX FacialMMTPipeline's `variables` as nested mappings of arrays
(`params` and `batch_stats`, each with `swin_model` and `multimodal`
branches) and returns {name: np.ndarray} under the reference's torch names,
which is what the port's modules are built with, so the result loads with
load_state_dict(strict=True).  It is the numpy twin of
facialmmt_tpu/checkpoint/torch_export.py (that module needs the JAX Swin ops
for its geometry buffers).  Layout rules:
  * dense kernel (in, out)            -> Linear weight (out, in);
  * patch kernel (p, p, C, E)          -> Conv2d weight (E, C, p, p);
  * in_proj_kernel (E, 3E)             -> in_proj_weight (3E, E);
  * BatchNorm batch_stats mean / var   -> running_mean / running_var.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np

from facialmmt_tpu_torch.ops.swin import (relative_position_index,
                                          shifted_window_mask)

StateDict = Dict[str, np.ndarray]


def _np(x) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(x, dtype=np.float32))


def _linear(tree: Mapping[str, Any], out: StateDict, prefix: str) -> None:
    out[f"{prefix}.weight"] = _np(tree["kernel"]).T.copy()
    if "bias" in tree:
        out[f"{prefix}.bias"] = _np(tree["bias"])


def _norm(tree: Mapping[str, Any], out: StateDict, prefix: str) -> None:
    """LayerNormTF ('weight') and flax LayerNorm / BatchNorm ('scale')."""
    out[f"{prefix}.weight"] = _np(tree["weight"] if "weight" in tree
                                  else tree["scale"])
    out[f"{prefix}.bias"] = _np(tree["bias"])


def _num_layers(tree) -> int:
    return sum(1 for k in tree if str(k).startswith("layer_"))


def _utt_encoder(tree, out: StateDict, p: str) -> None:
    out[f"{p}.position_embeddings.weight"] = _np(tree["position_embeddings"])
    for i in range(_num_layers(tree)):
        lt = tree[f"layer_{i}"]
        lp = f"{p}.layer.{i}"
        sa = f"{lp}.transformer_self_attention"
        for name in ("query", "key", "value"):
            _linear(lt["selfatt"][name], out, f"{sa}.selfatt.{name}")
        _linear(lt["attn_dense"], out, f"{sa}.dense_norm.dense")
        _norm(lt["attn_norm"], out, f"{sa}.dense_norm.LayerNorm")
        _linear(lt["intermediate"], out, f"{lp}.intermediate.dense")
        _linear(lt["output"], out, f"{lp}.output.dense")
        _norm(lt["out_norm"], out, f"{lp}.output.LayerNorm")


def _crossmodal(tree, out: StateDict, p: str) -> None:
    _norm(tree["final_norm"], out, f"{p}.layer_norm")
    out[f"{p}.version"] = np.asarray([2.0], np.float32)
    out[f"{p}.embed_positions._float_tensor"] = np.zeros((1,), np.float32)
    for i in range(_num_layers(tree)):
        lt = tree[f"layer_{i}"]
        lp = f"{p}.layers.{i}"
        sa = lt["self_attn"]
        out[f"{lp}.self_attn.in_proj_weight"] = _np(sa["in_proj_kernel"]).T.copy()
        out[f"{lp}.self_attn.in_proj_bias"] = _np(sa["in_proj_bias"])
        _linear(sa["out_proj"], out, f"{lp}.self_attn.out_proj")
        _linear(lt["fc1"], out, f"{lp}.fc1")
        _linear(lt["fc2"], out, f"{lp}.fc2")
        _norm(lt["ln0"], out, f"{lp}.layer_norms.0")
        _norm(lt["ln1"], out, f"{lp}.layer_norms.1")


def _text_encoder(tree, out: StateDict, p: str) -> None:
    for name in ("word_embeddings", "position_embeddings",
                 "token_type_embeddings"):
        out[f"{p}.embeddings.{name}.weight"] = _np(tree[name]["embedding"])
    _norm(tree["embeddings_norm"], out, f"{p}.embeddings.LayerNorm")
    for i in range(_num_layers(tree)):
        lt = tree[f"layer_{i}"]
        lp = f"{p}.encoder.layer.{i}"
        for name in ("query", "key", "value"):
            _linear(lt[name], out, f"{lp}.attention.self.{name}")
        _linear(lt["attn_out"], out, f"{lp}.attention.output.dense")
        _norm(lt["attn_norm"], out, f"{lp}.attention.output.LayerNorm")
        _linear(lt["intermediate"], out, f"{lp}.intermediate.dense")
        _linear(lt["output"], out, f"{lp}.output.dense")
        _norm(lt["out_norm"], out, f"{lp}.output.LayerNorm")


def _swin_backbone(params, batch_stats, out: StateDict, p: str) -> None:
    """Stage/block structure, window size and per-stage resolution are read
    off the tree itself (as torch_export does), for the geometry buffers."""
    depths = []
    while f"stage_{len(depths)}_block_0" in params:
        d = 0
        while f"stage_{len(depths)}_block_{d}" in params:
            d += 1
        depths.append(d)
    pe = params["patch_embed"]
    kernel = _np(pe["proj_kernel"])
    out[f"{p}.patch_embed.proj.weight"] = kernel.transpose(3, 2, 0, 1).copy()
    out[f"{p}.patch_embed.proj.bias"] = _np(pe["proj_bias"])
    if "norm" in pe:
        _norm(pe["norm"], out, f"{p}.patch_embed.norm")
    c_final = kernel.shape[3] * 2 ** (len(depths) - 1)
    head_in = np.asarray(params["head_linear"]["kernel"]).shape[0]
    final_res = int(round(np.sqrt(head_in // c_final)))
    for s, depth in enumerate(depths):
        res = final_res * 2 ** (len(depths) - 1 - s)
        for d in range(depth):
            bt = params[f"stage_{s}_block_{d}"]
            bp = f"{p}.layers.{s}.blocks.{d}"
            _norm(bt["norm1"], out, f"{bp}.norm1")
            _norm(bt["norm2"], out, f"{bp}.norm2")
            _linear(bt["attn"]["qkv"], out, f"{bp}.attn.qkv")
            _linear(bt["attn"]["proj"], out, f"{bp}.attn.proj")
            table = _np(bt["attn"]["relative_position_bias_table"])
            out[f"{bp}.attn.relative_position_bias_table"] = table
            ws = (int(round(np.sqrt(table.shape[0]))) + 1) // 2
            ws_eff = min(ws, res)
            out[f"{bp}.attn.relative_position_index"] = \
                relative_position_index(ws_eff).astype(np.int64)
            if d % 2 == 1 and res > ws:
                out[f"{bp}.attn_mask"] = shifted_window_mask(
                    res, res, ws_eff, ws // 2)
            _linear(bt["mlp_fc1"], out, f"{bp}.mlp.fc1")
            _linear(bt["mlp_fc2"], out, f"{bp}.mlp.fc2")
        if s < len(depths) - 1:
            dt = params[f"stage_{s}_downsample"]
            _norm(dt["norm"], out, f"{p}.layers.{s}.downsample.norm")
            _linear(dt["reduction"], out, f"{p}.layers.{s}.downsample.reduction")
    _norm(params["head_norm"], out, f"{p}.output_layer.0")
    _linear(params["head_linear"], out, f"{p}.output_layer.2")
    _norm(params["head_bn"], out, f"{p}.output_layer.3")
    out[f"{p}.output_layer.3.running_mean"] = _np(batch_stats["head_bn"]["mean"])
    out[f"{p}.output_layer.3.running_var"] = _np(batch_stats["head_bn"]["var"])
    out[f"{p}.output_layer.3.num_batches_tracked"] = np.asarray(0, np.int64)


def swin_fer_state_dict(variables, prefix: str = "") -> StateDict:
    """JAX SwinForAffwildClassification variables -> state_dict."""
    p = prefix
    out: StateDict = {}
    _swin_backbone(variables["params"]["swin"], variables["batch_stats"]["swin"],
                   out, f"{p}swin")
    _linear(variables["params"]["linear"], out, f"{p}linear")
    _linear(variables["params"]["classifier"], out, f"{p}classifier")
    return out


def multimodal_state_dict(variables, plm_name: str = "roberta-large",
                          prefix: str = "") -> StateDict:
    """JAX MultiModalTransformerForClassification variables -> state_dict.
    plm_name picks the text tower's attribute ('roberta' or 'bert')."""
    params = variables["params"]
    p = prefix
    out: StateDict = {}
    _text_encoder(params["text_encoder"], out,
                  p + ("roberta" if "roberta" in plm_name else "bert"))
    _linear(params["text_linear"], out, f"{p}text_linear")
    _linear(params["audio_linear"], out, f"{p}audio_linear")
    _utt_encoder(params["audio_utt_transformer"], out,
                 f"{p}audio_utt_transformer")
    _linear(params["vision_linear"], out, f"{p}vision_linear")
    _utt_encoder(params["vision_utt_transformer"], out,
                 f"{p}vision_utt_transformer")
    att = params["attention"]
    out[f"{p}attention.query_vector"] = _np(att["query_vector"])
    for name in ("P", "Q", "value"):
        _linear(att[name], out, f"{p}attention.{name}")
    _crossmodal(params["CrossModalTrans_TA"], out, f"{p}CrossModalTrans_TA")
    _crossmodal(params["CrossModalTrans_TA_V"], out, f"{p}CrossModalTrans_TA_V")
    _linear(params["classifier"], out, f"{p}classifier")
    return out


def pipeline_state_dict(variables, plm_name: str = "roberta-large") -> StateDict:
    """JAX FacialMMTPipeline variables -> the port pipeline's state_dict."""
    params, stats = variables["params"], variables["batch_stats"]
    out = swin_fer_state_dict({"params": params["swin_model"],
                               "batch_stats": stats["swin_model"]},
                              prefix="swin_model.")
    out.update(multimodal_state_dict({"params": params["multimodal"]},
                                     plm_name, prefix="multimodal."))
    return out

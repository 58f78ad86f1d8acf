"""Released reference checkpoints into the port (counterpart of
facialmmt_tpu/checkpoint/torch_convert.py's loader and main.py's doEval path).

The reference ships two files (reference utils/util.py:121-159): the fusion
model (`MultiModalTransformerForClassification`) and the Swin FER model
(`SwinForAffwildClassification`), each a state_dict or a whole pickled
module.  The port's parameters carry the reference's names, so the two state
dicts become the pipeline's under the prefixes `multimodal.` and
`swin_model.`, and load with `strict=True`:

    sd = released_state_dict("best_multimodal.pt", "best_swin.pt")
    EmotionServer(cfg, sd)                    # or
    Trainer(cfg).eval_multimodal_only(sd, test_ds)

`save_released` writes a pipeline state_dict back as the two files.

The files a run starts from, each as a state_dict that the trainer grafts
(train/trainer.py::graft_subtree) or loads with strict=True, none of them
through `transformers`:
  * the released V-only model, `unimodal_model_V.pt` (load_torch_state_dict);
  * the Ms-Celeb-1M Swin backbone (load_pretrained_swin_backbone): its
    `backbone.*` keys, the classifier head skipped (reference
    train.py:316-331);
  * a local HF text-tower directory (load_hf_text_tower): `config.json`,
    and the weights from `pytorch_model.bin` or `model.safetensors` (read by
    `read_safetensors`), one file or an index of shards.
"""

from __future__ import annotations

import json
import os
import struct
import sys
import types
from typing import Dict, Mapping

import torch

from facialmmt_tpu_torch.config import TextEncoderConfig

MULTIMODAL, SWIN = "multimodal.", "swin_model."


def _install_timm_stub() -> None:
    """Unpickling the reference's Swin needs `timm.models.layers`
    (DropPath, to_2tuple, trunc_normal_) to resolve; the stub satisfies the
    unpickler and never runs."""
    if "timm" in sys.modules:
        return
    import importlib.machinery

    def module(name):
        m = types.ModuleType(name)
        m.__spec__ = importlib.machinery.ModuleSpec(name, loader=None)
        return m

    timm, models, layers = (module("timm"), module("timm.models"),
                            module("timm.models.layers"))

    def to_2tuple(x):
        return tuple(x) if isinstance(x, (tuple, list)) else (x, x)

    class DropPath(torch.nn.Module):
        def __init__(self, drop_prob=None):
            super().__init__()
            self.drop_prob = drop_prob

        def forward(self, x):
            return x

    def trunc_normal_(tensor, mean=0., std=1., a=-2., b=2.):
        with torch.no_grad():
            tensor.normal_(mean, std).clamp_(a * std, b * std)
        return tensor

    # the pickle finds the class by this identity
    DropPath.__module__ = "timm.models.layers"
    DropPath.__qualname__ = "DropPath"
    layers.DropPath, layers.to_2tuple = DropPath, to_2tuple
    layers.trunc_normal_ = trunc_normal_
    models.layers, timm.models = layers, models
    sys.modules.update({"timm": timm, "timm.models": models,
                        "timm.models.layers": layers})


def load_torch_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """A torch checkpoint (a state_dict, {'state_dict': ...}, or a whole
    pickled module) as {name: CPU tensor}, dtypes as stored.  A whole-module
    pickle needs the reference's module classes importable (its sources on
    sys.path); timm is stubbed here."""
    _install_timm_stub()
    obj = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(obj, dict):
        sd = obj.get("state_dict", obj)
    else:  # a whole nn.Module pickle
        sd = obj.state_dict()
    return {k: v.detach().cpu() for k, v in sd.items() if hasattr(v, "detach")}


def released_state_dict(multimodal_path: str, swin_path: str
                        ) -> Dict[str, torch.Tensor]:
    """The pipeline's state_dict from the two released files.  The HF text
    tower's pooler, which the reference module holds and never uses, has no
    counterpart in the port and is left out."""
    mm = load_torch_state_dict(multimodal_path)
    out = {MULTIMODAL + k: v for k, v in mm.items()
           if ".pooler." not in f".{k}"}
    out.update({SWIN + k: v for k, v in load_torch_state_dict(swin_path)
                .items()})
    return out


def save_released(state_dict: Mapping[str, torch.Tensor],
                  multimodal_path: str, swin_path: str) -> None:
    """Write a pipeline state_dict as the reference's two files (plain
    state_dicts of CPU tensors), the inverse of released_state_dict."""
    for prefix, path in ((MULTIMODAL, multimodal_path), (SWIN, swin_path)):
        torch.save({k[len(prefix):]: v.detach().cpu()
                    for k, v in state_dict.items() if k.startswith(prefix)},
                   path)


def load_pretrained_swin_backbone(path: str) -> Dict[str, torch.Tensor]:
    """The Ms-Celeb-1M pretrained Swin as the backbone's state_dict: the
    file's `backbone.*` keys with the prefix taken off; the classifier head's
    keys are skipped (reference train.py:316-331)."""
    prefix = "backbone."
    return {k[len(prefix):]: v for k, v in load_torch_state_dict(path).items()
            if k.startswith(prefix)}


_SAFETENSORS_DTYPES = {
    "F64": torch.float64, "F32": torch.float32, "F16": torch.float16,
    "BF16": torch.bfloat16, "I64": torch.int64, "I32": torch.int32,
    "I16": torch.int16, "I8": torch.int8, "U8": torch.uint8,
    "BOOL": torch.bool}


def read_safetensors(path: str) -> Dict[str, torch.Tensor]:
    """A `.safetensors` file: an 8-byte little-endian header length, a JSON
    header {name: {dtype, shape, data_offsets: [begin, end]}} (offsets into
    the bytes after the header), then the raw little-endian tensors."""
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
        data = bytearray(f.read())
    out = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        begin, end = info["data_offsets"]
        dtype = _SAFETENSORS_DTYPES[info["dtype"]]
        count = (end - begin) // dtype.itemsize
        flat = (torch.frombuffer(data, dtype=dtype, count=count, offset=begin)
                if count else torch.empty(0, dtype=dtype))
        out[name] = flat.reshape(info["shape"]).clone()
    return out


def _hf_weights(model_dir: str) -> Dict[str, torch.Tensor]:
    """Every tensor of an HF directory's weight files."""
    for index, read in (("model.safetensors.index.json", read_safetensors),
                        ("pytorch_model.bin.index.json", None)):
        path = os.path.join(model_dir, index)
        if os.path.isfile(path):
            with open(path) as f:
                shards = sorted(set(json.load(f)["weight_map"].values()))
            break
    else:
        shards = [name for name in ("model.safetensors", "pytorch_model.bin")
                  if os.path.isfile(os.path.join(model_dir, name))][:1]
    if not shards:
        raise FileNotFoundError(
            f"{model_dir} holds no model.safetensors or pytorch_model.bin")
    sd: Dict[str, torch.Tensor] = {}
    for shard in shards:
        path = os.path.join(model_dir, shard)
        if shard.endswith(".safetensors"):
            sd.update(read_safetensors(path))
        else:
            sd.update(torch.load(path, map_location="cpu", weights_only=True))
    return sd


# keys of an HF checkpoint that the port's text tower has no counterpart for:
# the pooler (the reference reads only outputs[0], src/models.py:106), the
# pre-training heads, and the index buffers HF rebuilds itself
_HF_DROPPED = ("pooler.", "lm_head.", "cls.", "embeddings.position_ids",
               "embeddings.token_type_ids")


def load_hf_text_tower(model_dir: str, text_cfg: TextEncoderConfig,
                       prefix: str) -> Dict[str, torch.Tensor]:
    """A local HF RoBERTa/BERT directory as the text tower's state_dict under
    `prefix` ('roberta' or 'bert', the multimodal model's attribute).
    config.json is checked against `text_cfg` first, so a wrong --plm_name /
    directory pairing fails with the dimension diff; then the base-model
    prefix, the pooler and the heads go and LayerNorm's legacy gamma / beta
    names become weight / bias (as transformers renames them)."""
    with open(os.path.join(model_dir, "config.json")) as f:
        hf = json.load(f)
    checks = [
        ("hidden_size", text_cfg.hidden_size, hf.get("hidden_size")),
        ("num_layers", text_cfg.num_layers, hf.get("num_hidden_layers")),
        ("num_heads", text_cfg.num_heads, hf.get("num_attention_heads")),
        ("intermediate_size", text_cfg.intermediate_size,
         hf.get("intermediate_size")),
        ("vocab_size", text_cfg.vocab_size, hf.get("vocab_size")),
        ("max_position_embeddings", text_cfg.max_position_embeddings,
         hf.get("max_position_embeddings")),
    ]
    bad = [f"{name}: ours {ours} vs HF {theirs}"
           for name, ours, theirs in checks if ours != theirs]
    if bad:
        raise ValueError(
            f"pretrained text model at {model_dir} does not match the "
            f"resolved text-tower config ({'; '.join(bad)}) — check "
            f"--plm_name / --pretrainedtextmodel_path")
    out = {}
    for name, tensor in _hf_weights(model_dir).items():
        for base in ("roberta.", "bert."):
            if name.startswith(base):
                name = name[len(base):]
        if name.startswith(_HF_DROPPED):
            continue
        if name.endswith(".gamma"):
            name = name[:-len("gamma")] + "weight"
        elif name.endswith(".beta"):
            name = name[:-len("beta")] + "bias"
        out[f"{prefix}.{name}"] = tensor
    return out


def save_hf_text_tower(state_dict: Mapping[str, torch.Tensor],
                       text_cfg: TextEncoderConfig, prefix: str,
                       model_dir: str) -> None:
    """Write the text tower under `prefix` of `state_dict` as a local HF
    directory (config.json and pytorch_model.bin), the inverse of
    load_hf_text_tower: for runs that start from a tower the port made."""
    os.makedirs(model_dir, exist_ok=True)
    config = {"model_type": text_cfg.model_type,
              "hidden_size": text_cfg.hidden_size,
              "num_hidden_layers": text_cfg.num_layers,
              "num_attention_heads": text_cfg.num_heads,
              "intermediate_size": text_cfg.intermediate_size,
              "vocab_size": text_cfg.vocab_size,
              "max_position_embeddings": text_cfg.max_position_embeddings,
              "type_vocab_size": text_cfg.type_vocab_size,
              "pad_token_id": text_cfg.pad_token_id,
              "layer_norm_eps": text_cfg.layer_norm_eps}
    with open(os.path.join(model_dir, "config.json"), "w") as f:
        json.dump(config, f, indent=1)
    head = prefix + "."
    torch.save({k[len(head):]: v.detach().cpu().contiguous()
                for k, v in state_dict.items() if k.startswith(head)},
               os.path.join(model_dir, "pytorch_model.bin"))

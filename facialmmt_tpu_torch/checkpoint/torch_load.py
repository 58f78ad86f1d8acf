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
"""

from __future__ import annotations

import sys
import types
from typing import Dict, Mapping

import torch

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
